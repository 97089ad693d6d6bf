"""The process mesh of multi-process training, its collectives, and the
flat-shard helpers of the sharded optimizer state.

The JAX package scales over a ('data', 'model') device mesh
(spann3r_tpu/parallel/mesh.py); the reference with DDP over NCCL
(croco/utils/misc.py:222-259). Here each process is one rank of a
`torch.distributed` group, launched by torchrun:

    python -m torch.distributed.run --nproc_per_node N -m spann3r_torch.train ...

`init_distributed` reads torchrun's environment and joins the group
(NCCL on the card, gloo on the CPU); `make_mesh` lays the ranks out as
data x model, rank = data_rank * model + model_rank, as JAX reshapes its
devices. The data group holds the ranks that take different batches and
the same parameters; the model group the ranks that split each block's
weights (tensor parallelism) and take the same batch.

Two differentiable collectives carry the step: `all_reduce_sum` (the
group's sum forward, the gradient passed through unchanged) forms the
loss's batch-wide statistics over the data group, so that each rank's
backward yields the derivative through its own samples only, and closes a
row-parallel product over the model group; `copy_to_group` (the identity
forward, the gradient summed over the group) opens a column-parallel one.

The stream half serves independent video streams over the ranks:
`make_mesh_for_batch` takes the largest data size that divides the
number of streams (a subset of the ranks, as JAX takes a subset of its
devices), `batch_block` / `shard_batch` give a rank its contiguous block
of the (T, B, ...) batch axis (JAX's `batch_sharding`; the rest is
`replicated`, whole on every rank), and `gather_streams` puts the ranks'
blocks back in stream order (`parallel/streams.py` runs the scan).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(device: str = "cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device:
    `cuda:LOCAL_RANK` (made the current device) for a CUDA `device`, else
    `device`. Without that environment, or with a group already joined, it
    joins nothing. The backend follows the device (NCCL for CUDA, gloo for
    the CPU) unless `backend` names one; nothing falls back to another."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")
    if "WORLD_SIZE" not in os.environ:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                         f"{os.environ['MASTER_PORT']}"),
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return dev


@dataclass(frozen=True)
class Mesh:
    """The ranks as data x model. The groups are None in one process."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        return self.data_rank * self.model + self.model_rank

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    def gather_numpy(self, a: np.ndarray) -> np.ndarray:
        """(data, ...) stack of each data rank's `a` (same shape and dtype
        on every rank); every rank of the data group must call it."""
        return gather_numpy(a, self.data_group, comm_device())


def comm_device() -> torch.device:
    """The device of the tensors a collective of the default group takes
    for host numbers: the current card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(model: int = 1) -> Mesh:
    """The data x model mesh over the joined group, data = world // model
    (JAX make_mesh). `model` must divide the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or world % model:
        raise ValueError(f"--model_axis {model} does not divide the world "
                         f"size {world}")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, None, None)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(comm_device().type, (world // model, model),
                          mesh_dim_names=("data", "model"))
    return Mesh(world // model, model, dm.get_local_rank("data"),
                dm.get_local_rank("model"), dm.get_group("data"),
                dm.get_group("model"))


def data_for_batch(batch_size: int, avail: int) -> int:
    """The largest data size of at most `avail` ranks that divides
    batch_size (JAX make_mesh_for_batch's choice)."""
    return max(d for d in range(1, avail + 1) if batch_size % d == 0)


def make_mesh_for_batch(batch_size: int, model: int = 1) -> Optional[Mesh]:
    """The data x model mesh whose data axis divides batch_size, over the
    first data * model ranks (JAX make_mesh_for_batch: a subset of the
    devices when the batch has fewer streams than the world has data
    ranks). Every rank of the group must call it, as `new_group` requires;
    a rank outside the subset gets None and takes no streams."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"size {world}")
    data = data_for_batch(batch_size, world // model)
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, None, None)
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    rank = dist.get_rank()
    if rank >= data * model:
        return None
    return Mesh(data, model, rank // model, rank % model,
                data_groups[rank % model], model_groups[rank // model])


def batch_block(mesh: Mesh, batch_size: int) -> slice:
    """This data rank's contiguous block of a batch axis of batch_size
    (JAX batch_sharding: the batch axis split over 'data')."""
    b = batch_size // mesh.data
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def shard_batch(mesh: Mesh, batch):
    """This rank's part of a host batch {name: (T, B, ...)}: its block of
    axis 1 of each array of 2+ dimensions; the others whole (JAX's
    replicated)."""
    def part(x):
        x = np.asarray(x)
        return x[:, batch_block(mesh, x.shape[1])] if x.ndim >= 2 else x

    return {k: part(v) for k, v in batch.items()}


def gather_streams(mesh: Mesh, a: np.ndarray) -> np.ndarray:
    """(T, B, ...) in stream order from each data rank's (T, b, ...) block
    (every rank of the data group must call it); `a` as it is in one
    process."""
    if mesh.data_group is None:
        return a
    st = mesh.gather_numpy(a)                       # (data, T, b, ...)
    st = np.moveaxis(st, 0, 1)
    return st.reshape(st.shape[0], -1, *st.shape[3:])


def gather_numpy(a: np.ndarray, group: Optional[dist.ProcessGroup],
                 device: torch.device) -> np.ndarray:
    """(n, ...) stack of `a` from each of the group's n ranks (the default
    group when `group` is None)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return np.stack([o.cpu().numpy() for o in out])


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of `x` over the group, the same bits on every rank; the
    gradient goes to this rank's `x` unchanged (each rank's term is its own
    input's, the others' are constants here). `x` itself without a group."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor,
                  group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """`x`, whose gradient is summed over the group: the input of a product
    whose output columns the group's ranks split."""
    return x if group is None else _CopyToGroup.apply(x, group)


# ---------------------------------------------------------------------------
# flat shards (the sharded optimizer state)
# ---------------------------------------------------------------------------

def shard_len(numel: int, n: int) -> int:
    """Elements of each rank's slice of a tensor split over n ranks."""
    return -(-numel // n)


def flat_shard(t: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """Rank `rank`'s slice of t flattened and zero-padded to n slices."""
    k = shard_len(t.numel(), n)
    flat = t.reshape(-1)
    if k * n != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(k * n - flat.numel())])
    return flat[rank * k:(rank + 1) * k].clone()


def _buckets(tensors):
    """Names grouped by dtype, in their order."""
    out = {}
    for name, t in tensors.items():
        out.setdefault(t.dtype, []).append(name)
    return out.values()


def all_gather_flat(shards, numels, group) -> dict:
    """{name: the whole flat tensor (numels[name],)} from each rank's
    slices in `shards`: one all-gather per dtype."""
    n = dist.get_world_size(group)
    out = {}
    for names in _buckets(shards):
        lens = [shards[k].numel() for k in names]
        flat = torch.cat([shards[k] for k in names])
        full = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(full, flat, group=group)
        cols = full.view(n, -1).split(lens, dim=1)
        for k, c in zip(names, cols):
            out[k] = c.reshape(-1)[:numels[k]]
    return out


def all_reduce_flat(tensors, group) -> dict:
    """{name: the group's sum of tensors[name]}, each a view of one flat
    buffer: one all-reduce per dtype."""
    out = {}
    for names in _buckets(tensors):
        flat = torch.cat([tensors[k].reshape(-1) for k in names])
        dist.all_reduce(flat, group=group)
        for k, part in zip(names, flat.split([tensors[k].numel()
                                              for k in names])):
            out[k] = part.view(tensors[k].shape)
    return out


def reduce_scatter_flat(fulls, group) -> dict:
    """{name: this rank's slice of the group's sum of fulls[name]}, padded
    as `flat_shard` pads: one reduce-scatter per dtype."""
    n = dist.get_world_size(group)
    out = {}
    for names in _buckets(fulls):
        lens = [shard_len(fulls[k].numel(), n) for k in names]
        cols: List[torch.Tensor] = []
        for k, ln in zip(names, lens):
            flat = fulls[k].reshape(-1)
            if ln * n != flat.numel():
                flat = torch.cat([flat, flat.new_zeros(ln * n - flat.numel())])
            cols.append(flat.view(n, ln))
        whole = torch.cat(cols, dim=1).reshape(-1)
        mine = whole.new_empty(sum(lens))
        dist.reduce_scatter_tensor(mine, whole, group=group)
        out.update(zip(names, mine.split(lens)))
    return out
