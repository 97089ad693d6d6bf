"""How each rank holds the model's parameters over a `Mesh` (the JAX
package's `param_sharding`, spann3r_tpu/parallel/mesh.py:60-90).

Tensor parallelism (`--model_axis M`): each ViT block of the encoder, the
two decoders and the value encoder whose width is at least `min_dim` (and
whose heads and MLP width M divides) is split the Megatron way over the
model group: `attn.qkv` by heads (a rank holds its heads' rows of q, of k
and of v), `cross_attn.projq/projk/projv` and `mlp.fc1` by output rows,
`attn.proj`, `cross_attn.proj` and `mlp.fc2` by input columns, their
biases whole and added after the group's sum. Each split linear carries
its forward (`LinearSplit`, which `ops.layers.linear` calls), so that the
rule and the collectives that go with it live here. The patch
embeddings, norms, heads, attn-head MLPs and everything else stay whole
on every rank.

Sharded optimizer state (`--fsdp 1`, ZeRO-3 style): each weight of two or
more dimensions whose input dim (a linear's or convolution's input
channels) is at least `min_dim` keeps its fp32 master and its Adam
moments as this rank's flat slice of ceil(numel / N) elements, padded
(N the data group's size; after the tensor-parallel split when both
apply). A step all-gathers the working copy of these weights, and
reduce-scatters their gradients: that reduce-scatter is the data group's
sum for them. Every other gradient is summed over the data group by one
all-reduce per dtype.

Checkpoints hold the full tensors: `full_tensors` gathers the slices back
on every rank, and a full state is cut to this rank's part by
`shard_model_` / `shard_tensors`, so a checkpoint written under one layout
and world loads under any other.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..config import Spann3RConfig
from ..models.spann3r import value_encoder_cfg
from .mesh import (Mesh, all_gather_flat, all_reduce_flat, all_reduce_sum,
                   copy_to_group, flat_shard, reduce_scatter_flat)

# the split of each tensor of a split block: "qkv" rows by heads of the
# packed (3, H, Dh) output, "rows" output rows, "cols" input columns
TP_SPLIT = {
    "attn.qkv.weight": "qkv", "attn.qkv.bias": "qkv",
    "attn.proj.weight": "cols",
    "cross_attn.projq.weight": "rows", "cross_attn.projq.bias": "rows",
    "cross_attn.projk.weight": "rows", "cross_attn.projk.bias": "rows",
    "cross_attn.projv.weight": "rows", "cross_attn.projv.bias": "rows",
    "cross_attn.proj.weight": "cols",
    "mlp.fc1.weight": "rows", "mlp.fc1.bias": "rows",
    "mlp.fc2.weight": "cols",
}


class LinearSplit:
    """The forward of a linear that the model group splits. A column split
    (its output rows: "qkv" or "rows") takes its input through
    `copy_to_group`, so that the input's gradient is summed over the
    group; a row split (its input columns: "cols") sums its partial
    products over the group, then adds the whole bias. Weights cast to
    the input's dtype, as `ops.layers.linear` casts them."""

    def __init__(self, column: bool, group: dist.ProcessGroup):
        self.column, self.group = column, group

    def __call__(self, m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        w = m.weight.to(x.dtype)
        b = None if m.bias is None else m.bias.to(x.dtype)
        if self.column:
            return F.linear(copy_to_group(x, self.group), w, b)
        y = all_reduce_sum(F.linear(x, w), self.group)
        return y if b is None else y + b


def tp_slice(t: torch.Tensor, spec: str, rank: int, n: int) -> torch.Tensor:
    """Rank `rank`'s part of the full tensor t under `spec`, in its own
    storage."""
    if spec == "rows":
        part = t.chunk(n, 0)[rank]
    elif spec == "cols":
        part = t.chunk(n, 1)[rank]
    else:
        part = t.reshape(3, n, -1, *t.shape[1:])[:, rank].reshape(
            -1, *t.shape[1:])
    return part.clone(memory_format=torch.contiguous_format)


def tp_join(parts, spec: str) -> torch.Tensor:
    """The full tensor from each rank's part, in rank order."""
    if spec == "rows":
        return torch.cat(parts, 0)
    if spec == "cols":
        return torch.cat(parts, 1)
    rest = parts[0].shape[1:]
    return torch.stack([p.reshape(3, -1, *rest) for p in parts], 1).reshape(
        -1, *rest)


def _local_shape(shape, spec, n):
    if spec is None:
        return tuple(shape)
    if spec == "cols":
        return (shape[0], shape[1] // n, *shape[2:])
    return (shape[0] // n, *shape[1:])


def _input_dims(model: nn.Module) -> Dict[str, int]:
    """Each linear's and convolution's weight name -> its input channels."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, nn.ConvTranspose2d):
            out[f"{name}.weight"] = m.weight.shape[0]
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            out[f"{name}.weight"] = m.weight.shape[1]
    return out


def _block_stacks(model: nn.Module, cfg: Spann3RConfig):
    d, dc = model.dust3r, cfg.dust3r
    return (("dust3r.enc_blocks", d.enc_blocks, dc.enc),
            ("dust3r.dec_blocks", d.dec_blocks, dc.dec),
            ("dust3r.dec_blocks2", d.dec_blocks2, dc.dec),
            ("value_encoder", model.value_encoder, value_encoder_cfg(cfg)))


class Layout:
    """Which of `model`'s parameters this rank holds split or sliced, and
    the collectives that go with them. Built on the full model, before
    `shard_model_`."""

    def __init__(self, model: nn.Module, cfg: Spann3RConfig, mesh: Mesh,
                 fsdp: bool = False, min_dim: int = 1024):
        self.mesh = mesh
        self.shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.tp: Dict[str, str] = {}
        self._tp_linears: Dict[str, bool] = {}   # module -> column split
        m = mesh.model
        if m > 1:
            for prefix, blocks, vcfg in _block_stacks(model, cfg):
                hidden = int(vcfg.dim * vcfg.mlp_ratio)
                if vcfg.dim < min_dim or vcfg.num_heads % m or hidden % m:
                    continue
                for i in range(len(blocks)):
                    for suffix, spec in TP_SPLIT.items():
                        name = f"{prefix}.{i}.{suffix}"
                        if name not in self.shapes:
                            continue
                        self.tp[name] = spec
                        if name.endswith(".weight"):
                            self._tp_linears[name[:-len(".weight")]] = \
                                spec != "cols"
        self.local_shapes = {n: _local_shape(s, self.tp.get(n), m)
                             for n, s in self.shapes.items()}
        in_dims = _input_dims(model)
        self.fsdp = [n for n, s in self.shapes.items()
                     if fsdp and len(s) >= 2 and in_dims.get(n, 0) >= min_dim]
        self._numel = {n: math.prod(self.local_shapes[n]) for n in self.fsdp}

    def describe(self) -> str:
        return (f"{len(self.tp)} tensors split over model ({self.mesh.model}),"
                f" {len(self.fsdp)} sliced over data ({self.mesh.data}, "
                f"fsdp)")

    # -- the full state <-> this rank's part ---------------------------------

    def _part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if name in self.tp:
            t = tp_slice(t, self.tp[name], self.mesh.model_rank,
                         self.mesh.model)
        if name in self._numel:
            t = flat_shard(t, self.mesh.data_rank, self.mesh.data)
        return t

    @torch.no_grad()
    def shard_model_(self, model: nn.Module) -> nn.Module:
        """Cut the full model's parameters to this rank's parts, in place,
        and give each split linear its forward (`LinearSplit`)."""
        for name, p in model.named_parameters():
            part = self._part(name, p.data)
            if part is not p.data:
                p.data = part
        modules = dict(model.named_modules())
        for name, column in self._tp_linears.items():
            modules[name].tp_split = LinearSplit(column,
                                                 self.mesh.model_group)
        return model

    def shard_tensors(self, full: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """This rank's parts of full tensors keyed by parameter name (the
        Adam moments of a full checkpoint)."""
        return {n: self._part(n, t) for n, t in full.items()}

    @torch.no_grad()
    def full_tensors(self, local: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The full tensors of this rank's parts keyed by parameter name
        (parameters, moments or gradients). A collective: every rank of
        the mesh must call it with the same names."""
        out = dict(local)
        sliced = {n: local[n] for n in self.fsdp if n in local}
        if sliced:
            flat = all_gather_flat(sliced, self._numel, self.mesh.data_group)
            for n, t in flat.items():
                out[n] = t.view(self.local_shapes[n])
        for n, spec in self.tp.items():
            if n not in out:
                continue
            t = out[n].contiguous()
            buf = t.new_empty(self.mesh.model * t.numel())
            dist.all_gather_into_tensor(buf, t.reshape(-1),
                                        group=self.mesh.model_group)
            out[n] = tp_join(list(buf.view(self.mesh.model,
                                           *t.shape).unbind(0)), spec)
        return out

    @contextlib.contextmanager
    def gathered(self, model: nn.Module) -> Iterator[None]:
        """The sliced parameters whole (this rank's tensor-parallel parts)
        while the block runs, for the eval; a collective."""
        params = dict(model.named_parameters())
        shards = {n: params[n].data for n in self.fsdp}
        if shards:
            full = all_gather_flat(shards, self._numel, self.mesh.data_group)
            for n, t in full.items():
                params[n].data = t.view(self.local_shapes[n])
        try:
            yield
        finally:
            for n, t in shards.items():
                params[n].data = t

    # -- the step ------------------------------------------------------------

    def gather_work(self, wp: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The working copy to differentiate against: each sliced entry of
        `wp` (bf16 under a bf16 working copy, else fp32) all-gathered into
        a new leaf of its (tensor-parallel) shape."""
        if not self.fsdp:
            return wp
        full = all_gather_flat({n: wp[n].detach() for n in self.fsdp},
                               self._numel, self.mesh.data_group)
        return {n: (full[n].view(self.local_shapes[n]).requires_grad_(True)
                    if n in full else t) for n, t in wp.items()}

    def reduce_grads(self, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The gradients summed over the data group: this rank's slice for
        a sliced weight (reduce-scatter), the whole sum (one all-reduce per
        dtype) for the rest."""
        group = self.mesh.data_group
        out = reduce_scatter_flat({n: grads[n] for n in self.fsdp}, group) \
            if self.fsdp else {}
        out.update(all_reduce_flat(
            {n: g for n, g in grads.items() if n not in out}, group))
        return {n: out[n] for n in grads}

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole gradient from the data-reduced parts
        (`reduce_grads`), fp32, the same bits on every rank: each tensor's
        sum of squares, summed over the group its parts are split over
        (model, data, or both), then over the tensors in their order, as
        `training.global_norm_f32` sums them in one process."""
        sq = [torch.sum(torch.square(g.float())) for g in grads.values()]
        names = list(grads)
        sliced = set(self.fsdp)
        for want, group in (((True, False), self.mesh.model_group),
                            ((False, True), self.mesh.data_group),
                            ((True, True), None)):
            idx = [i for i, n in enumerate(names)
                   if (n in self.tp, n in sliced) == want]
            if idx:
                v = torch.stack([sq[i] for i in idx])
                dist.all_reduce(v, group=group)
                for j, i in enumerate(idx):
                    sq[i] = v[j]
        return torch.sqrt(sum(sq))

    def all_finite(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Whether every rank's gradients are finite, decided alike on every
        rank (a device bool)."""
        s = sum(torch.sum(torch.square(g.float())) for g in grads.values())
        s = torch.as_tensor(s).reshape(1).clone()
        dist.all_reduce(s)
        return torch.isfinite(s[0])

    def zero_grads(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """An fp32 gradient accumulator of zeros in the working copy's
        shapes (a sliced weight's whole, this rank's tensor-parallel part)."""
        return {n: torch.zeros(self.local_shapes[n], dtype=p.dtype,
                               device=p.device)
                for n, p in model.named_parameters()}
