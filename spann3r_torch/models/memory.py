"""Spatial memory: a fixed-capacity token bank with masked operations.

Same design as the JAX package's `models/memory.py`: the bank has a static
capacity with per-stream counters, so every operation is a masked dense
tensor operation that takes any number of streams B:

  - append       = per-stream slice write at each stream's size
  - dedup check  = masked cosine similarity against the working-memory window
  - spill        = counter bookkeeping only (working -> long-term)
  - prune        = stable top-k over masked usage weights + gather
  - read         = `ops.memory_read` (the CUDA kernel on the card, B = 1)
  - training read = `memory_read_train`: masked softmax, memory dropout,
                   attention cast to the values' dtype before the readout,
                   in plain differentiable PyTorch (JAX's XLA read)

Operations return new states and leave their inputs unchanged; the append
carries autograd through its index writes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import MemoryConfig
from ..ops.layers import layer_norm
from ..ops.memory_read import memory_read_attention

NEG_INF = -1e30


class MemoryState(NamedTuple):
    """Token bank. Per stream b, slots [0, size[b]) are valid."""
    k: torch.Tensor        # (B, C, D) keys
    v: torch.Tensor        # (B, C, D) values
    count: torch.Tensor    # (B, C) age of each slot in frames
    attn: torch.Tensor     # (B, C) accumulated attention received
    size: torch.Tensor     # (B,) int32 number of valid token slots
    wm: torch.Tensor       # (B,) int32 number of working-memory frames
    lm: torch.Tensor       # (B,) int32 number of long-term tokens


def init_memory(batch: int, capacity: int, dim: int,
                dtype=torch.bfloat16, device=None) -> MemoryState:
    z3 = lambda: torch.zeros((batch, capacity, dim), dtype=dtype, device=device)
    z2 = lambda: torch.zeros((batch, capacity), dtype=torch.float32,
                             device=device)
    zi = lambda: torch.zeros((batch,), dtype=torch.int32, device=device)
    return MemoryState(z3(), z3(), z2(), z2(), zi(), zi(), zi())


def _valid_mask(state: MemoryState) -> torch.Tensor:
    c = state.k.shape[1]
    return (torch.arange(c, device=state.k.device)[None, :]
            < state.size[:, None])


def _per_stream_select(pred: torch.Tensor, new: MemoryState,
                       old: MemoryState) -> MemoryState:
    """Select new/old per stream; pred: (B,) bool."""
    def sel(a, b):
        return torch.where(pred.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return MemoryState(*(sel(a, b) for a, b in zip(new, old)))


def memory_read(norms, state: MemoryState, feat: torch.Tensor,
                attn_thresh: float, ln_eps: float = 1e-6,
                res: bool = True) -> Tuple[torch.Tensor, MemoryState]:
    """Attention readout of the bank, the inference read. feat (B, P, D)
    queries; `norms` holds norm_q, norm_k and norm_v. Returns (fused
    (B, P, D), state with the attention statistic accumulated). Streams
    with an empty bank get feat unchanged: the kernel's output for them is
    discarded here. Training reads are `memory_read_train`."""
    q = layer_norm(norms.norm_q, feat, ln_eps)
    k = layer_norm(norms.norm_k, state.k.to(feat.dtype), ln_eps)
    vv = layer_norm(norms.norm_v, state.v.to(feat.dtype), ln_eps)
    has_mem = state.size > 0
    out, attn_slot = memory_read_attention(q, k, vv, state.size, attn_thresh)
    if res:
        out = out + feat
    out = torch.where(has_mem[:, None, None], out, feat)
    new_attn = state.attn + torch.where(has_mem[:, None], attn_slot,
                                        torch.zeros_like(attn_slot))
    return out, state._replace(attn=new_attn)


def memory_read_train(norms, state: MemoryState, feat: torch.Tensor,
                      attn_thresh: float = 0.0, ln_eps: float = 1e-6,
                      dropout_rate: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      keep: Optional[torch.Tensor] = None,
                      res: bool = True) -> Tuple[torch.Tensor, MemoryState]:
    """The training read, JAX's XLA branch of `memory_read`
    (spann3r_tpu/models/memory.py:130-153), differentiable: fp32 logits
    q k^T / sqrt(D) over the valid slots, an fp32 softmax, memory dropout
    (each weight kept with probability 1 - dropout_rate, the kept ones
    scaled by 1 / (1 - dropout_rate)), the threshold renormalisation (inert
    at attn_thresh = 0, the value training uses), then the weights cast to
    the values' dtype and the readout accumulated in fp32, cast to feat's
    dtype. Dropout draws its keep mask from `generator` (on feat's device),
    or takes `keep` (B, P, C) bool as given; with neither it is off. The
    products are plain matrix products (JAX leaves them to XLA)."""
    d = feat.shape[-1]
    q = layer_norm(norms.norm_q, feat, ln_eps)
    k = layer_norm(norms.norm_k, state.k.to(feat.dtype), ln_eps)
    vv = layer_norm(norms.norm_v, state.v.to(feat.dtype), ln_eps)
    has_mem = state.size > 0
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(d)
    logits = torch.where(_valid_mask(state)[:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    attn = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and (keep is not None or generator is not None):
        if keep is None:
            keep = torch.rand(attn.shape, generator=generator,
                              device=attn.device) < 1.0 - dropout_rate
        attn = attn * keep / (1.0 - dropout_rate)
    if attn_thresh > 0:
        attn = torch.where(attn < attn_thresh, torch.zeros_like(attn), attn)
        attn = attn / (attn.sum(-1, keepdim=True) + 1e-12)
    out = torch.matmul(attn.to(vv.dtype).float(), vv.float()).to(feat.dtype)
    if res:
        out = out + feat
    out = torch.where(has_mem[:, None, None], out, feat)
    new_attn = state.attn + torch.where(has_mem[:, None], attn.sum(-2).detach(),
                                        torch.zeros_like(state.attn))
    return out, state._replace(attn=new_attn)


def _append(state: MemoryState, feat_k: torch.Tensor,
            feat_v: torch.Tensor) -> MemoryState:
    """Unconditional append of one frame's P tokens. Valid slots age by one
    frame; new slots start at age 0 and attention 0."""
    b, p = feat_k.shape[:2]
    c = state.k.shape[1]
    count = state.count + _valid_mask(state).float()
    # slot index each stream writes its j-th new token to (clamped like a
    # dynamic-update-slice start)
    start = torch.clamp(state.size.long(), 0, c - p)
    idx = start[:, None] + torch.arange(p, device=feat_k.device)[None]  # (B, P)
    rows = torch.arange(b, device=feat_k.device)[:, None].expand(b, p)
    k, v = state.k.clone(), state.v.clone()
    attn = state.attn.clone()
    k[rows, idx] = feat_k.to(k.dtype)
    v[rows, idx] = feat_v.to(v.dtype)
    count[rows, idx] = 0.0
    attn[rows, idx] = 0.0
    return state._replace(k=k, v=v, count=count, attn=attn,
                          size=state.size + p)


def add_mem(state: MemoryState, feat_k: torch.Tensor,
            feat_v: torch.Tensor) -> MemoryState:
    """Training-mode write: append only."""
    return _append(state, feat_k, feat_v)


def check_sim(state: MemoryState, feat_k: torch.Tensor, num_patches: int,
              work_mem_size: int, sim_thresh: float) -> torch.Tensor:
    """Mean-cosine dedup against the working-memory window -> (B,) bool."""
    b, p, d = feat_k.shape
    w_tokens = work_mem_size * num_patches
    start = state.size - state.wm * num_patches                   # (B,)
    idx = start[:, None].long() + torch.arange(w_tokens, device=feat_k.device)[None]
    idx = idx.clamp(0, state.k.shape[1] - 1)                      # (B, W)
    window = torch.gather(state.k, 1, idx[:, :, None].expand(-1, -1, d)).float()
    window = window.reshape(b, work_mem_size, num_patches, d)

    fk = feat_k.float()
    fk = fk / torch.linalg.vector_norm(fk, dim=-1, keepdim=True).clamp(min=1e-12)
    wn = window / torch.linalg.vector_norm(window, dim=-1,
                                           keepdim=True).clamp(min=1e-12)
    corr = torch.einsum("bpc,btpc->btp", fk, wn)
    mean_corr = corr.mean(dim=-1)                                 # (B, Wf)
    # window rows [0, wm) hold the valid working frames
    frame_valid = (torch.arange(work_mem_size, device=feat_k.device)[None]
                   < state.wm[:, None])
    mean_corr = torch.where(frame_valid, mean_corr,
                            torch.full_like(mean_corr, NEG_INF))
    return (state.size > 0) & (mean_corr.amax(dim=1) > sim_thresh)


def memory_prune(state: MemoryState, cfg: MemoryConfig) -> MemoryState:
    """Keep the long_mem_size slots with the largest attention/age weight,
    protecting young slots. Ties keep the lower slot first (a stable
    descending sort), which is the order `lax.top_k` gives."""
    weights = state.attn / state.count.clamp(min=1e-8)
    weights = torch.where(state.count < cfg.protect_age,
                          torch.full_like(weights, 1e8), weights)
    weights = torch.where(_valid_mask(state), weights,
                          torch.full_like(weights, NEG_INF))
    order = torch.sort(weights, dim=1, descending=True, stable=True).indices
    idx = order[:, :cfg.long_mem_size]                            # (B, K)
    c = state.k.shape[1]
    pad = c - cfg.long_mem_size

    def padded(arr):
        g = torch.gather(arr, 1, idx[..., None].expand(-1, -1, arr.shape[2])
                         if arr.dim() == 3 else idx)
        shape = list(g.shape)
        shape[1] = pad
        return torch.cat([g, g.new_zeros(shape)], dim=1)

    return state._replace(
        k=padded(state.k), v=padded(state.v),
        count=padded(state.count), attn=padded(state.attn),
        size=torch.full_like(state.size, cfg.long_mem_size))


def add_mem_check(state: MemoryState, feat_k: torch.Tensor,
                  feat_v: torch.Tensor, cfg: MemoryConfig) -> MemoryState:
    """Eval-mode write: dedup -> append -> spill -> prune, each decided per
    stream."""
    b, p = feat_k.shape[:2]
    if cfg.sim_thresh >= 1.0:  # dedup disabled
        dup = torch.zeros((b,), dtype=torch.bool, device=feat_k.device)
    else:
        dup = check_sim(state, feat_k, p, cfg.work_mem_size, cfg.sim_thresh)

    s = _append(state, feat_k, feat_v)
    s = s._replace(wm=s.wm + 1)
    spill = s.wm > cfg.work_mem_size

    if cfg.long_mem_size == 0:
        # pure sliding window: evict the oldest frame by rolling the bank
        # left by one frame's tokens
        def roll(a):
            return torch.roll(a, -p, dims=1)

        evicted = MemoryState(roll(s.k), roll(s.v), roll(s.count),
                              roll(s.attn), s.size - p, s.wm - 1, s.lm)
        s = _per_stream_select(spill, evicted, s)
    else:
        # working -> long-term spill (counters only; the bank is contiguous)
        s = s._replace(wm=torch.where(spill, s.wm - 1, s.wm),
                       lm=torch.where(spill, s.lm + p, s.lm))
        # prune streams whose long-term exceeds the budget; unreachable when
        # the bank can never grow past long_mem_size
        if cfg.long_mem_size < s.k.shape[1]:
            need = s.lm > cfg.long_mem_size
            if bool(need.any()):
                s3 = memory_prune(s, cfg)
                s3 = s3._replace(lm=torch.full_like(s3.lm, cfg.long_mem_size)
                                 - s3.wm * p)
                s = _per_stream_select(need, s3, s)

    return _per_stream_select(dup, state, s)
