"""Spann3R: DUSt3R wrapped in a spatial memory, and the streaming engine.

Module keys are the reference's (`dust3r.*`, `value_encoder.{i}`,
`value_norm`, `value_out`, `norm_q`, `norm_k`, `norm_v`, `attn_head_1.0`,
`attn_head_1.2`, `pos_patch_embed.proj`).

Streaming inference follows the JAX package's chunked scan: each chunk's
frames go through the encoder in one batch, then a Python loop runs the
sequential part frame by frame (memory read, dual decoder, attn-head MLPs,
reference-frame head, value encoder, memory write). The target-frame head
runs once per video on the carried decoder hook states. The engine also
takes a stream a frame at a time (`InferenceEngine.step` / `run`), over
the same pair step, memory read and memory write.

Training (`forward_train`) runs the JAX package's training memory
semantics over a clip: one batched encoder pass, then per pair the
training read (memory dropout), the pair step with both heads, and an
unconditional append, all under autograd, with the JAX package's
activation rematerialisation as an option.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import BF16, Precision, Spann3RConfig, ViTConfig
from ..ops.layers import gelu, init_conv_, init_modules_, layer_norm, linear
from ..utils.graphs import LayerGraphs, graphed
from ..utils.trace import span
from . import dust3r as d3
from .memory import (MemoryState, add_mem, add_mem_check, init_memory,
                     memory_read, memory_read_train)
from .vit import (Block, PatchEmbed, encoder_apply, patch_embed_apply,
                  rematerialised)


def value_encoder_cfg(cfg: Spann3RConfig) -> ViTConfig:
    # rope disabled unless mem_pos_enc
    return ViTConfig(dim=cfg.value_enc_dim, depth=cfg.value_enc_depth,
                     num_heads=cfg.value_enc_heads,
                     rope_base=100.0 if cfg.mem_pos_enc else 0.0)


class Spann3R(nn.Module):
    def __init__(self, cfg: Spann3RConfig):
        super().__init__()
        vcfg = value_encoder_cfg(cfg)
        self.dust3r = d3.DUSt3R(cfg.dust3r)
        self.value_encoder = nn.ModuleList(Block(vcfg) for _ in range(vcfg.depth))
        self.value_norm = nn.LayerNorm(cfg.value_enc_dim, eps=vcfg.ln_eps)
        self.value_out = nn.Linear(cfg.value_enc_dim, cfg.attn_head_out)
        self.norm_q = nn.LayerNorm(cfg.attn_head_out, eps=1e-6)
        self.norm_k = nn.LayerNorm(cfg.attn_head_out, eps=1e-6)
        self.norm_v = nn.LayerNorm(cfg.attn_head_out, eps=1e-6)
        self.attn_head_1 = _attn_head(cfg)
        self.attn_head_2 = _attn_head(cfg)
        if not cfg.use_feat:
            self.pos_patch_embed = PatchEmbed(cfg.dust3r.patch_size, 3,
                                              cfg.dust3r.enc.dim)

    @torch.no_grad()
    def init_weights_(self, generator: Optional[torch.Generator]) -> None:
        """Random init by the JAX package's rules, from `generator`."""
        for name, child in self.named_children():
            if name == "dust3r":
                child.init_weights_(generator)
            elif name == "pos_patch_embed":
                init_conv_(child.proj, generator, xavier_flat=True)
            else:
                init_modules_(child, generator)


def _attn_head(cfg: Spann3RConfig) -> nn.Sequential:
    # (in -> in -> out) with GELU; keys `.0` and `.2`
    return nn.Sequential(nn.Linear(cfg.attn_head_in, cfg.attn_head_in),
                         nn.GELU(),
                         nn.Linear(cfg.attn_head_in, cfg.attn_head_out))


def build_spann3r(cfg: Spann3RConfig, device="cuda",
                  generator: Optional[torch.Generator] = None) -> Spann3R:
    """A randomly initialised model on `device`, the card unless the caller
    asks for the CPU (`device="cpu"`); raises when a CUDA device is asked
    for and none is present. The init draws from `generator` on the CPU,
    so one seed gives the same weights on every device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_spann3r: no CUDA device is available; pass "
                           "device='cpu' to build the model on the CPU")
    with torch.device("meta"):
        model = Spann3R(cfg)
    model = model.to_empty(device="cpu")
    model.init_weights_(generator)
    return model.to(device).eval()


def attn_head_apply(m: nn.Sequential, feat_enc: torch.Tensor,
                    feat_dec: torch.Tensor) -> torch.Tensor:
    """Memory query/key features from encoder ++ last decoder features."""
    x = torch.cat([feat_enc, feat_dec.to(feat_enc.dtype)], dim=-1)
    return linear(m[2], gelu(linear(m[0], x)))


def encode_value(model: Spann3R, cfg: Spann3RConfig, res1_pts: torch.Tensor,
                 dec_last: torch.Tensor, pos: torch.Tensor,
                 prec: Precision = BF16, remat: bool = False) -> torch.Tensor:
    """Value tokens from the predicted reference pointmap. remat: recompute
    each value-encoder block in the backward (training)."""
    vcfg = value_encoder_cfg(cfg)
    if cfg.use_feat:
        x, pos_v = dec_last.to(prec.compute_dtype), pos
    else:
        x, pos_v = patch_embed_apply(model.pos_patch_embed,
                                     res1_pts.to(prec.compute_dtype))
    x = encoder_apply(model.value_encoder, x, pos_v, vcfg, remat)
    x = layer_norm(model.value_norm, x, vcfg.ln_eps)
    return linear(model.value_out, x)


class PairOutputs(NamedTuple):
    res1: Dict[str, torch.Tensor]
    res2: Optional[Dict[str, torch.Tensor]]
    feat_k1: torch.Tensor
    feat_k2: torch.Tensor
    cur_v: torch.Tensor
    # dec2 hook states (feat2, *block outputs at head_hooks) when the res2
    # head is deferred (compute_res2=False); None otherwise
    dec2_hooks: Optional[Tuple[torch.Tensor, ...]] = None


def _key_heads(model: Spann3R, feat1: torch.Tensor, dec1_last: torch.Tensor,
               feat2: torch.Tensor, dec2_last: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (attn_head_apply(model.attn_head_1, feat1, dec1_last),
            attn_head_apply(model.attn_head_2, feat2, dec2_last))


def pair_step(model: Spann3R, cfg: Spann3RConfig, feat_fuse: torch.Tensor,
              feat1: torch.Tensor, feat2: torch.Tensor, pos: torch.Tensor,
              img_hw: Tuple[int, int], prec: Precision = BF16,
              compute_res2: bool = True, remat: bool = False,
              graphs: Optional[LayerGraphs] = None) -> PairOutputs:
    """Decode one (reference, target) pair and build the memory features.
    feat_fuse: memory-fused reference features (feat1 on the first pair).
    remat: recompute each decoder and value-encoder block in the backward
    (training). graphs: replay the decoders, the key heads, the reference
    head and the value encoder as CUDA graphs from these (`utils.graphs`);
    the target head, when computed here, stays eager."""
    dcfg = cfg.dust3r
    dm = model.dust3r
    dec1, dec2 = d3.decoder(dm, feat_fuse, pos, feat2, pos, dcfg, prec,
                            remat, graphs=graphs)
    with span("spann3r.memory.value"):
        feat_k1, feat_k2 = graphed(graphs, "keys", _key_heads, model, feat1,
                                   dec1[-1], feat2, dec2[-1])
    res1 = d3.downstream_head(dm, 1, dec1, img_hw, dcfg, prec, graphs=graphs)
    if compute_res2:
        res2, hooks2 = d3.downstream_head(dm, 2, dec2, img_hw, dcfg, prec), None
    else:
        res2 = None
        hooks2 = tuple([dec2[0]] + [dec2[h] for h in d3.head_hooks(dcfg)])
    with span("spann3r.memory.value"):
        cur_v = graphed(graphs, "value", encode_value, model, cfg,
                        res1["pts3d"], dec1[-1], pos, prec, remat)
    return PairOutputs(res1, res2, feat_k1, feat_k2, cur_v, hooks2)


def head2_from_hooks(model: Spann3R, cfg: Spann3RConfig,
                     hook_states: Tuple[torch.Tensor, ...],
                     img_hw: Tuple[int, int],
                     prec: Precision = BF16) -> Dict[str, torch.Tensor]:
    """The deferred target-frame head on carried decoder hook states."""
    states = d3.states_from_hooks(cfg.dust3r, hook_states)
    return d3.downstream_head(model.dust3r, 2, states, img_hw, cfg.dust3r, prec)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def forward_train(model: Spann3R, frames: torch.Tensor, cfg: Spann3RConfig,
                  prec: Precision = BF16,
                  generator: Optional[torch.Generator] = None,
                  remat: bool = False, remat_scan: Optional[bool] = None,
                  data_shard: Tuple[int, int] = (0, 1)
                  ) -> Dict[str, torch.Tensor]:
    """frames (B, T, H, W, 3) normalised -> the per-pair predictions stacked
    over time (JAX `forward_train`, spann3r_tpu/models/spann3r.py:174-256).

    Training memory semantics: an unconditional append, attn_thresh = 0,
    memory dropout at cfg.memory.mem_dropout when `generator` is given
    (drawn from it), and the raw reference features fused on the first
    pair (JAX reads the empty bank there and discards the result, so the
    read is skipped). Differentiable.

    Activation rematerialisation, as the JAX package's `jax.checkpoint`
    (`torch.utils.checkpoint`, non-reentrant): `remat` recomputes each
    encoder block, each pair of decoder blocks and each value-encoder block
    in the backward from its input; SPANN3R_NO_REMAT_ENC=1 keeps the
    encoder's activations (it runs once, outside the pair loop). `remat_scan`
    (default: SPANN3R_REMAT_SCAN set) also recomputes the whole per-pair
    body (memory read, pair step, append), so that only the bank and the
    pair's inputs stay resident between pairs. Each pair's dropout mask is
    drawn before its body, in the order the reads draw it without remat, so
    the recompute reads the mask the forward used and every setting gives
    the same gradients. Over several processes `data_shard` = (data rank,
    data world): `frames` are that rank's part of a batch of B * world
    clips, and each mask is drawn for the whole batch from the generator
    (seeded alike on every rank) and cut to the rank's rows, so that the
    ranks draw what one process draws on the whole batch, and the model
    ranks of one data rank draw the same. JAX's SPANN3R_UNROLL_TSCAN
    unrolls its `lax.scan` for XLA's fusions; the loop here is a Python
    loop and has no such switch.

    Returns {'pts3d_1', 'conf_1'} (reference frame t) and {'pts3d_2',
    'conf_2'} (target frame t + 1), each (T - 1, B, H, W[, 3]) fp32, all in
    frame 0's coordinates."""
    if remat_scan is None:
        remat_scan = bool(os.environ.get("SPANN3R_REMAT_SCAN"))
    # without autograd there is no backward to recompute for
    remat = remat and torch.is_grad_enabled()
    remat_scan = remat_scan and torch.is_grad_enabled()
    b, t, h, w, _ = frames.shape
    dcfg = cfg.dust3r
    p_tokens = (h // dcfg.patch_size) * (w // dcfg.patch_size)
    remat_enc = remat and not os.environ.get("SPANN3R_NO_REMAT_ENC")
    feats, pos = d3.encode_image(model.dust3r, frames.reshape(b * t, h, w, 3),
                                 dcfg, prec, remat_enc)
    feats = feats.reshape(b, t, p_tokens, -1).transpose(0, 1)   # (T,B,P,D)
    pos = pos[:b]
    mem = init_memory(b, (t - 1) * p_tokens, cfg.attn_head_out,
                      dtype=prec.compute_dtype, device=frames.device)
    rate = cfg.memory.mem_dropout if generator is not None else 0.0

    def body(feat1, feat2, feat_k2, keep, *bank):
        mem = MemoryState(*bank)
        if feat_k2 is None:
            feat_fuse = feat1
        else:
            feat_fuse, mem = memory_read_train(model, mem, feat_k2,
                                               attn_thresh=0.0,
                                               dropout_rate=rate, keep=keep)
        out = pair_step(model, cfg, feat_fuse, feat1, feat2, pos, (h, w),
                        prec, remat=remat)
        mem = add_mem(mem, out.feat_k1, out.cur_v + out.feat_k1)
        return (out.feat_k2, out.res1["pts3d"], out.res1["conf"],
                out.res2["pts3d"], out.res2["conf"], *mem)

    ys: Dict[str, List[torch.Tensor]] = {
        "pts3d_1": [], "conf_1": [], "pts3d_2": [], "conf_2": []}
    feat_k2 = None
    for i in range(t - 1):
        keep = None
        if i > 0 and rate > 0.0:
            # the read's (B, P, C) weights, each kept with 1 - rate
            rank, world = data_shard
            draw = torch.rand((b * world, p_tokens, mem.k.shape[1]),
                              generator=generator, device=frames.device)
            keep = draw[rank * b:(rank + 1) * b] < 1.0 - rate
        args = (feats[i], feats[i + 1], feat_k2, keep, *mem)
        outs = rematerialised(body, *args) if remat_scan else body(*args)
        feat_k2, mem = outs[0], MemoryState(*outs[5:])
        for key, y in zip(("pts3d_1", "conf_1", "pts3d_2", "conf_2"),
                          outs[1:5]):
            ys[key].append(y)
    return {key: torch.stack(v) for key, v in ys.items()}


# ---------------------------------------------------------------------------
# chunked video loop (eval memory semantics)
# ---------------------------------------------------------------------------

class VideoCarry(NamedTuple):
    mem: MemoryState
    feat_prev: torch.Tensor
    feat_k2: torch.Tensor
    dec2_prev: Tuple[torch.Tensor, ...]
    have_prev: bool
    have_key: bool


def init_video_carry(cfg: Spann3RConfig, img_hw: Tuple[int, int],
                     batch: int = 1, prec: Precision = BF16,
                     device=None) -> VideoCarry:
    dcfg = cfg.dust3r
    p_tokens = (img_hw[0] // dcfg.patch_size) * (img_hw[1] // dcfg.patch_size)
    dt = prec.compute_dtype
    mem = init_memory(batch, cfg.memory.capacity(p_tokens), cfg.attn_head_out,
                      dtype=dt, device=device)
    zeros = lambda d: torch.zeros((batch, p_tokens, d), dtype=dt, device=device)
    dec2_0 = tuple([zeros(dcfg.enc.dim)]
                   + [zeros(dcfg.dec.dim) for _ in d3.head_hooks(dcfg)])
    return VideoCarry(mem, zeros(dcfg.enc.dim), zeros(cfg.attn_head_out),
                      dec2_0, False, False)


def _prep(img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if img.dtype == torch.uint8:
        return img.to(dtype) * (2.0 / 255.0) - 1.0
    return img.to(dtype)


def _encode_frame(m: d3.DUSt3R, img: torch.Tensor, cfg, prec: Precision
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return d3.encode_tokens(m, _prep(img, prec.compute_dtype), cfg, prec)


@torch.no_grad()
def scan_video_chunk(model: Spann3R, cfg: Spann3RConfig, carry: VideoCarry,
                     imgs: torch.Tensor, img_hw: Tuple[int, int],
                     prec: Precision = BF16, stats: Optional[dict] = None
                     ) -> Tuple[VideoCarry, List[Optional[Dict]]]:
    """Process one chunk of frames.

    imgs: (chunk, B, H, W, 3) uint8 or normalised float on the model's
    device. Returns the new carry and, per frame, the reference-frame
    prediction {'pts3d', 'conf'} of pair (t-1, t) when the frame was
    written, else None. Outputs are rounded to bf16 under a bf16 compute
    dtype, as the JAX scan emits them. `stats`, when given, counts the
    memory reads.

    The JAX scan has static shapes: it pads the last chunk and computes
    every step, then selects. Here a chunk may be short, and the steps whose
    results the scan discards are skipped: the pair step of the first frame
    and the memory read until a key exists.
    """
    dcfg = cfg.dust3r
    odt = torch.bfloat16 if prec.compute_dtype == torch.bfloat16 else torch.float32
    chunk, b, h, w, _ = imgs.shape
    flat = _prep(imgs.reshape(chunk * b, h, w, 3), prec.compute_dtype)
    feats_all, pos = d3.encode_image(model.dust3r, flat, dcfg, prec)
    feats_all = feats_all.reshape(chunk, b, *feats_all.shape[-2:])
    pos = pos[:b]

    mem, feat_prev, feat_k2, dec2_prev, have_prev, have_key = carry
    ys: List[Optional[Dict]] = []
    for t in range(chunk):
        feat2 = feats_all[t]
        if not have_prev:
            feat_prev, have_prev = feat2, True
            ys.append(None)
            continue
        if have_key:
            feat_fuse, mem = memory_read(model, mem, feat_k2,
                                         attn_thresh=cfg.memory.attn_thresh)
            if stats is not None:
                stats["memory_reads"] = stats.get("memory_reads", 0) + 1
        else:
            feat_fuse = feat_prev
        out = pair_step(model, cfg, feat_fuse, feat_prev, feat2, pos, img_hw,
                        prec, compute_res2=False)
        mem = add_mem_check(mem, out.feat_k1, out.cur_v + out.feat_k1,
                            cfg.memory)
        dec2_prev = out.dec2_hooks
        feat_prev, feat_k2, have_key = feat2, out.feat_k2, True
        ys.append({"pts3d": out.res1["pts3d"].to(odt),
                   "conf": out.res1["conf"].to(odt)})
    return VideoCarry(mem, feat_prev, feat_k2, dec2_prev, have_prev,
                      have_key), ys


# ---------------------------------------------------------------------------
# streaming inference engine
# ---------------------------------------------------------------------------

class InferenceEngine:
    """Reconstruction of a frame stream with eval memory semantics (cosine
    dedup, working -> long-term spill, usage-based pruning): chunked over a
    whole video (`run_video`), or a frame at a time (`step`, `run`).

    On the card, `step` replays the layers whose shapes the engine's batch
    and frame size fix as CUDA graphs (`utils.graphs`): the encoder of the
    new frame with its normalisation, the decoders, the memory's key heads,
    the reference-frame head and the value encoder, each captured on the
    first step that runs it. The memory's read and write, whose bank
    changes size, and the target-frame head stay eager. `cuda_graphs=False`
    keeps every layer eager. The graphs read the model's parameters where
    they were at capture; `reset` drops them if any parameter has been
    replaced by another tensor since.

    `stats`: `memory_reads` and `graph_replays` (the steps whose graphed
    layers all replayed) of the current stream, and `graph_captures`, the
    graphs the engine has captured, which a reset keeps."""

    def __init__(self, model: Spann3R, cfg: Spann3RConfig,
                 img_hw: Tuple[int, int], prec: Precision = BF16,
                 batch: int = 1, cuda_graphs: bool = True):
        self.model = model
        self.cfg = cfg
        self.prec = prec
        self.img_hw = tuple(img_hw)
        self.batch = batch
        self.device = next(model.parameters()).device
        dcfg = cfg.dust3r
        self.p_tokens = ((self.img_hw[0] // dcfg.patch_size)
                         * (self.img_hw[1] // dcfg.patch_size))
        self.carry: Optional[VideoCarry] = None
        self._cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._graphs: Optional[LayerGraphs] = None
        self._graph_params: Tuple[int, ...] = ()
        self.reset()

    def _param_addresses(self) -> Tuple[int, ...]:
        return tuple(t.data_ptr() for t in itertools.chain(
            self.model.parameters(), self.model.buffers()))

    # -- frame at a time -----------------------------------------------------

    def reset(self) -> None:
        """Start a new stream: no bank (the first pair allocates an empty
        one), no previous frame."""
        if self._cuda_graphs:
            params = self._param_addresses()
            if self._graphs is None or params != self._graph_params:
                self._graphs = LayerGraphs(self.device)
                self._graph_params = params
        self.stats: Dict[str, int] = {
            "memory_reads": 0, "graph_replays": 0,
            "graph_captures": self._graphs.captures if self._graphs else 0}
        self.mem: Optional[MemoryState] = None
        self._feat_prev: Optional[torch.Tensor] = None
        self._feat_k2: Optional[torch.Tensor] = None
        self._last_hooks: Optional[Tuple[torch.Tensor, ...]] = None

    @torch.no_grad()
    def encode(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """img: (B, H, W, 3) uint8 or normalised float on the model's
        device -> tokens (B, P, D), positions (B, P, 2)."""
        with span("spann3r.encode"):
            return graphed(self._graphs, "encode", _encode_frame,
                           self.model.dust3r, img, self.cfg.dust3r, self.prec)

    def put_frame(self, frame) -> torch.Tensor:
        """Start the copy of one (B, H, W, 3) frame to the model's device:
        from pinned host memory without waiting, on the card."""
        t = torch.as_tensor(np.asarray(frame)) if not isinstance(
            frame, torch.Tensor) else frame
        if self.device.type != "cuda" or t.device.type == "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    @torch.no_grad()
    def step(self, img: torch.Tensor, want_res2: bool = False
             ) -> Optional[Dict[str, Optional[Dict[str, torch.Tensor]]]]:
        """Feed the next frame (on the model's device); returns {'res1':
        the prediction of the (previous, current) pair's reference frame,
        'res2': None} as device tensors, or None on the first frame.

        The target-frame head is deferred: the step keeps the decoder's
        hook states, and `target_prediction()` (or want_res2=True) runs the
        head on them when a target prediction is wanted."""
        graphs = self._graphs
        if graphs is not None:
            captures, replays = graphs.captures, graphs.replays
        with span("spann3r.step"):
            out = self._step(img, want_res2)
        if graphs is not None:
            self.stats["graph_captures"] = graphs.captures
            if graphs.captures == captures and graphs.replays > replays:
                self.stats["graph_replays"] += 1
        return out

    def _step(self, img: torch.Tensor, want_res2: bool):
        feat2, pos = self.encode(img)
        if self._feat_prev is None:
            self._feat_prev = feat2
            return None
        if self._feat_k2 is None:
            feat_fuse = self._feat_prev
        else:
            feat_fuse, self.mem = memory_read(
                self.model, self.mem, self._feat_k2,
                attn_thresh=self.cfg.memory.attn_thresh)
            self.stats["memory_reads"] += 1
        out = pair_step(self.model, self.cfg, feat_fuse, self._feat_prev,
                        feat2, pos, self.img_hw, self.prec,
                        compute_res2=False, graphs=self._graphs)
        if self.mem is None:
            self.mem = init_memory(self.batch,
                                   self.cfg.memory.capacity(self.p_tokens),
                                   self.cfg.attn_head_out,
                                   dtype=self.prec.compute_dtype,
                                   device=self.device)
        self.mem = add_mem_check(self.mem, out.feat_k1,
                                 out.cur_v + out.feat_k1, self.cfg.memory)
        self._feat_prev, self._feat_k2 = feat2, out.feat_k2
        self._last_hooks = out.dec2_hooks
        return {"res1": out.res1,
                "res2": self.target_prediction() if want_res2 else None}

    @torch.no_grad()
    def target_prediction(self) -> Optional[Dict[str, torch.Tensor]]:
        """The current frame's prediction from the carried decoder hook
        states (the deferred head, run on demand); None before the second
        frame."""
        if self._last_hooks is None:
            return None
        return head2_from_hooks(self.model, self.cfg, self._last_hooks,
                                self.img_hw, self.prec)

    def run(self, frames) -> List[Dict[str, torch.Tensor]]:
        """frames: (T, B, H, W, 3) uint8 or normalised float (numpy or
        tensor), fed a frame at a time; the next frame's copy to the device
        starts before the current step. Returns the `preds` list of
        `run_video` as fp32 tensors on the device; the target head runs
        once, at the end of the stream."""
        self.reset()
        preds: List[Dict[str, torch.Tensor]] = []
        pending = self.put_frame(frames[0])
        for i in range(len(frames)):
            cur = pending
            if i + 1 < len(frames):
                pending = self.put_frame(frames[i + 1])
            out = self.step(cur)
            if out is None:
                continue
            key = "pts3d" if not preds else "pts3d_in_other_view"
            preds.append({key: out["res1"]["pts3d"],
                          "conf": out["res1"]["conf"]})
        last = self.target_prediction()
        if last is not None:
            preds.append({"pts3d_in_other_view": last["pts3d"],
                          "conf": last["conf"]})
        return preds

    # -- whole video ---------------------------------------------------------

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """Start the copy of one output to the host without waiting: pinned
        buffers on the card, so later frames keep computing meanwhile."""
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    @torch.no_grad()
    def run_video(self, frames, chunk: int = 16) -> List[Dict[str, np.ndarray]]:
        """frames: (T, B, H, W, 3) uint8 or normalised float (numpy or
        tensor). Returns the `preds` list: preds[0] has 'pts3d', the rest
        'pts3d_in_other_view', each with 'conf', all in frame-0
        coordinates, as fp32 numpy arrays; the last entry is the target
        frame's prediction from the deferred head."""
        t_total = len(frames)
        self.stats["memory_reads"] = 0
        carry = init_video_carry(self.cfg, self.img_hw, self.batch, self.prec,
                                 self.device)
        emitted = []
        for s in range(0, t_total, chunk):
            part = torch.as_tensor(np.asarray(frames[s:s + chunk]))
            carry, ys = scan_video_chunk(self.model, self.cfg, carry,
                                         part.to(self.device), self.img_hw,
                                         self.prec, self.stats)
            emitted += [{k: self._to_host(v) for k, v in y.items()}
                        for y in ys if y is not None]
        self.carry = carry
        if not emitted:  # no pair was ever formed (e.g. a 1-frame video)
            return []
        res2 = head2_from_hooks(self.model, self.cfg, carry.dec2_prev,
                                self.img_hw, self.prec)
        emitted.append({k: self._to_host(v) for k, v in res2.items()})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        preds = []
        for i, y in enumerate(emitted):
            key = "pts3d" if i == 0 else "pts3d_in_other_view"
            preds.append({key: y["pts3d"].float().numpy(),
                          "conf": y["conf"].float().numpy()})
        return preds
