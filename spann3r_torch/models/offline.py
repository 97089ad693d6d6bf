"""Offline reconstruction: pairwise confidence scan, then greedy
next-best-view over a spatial memory.

The JAX package (`models/offline.py`) has two versions of the greedy
loop: one that picks the next frame on the host and one fused into a
single `lax.scan`. Eager PyTorch runs both as the same loop, written once
in the fused version's order:

  1. write the last pair's key and value to the memory;
  2. read the memory with the last pair's target key (`feat_k2`);
  3. score the frames not used yet as the next target, in one batched
     decode through both heads (the mean of (conf - 1) / conf of each
     head, summed);
  4. take their argmax (the first of equal scores, as JAX's masked one);
  5. decode the pair (last target, best frame) against the fused features.

The mask of unused frames, the unused frames' indices (a stable sort of
the mask: their count is known on the host) and the argmax stay on the
device, and the features are indexed with the device indices
(`index_select`), so a round reads nothing back to the host of its own;
`idx_used` is read back once, at the end. (The memory write reads its one
prune flag per round, as in streaming.) Every frame is encoded once, in
one batch. Nothing is padded: the JAX package pads pair chunks to 8 and
scores all n frames a round for its fixed shapes, the port decodes
exactly the pairs and the candidates there are.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import BF16, DUSt3RConfig, Precision, Spann3RConfig
from . import dust3r as d3
from .inference import decode_pairs
from .memory import add_mem_check, init_memory, memory_read
from .pairs import make_pairs
from .spann3r import Spann3R, pair_step


def _conf_sig_mean(conf: torch.Tensor) -> torch.Tensor:
    """Mean of (conf - 1) / conf over the pixels of each map."""
    return ((conf - 1.0) / conf).mean(dim=(-2, -1))


def _pair_scores(m: d3.DUSt3R, f1: torch.Tensor, f2: torch.Tensor,
                 pos: torch.Tensor, img_hw: Tuple[int, int],
                 cfg: DUSt3RConfig, prec: Precision) -> torch.Tensor:
    """Summed sigmoid-confidence of B decoded pairs -> (B,)."""
    r1, r2 = decode_pairs(m, f1, f2, pos, img_hw, cfg, prec)
    return _conf_sig_mean(r1["conf"]) + _conf_sig_mean(r2["conf"])


def _score_candidates(m: d3.DUSt3R, fused: torch.Tensor, cand: torch.Tensor,
                      pos: torch.Tensor, img_hw: Tuple[int, int],
                      cfg: DUSt3RConfig, prec: Precision) -> torch.Tensor:
    """The candidate frames cand (C, P, D) as targets of the fused
    reference, in one batch of C -> (C,) scores. Only the scores outlive
    the call."""
    c = cand.shape[0]
    return _pair_scores(m, fused.expand(c, -1, -1), cand, pos, img_hw, cfg,
                        prec)


@torch.no_grad()
def pairwise_confidences(m: d3.DUSt3R, feats: torch.Tensor, pos: torch.Tensor,
                         pairs: Sequence[Tuple[int, int]], img_hw,
                         cfg: Spann3RConfig, prec: Precision = BF16,
                         chunk: int = 8) -> np.ndarray:
    """Decode the pairs `chunk` at a time -> summed sigmoid-confidence per
    pair (N_pairs,). feats: (n, P, D) encoded frames; pairs index them."""
    ij = torch.tensor(list(pairs), dtype=torch.long).to(feats.device)
    out = [_pair_scores(m, feats.index_select(0, ij[s:s + chunk, 0]),
                        feats.index_select(0, ij[s:s + chunk, 1]), pos[:1],
                        tuple(img_hw), cfg.dust3r, prec)
           for s in range(0, len(pairs), chunk)]
    return torch.cat(out).float().cpu().numpy()


def find_initial_pair(pairs, confs, n_frames: int) -> Tuple[int, int]:
    """The argmax of the pairwise confidence matrix."""
    mat = np.zeros((n_frames, n_frames), dtype=np.float32)
    for (a, b), c in zip(pairs, confs):
        mat[a, b] = c
    return tuple(int(v) for v in np.unravel_index(mat.argmax(), mat.shape))


@torch.no_grad()
def offline_reconstruction(model: Spann3R, frames, cfg: Spann3RConfig,
                           img_hw, scene_graph: str = "complete",
                           prec: Precision = BF16
                           ) -> Tuple[List[Dict], List[Tuple], List[int]]:
    """frames: (n, H, W, 3) normalised floats (numpy or tensor) ->
    (preds, preds_all, idx_used), as numpy fp32 arrays on the host.

    preds[0] has 'pts3d', the rest 'pts3d_in_other_view', each with
    'conf', in the order of idx_used (the initial pair, then the greedy
    picks); the last entry is the last pair's target-frame prediction.
    preds_all holds (res1, res2) of each of the n - 1 decoded pairs.
    uint8 frames raise: the JAX package would encode their raw bytes."""
    x = frames if isinstance(frames, torch.Tensor) else \
        torch.from_numpy(np.asarray(frames))
    if not x.is_floating_point():
        raise ValueError("offline reconstruction takes normalised float "
                         f"frames, got {x.dtype}")
    dcfg = cfg.dust3r
    img_hw = tuple(img_hw)
    n = x.shape[0]
    dev = next(model.parameters()).device
    p_tokens = (img_hw[0] // dcfg.patch_size) * (img_hw[1] // dcfg.patch_size)

    feats, pos_all = d3.encode_image(model.dust3r, x.to(dev), dcfg, prec)
    pos = pos_all[:1]
    pairs = make_pairs(n, scene_graph, symmetrize=True)
    confs = pairwise_confidences(model.dust3r, feats, pos, pairs, img_hw,
                                 cfg, prec)
    i0, i1 = find_initial_pair(pairs, confs, n)

    take = lambda idx: feats.index_select(0, idx)
    idx = torch.tensor([i0, i1]).to(dev)
    prev = idx[1:]
    cur = pair_step(model, cfg, take(idx[:1]), take(idx[:1]), take(prev),
                    pos, img_hw, prec)
    res1, res2, order = [cur.res1], [cur.res2], []
    mem = init_memory(1, cfg.memory.capacity(p_tokens), cfg.attn_head_out,
                      dtype=prec.compute_dtype, device=dev)
    todo = torch.ones(n, dtype=torch.bool)
    todo[[i0, i1]] = False
    todo = todo.to(dev)
    for r in range(n - 2):
        mem = add_mem_check(mem, cur.feat_k1, cur.cur_v + cur.feat_k1,
                            cfg.memory)
        fused, mem = memory_read(model, mem, cur.feat_k2,
                                 attn_thresh=cfg.memory.attn_thresh)
        # the n - 2 - r unused frames, in index order
        cand = torch.argsort(todo.int(), descending=True,
                             stable=True)[:n - 2 - r]
        scores = _score_candidates(model.dust3r, fused, take(cand), pos,
                                   img_hw, dcfg, prec)
        best = cand[scores.argmax()].reshape(1)
        todo = todo.index_fill(0, best, False)
        cur = pair_step(model, cfg, fused, take(prev), take(best), pos,
                        img_hw, prec)
        res1.append(cur.res1)
        res2.append(cur.res2)
        order.append(best)
        prev = best
    idx_used = [i0, i1] + (torch.cat(order).tolist() if order else [])

    host = lambda r, k: r[k].float().cpu().numpy()
    preds, preds_all = [], []
    for t, (r1, r2) in enumerate(zip(res1, res2)):
        a = {"conf": host(r1, "conf"),
             "pts3d" if t == 0 else "pts3d_in_other_view": host(r1, "pts3d")}
        b = {"pts3d_in_other_view": host(r2, "pts3d"),
             "conf": host(r2, "conf")}
        preds.append(a)
        preds_all.append((a, b))
    preds.append(preds_all[-1][1])
    return preds, preds_all, idx_used


# the JAX package's two names for the greedy reconstruction: its loop and
# its fused scan are one loop here
offline_reconstruction_fused = offline_reconstruction
