"""Pairwise inference over a list of view pairs (the reference's
dust3r/inference.py contract, as the JAX package's `models/inference.py`
gives it).

Each unique frame is encoded once, in one batch; the pairs are then
decoded `batch_size` at a time through the dual decoder and both heads.
The port runs eagerly, so the last batch is simply shorter: nothing is
padded.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..config import BF16, DUSt3RConfig, Precision
from ..utils.trace import span
from . import dust3r as d3


def decode_pairs(m: d3.DUSt3R, f1: torch.Tensor, f2: torch.Tensor,
                 pos: torch.Tensor, img_hw: Tuple[int, int],
                 cfg: DUSt3RConfig, prec: Precision = BF16
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Decode B pairs of encoded frames f1, f2 (B, P, D) that share the
    positions pos (1, P, 2), through both heads. The positions are expanded
    over the batch with stride 0, so both attentions of a decoder block see
    one set of positions."""
    pp = pos.expand(f1.shape[0], -1, -1)
    dec1, dec2 = d3.decoder(m, f1, pp, f2, pp, cfg, prec)
    return (d3.downstream_head(m, 1, dec1, img_hw, cfg, prec),
            d3.downstream_head(m, 2, dec2, img_hw, cfg, prec))


@torch.no_grad()
def inference(pairs: Sequence[Tuple[dict, dict]], model: d3.DUSt3R,
              cfg: DUSt3RConfig, batch_size: int = 8, prec: Precision = BF16,
              verbose: bool = True) -> Dict:
    """pairs: [(view1, view2), ...] with view = {'img': (1, H, W, 3)
    normalised, 'idx': i}; `model` is the two-view backbone (`Spann3R.dust3r`)
    on the device it runs on.

    Returns {'view1': {'idx': [...]}, 'view2': ..., 'pred1': {'pts3d',
    'conf'}, 'pred2': {'pts3d_in_other_view', 'conf'}} with stacked fp32
    numpy arrays, one row per pair."""
    if verbose:
        print(f">> Inference with model on {len(pairs)} image pairs")
    dev = next(model.parameters()).device
    frames = {}
    for v1, v2 in pairs:
        for v in (v1, v2):
            frames.setdefault(int(v["idx"]), np.asarray(v["img"]))
    idxs = sorted(frames)
    # the frames, like each batch's index lists below, reach the card as a
    # copy from pageable memory, which waits for the device
    with span("spann3r.sync"):
        imgs = torch.from_numpy(np.concatenate([frames[i] for i in idxs])).to(dev)
    feats, pos = d3.encode_image(model, imgs, cfg, prec)
    row = {i: k for k, i in enumerate(idxs)}
    hw = tuple(imgs.shape[1:3])

    i1_all = [int(a["idx"]) for a, _ in pairs]
    i2_all = [int(b["idx"]) for _, b in pairs]
    outs = []
    for s in range(0, len(pairs), batch_size):
        with span("spann3r.sync"):
            sel1 = torch.tensor([row[i] for i in i1_all[s:s + batch_size]],
                                device=dev)
        with span("spann3r.sync"):
            sel2 = torch.tensor([row[i] for i in i2_all[s:s + batch_size]],
                                device=dev)
        outs.append(decode_pairs(model, feats.index_select(0, sel1),
                                 feats.index_select(0, sel2), pos[:1], hw,
                                 cfg, prec))

    def stack(j, key):
        with span("spann3r.to_host"):
            return torch.cat([o[j][key] for o in outs]).float().cpu().numpy()

    return {
        "view1": {"idx": i1_all},
        "view2": {"idx": i2_all},
        "pred1": {"pts3d": stack(0, "pts3d"), "conf": stack(0, "conf")},
        "pred2": {"pts3d_in_other_view": stack(1, "pts3d"),
                  "conf": stack(1, "conf")},
    }
