"""Pixelwise DPT task head for stereo and flow finetuning (the JAX
package's stereoflow/head.py).

Reference: croco/models/head_downstream.py:19-58 (PixelwiseTaskWithDPT)
driving croco/models/dpt_block.py:264-450 (DPTOutputAdapter, regression
head). The reassembly and refinement cascade is the DPT machinery of the
pointmap head (`models/heads.py`, whose residual and fusion blocks it
reuses), here for any channel count, over the concatenated
[encoder states..., decoder states...] hook list of the downstream
forwards, returning the RAW (B, H, W, C) map: no pointmap postprocess (the
reference head has postprocess=None, stereoflow/train.py:118-121). It runs
in fp32 whatever the transformer's compute type. Parameter names are the
reference's (`head.dpt.act_postprocess.*`, `head.dpt.scratch.layer{1-4}_rn`,
`head.dpt.scratch.refinenet{1-4}.resConfUnit{1,2}.conv{1,2}`,
`head.dpt.head.{0,2,4}` inside the downstream model), so a reference
checkpoint loads as it is.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import DUSt3RConfig
from ..models.croco_downstream import dpt_hook_indices
from ..models.heads import FusionBlock, _fusion_block
from ..ops.layers import (conv2d, conv2d_transpose, init_modules_,
                          interpolate_bilinear)


class _Scratch(nn.Module):
    def __init__(self, layer_dims: Sequence[int], fd: int):
        super().__init__()
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn", nn.Conv2d(
                layer_dims[i], fd, 3, padding=1, bias=False))
        for i in range(4):
            self.add_module(f"refinenet{i + 1}", FusionBlock(fd))


class _DPTAdapter(nn.Module):
    """act_postprocess reassembly (dpt_block.py:356-410), the scratch
    projections and refinenets, and the regression head (dpt_block.py:
    316-324; indices 1 and 3, the resize and the ReLU, hold no
    parameters)."""

    def __init__(self, hook_dims: Sequence[int], layer_dims: Sequence[int],
                 fd: int, last_dim: int, num_channels: int):
        super().__init__()
        ld, hd = layer_dims, hook_dims
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(hd[0], ld[0], 1),
                          nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(hd[1], ld[1], 1),
                          nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(hd[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(hd[3], ld[3], 1),
                          nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)),
        ])
        self.scratch = _Scratch(ld, fd)
        self.head = nn.Sequential(
            nn.Conv2d(fd, fd // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(fd // 2, last_dim, 3, padding=1), nn.ReLU(),
            nn.Conv2d(last_dim, num_channels, 1))


class PixelwiseTaskWithDPT(nn.Module):
    """The task head. `hooks` defaults to the reference's automatic
    placement (head_downstream.py:38-46): the last encoder state and 3
    equally spread decoder states (4 encoder states when encoder_only);
    each hook's token width is its stack's (head_downstream.py:50)."""

    def __init__(self, cfg: DUSt3RConfig, num_channels: int,
                 hooks: Optional[Sequence[int]] = None,
                 layer_dims: Sequence[int] = (96, 192, 384, 768),
                 feature_dim: int = 256, last_dim: int = 32,
                 encoder_only: bool = False):
        super().__init__()
        if hooks is None:
            hooks = dpt_hook_indices(cfg.enc.depth,
                                     None if encoder_only else cfg.dec.depth)
        self.hooks = list(hooks)
        self.num_channels = num_channels
        hook_dims = [cfg.enc.dim if h < cfg.enc.depth else cfg.dec.dim
                     for h in self.hooks]
        self.dpt = _DPTAdapter(hook_dims, layer_dims, feature_dim, last_dim,
                               num_channels)

    def init_weights_(self, generator: Optional[torch.Generator]) -> None:
        init_modules_(self, generator)


def pixelwise_dpt_apply(m: PixelwiseTaskWithDPT, states: List[torch.Tensor],
                        img_hw: Tuple[int, int], patch_size: int
                        ) -> torch.Tensor:
    """states: the all-blocks hook list (each (B, N, C)); returns the raw
    regression map (B, H, W, num_channels) in fp32. The cascade follows
    DPTOutputAdapter.forward (dpt_block.py:419-450); the refinenet4 crop is
    a no-op when every grid dim is a patch multiple, kept as in
    models/heads.py."""
    h, w = img_hw
    nh, nw = h // patch_size, w // patch_size
    maps = []
    for hook in m.hooks:
        t = states[hook].float()
        maps.append(t.reshape(t.shape[0], nh, nw, t.shape[2])
                    .permute(0, 3, 1, 2))

    d = m.dpt
    ap = d.act_postprocess
    l0 = conv2d_transpose(ap[0][1], conv2d(ap[0][0], maps[0]), stride=4)
    l1 = conv2d_transpose(ap[1][1], conv2d(ap[1][0], maps[1]), stride=2)
    l2 = conv2d(ap[2][0], maps[2])
    l3 = conv2d(ap[3][1], conv2d(ap[3][0], maps[3]), stride=2, padding=1)

    sc = d.scratch
    r0 = conv2d(sc.layer1_rn, l0, padding=1)
    r1 = conv2d(sc.layer2_rn, l1, padding=1)
    r2 = conv2d(sc.layer3_rn, l2, padding=1)
    r3 = conv2d(sc.layer4_rn, l3, padding=1)

    path4 = _fusion_block(sc.refinenet4, r3, None)[:, :, :r2.shape[2],
                                                   :r2.shape[3]]
    path3 = _fusion_block(sc.refinenet3, path4, r2)
    path2 = _fusion_block(sc.refinenet2, path3, r1)
    path1 = _fusion_block(sc.refinenet1, path2, r0)

    out = conv2d(d.head[0], path1, padding=1)
    out = interpolate_bilinear(out, (out.shape[2] * 2, out.shape[3] * 2))
    out = torch.relu(conv2d(d.head[2], out, padding=1))
    return conv2d(d.head[4], out).permute(0, 2, 3, 1)
