"""Pointmap regression heads: linear (pixel shuffle) and DPT.

Module paths are the reference keys (`dpt.act_postprocess.0.1`,
`dpt.scratch.refinenet1.resConfUnit1.conv1`, `dpt.head.4`, `proj`). The
DPT stack runs NCHW inside; the public outputs are NHWC like the JAX
package's: {'pts3d': (B, H, W, 3), 'conf': (B, H, W)}.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import DUSt3RConfig
from ..ops.layers import (conv2d, conv2d_transpose, init_modules_,
                          interpolate_bilinear, linear)


# ---------------------------------------------------------------------------
# postprocess
# ---------------------------------------------------------------------------

def reg_dense_depth(xyz: torch.Tensor, mode) -> torch.Tensor:
    name, _, _ = mode
    if name == "linear":
        return xyz
    d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    xyz = xyz / d.clamp(min=1e-8)
    if name == "square":
        return xyz * d.square()
    if name == "exp":
        return xyz * torch.expm1(d)
    raise ValueError(f"bad depth mode {name}")


def reg_dense_conf(x: torch.Tensor, mode) -> torch.Tensor:
    name, vmin, vmax = mode
    if name == "exp":
        return vmin + torch.exp(x).clamp(max=vmax - vmin)
    if name == "sigmoid":
        return (vmax - vmin) * torch.sigmoid(x) + vmin
    raise ValueError(f"bad conf mode {name}")


def postprocess(fmap: torch.Tensor, cfg: DUSt3RConfig) -> Dict[str, torch.Tensor]:
    """fmap (B, H, W, 3+conf) -> {'pts3d': (B, H, W, 3), 'conf': (B, H, W)}."""
    res = {"pts3d": reg_dense_depth(fmap[..., 0:3], cfg.depth_mode)}
    if fmap.shape[-1] > 3:
        res["conf"] = reg_dense_conf(fmap[..., 3], cfg.conf_mode)
    return res


def _damp_(m: nn.Module, factor: float = 0.01) -> None:
    """Scale down the final projection's random init: with the 'exp' depth
    mode, full-width random weights can emit |xyz| > 88, whose expm1
    overflows. Loading a checkpoint overwrites it."""
    with torch.no_grad():
        m.weight.mul_(factor)


# ---------------------------------------------------------------------------
# linear head
# ---------------------------------------------------------------------------

class LinearHead(nn.Module):
    def __init__(self, cfg: DUSt3RConfig):
        super().__init__()
        ps = cfg.patch_size
        self.proj = nn.Linear(cfg.dec.dim, cfg.out_channels * ps * ps)

    def init_weights_(self, generator: Optional[torch.Generator]) -> None:
        init_modules_(self, generator)
        _damp_(self.proj)


def linear_head_apply(m: LinearHead, dec_states: List[torch.Tensor],
                      img_hw: Tuple[int, int], cfg: DUSt3RConfig):
    h, w = img_hw
    ps = cfg.patch_size
    feat = linear(m.proj, dec_states[-1])       # (B, N, (3+c)*ps*ps)
    b = feat.shape[0]
    nh, nw, c = h // ps, w // ps, cfg.out_channels
    # pixel-shuffle channel order: d = (chan*ps + i)*ps + j
    feat = feat.reshape(b, nh, nw, c, ps, ps).permute(0, 1, 4, 2, 5, 3)
    return postprocess(feat.reshape(b, h, w, c), cfg)


# ---------------------------------------------------------------------------
# DPT head
# ---------------------------------------------------------------------------

class ResidualConvUnit(nn.Module):
    def __init__(self, fd: int):
        super().__init__()
        self.conv1 = nn.Conv2d(fd, fd, 3, padding=1)
        self.conv2 = nn.Conv2d(fd, fd, 3, padding=1)


class FusionBlock(nn.Module):
    def __init__(self, fd: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(fd)
        self.resConfUnit2 = ResidualConvUnit(fd)
        self.out_conv = nn.Conv2d(fd, fd, 1)


class Scratch(nn.Module):
    def __init__(self, cfg: DUSt3RConfig):
        super().__init__()
        fd, ld = cfg.dpt_feature_dim, cfg.dpt_layer_dims
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn",
                            nn.Conv2d(ld[i], fd, 3, padding=1, bias=False))
        for i in range(4):
            self.add_module(f"refinenet{i + 1}", FusionBlock(fd))


class DPT(nn.Module):
    def __init__(self, cfg: DUSt3RConfig):
        super().__init__()
        ld, hd, fd = cfg.dpt_layer_dims, cfg.dpt_hook_dims, cfg.dpt_feature_dim
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(hd[0], ld[0], 1),
                          nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(hd[1], ld[1], 1),
                          nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(hd[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(hd[3], ld[3], 1),
                          nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)),
        ])
        self.scratch = Scratch(cfg)
        # indices 1 and 3 (resize, ReLU) hold no parameters
        self.head = nn.Sequential(
            nn.Conv2d(fd, fd // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(fd // 2, cfg.dpt_last_dim, 3, padding=1), nn.ReLU(),
            nn.Conv2d(cfg.dpt_last_dim, cfg.out_channels, 1))


class DPTHead(nn.Module):
    def __init__(self, cfg: DUSt3RConfig):
        super().__init__()
        self.dpt = DPT(cfg)

    def init_weights_(self, generator: Optional[torch.Generator]) -> None:
        init_modules_(self, generator)
        _damp_(self.dpt.head[4])


def _residual_conv_unit(m: ResidualConvUnit, x: torch.Tensor) -> torch.Tensor:
    out = conv2d(m.conv1, torch.relu(x), padding=1)
    out = conv2d(m.conv2, torch.relu(out), padding=1)
    return out + x


def _fusion_block(m: FusionBlock, x: torch.Tensor,
                  skip: Optional[torch.Tensor]) -> torch.Tensor:
    out = x
    if skip is not None:
        out = out + _residual_conv_unit(m.resConfUnit1, skip)
    out = _residual_conv_unit(m.resConfUnit2, out)
    out = interpolate_bilinear(out, (out.shape[2] * 2, out.shape[3] * 2))
    return conv2d(m.out_conv, out)


def dpt_head_apply(m: DPTHead, dec_states: List[torch.Tensor],
                   img_hw: Tuple[int, int], cfg: DUSt3RConfig):
    """dec_states: the 1 + depth hook states (B, N, C)."""
    h, w = img_hw
    nh, nw = h // cfg.patch_size, w // cfg.patch_size
    maps = []
    for hook in cfg.dpt_hooks:
        t = dec_states[hook]
        maps.append(t.reshape(t.shape[0], nh, nw, t.shape[2]).permute(0, 3, 1, 2))

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

    # crop path4 to r2's size (odd patch grids upsample one row too many)
    path4 = _fusion_block(sc.refinenet4, r3, None)[:, :, :r2.shape[2], :r2.shape[3]]
    path3 = _fusion_block(sc.refinenet3, path4, r2)
    path2 = _fusion_block(sc.refinenet2, path3, r1)
    path1 = _fusion_block(sc.refinenet1, path2, r0)

    out = conv2d(d.head[0], path1, padding=1)
    out = interpolate_bilinear(out, (out.shape[2] * 2, out.shape[3] * 2))
    out = torch.relu(conv2d(d.head[2], out, padding=1))
    fmap = conv2d(d.head[4], out)
    return postprocess(fmap.permute(0, 2, 3, 1), cfg)


def make_head(cfg: DUSt3RConfig) -> nn.Module:
    return DPTHead(cfg) if cfg.head_type == "dpt" else LinearHead(cfg)


def head_apply(m: nn.Module, dec_states, img_hw, cfg: DUSt3RConfig):
    if cfg.head_type == "dpt":
        return dpt_head_apply(m, dec_states, img_hw, cfg)
    return linear_head_apply(m, dec_states, img_hw, cfg)
