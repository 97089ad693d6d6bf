"""Masked cross-view completion demo (the JAX package's tools/croco_demo.py,
after the reference's croco/demo.py:10-55).

    python -m spann3r_torch.tools.croco_demo --img1 A.png --img2 B.png \
        [--model "CroCoNet(...)"] [--ckpt <pretrain output dir>] \
        [--output demo_output.png] [--device cuda|cpu]

Loads an image pair, masks image 1 and reconstructs it with image 2 as the
reference view, and writes a 4-panel image per batch row: [reference |
masked input | reconstruction | input], the reconstruction denormalised
from each input patch's own mean and variance (the prediction is trained
with norm_pix_loss). --ckpt restores checkpoint-last.pth written by
`python -m spann3r_torch.pretrain`; without it the model has random
weights (the reconstruction is noise, the pipeline runs end to end).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import PIL.Image
import torch

from ..config import BF16, set_tf32_policy
from ..datasets.pairs import IMAGENET_MEAN, IMAGENET_STD
from ..models import croco_pretrain as cp
from ..utils.convert import read_checkpoint


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("CroCo masked-completion demo")
    p.add_argument("--img1", required=True, help="image to mask+reconstruct")
    p.add_argument("--img2", required=True, help="reference view")
    p.add_argument("--model", default="CroCoNet()", type=str,
                   help="CroCoNet(...) model string (pretrain --model)")
    p.add_argument("--ckpt", default=None, type=str,
                   help="pretrain output dir holding checkpoint-last.pth")
    p.add_argument("--output", default="demo_output.png", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default; raises without a card) or cpu")
    return p


def _load_image(path: str, size) -> np.ndarray:
    """ImageNet-normalised (H, W, 3) float32 (ref croco/demo.py:14-20)."""
    img = PIL.Image.open(path).convert("RGB").resize(
        (size[1], size[0]), PIL.Image.Resampling.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


@torch.no_grad()
def run_demo(img1: np.ndarray, img2: np.ndarray, model: str = "CroCoNet()",
             ckpt: Optional[str] = None, seed: int = 0,
             device: str = "cuda") -> np.ndarray:
    """The visualisation as (B*H, 4*W, 3) uint8."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    cfg, mask_ratio = cp.parse_croco_model(model)
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    b, h, w, _ = img1.shape

    net = cp.build_croco(cfg, device, torch.Generator().manual_seed(seed))
    if ckpt is not None:
        path = os.path.join(ckpt, "checkpoint-last.pth")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint-last under {ckpt}")
        net.load_state_dict(read_checkpoint(path)["model"], strict=True)
    else:
        print("WARNING: no --ckpt; running with RANDOM weights "
              "(reconstruction will be noise)")

    n_patches = (h // cfg.patch_size) * (w // cfg.patch_size)
    mask = cp.random_mask(torch.Generator().manual_seed(seed + 1), b,
                          n_patches, mask_ratio).to(device)
    t1 = torch.from_numpy(np.ascontiguousarray(img1, np.float32)).to(device)
    t2 = torch.from_numpy(np.ascontiguousarray(img2, np.float32)).to(device)
    pred, mask, _ = cp.croco_forward(net, t1, t2, mask, mask_ratio, BF16)
    # norm-pix denormalisation from the input's own patch statistics
    # (ref demo.py:33-37)
    patches = cp.patchify(t1, cfg.patch_size)
    mean = patches.mean(dim=-1, keepdim=True)
    var = patches.var(dim=-1, keepdim=True, unbiased=False)
    decoded = cp.unpatchify(pred * torch.sqrt(var + 1e-6) + mean,
                            cfg.patch_size, h, w).cpu().numpy()

    # the per-pixel mask from the patch mask (demo.py:42-43)
    p = cfg.patch_size
    mask_np = mask.cpu().numpy().reshape(b, h // p, w // p)
    mask_img = np.repeat(np.repeat(mask_np, p, axis=1), p, axis=2)[..., None]

    def to_rgb(x):
        x = np.asarray(x, np.float32) * IMAGENET_STD + IMAGENET_MEAN
        return np.clip(x, 0.0, 1.0)

    input_rgb = to_rgb(img1)
    panels = [to_rgb(img2), (1 - mask_img) * input_rgb, to_rgb(decoded),
              input_rgb]
    vis = np.concatenate(panels, axis=2).reshape(b * h, 4 * w, 3)
    return (vis * 255).round().astype(np.uint8)


def main(args=None):
    args = get_args_parser().parse_args(args)
    set_tf32_policy()
    cfg, _ = cp.parse_croco_model(args.model)
    img1 = _load_image(args.img1, cfg.img_size)
    img2 = _load_image(args.img2, cfg.img_size)
    vis = run_demo(img1, img2, args.model, args.ckpt, args.seed, args.device)
    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    PIL.Image.fromarray(vis).save(args.output)
    print("Visualization saved in " + args.output)


if __name__ == "__main__":
    main()
