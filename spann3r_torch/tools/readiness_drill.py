"""Real-weights readiness drill of the port.

One command that gives the BASELINE.md chamfer table once the real assets
are present, proven end to end on fabricated fixtures now:

    # the real thing (assets and the published checkpoint present):
    python -m spann3r_torch.tools.readiness_drill --data_root ./data \
        --exp_path ./checkpoints --ckpt spann3r.pth

    # the drill (no assets needed; it writes the exact on-disk formats):
    python -m spann3r_torch.tools.readiness_drill --fixtures /tmp/drill \
        --tiny --device cpu

It runs the port's eval protocol (`spann3r_torch.eval.main`: dataset parse,
streaming reconstruction, median-shift / GT-scale alignment, ICP, masked
chamfer and normal consistency, logs.txt) over 7-Scenes, NRGBD, Replica
and DTU, then parses each logs.txt into the BASELINE comparison table. The
JAX package's counterpart is `tools/readiness_drill.py`; the fixtures
written here are the same bytes.

Fixture formats replicate the reference loaders:
  7-Scenes  ref spann3r/datasets/seven_scenes.py:105-131 -
            <root>/7scenes/<scene>/TestSplit.txt ("sequenceN" lines),
            <scene>/seq-NN/frame-%06d.{color.png, depth.proj.png (uint16 mm,
            65535=invalid), pose.txt (4x4 c2w)}
  NRGBD     ref spann3r/datasets/nrgbd.py:95-120 -
            <root>/neural_rgbd/<scene>/{images/imgN.png, depth/depthN.png
            (uint16 mm), poses.txt (4 text lines per 4x4 GL c2w, 'nan' row
            marks invalid)}
  Replica   the nice-slam release layout, which is NRGBD's (<root>/replica/)
  DTU       ref spann3r/datasets/dtu.py:117-160 -
            <root>/dtu_test/<scan>/{images/%08d.jpg, depths/%08d.npy,
            binary_masks/%08d.png, cams/%08d_cam.txt (MVSNet text format),
            pair.txt (MVSNet cluster file)}

--tiny also writes a spann3r.pth-shaped zipfile checkpoint
(torch.save({'model': state_dict})) of a small random model of the port, in
the reference's key layout, and the eval loads it through the port's
checkpoint reader, so the drill covers checkpoint ingestion too.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import re

import numpy as np

# BASELINE.md v1.01 published chamfer means (acc/comp averaged protocol)
BASELINE_CHAMFER = {"7scenes": 0.0255, "NRGBD": 0.0437,
                    "Replica": 0.0480, "DTU": 2.955}


# --------------------------------------------------------------------------
# fixture fabrication (exact reference on-disk formats)
# --------------------------------------------------------------------------

def _frame(rng, i, hw=(480, 640)):
    """Deterministic structured rgb + depth for frame i: a textured plane
    receding in z, camera translating in x — smooth depth so normals/ICP
    are non-degenerate."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([(xx / w * 255), (yy / h * 255),
                    ((xx + yy + 37.0 * i) % 255)], -1).astype(np.uint8)
    depth_m = 1.5 + 0.8 * (yy / h) + 0.1 * np.sin(xx / 40.0 + i)
    noise = rng.standard_normal((h, w)).astype(np.float32) * 0.003
    return rgb, depth_m + noise


def _pose(i, gl=False):
    p = np.eye(4, dtype=np.float32)
    p[:3, 3] = [0.05 * i, 0.01 * i, 0.02 * i]
    if gl:  # loaders negate columns 1:3 to get cv convention back
        p = p.copy()
        p[:, 1:3] *= -1.0
    return p


def make_seven_scenes(root, n_frames=41, seed=0):
    import cv2
    scene = osp.join(root, "chess", "seq-01")
    os.makedirs(scene, exist_ok=True)
    with open(osp.join(root, "chess", "TestSplit.txt"), "w") as f:
        f.write("sequence1\n")
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        rgb, depth_m = _frame(rng, i)
        cv2.imwrite(osp.join(scene, f"frame-{i:06d}.color.png"), rgb)
        d16 = (depth_m * 1000).astype(np.uint16)
        d16[:4, :4] = 65535  # the invalid-sentinel rows real scans carry
        cv2.imwrite(osp.join(scene, f"frame-{i:06d}.depth.proj.png"), d16)
        np.savetxt(osp.join(scene, f"frame-{i:06d}.pose.txt"), _pose(i))


def make_nrgbd(root, scene="kitchen", n_frames=81, seed=1):
    import cv2
    base = osp.join(root, scene)
    os.makedirs(osp.join(base, "images"), exist_ok=True)
    os.makedirs(osp.join(base, "depth"), exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_frames):
        rgb, depth_m = _frame(rng, i)
        cv2.imwrite(osp.join(base, "images", f"img{i}.png"), rgb)
        cv2.imwrite(osp.join(base, "depth", f"depth{i}.png"),
                    (depth_m * 1000).astype(np.uint16))
        for row in _pose(i, gl=True):
            lines.append(" ".join(f"{x:.9f}" for x in row))
    with open(osp.join(base, "poses.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _mvsnet_cam_txt(extrinsic, intrinsic, d0=425.0, step=2.5):
    rows = "\n".join(" ".join(f"{x:.6f}" for x in r) for r in extrinsic)
    irows = "\n".join(" ".join(f"{x:.6f}" for x in r) for r in intrinsic)
    return f"extrinsic\n{rows}\n\nintrinsic\n{irows}\n\n{d0} {step}\n"


def make_dtu(root, scan="scan1", n_frames=11, seed=2, hw=(600, 800)):
    import cv2
    base = osp.join(root, scan)
    for sub in ("images", "depths", "binary_masks", "cams"):
        os.makedirs(osp.join(base, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    k = np.array([[900.0, 0, hw[1] / 2], [0, 900.0, hw[0] / 2], [0, 0, 1]],
                 np.float32)
    for i in range(n_frames):
        rgb, depth_m = _frame(rng, i, hw)
        cv2.imwrite(osp.join(base, "images", f"{i:08d}.jpg"), rgb)
        np.save(osp.join(base, "depths", f"{i:08d}.npy"),
                (depth_m * 400).astype(np.float32))  # DTU depths are ~mm
        mask = np.full(hw, 255, np.uint8)
        mask[:, : hw[1] // 8] = 0  # partial object mask like the real release
        cv2.imwrite(osp.join(base, "binary_masks", f"{i:08d}.png"), mask)
        w2c = np.linalg.inv(_pose(i)).astype(np.float32)
        with open(osp.join(base, "cams", f"{i:08d}_cam.txt"), "w") as f:
            f.write(_mvsnet_cam_txt(w2c, k))
    # MVSNet pair.txt: count, then (ref_idx, "n id score id score ...") pairs
    with open(osp.join(base, "pair.txt"), "w") as f:
        f.write(f"{n_frames}\n")
        for i in range(n_frames):
            cands = [j for j in range(n_frames) if j != i][:10]
            f.write(f"{i}\n")
            f.write(f"{len(cands)} " + " ".join(
                f"{j} {100.0 - abs(i - j)}" for j in cands) + "\n")


def fabricate_all(data_root):
    made = []
    for name, sub, fn in (("7scenes", "7scenes", make_seven_scenes),
                          ("NRGBD", "neural_rgbd", make_nrgbd),
                          ("Replica", "replica", make_nrgbd),
                          ("DTU", "dtu_test", make_dtu)):
        path = osp.join(data_root, sub)
        if not osp.isdir(path):
            fn(path)
            made.append(name)
    return made


# --------------------------------------------------------------------------
# tiny model + checkpoint (drill mode)
# --------------------------------------------------------------------------

def tiny_cfg():
    from ..config import DUSt3RConfig, Spann3RConfig, ViTConfig
    return Spann3RConfig(
        dust3r=DUSt3RConfig(img_size=(32, 32), patch_size=16,
                            enc=ViTConfig(dim=64, depth=2, num_heads=4),
                            dec=ViTConfig(dim=48, depth=12, num_heads=4),
                            head_type="linear"),
        value_enc_depth=2, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64)


def synth_tiny_ckpt(path, cfg):
    """A spann3r.pth-shaped zipfile, torch.save({'model': state_dict}), the
    published container (ref demo.py load contract), of the port's model
    with random weights from seed 0."""
    import torch

    from ..models.spann3r import build_spann3r
    model = build_spann3r(cfg, "cpu", torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, path)


# --------------------------------------------------------------------------
# table
# --------------------------------------------------------------------------

_ROW = re.compile(r"Dataset: (\w+), Accuracy: ([\d.eE+-]+), "
                  r"Completion: ([\d.eE+-]+)")


def parse_logs(exp_dir, datasets):
    out = {}
    for name in datasets:
        log = osp.join(exp_dir, name, "logs.txt")
        if not osp.exists(log):
            continue
        for line in open(log):
            m = _ROW.match(line)
            if m and m.group(1) == name:
                out[name] = (float(m.group(2)), float(m.group(3)))
    return out


def print_table(results, real_weights):
    print("\n| Dataset | Acc | Comp | Chamfer (acc+comp)/2 | "
          "BASELINE v1.01 | within 1%? |")
    print("|---|---|---|---|---|---|")
    for name, (acc, comp) in results.items():
        cham = (acc + comp) / 2
        tgt = BASELINE_CHAMFER.get(name)
        ok = ("n/a (fixture weights)" if not real_weights else
              ("YES" if tgt and abs(cham - tgt) / tgt <= 0.01
               else f"no ({(cham - tgt) / tgt * 100:+.1f}%)"))
        print(f"| {name} | {acc:.4f} | {comp:.4f} | {cham:.4f} | "
              f"{tgt} | {ok} |")
    print()


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        "readiness drill (PyTorch port)", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_root", type=str, default="./data")
    ap.add_argument("--exp_path", type=str, default="./checkpoints")
    ap.add_argument("--exp_name", type=str, default="readiness_drill")
    ap.add_argument("--ckpt", type=str, default="spann3r.pth")
    ap.add_argument("--datasets", type=str, default="7scenes,NRGBD,Replica,DTU")
    ap.add_argument("--resolution", type=int, default=224)
    ap.add_argument("--fixtures", type=str, default=None, metavar="DIR",
                    help="fabricate any missing dataset under DIR (exact "
                         "reference on-disk formats) and use it as data_root")
    ap.add_argument("--tiny", action="store_true",
                    help="drill mode: tiny model + synthesized .pth + "
                         "resolution 32 (plumbing proof, garbage geometry)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.fixtures:
        args.data_root = args.fixtures
        made = fabricate_all(args.fixtures)
        if made:
            print(f"fabricated fixtures for: {', '.join(made)}")

    from .. import eval as eval_cli
    eargs = eval_cli.get_args_parser().parse_args([])
    eargs.data_root = args.data_root
    eargs.exp_path = args.exp_path
    eargs.exp_name = args.exp_name
    eargs.ckpt = args.ckpt
    eargs.datasets = args.datasets
    eargs.resolution = args.resolution
    eargs.device = args.device

    real_weights = osp.exists(osp.join(args.exp_path, args.ckpt))
    if args.tiny:
        eargs.resolution = 32
        eargs.fp32 = True
        cfg = tiny_cfg()
        if not real_weights:
            os.makedirs(args.exp_path, exist_ok=True)
            synth_tiny_ckpt(osp.join(args.exp_path, args.ckpt), cfg)
        from unittest import mock
        with mock.patch("spann3r_torch.config.Spann3RConfig",
                        lambda **kw: cfg):
            eval_cli.main(eargs)
    else:
        eval_cli.main(eargs)

    results = parse_logs(osp.join(args.exp_path, args.exp_name),
                         args.datasets.split(","))
    print_table(results, real_weights and not args.tiny)
    missing = [d for d in args.datasets.split(",") if d not in results]
    if missing:
        raise SystemExit(f"datasets with no evaluated scenes: {missing}")
    print("READINESS DRILL PASSED" if args.tiny or not real_weights else
          "BASELINE TABLE COMPLETE")


if __name__ == "__main__":
    main()
