"""Spann3R demo on the port: incremental (or offline) reconstruction of an
image folder -> PLY / transforms.json / npy exports.

    python -m spann3r_torch.demo --demo_path FRAMES --save_path OUT [--offline]

The flags are those of the JAX package's demo.py (ref demo.py:26-41), plus
--device (default cuda; raises without a card, --device cpu runs the
plain versions of the kernels on the CPU). The compute path is
`spann3r_torch.api.reconstruct_video`.
"""
import argparse
import json
import os
import os.path as osp

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser("Spann3R demo (PyTorch port)", add_help=False)
    p.add_argument("--save_path", type=str, default="./output/demo/")
    p.add_argument("--demo_path", type=str, default="./examples/s00567")
    p.add_argument("--ckpt_path", type=str, default="./checkpoints/spann3r.pth")
    p.add_argument("--dust3r_ckpt", type=str,
                   default="./checkpoints/DUSt3R_ViTLarge_BaseDecoder_512_dpt.pth")
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--scenegraph_type", type=str, default="complete")
    p.add_argument("--offline", action="store_true")
    p.add_argument("--conf_thresh", type=float, default=1e-3)
    p.add_argument("--kf_every", type=int, default=10)
    p.add_argument("--vis", action="store_true")
    p.add_argument("--vis_cam", action="store_true")
    p.add_argument("--save_ori", action="store_true")
    p.add_argument("--dynamic", action="store_true")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--int8", type=int, nargs="?", const=1, default=0,
                   help="1 (or bare --int8) = int8 weight-only serving "
                        "(ops/quant.py); 2 = also int8 activations for "
                        "calls of at least quant.INT8_ACT_ROWS rows (the "
                        "batched encoder)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


def load_model(args):
    """(model, cfg, prec) for the flags: the DPT model at the demo's
    resolution on args.device, from the checkpoint or, when it is missing,
    a random init from a seeded generator; bf16 weight storage unless
    --fp32, int8 linears with --int8."""
    import torch

    from .config import BF16, FP32, DUSt3RConfig, Spann3RConfig
    from .models.spann3r import build_spann3r
    from .ops import quant
    from .utils.convert import load_spann3r_checkpoint

    cfg = Spann3RConfig(dust3r=DUSt3RConfig(
        img_size=(args.resolution, args.resolution), head_type="dpt"))
    model = build_spann3r(cfg, args.device, torch.Generator().manual_seed(0))
    if osp.exists(args.ckpt_path):
        load_spann3r_checkpoint(args.ckpt_path, model)
    else:
        print(f"WARNING: checkpoint {args.ckpt_path} not found; "
              f"using random init (smoke-test mode)")
    prec = FP32 if args.fp32 else BF16
    # bf16 weight storage: the same bits under BF16 (weights are cast to
    # the activation dtype at use anyway; LN + heads stay fp32), half the
    # device residency (ops/quant.cast_serving_weights_)
    if not args.fp32 or args.int8:
        quant.cast_serving_weights_(model)
    if args.int8:
        act_rows = quant.INT8_ACT_ROWS if args.int8 >= 2 else 0
        quant.quantize_linear_weights_(model, act_min_rows=act_rows)
        print(f"int8 weight-only serving: {quant.count_quantized(model)} "
              f"matrices")
        if act_rows:
            print("int8 activation compute enabled for batched matmuls")
    return model, cfg, prec


def reconstruct_and_export(model, cfg, prec, batch, args, demo_name,
                           views=None):
    """Reconstruct one collated scene and write its exports under
    args.save_path/demo_name: the .npy dump, the conf-thresholded PLY,
    transforms.json (and the renders with --vis). Returns
    (save directory, focal, fps)."""
    import torch

    from .api import reconstruct_video
    from .utils.export import transforms_json, write_ply
    from .utils.geometry import estimate_focal_weiszfeld
    from .utils.pnp import pose_from_pointmap

    hw = batch["img"].shape[2:4]
    preds, order, fps = reconstruct_video(
        model, cfg, batch["img"], prec, offline=args.offline,
        scene_graph=args.scenegraph_type)
    print(f"Finished reconstruction for {demo_name}, FPS: {fps:.2f}")

    save_demo_path = osp.join(args.save_path, demo_name)
    os.makedirs(save_demo_path, exist_ok=True)

    # focal from the first pointmap (ref demo.py:148-151), on the card
    h, w = hw
    dev = next(model.parameters()).device
    pts0 = torch.from_numpy(np.asarray(preds[0]["pts3d"], np.float32)).to(dev)
    pp = torch.tensor([[w / 2.0, h / 2.0]], device=dev)
    focal = float(estimate_focal_weiszfeld(pts0, pp)[0])
    print(f"Estimated focal of first camera: {focal:.2f} ({w}x{h})")
    intrinsic = np.eye(3)
    intrinsic[0, 0] = intrinsic[1, 1] = focal
    intrinsic[:2, 2] = (w / 2.0, h / 2.0)

    pts_all, pts_gt_all, images_all, masks_all, conf_all, poses_all = \
        [], [], [], [], [], []
    for j, src in enumerate(order):
        key = "pts3d" if j == 0 else "pts3d_in_other_view"
        pts = np.asarray(preds[j][key], np.float32)[0]
        conf = np.asarray(preds[j]["conf"], np.float32)[0]
        image = batch["img"][src, 0]
        pose = pose_from_pointmap(pts, intrinsic)
        poses_all.append(pose if pose is not None else np.eye(4))
        images_all.append((image + 1.0) / 2.0)
        pts_all.append(pts)
        pts_gt_all.append(batch["pts3d"][src, 0])
        masks_all.append(batch["valid_mask"][src, 0])
        conf_all.append(conf)

    images_all = np.stack(images_all)
    pts_all = np.stack(pts_all)
    conf_all = np.stack(conf_all)
    poses_all = np.stack(poses_all)

    np.save(osp.join(save_demo_path, f"{demo_name}.npy"), dict(
        images_all=images_all, pts_all=pts_all,
        pts_gt_all=np.stack(pts_gt_all), masks_all=np.stack(masks_all),
        conf_all=conf_all, poses_all=poses_all, intrinsic=intrinsic))

    # conf-thresholded point cloud (ref demo.py:213-218)
    conf_sig = (conf_all - 1.0) / conf_all
    keep = conf_sig > args.conf_thresh
    ply_name = f"{demo_name}_conf{args.conf_thresh}.ply"
    write_ply(osp.join(save_demo_path, ply_name),
              pts_all[keep], images_all[keep])

    if args.vis:
        from .tools.vis import render_frames, vis_pred_and_imgs
        render_frames(pts_all, images_all, None, save_demo_path, mask=keep,
                      dynamic=args.dynamic)
        vis_pred_and_imgs(pts_all, save_demo_path, images_all=images_all,
                          conf_all=conf_sig)

    # Nerfstudio transforms.json (ref demo.py:227-253)
    if args.save_ori:
        scale_factor = float(views[0]["camera_intrinsics"][0, 0])
        focal_ori = focal / scale_factor
        from .utils.image import imread_cv2
        img0 = imread_cv2(views[0]["label"])
        h_ori, w_ori = img0.shape[:2]
        paths = [osp.abspath(v["label"]) for v in views]
        tj = transforms_json(h_ori, w_ori, focal_ori, list(poses_all),
                             ply_name, ori_paths=paths)
    else:
        tj = transforms_json(h, w, focal, list(poses_all), ply_name)
    with open(osp.join(save_demo_path, "transforms.json"), "w") as f:
        json.dump(tj, f, indent=4)
    print(f"Saved results to {save_demo_path}")
    return save_demo_path, focal, fps


def main(args):
    from .config import set_tf32_policy
    from .datasets import Demo
    from .datasets.loader import collate_views

    set_tf32_policy()
    os.makedirs(args.save_path, exist_ok=True)
    model, cfg, prec = load_model(args)

    dataset = Demo(ROOT=args.demo_path, resolution=args.resolution,
                   full_video=True, kf_every=args.kf_every)
    views = dataset[0]
    if len(views) < 2:
        raise SystemExit(
            f"error: need at least 2 frames to reconstruct, found "
            f"{len(views)} image(s) in {args.demo_path} "
            f"(kf_every={args.kf_every})")
    batch = collate_views([views])  # {key: (T, 1, ...)}
    demo_name = args.demo_path.rstrip("/").split("/")[-1]
    print(f"Started reconstruction for {demo_name} "
          f"({batch['img'].shape[0]} frames)")
    return reconstruct_and_export(model, cfg, prec, batch, args, demo_name,
                                  views)


if __name__ == "__main__":
    main(get_args_parser().parse_args())
