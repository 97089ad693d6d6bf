"""Global alignment of pairwise pointmaps (the reference's
dust3r/cloud_opt, as the JAX package's `models/global_align.py` gives it).

Given pairwise two-view predictions over a scene graph (from
models.inference.inference), jointly optimizes per-image depthmaps, poses and
focals plus per-edge similarity transforms so that every pairwise prediction
agrees with one global point cloud — the reference's PointCloudOptimizer
(dust3r/cloud_opt/base_opt.py:270-297, optimizer.py:16-50).

All per-image and per-edge states are stacked tensors on the aligner's
device (the card unless the caller passes `device="cpu"`), and the
alignment energy is one autograd graph a step, stepped by Adam written out
as optax's `adam(cosine_decay_schedule(lr, niter, alpha=1e-3), b1=0.9,
b2=0.9)` steps. The pose initialization is the JAX package's host-side
numpy, unchanged: pointmaps anchored along a max-confidence spanning tree
with per-edge weighted scaled-Procrustes (Umeyama) fits, the reference's
init_minimum_spanning_tree (cloud_opt/init_im_poses.py:146-228), with
fast-PnP pose recovery for images the tree registration leaves unposed
(init_im_poses.py:210-218).

Loss (ref base_opt.forward): for each edge e=(i,j)
    loss_e = mean(w_i * |P_i - s_e T_e pred_i|) + mean(w_j * |P_j - s_e T_e pred_j|)
with P_k the global points unprojected from (depth_k, focal_k, pose_k) and
w = log(conf).  Per-edge scales are normalized to mean-log 0.

The rotations of the energy are multiply-sums over the size-3 axis
(`_rotate`), elementwise on the CUDA cores: no batched GEMM, so the TF32
policy cannot move them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# quaternion / SE3 helpers
# ---------------------------------------------------------------------------

def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) xyzw quaternion -> (…, 3, 3) rotation."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-8)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def rot_to_quat(r: np.ndarray) -> np.ndarray:
    """3x3 -> xyzw quaternion (host-side init only)."""
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(r).as_quat()


def rigid_points_registration(src: np.ndarray, dst: np.ndarray,
                              conf: np.ndarray) -> Tuple[float, np.ndarray,
                                                         np.ndarray]:
    """Weighted scaled Procrustes/Umeyama: (s, R, T) minimizing
    sum_k w_k |s R src_k + T - dst_k|^2 (the reference calls
    roma.rigid_points_registration with conf weights,
    cloud_opt/init_im_poses.py:238-242)."""
    src = src.reshape(-1, 3).astype(np.float64)
    dst = dst.reshape(-1, 3).astype(np.float64)
    w = conf.reshape(-1).astype(np.float64)
    w = w / max(w.sum(), 1e-12)
    mu_s = w @ src
    mu_d = w @ dst
    xs = src - mu_s
    xd = dst - mu_d
    cov = (w[:, None] * xd).T @ xs
    u, d, vt = np.linalg.svd(cov)
    sgn = np.ones(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2] = -1.0
    rot = u @ np.diag(sgn) @ vt
    var_s = w @ (xs * xs).sum(1)
    s = float((d * sgn).sum() / max(var_s, 1e-12))
    t = mu_d - s * rot @ mu_s
    return s, rot.astype(np.float32), t.astype(np.float32)


def _srt_to_4x4(s: float, rot: np.ndarray, t: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = s * rot
    m[:3, 3] = t
    return m


def _apply44(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply one 4x4 (possibly scaled) transform to (..., 3) points."""
    return pts @ m[:3, :3].T + m[:3, 3]



def _unproject(depth: torch.Tensor, focal: torch.Tensor,
               pp: torch.Tensor) -> torch.Tensor:
    """depth (N,H,W), focal (N,), pp (N,2) -> camera-frame points (N,H,W,3)."""
    n, h, w = depth.shape
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)[None, None]
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)[None, :, None]
    u = xs - pp[:, 0, None, None]
    v = ys - pp[:, 1, None, None]
    f = focal[:, None, None]
    return torch.stack([depth * u / f, depth * v / f, depth], dim=-1)


def _rotate(rot: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """rot (N,3,3) applied to pts (N,H,W,3): out[..., a] = sum_b rot[a, b]
    pts[..., b], as a multiply-sum over the size-3 axis."""
    r = rot[:, None, None]                        # (N,1,1,3,3)
    return (r[..., 0] * pts[..., 0:1] + r[..., 1] * pts[..., 1:2]
            + r[..., 2] * pts[..., 2:3])


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("global_aligner: no CUDA device is available; "
                           "pass device='cpu' to align on the CPU")
    return dev


class GlobalAligner:
    """Joint pose/depth/focal optimization over a pairwise scene graph."""

    def __init__(self, output: Dict, min_conf_thr: float = 3.0,
                 init: str = "mst", device="cuda"):
        self.device = _device(device)
        i1 = np.asarray(output["view1"]["idx"])
        i2 = np.asarray(output["view2"]["idx"])
        self.edges: List[Tuple[int, int]] = list(zip(i1.tolist(), i2.tolist()))
        self.pred_i = np.asarray(output["pred1"]["pts3d"], np.float32)
        self.pred_j = np.asarray(output["pred2"]["pts3d_in_other_view"],
                                 np.float32)
        self.conf_i = np.asarray(output["pred1"]["conf"], np.float32)
        self.conf_j = np.asarray(output["pred2"]["conf"], np.float32)
        self.n_imgs = int(max(i1.max(), i2.max())) + 1
        self.n_edges = len(self.edges)
        _, self.h, self.w, _ = self.pred_i.shape
        self.min_conf_thr = min_conf_thr
        self.params = self._init_params(init)
        self._edge_i = torch.as_tensor(i1, dtype=torch.long, device=self.device)
        self._edge_j = torch.as_tensor(i2, dtype=torch.long, device=self.device)
        self._dev_data = None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ---------------- initialization (host-side) ----------------

    def _init_params(self, init: str = "mst") -> Dict[str, torch.Tensor]:
        n, e = self.n_imgs, self.n_edges
        base_focal = max(self.h, self.w) / (2 * np.tan(np.deg2rad(60) / 2))
        if init == "mst":
            poses, pts3d, focals = self._mst_rigid_init()
        elif init == "centroid":  # legacy coarse init, kept for A/B tests
            poses = self._centroid_pose_init()
            pts3d = focals = None
        else:
            raise ValueError(f"unknown init {init!r} (want 'mst'|'centroid')")

        quats = np.stack([rot_to_quat(p[:3, :3]) for p in poses])
        trans = poses[:, :3, 3].copy()

        # depth init: back-project each image's anchored global points into
        # its own camera (ref init_im_poses.py:125-131 init_from_pts3d);
        # centroid mode falls back to the most-confident edge's raw z
        depth0 = np.full((n, self.h, self.w), 1.0, np.float32)
        if pts3d is not None:
            for i in range(n):
                if pts3d[i] is not None:
                    z = _apply44(np.linalg.inv(poses[i]), pts3d[i])[..., 2]
                    depth0[i] = np.clip(z, 1e-3, None)
        else:
            best_conf = np.full(n, -np.inf)
            for k, (i, j) in enumerate(self.edges):
                ci = self.conf_i[k].mean()
                if ci > best_conf[i]:
                    best_conf[i] = ci
                    depth0[i] = np.clip(self.pred_i[k][..., 2], 1e-3, None)

        logfocal = np.full((n,), np.log(base_focal), np.float32)
        if focals is not None:
            for i in range(n):
                if focals[i] is not None and np.isfinite(focals[i]) \
                        and focals[i] > 0:
                    logfocal[i] = np.log(focals[i])

        # per-edge similarity init: register pred_i[k] onto the anchored
        # global pts3d[i] (ref init_im_poses.py:110-113)
        pw_quat = np.tile(np.array([0, 0, 0, 1.0], np.float32), (e, 1))
        pw_trans = np.zeros((e, 3), np.float32)
        pw_logscale = np.zeros((e,), np.float32)
        if pts3d is not None:
            for k, (i, j) in enumerate(self.edges):
                if pts3d[i] is None:
                    continue
                s, rot, t = rigid_points_registration(self.pred_i[k],
                                                      pts3d[i], self.conf_i[k])
                if s <= 0 or not np.isfinite(s):
                    continue
                pw_quat[k] = rot_to_quat(rot)
                pw_trans[k] = t
                pw_logscale[k] = np.log(s)
            # the energy normalizes scales to mean-log 0; rebase the init's
            # translations/global scene the same way so it starts consistent
            pw_logscale -= pw_logscale.mean()

        return {k: self._tensor(v) for k, v in (
            ("im_quat", quats), ("im_trans", trans),
            ("im_logdepth", np.log(depth0)), ("im_logfocal", logfocal),
            ("pw_quat", pw_quat), ("pw_trans", pw_trans),
            ("pw_logscale", pw_logscale))}

    def _estimate_focal(self, pts3d: np.ndarray) -> float:
        from ..utils.geometry import estimate_focal_weiszfeld
        pp = self._tensor([[self.w / 2.0, self.h / 2.0]])
        return float(estimate_focal_weiszfeld(self._tensor(pts3d[None]),
                                              pp).cpu().numpy().ravel()[0])

    def _mst_rigid_init(self):
        """Anchor pointmaps along a max-confidence spanning tree with
        weighted Umeyama fits — the reference's init_minimum_spanning_tree
        (cloud_opt/init_im_poses.py:146-228).  Edge score = product of mean
        confs (commons.py:20-28); each new image j is anchored by
        registering pred_i[k] onto the already-anchored pts3d[i]
        (pixel-wise correspondence) and mapping pred_j[k] through that
        similarity; camera poses are the UNSCALED (s=1) registrations;
        unposed leftovers fall back to PnP on their anchored points
        (init_im_poses.py:210-218).  Returns (poses (N,4,4) cam2world
        rebased to image-0 identity, anchored pts3d list, focals list)."""
        n = self.n_imgs
        scores = self.conf_i.mean((1, 2)) * self.conf_j.mean((1, 2))

        # max spanning tree over best-undirected-pair scores (Kruskal)
        best_k = {}
        for k, (i, j) in enumerate(self.edges):
            key = (min(i, j), max(i, j))
            if key not in best_k or scores[k] > scores[best_k[key]]:
                best_k[key] = k
        tree_edges = []
        comp = list(range(n))

        def find(a):
            while comp[a] != a:
                comp[a] = comp[comp[a]]
                a = comp[a]
            return a

        for key in sorted(best_k, key=lambda kk: -scores[best_k[kk]]):
            ra, rb = find(key[0]), find(key[1])
            if ra != rb:
                comp[ra] = rb
                tree_edges.append(best_k[key])

        pts3d = [None] * n
        poses = [None] * n
        focals = [None] * n
        todo = sorted(tree_edges, key=lambda kk: scores[kk], reverse=True)
        if not todo:
            return (np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)),
                    pts3d, focals)

        k0 = todo.pop(0)
        i0, j0 = self.edges[k0]
        pts3d[i0] = self.pred_i[k0].copy()
        pts3d[j0] = self.pred_j[k0].copy()
        poses[i0] = np.eye(4, dtype=np.float32)
        focals[i0] = self._estimate_focal(self.pred_i[k0])
        done = {i0, j0}

        while todo:
            progressed = False
            for idx in range(len(todo)):
                k = todo[idx]
                i, j = self.edges[k]
                if focals[i] is None:
                    focals[i] = self._estimate_focal(self.pred_i[k])
                if i in done and j not in done:
                    s, rot, t = rigid_points_registration(
                        self.pred_i[k], pts3d[i], self.conf_i[k])
                    pts3d[j] = (s * self.pred_j[k] @ rot.T + t)
                    if poses[i] is None:
                        poses[i] = _srt_to_4x4(1.0, rot, t)
                    done.add(j)
                elif j in done and i not in done:
                    s, rot, t = rigid_points_registration(
                        self.pred_j[k], pts3d[j], self.conf_j[k])
                    pts3d[i] = (s * self.pred_i[k] @ rot.T + t)
                    if poses[i] is None:
                        poses[i] = _srt_to_4x4(1.0, rot, t)
                    done.add(i)
                else:  # endpoints not anchored yet — retry later
                    continue
                todo.pop(idx)
                progressed = True
                break
            if not progressed:  # disconnected graph: leave the rest default
                break

        # missing focals from the best remaining edge touching the image
        order = np.argsort(-scores)
        for k in order:
            i, _ = self.edges[k]
            if focals[i] is None:
                focals[i] = self._estimate_focal(self.pred_i[k])

        # missing poses: fast PnP between each image's anchored global
        # points and its pixel grid (ref init_im_poses.py:210-218)
        from ..utils.pnp import pose_from_pointmap
        im_conf = self._im_conf()
        for i in range(n):
            if poses[i] is None and pts3d[i] is not None:
                f = focals[i] if focals[i] else \
                    max(self.h, self.w) / (2 * np.tan(np.deg2rad(60) / 2))
                intr = np.array([[f, 0, self.w / 2], [0, f, self.h / 2],
                                 [0, 0, 1]], np.float32)
                msk = im_conf[i] > self.min_conf_thr
                pose = pose_from_pointmap(pts3d[i], intr,
                                          mask=msk if msk.sum() > 8 else None)
                if pose is not None:
                    poses[i] = pose.astype(np.float32)
            if poses[i] is None:
                poses[i] = np.eye(4, dtype=np.float32)

        poses = np.stack(poses)
        # rebase so image 0 is identity (our energy gauge-fixes image 0)
        base_inv = np.linalg.inv(poses[0])
        poses = np.einsum("ab,nbc->nac", base_inv, poses)
        pts3d = [None if p is None else _apply44(base_inv, p) for p in pts3d]
        return poses, pts3d, focals

    def _im_conf(self) -> np.ndarray:
        """Per-image max-over-edges confidence (ref base_opt im_conf)."""
        conf = np.zeros((self.n_imgs, self.h, self.w), np.float32)
        for k, (i, j) in enumerate(self.edges):
            conf[i] = np.maximum(conf[i], self.conf_i[k])
            conf[j] = np.maximum(conf[j], self.conf_j[k])
        return conf

    def _centroid_pose_init(self) -> np.ndarray:
        """Legacy round-1 init: chain centroid offsets (identity rotations)
        along a max-confidence tree.  Kept only as the A/B baseline for the
        rigid MST init (see test_global_align.py)."""
        n = self.n_imgs
        conf_e = self.conf_i.mean((1, 2)) + self.conf_j.mean((1, 2))
        order = np.argsort(-conf_e)
        visited = {int(self.edges[order[0]][0])}
        pose = {next(iter(visited)): np.eye(4)}

        def rel_pose(k):
            cj = self.pred_j[k].reshape(-1, 3)
            wj = self.conf_j[k].reshape(-1)
            centroid = (cj * wj[:, None]).sum(0) / np.clip(wj.sum(), 1e-8,
                                                           None)
            m = np.eye(4)
            m[:3, 3] = centroid
            return m

        changed = True
        while changed and len(visited) < n:
            changed = False
            for k in order:
                i, j = self.edges[k]
                if i in visited and j not in visited:
                    pose[j] = pose[i] @ rel_pose(k)
                    visited.add(j)
                    changed = True
                elif j in visited and i not in visited:
                    m = rel_pose(k)
                    m[:3, 3] *= -1
                    pose[i] = pose[j] @ m
                    visited.add(i)
                    changed = True
        base_inv = np.linalg.inv(pose.get(0, np.eye(4)))
        return np.stack([(base_inv @ pose.get(i, np.eye(4))).astype(np.float32)
                         for i in range(n)])

    # ---------------- energy ----------------

    def _data(self) -> Dict[str, torch.Tensor]:
        """The edge tensors on the device, moved there once (the JAX
        package passes them to its jitted step as arguments)."""
        if self._dev_data is None:
            self._dev_data = {
                "pi": self._tensor(self.pred_i), "pj": self._tensor(self.pred_j),
                "wi": torch.log(self._tensor(self.conf_i)),
                "wj": torch.log(self._tensor(self.conf_j))}
        return self._dev_data

    def _pp(self) -> torch.Tensor:
        return self._tensor([[self.w / 2, self.h / 2]]).expand(self.n_imgs, 2)

    def _camera_arrays(self, params):
        """(rot (N,3,3), tr (N,3), focal (N,), pp (N,2)) with gauge fixing
        applied — the hook ModularPointCloudOptimizer overrides to splice
        in preset (frozen) poses/intrinsics. Image 0 is spliced in by
        concatenation, so its quaternion and translation get an exactly
        zero gradient."""
        rot = quat_to_rot(params["im_quat"])          # (N,3,3)
        tr = params["im_trans"]                       # (N,3)
        # freeze image 0 at identity (gauge fixing, ref optimizer.py)
        rot = torch.cat([torch.eye(3, device=rot.device)[None], rot[1:]])
        tr = torch.cat([tr.new_zeros(1, 3), tr[1:]])
        return rot, tr, torch.exp(params["im_logfocal"]), self._pp()

    _norm_pw_scale = True  # ref base_opt norm_pw_scale (modular may clear)

    def _loss(self, params, data) -> torch.Tensor:
        rot, tr, focal, pp = self._camera_arrays(params)
        depth = torch.exp(params["im_logdepth"])
        cam_pts = _unproject(depth, focal, pp)        # (N,H,W,3)
        glob = _rotate(rot, cam_pts) + tr[:, None, None]

        # per-edge similarity transform with mean-log-0 scale normalization
        logscale = params["pw_logscale"]
        if self._norm_pw_scale:
            logscale = logscale - logscale.mean()
        scale = torch.exp(logscale)
        e_rot = quat_to_rot(params["pw_quat"]) * scale[:, None, None]
        e_tr = params["pw_trans"][:, None, None]

        pi, pj, wi, wj = data["pi"], data["pj"], data["wi"], data["wj"]
        ali = _rotate(e_rot, pi) + e_tr
        alj = _rotate(e_rot, pj) + e_tr

        gi = glob.index_select(0, self._edge_i)
        gj = glob.index_select(0, self._edge_j)

        def safe_norm(x):  # grad-safe at zero residual
            return torch.sqrt(x.square().sum(-1) + 1e-12)

        li = (wi * safe_norm(gi - ali)).mean(dim=(1, 2))
        lj = (wj * safe_norm(gj - alj)).mean(dim=(1, 2))
        return (li + lj).mean()

    # ---------------- optimization ----------------

    def _step(self, state: Dict, data: Dict, lr: float, niter: int
              ) -> torch.Tensor:
        """One Adam step on self.params, as optax.adam(
        cosine_decay_schedule(lr, niter, alpha=1e-3), b1=0.9, b2=0.9) takes
        it: the moments, their bias correction at count + 1, and the
        schedule read at count (so the first step is at lr). Returns the
        loss at the params before the step."""
        b1, b2, eps = 0.9, 0.9, 1e-8
        names = list(self.params)
        with torch.enable_grad():
            leaves = {k: self.params[k].detach().requires_grad_(True)
                      for k in names}
            loss = self._loss(leaves, data)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        count = state["count"]
        step_size = lr * ((1 - 1e-3) * 0.5 * (1 + math.cos(
            math.pi * min(count, niter) / niter)) + 1e-3)
        c1, c2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
        with torch.no_grad():
            for k, g in zip(names, grads):
                mu, nu = state["mu"][k], state["nu"][k]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).add_(g * g, alpha=1 - b2)
                upd = (mu / c1) / (torch.sqrt(nu / c2) + eps)
                self.params[k] = self.params[k] - step_size * upd
        state["count"] = count + 1
        return loss.detach()

    def optimize(self, niter: int = 300, lr: float = 0.01,
                 verbose: bool = False) -> float:
        """Adam with cosine LR decay (ref demo usage: niter 300, lr 0.01)."""
        state = {"count": 0,
                 "mu": {k: torch.zeros_like(v) for k, v in self.params.items()},
                 "nu": {k: torch.zeros_like(v) for k, v in self.params.items()}}
        data = self._data()
        loss = None
        for it in range(niter):
            loss = self._step(state, data, lr, niter)
            if verbose and it % 50 == 0:
                print(f"align iter {it}: loss {float(loss):.5f}")
        return float(loss)

    # ---------------- results ----------------

    def _cameras_np(self):
        with torch.no_grad():
            return [t.cpu().numpy() for t in self._camera_arrays(self.params)]

    def get_focals(self) -> np.ndarray:
        return self._cameras_np()[2]

    def get_principal_points(self) -> np.ndarray:
        return self._cameras_np()[3]

    def get_intrinsics(self) -> np.ndarray:
        k = np.zeros((self.n_imgs, 3, 3), np.float32)
        k[:, 0, 0] = k[:, 1, 1] = self.get_focals()
        k[:, :2, 2] = self.get_principal_points()
        k[:, 2, 2] = 1
        return k

    def get_im_poses(self) -> np.ndarray:
        rot, tr, _, _ = self._cameras_np()
        out = np.tile(np.eye(4, dtype=np.float32), (self.n_imgs, 1, 1))
        out[:, :3, :3] = rot
        out[:, :3, 3] = tr
        return out

    def get_depthmaps(self) -> np.ndarray:
        return np.exp(self.params["im_logdepth"].detach().cpu().numpy())

    @torch.no_grad()
    def get_pts3d(self) -> np.ndarray:
        """Optimized global pointmaps (N, H, W, 3)."""
        _, _, focal, pp = self._camera_arrays(self.params)
        cam = _unproject(torch.exp(self.params["im_logdepth"]), focal, pp)
        poses = self._tensor(self.get_im_poses())
        return (_rotate(poses[:, :3, :3], cam)
                + poses[:, None, None, :3, 3]).cpu().numpy()

    def get_masks(self) -> np.ndarray:
        """Per-image max-over-edges confidence mask (ref get_masks)."""
        conf = self._im_conf()
        for i, sky in getattr(self, "_sky_masks", {}).items():
            conf[i][sky] = 0.0
        return conf > self.min_conf_thr

    def mask_sky(self, imgs) -> "GlobalAligner":
        """Copy of the aligner with sky pixels' per-image confidence zeroed
        (ref dust3r/cloud_opt/base_opt.py:320-326 zeroes im_conf — the MASK
        source — never the edge weights conf_i/conf_j, which feed the
        energy through log and would go -inf).  imgs: per-image RGB arrays
        in [0,1] or uint8."""
        import copy

        from ..utils.viz3d import segment_sky
        res = copy.deepcopy(self)
        res._sky_masks = {i: segment_sky(np.asarray(im))
                          for i, im in enumerate(imgs)}
        return res

    def show(self, imgs=None, cam_size: float = None, path: str = None) -> str:
        """Assemble pointclouds + camera frusta and write/show a GLB scene
        (ref base_opt.py:328-343 via SceneViz)."""
        from ..utils.viz3d import CAM_COLORS, SceneViz, auto_cam_size
        viz = SceneViz()
        pts = self.get_pts3d()
        masks = self.get_masks()
        colors = [CAM_COLORS[n % len(CAM_COLORS)] for n in range(self.n_imgs)]
        for n in range(self.n_imgs):
            viz.add_pointcloud(pts[n],
                               imgs[n] if imgs is not None else colors[n],
                               masks[n])
        poses = self.get_im_poses()
        if cam_size is None:
            cam_size = max(auto_cam_size(poses), 1e-3)
        viz.add_cameras(poses, self.get_focals(), colors=colors,
                        imsizes=[(self.w, self.h)] * self.n_imgs,
                        cam_size=cam_size)
        return viz.show(path)


class ModularPointCloudOptimizer(GlobalAligner):
    """Global alignment with freezable per-image poses/intrinsics
    (ref dust3r/cloud_opt/modular_optimizer.py:17-118).

    preset_pose / preset_focal / preset_principal_point / preset_intrinsics
    pin chosen images' cameras; frozen entries are spliced into the energy
    with where-selects, so Adam's gradients simply never reach them (the
    reference freezes via requires_grad_(False)).  Principal points are
    parameterized as center + 10*offset like the reference and optimized
    only when optimize_pp=True."""

    def __init__(self, output: Dict, min_conf_thr: float = 3.0,
                 optimize_pp: bool = False, init: str = "mst",
                 device="cuda"):
        super().__init__(output, min_conf_thr=min_conf_thr, init=init,
                         device=device)
        n = self.n_imgs
        self.optimize_pp = optimize_pp
        if optimize_pp:
            self.params["im_pp"] = self._tensor(np.zeros((n, 2)))
        self._pose_fixed = np.zeros(n, bool)
        self._fixed_rot = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        self._fixed_tr = np.zeros((n, 3), np.float32)
        self._focal_fixed = np.zeros(n, bool)
        self._fixed_focal = np.ones(n, np.float32)
        self._pp_fixed = np.zeros(n, bool)
        self._fixed_pp = np.tile(np.asarray([[self.w / 2, self.h / 2]],
                                            np.float32), (n, 1))

    # ---------------- presets ----------------

    def _msk_indices(self, msk):
        if msk is None:
            return list(range(self.n_imgs))
        if isinstance(msk, int):
            return [msk]
        arr = np.asarray(msk)
        if arr.dtype == bool:
            assert len(arr) == self.n_imgs
            return np.where(arr)[0].tolist()
        return arr.astype(int).tolist()

    def preset_pose(self, known_poses, pose_msk=None):
        """Pin cam2world poses (ref modular_optimizer.py:38-49).  With >1
        known pose the pairwise-scale gauge freedom is resolved by the
        poses themselves, so scale normalization turns off."""
        known_poses = np.asarray(known_poses, np.float32)
        if known_poses.ndim == 2:
            known_poses = known_poses[None]
        for idx, pose in zip(self._msk_indices(pose_msk), known_poses):
            self._pose_fixed[idx] = True
            self._fixed_rot[idx] = pose[:3, :3]
            self._fixed_tr[idx] = pose[:3, 3]
        self._norm_pw_scale = int(self._pose_fixed.sum()) <= 1

    def preset_focal(self, known_focals, msk=None):
        for idx, f in zip(self._msk_indices(msk), np.atleast_1d(known_focals)):
            self._focal_fixed[idx] = True
            self._fixed_focal[idx] = float(f)

    def preset_principal_point(self, known_pp, msk=None):
        known_pp = np.asarray(known_pp, np.float32).reshape(-1, 2)
        for idx, pp in zip(self._msk_indices(msk), known_pp):
            self._pp_fixed[idx] = True
            self._fixed_pp[idx] = pp

    def preset_intrinsics(self, known_intrinsics, msk=None):
        ks = np.asarray(known_intrinsics, np.float32)
        if ks.ndim == 2:
            ks = ks[None]
        self.preset_focal([k.diagonal()[:2].mean() for k in ks], msk)
        self.preset_principal_point([k[:2, 2] for k in ks], msk)


    # ---------------- energy hook ----------------

    def _camera_arrays(self, params):
        rot = quat_to_rot(params["im_quat"])
        tr = params["im_trans"]
        if not self._pose_fixed.any():
            # gauge-fix image 0 only when nothing anchors the scene
            rot = torch.cat([torch.eye(3, device=rot.device)[None], rot[1:]])
            tr = torch.cat([tr.new_zeros(1, 3), tr[1:]])
        pm = torch.as_tensor(self._pose_fixed, device=self.device)
        rot = torch.where(pm[:, None, None], self._tensor(self._fixed_rot), rot)
        tr = torch.where(pm[:, None], self._tensor(self._fixed_tr), tr)

        focal = torch.exp(params["im_logfocal"])
        focal = torch.where(torch.as_tensor(self._focal_fixed,
                                            device=self.device),
                            self._tensor(self._fixed_focal), focal)

        pp = self._pp()
        if self.optimize_pp:
            pp = pp + 10.0 * params["im_pp"]  # ref modular pp param'n
        pp = torch.where(torch.as_tensor(self._pp_fixed,
                                         device=self.device)[:, None],
                         self._tensor(self._fixed_pp), pp)
        return rot, tr, focal, pp


class PairViewer(GlobalAligner):
    """Dummy optimizer for a symmetrized image PAIR: every quantity is
    computed directly from the raw predictions, no optimization
    (ref dust3r/cloud_opt/pair_viewer.py:18-127).

    Picks the more confident direction as the anchor camera, estimates
    focals by Weiszfeld and the relative pose by PnP-RANSAC on the other
    view's pointmap, and back-projects depths from the anchored pointmaps.
    """

    def __init__(self, output: Dict, min_conf_thr: float = 3.0,
                 device="cuda"):
        super().__init__(output, min_conf_thr=min_conf_thr, init="centroid",
                         device=device)
        assert self.n_imgs == 2 and self.n_edges == 2, \
            "PairViewer needs a symmetrized single pair (edges (0,1),(1,0))"
        from ..utils.pnp import pose_from_pointmap

        k = {e: idx for idx, e in enumerate(self.edges)}
        masks = self.get_masks()
        confs, focals, rel_poses = [], [], []
        for i in range(2):
            kf, kb = k[(i, 1 - i)], k[(1 - i, i)]
            confs.append(float(self.conf_i[kf].mean() *
                               self.conf_j[kf].mean()))
            f = self._estimate_focal(self.pred_i[kf])
            focals.append(f)
            intr = np.array([[f, 0, self.w / 2], [0, f, self.h / 2],
                             [0, 0, 1]], np.float32)
            # pose of camera i in the OTHER camera's frame: PnP between
            # image i's pixels and its pointmap as predicted in cam (1-i)
            pose = pose_from_pointmap(self.pred_j[kb], intr,
                                      mask=masks[i] if masks[i].sum() > 8
                                      else None)
            rel_poses.append(np.eye(4, dtype=np.float32) if pose is None
                             else pose.astype(np.float32))

        if confs[0] > confs[1]:  # anchor = camera 0
            anchor, kf = 0, k[(0, 1)]
            poses = np.stack([np.eye(4, dtype=np.float32), rel_poses[1]])
            depths = [self.pred_i[kf][..., 2],
                      _apply44(np.linalg.inv(rel_poses[1]),
                               self.pred_j[kf])[..., 2]]
        else:                    # anchor = camera 1
            anchor, kf = 1, k[(1, 0)]
            poses = np.stack([rel_poses[0], np.eye(4, dtype=np.float32)])
            depths = [_apply44(np.linalg.inv(rel_poses[0]),
                               self.pred_j[kf])[..., 2],
                      self.pred_i[kf][..., 2]]
        self.anchor = anchor

        self.params = {
            "im_quat": self._tensor(np.stack([rot_to_quat(p[:3, :3])
                                              for p in poses])),
            "im_trans": self._tensor(poses[:, :3, 3]),
            "im_logdepth": torch.log(self._tensor(np.stack(depths)).clamp(
                min=1e-6)),
            "im_logfocal": torch.log(self._tensor(focals)),
            "pw_quat": self.params["pw_quat"],
            "pw_trans": self.params["pw_trans"],
            "pw_logscale": self.params["pw_logscale"],
        }

    def _camera_arrays(self, params):
        # no gauge fixing: the anchor camera already carries identity
        return (quat_to_rot(params["im_quat"]), params["im_trans"],
                torch.exp(params["im_logfocal"]), self._pp())

    def optimize(self, niter: int = 0, lr: float = 0.0,
                 verbose: bool = False) -> float:
        """Nothing to optimize (ref pair_viewer.py:126-127 returns nan)."""
        return float("nan")


# factory modes, mirroring dust3r.cloud_opt.GlobalAlignerMode
MODE_POINT_CLOUD = "PointCloudOptimizer"
MODE_MODULAR = "ModularPointCloudOptimizer"
MODE_PAIR_VIEWER = "PairViewer"


def global_aligner(output: Dict, min_conf_thr: float = 3.0,
                   mode: str = MODE_POINT_CLOUD, **kw):
    """Factory mirroring dust3r.cloud_opt.global_aligner()
    (ref cloud_opt/__init__.py:14-28); `device` (in kw) is the card by
    default, "cpu" on request."""
    cls = {MODE_POINT_CLOUD: GlobalAligner,
           MODE_MODULAR: ModularPointCloudOptimizer,
           MODE_PAIR_VIEWER: PairViewer}[mode]
    return cls(output, min_conf_thr=min_conf_thr, **kw)
