"""The port's eval path against the JAX package, on the CPU: the masked
statistics, the torch geometry, the alignment criterion, the per-scene
`evaluate_scene` (online and offline) on a 7-Scenes-format fixture, the
dataset copies, and the JAX-free modules the port keeps its own copy of.

Tolerances: the masked median is exact on the same fp32 inputs (it picks
an element of a sorted tensor); the quantile interpolates between two
such elements (1e-6); the geometry and the alignment criterion sum in
another order (1e-5 relative); the aligned points of a whole scene carry
the reconstruction's fp32 differences (1e-4 * (1 + |gt|)). The dataset
copies give the same views bit for bit.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import config as JC
from spann3r_tpu import losses as JL
from spann3r_tpu.tools import eval_pipeline as JE
from spann3r_tpu.utils import geometry as JG
from spann3r_tpu.utils import masked as JM
from spann3r_torch import config as TC
from spann3r_torch import losses as TL
from spann3r_torch.models import offline as TO
from spann3r_torch.tools import eval_pipeline as TE
from spann3r_torch.utils import geometry as TG
from spann3r_torch.utils import masked as TM
from tests.test_torch_model import HW, _models
from tests.test_torch_offline import GAP_TOL

REPO = Path(__file__).resolve().parent.parent
GEOM_TOL = 1e-5
ALIGN_TOL = 1e-4

# the JAX-free modules of the JAX package that the port keeps a copy of,
# equal to the original but for their import lines (and, where named, the
# lines the port changes on purpose)
COPIES = [
    "utils/image.py", "utils/export.py", "utils/pnp.py", "native/geomlib.cpp",
    "native/__init__.py", "tools/icp.py", "tools/eval_recon.py",
    "tools/vis.py", "habitat_gen/quat.py", "habitat_gen/geometry.py",
    "habitat_gen/backends.py", "datasets/cropping.py", "datasets/base.py",
    "datasets/loader.py", "datasets/demo.py", "datasets/seven_scenes.py",
    "datasets/nrgbd.py", "datasets/dtu.py", "datasets/synth.py",
    "datasets/sampler.py", "utils/metrics.py",
    "datasets/scannet.py", "datasets/scannetpp.py", "datasets/arkit.py",
    "datasets/blendedmvs.py", "datasets/co3d.py", "datasets/habitat.py",
    "habitat_gen/generator.py", "habitat_gen/scripts.py", "datasets/pairs.py",
    "tools/extract_crops.py", "habitat_gen/__init__.py",
    "tools/render_dtu.py", "utils/viz3d.py",
    "stereoflow/io.py", "stereoflow/augmentor.py", "stereoflow/datasets.py",
]
# the native library builds beside the port's kernels, under a name that
# is renamed into place
PORT_ONLY_LINES = {
    # a nested mixture, N @ (A + B), draws its inner maps each epoch and
    # follows the curriculum (the JAX copy leaves its inner datasets alone)
    "datasets/base.py": {
        'if hasattr(self.dataset, "set_epoch"):  # a nested mixture\'s maps',
        "self.dataset.set_epoch(epoch)",
        'if hasattr(self.dataset, "set_ratio"):  # and a nested mixture\'s',
        "self.dataset.set_ratio(train_ratio)"},
    # the commands it prints name the port's CLI
    "habitat_gen/scripts.py": {
        'f"{prefix}python -m spann3r_torch.habitat_gen.scripts "',
        'print(f"python -m spann3r_torch.habitat_gen.scripts "'},
    # a world of one unless torch.distributed is initialised
    "utils/metrics.py": {
        "if not (dist.is_available() and dist.is_initialized()):",
        "# on the device the group's backend takes: NCCL takes CUDA tensors",
        "arr = torch.tensor([self.count, self.total], dtype=torch.float64,",
        "device=comm_device())",
        "dist.all_reduce(arr)", "self.count = int(arr[0])",
        "self.total = float(arr[1])"},
    "native/__init__.py": {
        '_LIB = os.path.join(os.path.dirname(_DIR), "_build", "libgeomlib.so")',
        "# built beside the port's CUDA kernels, under a temporary name that is",
        "# renamed into place, so processes that build at once never load a",
        "# half-written library",
        "os.makedirs(os.path.dirname(_LIB), exist_ok=True)",
        'tmp = f"{_LIB}.{os.getpid()}.tmp"',
        'cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]',
        "os.replace(tmp, _LIB)"},
}
JAX_ONLY_LINES = {
    "habitat_gen/scripts.py": {
        'f"{prefix}python -m spann3r_tpu.habitat_gen.scripts "',
        'print(f"python -m spann3r_tpu.habitat_gen.scripts "'},
    "utils/metrics.py": {
        "if jax.process_count() == 1:",
        "arr = process_allgather(np.array([self.count, self.total]))",
        "self.count = int(arr[:, 0].sum())",
        "self.total = float(arr[:, 1].sum())"},
    "native/__init__.py": {
        '_LIB = os.path.join(_DIR, "libgeomlib.so")',
        'cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", _LIB]'},
}
_IMPORT = re.compile(r"^\s*(from\s+\S+\s+)?import\s")
# where an original names the reference by the absolute path of its
# checkout, the copy says "the reference's"
_CHECKOUT = re.compile(r"\(/\S*?/reference/")


def _body(text, drop):
    return [ln for ln in text.splitlines()
            if not _IMPORT.match(ln) and ln.strip() not in drop]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_original(rel):
    port = (REPO / "spann3r_torch" / rel).read_text()
    orig = (REPO / "spann3r_tpu" / rel).read_text()
    assert _body(port, PORT_ONLY_LINES.get(rel, set())) == \
        _body(_CHECKOUT.sub("(the reference's ", orig),
              JAX_ONLY_LINES.get(rel, set()))


def test_geometry_host_part_equals_the_original():
    """The numpy half of utils/geometry.py is the JAX package's, verbatim."""
    marker = "# numpy (host / dataset) versions"
    port = (REPO / "spann3r_torch/utils/geometry.py").read_text()
    orig = (REPO / "spann3r_tpu/utils/geometry.py").read_text()
    assert port[port.index(marker):] == orig[orig.index(marker):]


# ---------------------------------------------------------------------------
# masked statistics and geometry
# ---------------------------------------------------------------------------

def _masked_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 301)).astype(np.float32)
    x[:, ::7] = x[:, 1::7][:, :x[:, ::7].shape[1]]   # repeated values
    m = rng.random((5, 301)) > 0.4
    m[1] = False          # no valid element: NaN
    m[3] = False
    m[3, 17] = True       # one valid element
    m[4, :2] = True       # an even count of valid elements
    m[4, 2:] = False
    return x, m


@pytest.mark.parametrize("axis", [-1, 0])
def test_masked_median_is_exact(axis):
    x, m = _masked_inputs(0)
    want = np.asarray(JM.masked_median(jnp.asarray(x), jnp.asarray(m), axis))
    got = TM.masked_median(torch.from_numpy(x), torch.from_numpy(m), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    if axis == -1:
        got = got.numpy()
        assert np.isnan(got[1]) and got[3] == x[3, 17]
        assert got[4] == min(x[4, 0], x[4, 1])    # the lower middle element


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_masked_quantile(q):
    x, m = _masked_inputs(1)
    want = np.asarray(JM.masked_quantile(jnp.asarray(x), jnp.asarray(m), q))
    got = TM.masked_quantile(torch.from_numpy(x), torch.from_numpy(m), q).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.isnan(got[1])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (None, True),
                                           (-1, False), (0, True)])
def test_masked_mean(axis, keepdims):
    x, m = _masked_inputs(2)
    want = np.asarray(JM.masked_mean(jnp.asarray(x), jnp.asarray(m), axis,
                                     keepdims))
    got = TM.masked_mean(torch.from_numpy(x), torch.from_numpy(m), axis,
                         keepdims).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = rng.standard_normal(3)
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        u, _, vt = np.linalg.svd(np.eye(3) + 0.3 * k)
        out[i, :3, :3] = u @ vt
        out[i, :3, 3] = rng.standard_normal(3)
    return out


def test_inv_se3_and_geotrf():
    rng = np.random.default_rng(3)
    trf = _poses(2, 3)
    pts = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    for fn_t, fn_j, args in (
            (TG.inv_se3, JG.inv_se3, (trf,)),
            (TG.geotrf, JG.geotrf, (trf, pts)),
            (TG.geotrf, JG.geotrf, (trf[:, :3, :3].copy(), pts))):
        got = fn_t(*map(torch.from_numpy, args)).numpy()
        want = np.asarray(fn_j(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got, want, rtol=GEOM_TOL, atol=GEOM_TOL)
    np.testing.assert_array_equal(TG.xy_grid(5, 3).numpy(),
                                  np.asarray(JG.xy_grid(5, 3)))


def test_estimate_focal_weiszfeld():
    rng = np.random.default_rng(4)
    h, w = 24, 32
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    z = 2.0 + rng.random((3, h, w))
    pts = np.stack([(u - 16) * z / 40.0, (v - 12) * z / 40.0, z], -1)
    pts = (pts + 0.01 * rng.standard_normal(pts.shape)).astype(np.float32)
    pts[1, 0, 0, 2] = 0.0                       # a point at z = 0
    pp = np.array([[16, 12], [16, 12], [15.5, 12.5]], np.float32)
    got = TG.estimate_focal_weiszfeld(torch.from_numpy(pts),
                                      torch.from_numpy(pp)).numpy()
    want = np.asarray(JG.estimate_focal_weiszfeld(jnp.asarray(pts),
                                                  jnp.asarray(pp)))
    np.testing.assert_allclose(got, want, rtol=GEOM_TOL)
    assert np.all(np.abs(got - 40.0) < 1.0)


# ---------------------------------------------------------------------------
# the alignment criterion
# ---------------------------------------------------------------------------

def _criterion_inputs(t=4, b=2, h=8, w=10, seed=5):
    rng = np.random.default_rng(seed)
    gts = {"pts3d": rng.standard_normal((t, b, h, w, 3)).astype(np.float32) + 2,
           "valid_mask": rng.random((t, b, h, w)) > 0.3,
           "camera_pose": np.stack([_poses(b, seed + i) for i in range(t)])}
    gts["valid_mask"][1, b - 1] = False
    pr = rng.standard_normal((t, b, h, w, 3)).astype(np.float32) * 0.5 + 1
    preds = {"pts3d_1": pr[:-1], "pts3d_2": pr[1:],
             "conf_1": np.ones((t - 1, b, h, w), np.float32),
             "conf_2": np.ones((t - 1, b, h, w), np.float32)}
    return gts, preds


@pytest.mark.parametrize("t,b,seed", [(4, 2, 5), (3, 1, 6)])
def test_regr3d_t_scale_shift_inv(t, b, seed):
    """Against the JAX criterion as the eval builds it (GT scale, no
    normalisation), whose two normalisation factors are then None."""
    gts, preds = _criterion_inputs(t=t, b=b, seed=seed)
    want = JL.regr3d_t_scale_shift_inv(
        {k: jnp.asarray(v) for k, v in gts.items()},
        {k: jnp.asarray(v) for k, v in preds.items()}, gt_scale=True,
        norm_mode=False)
    assert want[3] is None and want[4] is None
    want = want[:3] + want[5:]
    got = TL.regr3d_t_scale_shift_inv(
        {k: torch.from_numpy(v) for k, v in gts.items()},
        {k: torch.from_numpy(v) for k, v in preds.items()})
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=GEOM_TOL, atol=GEOM_TOL)
    assert len(got) == len(want) == 5
    for i in range(4):                # gt points, pred lists, valids
        assert len(got[i]) == len(want[i])
        for a, b in zip(got[i], want[i]):
            close(a, b)
    assert set(got[4]) == set(want[4]) == {"gt_shift_z", "pred_shift_z",
                                           "gt_scale", "pred_scale"}
    for k in got[4]:
        close(got[4][k], want[4][k])


# ---------------------------------------------------------------------------
# evaluate_scene on a 7-Scenes fixture, and the dataset copies
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seven_scenes_root(tmp_path_factory):
    """The 7-Scenes layout of tests/test_eval_and_train_cli.py."""
    import cv2

    root = tmp_path_factory.mktemp("7s")
    scene = root / "chess" / "seq-01"
    scene.mkdir(parents=True)
    (root / "chess" / "TestSplit.txt").write_text("sequence1\n")
    rng = np.random.default_rng(0)
    for i in range(6):
        img = (rng.random((480, 640, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(scene / f"frame-{i:06d}.color.png"), img)
        depth = (rng.random((480, 640)) * 3000 + 500).astype(np.uint16)
        cv2.imwrite(str(scene / f"frame-{i:06d}.depth.proj.png"), depth)
        pose = np.eye(4)
        pose[:3, 3] = [i * 0.05, 0, 0]
        np.savetxt(str(scene / f"frame-{i:06d}.pose.txt"), pose)
    return str(root)


def _scene_batch(root, resolution):
    from spann3r_torch.datasets import SevenScenes
    from spann3r_torch.datasets.loader import collate_views

    ds = SevenScenes(split="test", ROOT=root, resolution=resolution,
                     num_seq=1, full_video=True, kf_every=2)
    return collate_views([ds[0]])


@pytest.fixture(scope="module")
def scene_batch(seven_scenes_root):
    return _scene_batch(seven_scenes_root, HW["linear"][0])


_JAX_SCENES = {}


def _jax_scene(kind, batch, offline):
    if (kind, offline) not in _JAX_SCENES:
        jcfg, _, params, _, _ = _models(kind)
        _JAX_SCENES[kind, offline] = JE.evaluate_scene(params, jcfg, JC.FP32,
                                                       batch, offline=offline)
    return _JAX_SCENES[kind, offline]


@pytest.mark.parametrize("kind,offline", [("linear", False), ("linear", True),
                                          ("dpt", False)])
def test_evaluate_scene_matches_jax(seven_scenes_root, scene_batch, kind,
                                    offline, monkeypatch):
    """The linear head online and offline, and the DPT head the CLIs build
    online, at its tiny config's 64x64. Offline, the frame order comes from
    argmaxes: the best two pairwise confidences and the best two candidate
    scores of every round must be further apart than GAP_TOL
    (tests/test_torch_offline.py), so a near tie fails loudly rather than
    at random."""
    _, tcfg, _, _, model = _models(kind)
    batch = scene_batch if kind == "linear" else \
        _scene_batch(seven_scenes_root, HW[kind][0])
    want = _jax_scene(kind, batch, offline)
    scores = []
    for fn in ("pairwise_confidences", "_score_candidates"):
        orig = getattr(TO, fn)
        monkeypatch.setattr(TO, fn, lambda *a, _f=orig, **k: scores.append(
            np.asarray(torch.as_tensor(_f(*a, **k)).float())) or scores[-1])
    got = TE.evaluate_scene(model, tcfg, TC.FP32, batch, offline=offline)
    for s in scores:
        if s.size > 1:
            top2 = np.sort(s)[-2:]
            assert top2[1] - top2[0] > GAP_TOL, s
    assert bool(scores) == offline
    pts, gts, masks, colors, fps, preds, order, conf = got
    assert list(order) == list(want[6])
    t, hw = batch["img"].shape[0], HW[kind]
    assert pts.shape == gts.shape == (t, *hw, 3) and fps > 0
    assert len(preds) == len(want[5]) == t
    np.testing.assert_allclose(gts, want[1], rtol=GEOM_TOL, atol=GEOM_TOL)
    err = np.abs(pts - np.asarray(want[0]))
    assert (err <= ALIGN_TOL * (1 + np.abs(want[1]))).all(), float(err.max())
    np.testing.assert_array_equal(masks, want[2])
    np.testing.assert_array_equal(colors, want[3])
    np.testing.assert_allclose(conf, want[7], rtol=ALIGN_TOL, atol=ALIGN_TOL)


def _views_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(4):
        img = (rng.random((96, 128, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(d / f"frame_{i:03d}.jpg"), img)
    return str(d)


@pytest.mark.parametrize("name", ["Demo", "SevenScenes", "SevenScenes-clip",
                                  "SynthRoom"])
def test_dataset_copies_give_the_same_views(name, seven_scenes_root,
                                            image_folder):
    import spann3r_torch.datasets as TD
    import spann3r_tpu.datasets as JD

    kw = {"Demo": dict(ROOT=image_folder, resolution=32, kf_every=1),
          "SevenScenes": dict(split="test", ROOT=seven_scenes_root,
                              resolution=32, num_seq=1, full_video=True,
                              kf_every=2),
          "SevenScenes-clip": dict(split="test", ROOT=seven_scenes_root,
                                   resolution=(32, 24), num_seq=1,
                                   num_frames=3, min_thresh=1, max_thresh=2,
                                   seed=3),
          "SynthRoom": dict(num_seq=2, resolution=32, seq_len=4, kf_every=1,
                            full_video=True, scene_seed=9)}[name]
    cls = name.split("-")[0]
    got = getattr(TD, cls)(**kw)
    want = getattr(JD, cls)(**kw)
    for i in range(len(want)):
        _views_equal(got[i], want[i])


def test_native_and_icp_match_the_original():
    """The port's copy of the native KD-tree and ICP gives the JAX
    package's results on the same points."""
    from spann3r_torch.tools import icp as TI
    from spann3r_torch.utils.geometry import find_reciprocal_matches
    from spann3r_tpu.tools import icp as JI
    from spann3r_tpu.utils.geometry import find_reciprocal_matches as jfrm

    rng = np.random.default_rng(6)
    a = rng.standard_normal((400, 3)).astype(np.float32)
    b = (a + 0.01 * rng.standard_normal(a.shape) + [0.02, 0, 0]).astype(np.float32)
    for x, y in zip(find_reciprocal_matches(a, b), jfrm(a, b)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(TI.registration_icp(a, b, 0.1),
                                  JI.registration_icp(a, b, 0.1))
    np.testing.assert_array_equal(TI.estimate_normals(a), JI.estimate_normals(a))
