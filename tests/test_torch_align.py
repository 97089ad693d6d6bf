"""Global alignment in the port (`spann3r_torch.models.global_align`)
against the JAX package's, on the CPU, on the JAX tests' synthetic scene
(tests/test_global_align.py: N = 3 cameras at 16x16 with exact pairwise
predictions over the complete symmetric graph).

Tolerances: the MST init is the same numpy (bit for bit) but for the focal,
which the port estimates with its torch Weiszfeld (1e-5 relative); the
energy on one parameter state sums in another order (1e-6 relative), its
gradients within 1e-5 of the largest |grad|, image 0's pose gradients
exactly 0; after 10 Adam steps every parameter within 1e-4 of its tensor's
largest |value|; after 300 steps the final loss within 1e-3 relative and
the points within 1e-3 of the scene's extent (the loss on the scene with
noisy predictions, see test_three_hundred_steps_match_jax).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_global_align as JT
from spann3r_tpu.models import global_align as JG
from spann3r_tpu.utils.export import read_glb
from spann3r_torch.models import global_align as TG

INIT_TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
STEP10_TOL = 1e-4
LOSS300_TOL = 1e-3
PTS300_TOL = 1e-3
NUMPY_HALF = (
    "rot_to_quat", "rigid_points_registration", "_srt_to_4x4", "_apply44",
    "GlobalAligner._mst_rigid_init", "GlobalAligner._im_conf",
    "GlobalAligner._centroid_pose_init", "GlobalAligner.get_masks",
    "GlobalAligner.mask_sky", "GlobalAligner.show",
    "ModularPointCloudOptimizer._msk_indices",
    "ModularPointCloudOptimizer.preset_pose",
    "ModularPointCloudOptimizer.preset_focal",
    "ModularPointCloudOptimizer.preset_principal_point",
    "ModularPointCloudOptimizer.preset_intrinsics")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene(n=JT.N):
    saved = JT.N
    try:
        JT.N = n
        return JT._make_scene(None)
    finally:
        JT.N = saved


def _np(params):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in params.items()}


def _perturbed(params, seed=5, scale=0.05):
    rng = np.random.default_rng(seed)
    return {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in _np(params).items()}


def _set(jax_al, port_al, params):
    jax_al.params = {k: jnp.asarray(v) for k, v in params.items()}
    port_al.params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def _pair(output, cls="GlobalAligner", **kw):
    return (getattr(JG, cls)(output, **kw),
            getattr(TG, cls)(output, device="cpu", **kw))


def _source(mod, dotted):
    import inspect
    obj = mod
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return inspect.getsource(obj)


@pytest.mark.parametrize("name", NUMPY_HALF)
def test_numpy_half_equals_the_original(name):
    """The host-side numpy of the aligner is the JAX package's, verbatim."""
    assert _source(TG, name) == _source(JG, name)


def test_init_params_body_equals_the_original():
    """_init_params is the JAX package's numpy up to its return, which puts
    the arrays on the aligner's device."""
    cut = lambda s: s[s.index("\n"):s.index("        return {")]
    assert cut(_source(TG, "GlobalAligner._init_params")) == \
        cut(_source(JG, "GlobalAligner._init_params"))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.global_aligner(scene()[0])


@pytest.mark.parametrize("init", ["mst", "centroid"])
def test_init_matches_jax(init):
    """Every parameter of the init; all but the focal bit for bit."""
    output, _ = scene()
    ja, ta = _pair(output, init=init)
    want, got = _np(ja.params), _np(ta.params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        if k == "im_logfocal":
            np.testing.assert_allclose(got[k], want[k], rtol=INIT_TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_value_and_grad(al, params):
    return jax.value_and_grad(al._loss)(
        {k: jnp.asarray(v) for k, v in params.items()}, al._data())


def _port_value_and_grad(al, params):
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in params.items()}
    loss = al._loss(leaves, al._data())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, (g.numpy() for g in grads)))


@pytest.mark.parametrize("cls", ["GlobalAligner", "ModularPointCloudOptimizer"])
def test_energy_and_gradients_match_jax(cls):
    output, _ = scene()
    ja, ta = _pair(output, cls)
    if cls == "ModularPointCloudOptimizer":
        for al in (ja, ta):
            al.preset_focal([21.5], msk=[2])
    params = _perturbed(ja.params)
    jl, jg = _jax_value_and_grad(ja, params)
    tl, tg = _port_value_and_grad(ta, params)
    assert abs(tl - float(jl)) <= LOSS_TOL * abs(float(jl))
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
    for k, g in jg.items():
        np.testing.assert_allclose(tg[k], np.asarray(g), rtol=0,
                                   atol=GRAD_TOL * gmax, err_msg=k)
    # the gauge: image 0's pose gets exactly no gradient (and, under the
    # preset, the frozen focal none either)
    assert not tg["im_quat"][0].any() and not tg["im_trans"][0].any()
    if cls == "ModularPointCloudOptimizer":
        assert tg["im_logfocal"][2] == 0.0


def test_ten_steps_match_jax():
    output, _ = scene()
    ja, ta = _pair(output)
    _set(ja, ta, _perturbed(ja.params))
    ja.optimize(niter=10, lr=0.01)
    ta.optimize(niter=10, lr=0.01)
    want, got = _np(ja.params), _np(ta.params)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=STEP10_TOL * max(scale, 1e-30),
                                   err_msg=k)


def noisy_scene(noise=0.01, seed=7):
    """The scene with seeded noise on both pairwise pointmaps, as a
    network's predictions are never exactly consistent: the energy's
    minimum is no longer 0."""
    output, world = scene()
    rng = np.random.default_rng(seed)
    out = {k: dict(v) for k, v in output.items()}
    for view, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view")):
        x = output[view][key]
        out[view][key] = x + noise * rng.standard_normal(x.shape).astype(
            np.float32)
    return out, world


def test_three_hundred_steps_match_jax():
    """300 steps from one perturbed state: the final loss and the points.
    On the exact scene the loss ends at its noise floor (~1e-3), where one
    ulp of one parameter of JAX's own start moves JAX's final loss by 6%,
    so the loss is compared on the noisy scene, whose minimum holds it."""
    output, world = noisy_scene()
    ja, ta = _pair(output)
    _set(ja, ta, _perturbed(ja.params))
    jl = ja.optimize(niter=300, lr=0.01)
    tl = ta.optimize(niter=300, lr=0.01)
    assert abs(tl - jl) <= LOSS300_TOL * abs(jl), (tl, jl)
    extent = float(np.ptp(np.stack(world).reshape(-1, 3), axis=0).max())
    np.testing.assert_allclose(ta.get_pts3d(), ja.get_pts3d(), rtol=0,
                               atol=PTS300_TOL * extent)


def test_exact_scene_points_after_300_steps():
    """On the exact scene, from the MST init (the JAX tests' run), the
    points after 300 steps within 1e-3 of the scene's extent."""
    output, world = scene()
    ja, ta = _pair(output)
    ja.optimize(niter=300, lr=0.01)
    ta.optimize(niter=300, lr=0.01)
    extent = float(np.ptp(np.stack(world).reshape(-1, 3), axis=0).max())
    np.testing.assert_allclose(ta.get_pts3d(), ja.get_pts3d(), rtol=0,
                               atol=PTS300_TOL * extent)


def test_converges_and_recovers_the_scene(rng):
    """The JAX test's convergence, on the port: from the MST init the
    energy stays near 0 and the geometry is recovered (test_global_align's
    bounds); the accessors' shapes and the gauge."""
    output, world = scene()
    al = TG.global_aligner(output, device="cpu")
    l0 = float(al._loss(al.params, al._data()))
    assert l0 < 1e-4, l0
    loss = al.optimize(niter=400, lr=0.02)
    assert loss < 2e-3, loss
    n, h, w = JT.N, JT.H, JT.W
    assert al.get_pts3d().shape == (n, h, w, 3)
    assert al.get_im_poses().shape == (n, 4, 4)
    assert al.get_focals().shape == (n,)
    assert al.get_intrinsics().shape == (n, 3, 3)
    assert al.get_depthmaps().shape == (n, h, w)
    assert al.get_masks().dtype == bool
    np.testing.assert_array_equal(al.get_im_poses()[0], np.eye(4))
    a = al.get_pts3d().reshape(n, -1, 3)
    g = np.stack(world).reshape(n, -1, 3)
    sel = rng.integers(0, h * w, 64)
    da = np.linalg.norm(a[0][sel] - a[n - 1][sel], axis=-1)
    dg = np.linalg.norm(g[0][sel] - g[n - 1][sel], axis=-1)
    assert np.corrcoef(da / np.median(da), dg / np.median(dg))[0, 1] > 0.8


def test_rigid_init_beats_centroid_init():
    output, _ = scene()
    a_mst = TG.GlobalAligner(output, init="mst", device="cpu")
    a_cen = TG.GlobalAligner(output, init="centroid", device="cpu")
    l0 = [float(a._loss(a.params, a._data())) for a in (a_mst, a_cen)]
    assert l0[0] < l0[1], l0
    assert a_mst.optimize(60, 0.01) < a_cen.optimize(60, 0.01)


def test_modular_presets_stay_pinned_and_match_jax():
    """Preset poses and intrinsics stay exactly pinned through the steps
    (their parameters bit-unchanged), the free cameras move, and the
    cameras agree with the JAX optimizer's after 20 steps."""
    output, _ = scene()
    ja, ta = _pair(output, "ModularPointCloudOptimizer")
    pose1 = np.eye(4, dtype=np.float32)
    pose1[:3, 3] = [0.3, 0.05, -0.1]
    k = np.array([[19.0, 0, 8.5], [0, 19.0, 7.5], [0, 0, 1]], np.float32)
    for al in (ja, ta):
        al.preset_pose([pose1], pose_msk=[1])
        al.preset_focal([21.5], msk=[2])
        al.preset_intrinsics([k], msk=[0])
    before = _np(ta.params)
    assert np.isfinite(ta.optimize(niter=20, lr=0.01))
    ja.optimize(niter=20, lr=0.01)
    after = _np(ta.params)
    np.testing.assert_array_equal(after["im_quat"][1], before["im_quat"][1])
    np.testing.assert_array_equal(after["im_trans"][1], before["im_trans"][1])
    np.testing.assert_array_equal(after["im_logfocal"][[0, 2]],
                                  before["im_logfocal"][[0, 2]])
    np.testing.assert_array_equal(ta.get_im_poses()[1], pose1)
    np.testing.assert_array_equal(ta.get_focals()[[0, 2]],
                                  np.float32([19.0, 21.5]))
    np.testing.assert_array_equal(ta.get_principal_points()[0], [8.5, 7.5])
    assert not np.allclose(ta.get_im_poses()[2], np.eye(4))
    for fn in ("get_im_poses", "get_focals", "get_principal_points"):
        want = getattr(ja, fn)()
        np.testing.assert_allclose(getattr(ta, fn)(), want, rtol=0,
                                   atol=STEP10_TOL * np.abs(want).max())
    assert ta._norm_pw_scale
    ta.preset_pose([np.eye(4, dtype=np.float32)], pose_msk=[0])
    assert not ta._norm_pw_scale


def test_pair_viewer_matches_jax():
    """PairViewer: no optimization; the anchor, poses, focals and depths
    of the JAX PairViewer (PnP on the same points; the focal from the
    port's Weiszfeld)."""
    output, _ = scene(2)
    ja = JG.global_aligner(output, mode=JG.MODE_PAIR_VIEWER)
    ta = TG.global_aligner(output, mode=TG.MODE_PAIR_VIEWER, device="cpu")
    assert np.isnan(ta.optimize())
    assert ta.anchor == ja.anchor
    np.testing.assert_allclose(ta.get_im_poses()[ta.anchor], np.eye(4),
                               atol=1e-6)
    for fn in ("get_im_poses", "get_focals", "get_depthmaps", "get_pts3d"):
        want = getattr(ja, fn)()
        np.testing.assert_allclose(getattr(ta, fn)(), want, rtol=0,
                                   atol=INIT_TOL * np.abs(want).max(),
                                   err_msg=fn)


def test_mask_sky_and_show(tmp_path):
    """mask_sky zeroes the per-image mask confidence, never the edge
    weights; show() writes a GLB of points and camera frusta
    (tests/test_viz3d.py's aligner case, on the port)."""
    from tests.test_viz3d import synth_sky_image

    h, w = 24, 32
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((2, h, w, 3)).astype(np.float32) + 3.0
    conf = np.full((2, h, w), 5.0, np.float32)
    out = {"view1": {"idx": [0, 1]}, "view2": {"idx": [1, 0]},
           "pred1": {"pts3d": pred.copy(), "conf": conf.copy()},
           "pred2": {"pts3d_in_other_view": pred.copy(), "conf": conf.copy()}}
    al = TG.global_aligner(out, device="cpu")
    imgs = [synth_sky_image(h, w).astype(np.float32) / 255.0
            for _ in range(2)]
    masked = al.mask_sky(imgs)
    np.testing.assert_array_equal(masked.conf_i, al.conf_i)
    m = masked.get_masks()
    np.testing.assert_array_equal(
        m, JG.global_aligner(out).mask_sky(imgs).get_masks())
    assert not m[0][:h // 2 - 4].any() and m[0][h // 2 + 4:].all()
    assert al.get_masks()[0].all()
    assert np.isfinite(masked.optimize(niter=2, lr=0.01))
    glb = read_glb(masked.show(imgs=imgs, path=str(tmp_path / "al.glb")))
    modes = sorted(p["mode"] for p in glb["primitives"])
    assert modes == [0, 4]
    pc = next(p for p in glb["primitives"] if p["mode"] == 0)
    pts = masked.get_pts3d()[m]
    np.testing.assert_allclose(pc["positions"], pts, rtol=1e-6)


def test_mask_sky_copy_keeps_the_original():
    output, _ = scene()
    al = TG.global_aligner(output, device="cpu")
    params = copy.deepcopy(_np(al.params))
    imgs = [np.zeros((JT.H, JT.W, 3), np.float32)] * JT.N
    al.mask_sky(imgs).optimize(niter=3)
    for k, v in _np(al.params).items():
        np.testing.assert_array_equal(v, params[k])
