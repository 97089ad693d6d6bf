"""Stereo and flow finetuning in the port against the JAX package, on the
CPU: the downstream adapters' states (monocular and binocular, cosine and
RoPE100), the pixelwise DPT head, the four criteria and the batch metrics,
tiled_pred and the JAX bicubic resize, one train step with its decay rule
and LR, and test_main on weights carried from the JAX model. The drivers
end to end and the datasets are in test_torch_stereoflow_data.py.

Tolerances (FP32): every state and head output within 1e-5 of its largest
|value| (sums in another order); losses and metrics within 1e-5 relative;
the resize within 1e-5 of the largest |value| (one weight matrix per axis
against XLA's einsum); the step's loss within 1e-5 relative, every
gradient within 1e-5 of the largest |grad|, the updated weights by
`_check_updates`' rule; test_main's tiled predictions within 1e-4 of the
largest |pred| (a whole model's fp32 differences, weighted across tiles).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import config as JC
from spann3r_tpu import training as JT
from spann3r_tpu.models import croco_downstream as JD
from spann3r_tpu.stereoflow import criterion as JCR
from spann3r_tpu.stereoflow import engine as JE
from spann3r_tpu.stereoflow import head as JH
from spann3r_tpu.stereoflow import tiling as JTL
from spann3r_torch import config as TC
from spann3r_torch import training as TT
from spann3r_torch.models import croco_downstream as TD
from spann3r_torch.stereoflow import criterion as TCR
from spann3r_torch.stereoflow import engine as TE
from spann3r_torch.stereoflow import head as TH
from spann3r_torch.stereoflow import tiling as TTL
from spann3r_torch.utils.convert import (_dpt_head,
                                         state_dict_from_stereoflow_params)
from tests.test_torch_training import _check_updates

TOL = 1e-5
TILED_TOL = 1e-4
HW = (32, 48)            # a 2 x 3 patch grid: rectangular, as the crops are
LR, WD = 1e-4, 0.05


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: at these shapes more threads only contend with
    the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(rope=100.0, enc_depth=2, dec_depth=2):
    """The JAX and the port's config of one narrow CroCo (head dim 64)."""
    kw = dict(img_size=HW, patch_size=16)
    vit = lambda m, depth: m.ViTConfig(dim=64, depth=depth, num_heads=1,
                                       rope_base=rope)
    return (JC.DUSt3RConfig(enc=vit(JC, enc_depth), dec=vit(JC, dec_depth),
                            **kw),
            TC.DUSt3RConfig(enc=vit(TC, enc_depth), dec=vit(TC, dec_depth),
                            **kw))


def _models(rope=100.0, num_channels=3, seed=0, **depths):
    """JAX params and the port's StereoFlowNet with the same weights."""
    jcfg, tcfg = _cfgs(rope, **depths)
    params, hooks = JE.init_stereoflow(jax.random.PRNGKey(seed), jcfg,
                                       num_channels)
    model, thooks = TE.init_stereoflow(None, tcfg, num_channels, "cpu")
    assert thooks == hooks
    model.load_state_dict(state_dict_from_stereoflow_params(
        jax.tree.map(np.asarray, params)), strict=True)
    return jcfg, tcfg, params, hooks, model


def _images(seed, b=2, hw=HW):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, *hw, 3)).astype(np.float32)
                 for _ in range(2))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err,
                                                         np.abs(want).max())


# ---------------------------------------------------------------------------
# the adapters and the head
# ---------------------------------------------------------------------------

def test_ckpt_args_and_hooks_match_jax():
    import argparse
    for ck in ({"croco_kwargs": {"enc_depth": 24}}, {},
               {"args": argparse.Namespace(
                   model="CroCoNet(enc_embed_dim=1024, enc_depth=24)")}):
        assert TD.croco_args_from_ckpt(ck) == JD.croco_args_from_ckpt(ck)
    with pytest.raises(ValueError):
        TD.croco_args_from_ckpt(
            {"args": argparse.Namespace(model="__import__('os')")})
    for depths in ((24, 8), (24, 12), (12, None), (2, 2), (3, 5)):
        assert TD.dpt_hook_indices(*depths) == JD.dpt_hook_indices(*depths)


@pytest.mark.parametrize("rope", [100.0, 0.0], ids=["RoPE100", "cosine"])
@pytest.mark.parametrize("kind", ["monocular", "binocular"])
def test_downstream_states_match_jax(rope, kind):
    """Every state handed to the head (the monocular encoder's, or image
    1's half of every encoder state then every decoder state), FP32."""
    jcfg, tcfg, params, _, model = _models(rope, enc_depth=3, dec_depth=2)
    i1, i2 = _images(1)
    capture = lambda states, hw: (states, hw)
    J32 = JC.Precision(compute_dtype=jnp.float32)
    if kind == "monocular":
        want, whw = JD.downstream_monocular(params["croco"], jnp.asarray(i1),
                                            jcfg, capture, J32)
        with torch.no_grad():
            got, ghw = TD.downstream_monocular(model.croco,
                                               torch.from_numpy(i1), tcfg,
                                               capture, TC.FP32)
    else:
        want, whw = JD.downstream_binocular(params["croco"], jnp.asarray(i1),
                                            jnp.asarray(i2), jcfg, capture,
                                            J32)
        with torch.no_grad():
            got, ghw = TD.downstream_binocular(
                model.croco, torch.from_numpy(i1), torch.from_numpy(i2), tcfg,
                capture, TC.FP32)
    assert tuple(ghw) == tuple(whw) == HW
    assert len(got) == len(want) == (3 if kind == "monocular" else 5)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("num_channels", [1, 2, 3])
def test_pixelwise_dpt_matches_jax(num_channels):
    """Random hook states through the JAX head and the port's with the
    same weights (narrow DPT widths, the last encoder state and three
    decoder states)."""
    jcfg, tcfg = _cfgs()
    dims = dict(layer_dims=(16, 24, 32, 48), feature_dim=32, last_dim=16)
    p, hooks = JH.init_pixelwise_dpt(jax.random.PRNGKey(3), jcfg,
                                     num_channels, **dims)
    head = TH.PixelwiseTaskWithDPT(tcfg, num_channels, **dims)
    assert head.hooks == hooks
    sd = {}
    _dpt_head(sd, "dpt", jax.tree.map(np.asarray, p))
    head.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(4)
    states = [rng.standard_normal((2, 6, 64)).astype(np.float32)
              for _ in range(4)]
    want = JH.pixelwise_dpt_apply(p, [jnp.asarray(s) for s in states], HW,
                                  hooks, 16)
    with torch.no_grad():
        got = TH.pixelwise_dpt_apply(head, [torch.from_numpy(s)
                                            for s in states], HW, 16)
    assert got.dtype == torch.float32 and got.shape == (2, *HW, num_channels)
    _close(got.numpy(), want)


def test_linear_pixelwise_head_matches_jax():
    jcfg, tcfg = _cfgs()
    p, jfn = JD.linear_pixelwise_head(jax.random.PRNGKey(5), jcfg, 2)
    proj, tfn = TD.linear_pixelwise_head(None, tcfg, 2, "cpu")
    with torch.no_grad():
        proj.weight.copy_(torch.from_numpy(np.asarray(p["w"]).T))
        proj.bias.copy_(torch.from_numpy(np.asarray(p["b"])))
    x = np.random.default_rng(6).standard_normal((2, 6, 64)).astype(
        np.float32)
    _close(tfn([torch.from_numpy(x)], HW).detach().numpy(),
           jfn([jnp.asarray(x)], HW))


# ---------------------------------------------------------------------------
# criteria and metrics
# ---------------------------------------------------------------------------

def _gt_pred(channels, seed):
    """Predictions and a gt with +inf holes and a few huge (past
    max_gtnorm) entries; conf of both signs."""
    rng = np.random.default_rng(seed)
    gt = (rng.standard_normal((2, 8, 12, channels)) * 4).astype(np.float32)
    gt[0, :2] = np.inf
    gt[1, 3, 4] = np.inf
    gt[1, 5, :3] = 2e4
    pred = (gt + rng.standard_normal(gt.shape)).astype(np.float32)
    pred[~np.isfinite(pred)] = 0.0
    conf = rng.standard_normal((2, 8, 12)).astype(np.float32)
    return pred, gt, conf


@pytest.mark.parametrize("spec", [
    "L1Loss()", "L1Loss(max_gtnorm=400)", "LaplacianLoss()",
    "LaplacianLossBounded()", "LaplacianLossBounded(a=0.5, b=2.0)",
    "LaplacianLossBounded2()", "LaplacianLossBounded2(max_gtnorm=100.0)"])
@pytest.mark.parametrize("channels", [1, 2])
def test_criteria_match_jax(spec, channels):
    pred, gt, conf = _gt_pred(channels, channels)
    jc, tc = JCR.build_criterion(spec), TCR.build_criterion(spec)
    assert jc.with_conf == tc.with_conf
    jargs = (jnp.asarray(pred), jnp.asarray(gt)) + (
        (jnp.asarray(conf),) if jc.with_conf else ())
    targs = (torch.from_numpy(pred), torch.from_numpy(gt)) + (
        (torch.from_numpy(conf),) if tc.with_conf else ())
    want, got = float(jc(*jargs)), float(tc(*targs))
    assert np.isfinite(got)
    assert abs(got - want) <= TOL * abs(want)


def test_build_criterion_refuses_code():
    with pytest.raises(ValueError):
        TCR.build_criterion("__import__('os').system('true')")


@pytest.mark.parametrize("task", ["stereo", "flow"])
def test_batch_metrics_match_jax(task):
    pred, gt, _ = _gt_pred(1 if task == "stereo" else 2, 7)
    jf = JCR.stereo_metrics if task == "stereo" else JCR.flow_metrics
    tf = TCR.stereo_metrics if task == "stereo" else TCR.flow_metrics
    want = jf(jnp.asarray(pred), jnp.asarray(gt))
    got = tf(torch.from_numpy(pred), torch.from_numpy(gt))
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= \
            TOL * abs(float(want[k])) + 1e-6, k


def test_dataset_metrics_are_the_jax_packages_numpy():
    """The per-dataset accumulators are the JAX package's host numpy,
    verbatim (from the marker on), and give its results on a batch with
    a Spring-sized (2x) gt."""
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    marker = "# ---------------- per-dataset accumulators (host numpy) ---"
    port = (repo / "spann3r_torch/stereoflow/criterion.py").read_text()
    orig = (repo / "spann3r_tpu/stereoflow/criterion.py").read_text()
    assert port[port.index(marker):] == orig[orig.index(marker):]
    for cls, channels in (("StereoDatasetMetrics", 1),
                          ("FlowDatasetMetrics", 2)):
        pred, gt, _ = _gt_pred(channels, 8)
        tm, jm = getattr(TCR, cls)(), getattr(JCR, cls)()
        for m in (tm, jm):
            m.reset()
            m.add_batch(pred, gt)
            m.add_batch(pred[:, ::2, ::2], gt)
        assert tm.get_results() == jm.get_results()


# ---------------------------------------------------------------------------
# tiled prediction and the resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((20, 30), (37, 61)),
                                     ((40, 64), (17, 23)),
                                     ((12, 16), (12, 40))])
def test_resize_matches_jax_image_resize(src, dst):
    """jax.image.resize(method='bicubic') up (a = -0.5 cubic) and down
    (antialiased: the kernel widened by the scale)."""
    x = np.random.default_rng(9).standard_normal((2, *src, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3),
                                       method="bicubic"))
    _close(TTL._resize_img(x, dst), want)
    assert not np.allclose(want, torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy(), atol=1e-3)


def _tile_model(with_conf):
    """A deterministic stand-in model: per-pixel maps of the two crops."""
    def fn(a, b):
        d = a[..., :1] - 0.5 * b[..., 1:2] + a.mean(axis=(1, 2, 3))[
            :, None, None, None]
        out = [d, 0.3 * a[..., 2:3] * b[..., :1]]
        return np.concatenate(out, -1).astype(np.float32) if with_conf \
            else d.astype(np.float32)
    return fn


@pytest.mark.parametrize("with_conf", [False, True])
@pytest.mark.parametrize("hw", [(56, 100), (24, 40)], ids=["tiles", "upscale"])
def test_tiled_pred_matches_jax(with_conf, hw):
    """The tiles, chunks (a ragged tail of repeats), weights and the
    upscale path for an image smaller than a tile (the resize both ways)."""
    i1, i2 = _images(10, b=1, hw=hw)
    gt = np.random.default_rng(11).random((1, *hw, 1)).astype(np.float32) * 5
    gt[0, :3] = np.inf
    crit = "LaplacianLossBounded2()" if with_conf else "L1Loss()"
    kw = dict(crop=(32, 48), overlap=0.5, conf_mode="conf_expsigmoid_15_3",
              with_conf=with_conf, tile_batch=3)
    want = JTL.tiled_pred(_tile_model(with_conf), JCR.build_criterion(crit),
                          i1, i2, gt, **kw)
    got = TTL.tiled_pred(_tile_model(with_conf), TCR.build_criterion(crit),
                         i1, i2, gt, **kw)
    _close(got[0], want[0])
    assert abs(got[1] - want[1]) <= TOL * abs(want[1])
    _close(got[2], want[2]) if with_conf else None


def test_tile_slices_and_weights_match_jax():
    for total, win, ov in ((540, 352, 0.7), (960, 704, 0.7), (384, 320, 0.5),
                           (352, 352, 0.7)):
        assert TTL.tile_slices(total, win, ov) == JTL.tile_slices(total, win,
                                                                  ov)
    assert len(TTL.tile_slices(540, 352, 0.7)) * len(
        TTL.tile_slices(960, 704, 0.7)) == 9
    c = np.linspace(-5, 5, 11).astype(np.float32)
    for mode in ("conf_expsigmoid_10_5", "conf_expbeta3"):
        np.testing.assert_array_equal(TTL._conf_weight(c, mode),
                                      JTL._conf_weight(c, mode))


# ---------------------------------------------------------------------------
# the train step, its decay rule and LR
# ---------------------------------------------------------------------------

def test_decayed_names_are_the_jax_packages():
    """The port's decay rule picks the tensors that the JAX rule does:
    each JAX leaf's verdict carried through the weight converter onto the
    port's names."""
    _, tcfg, params, _, model = _models()
    verdict = jax.tree.map(lambda m, x: np.full(np.shape(x), float(m),
                                                np.float32),
                           JT.decay_mask(params), params)
    carried = state_dict_from_stereoflow_params(verdict)
    want = {n for n, t in carried.items() if bool((t == 1).all())}
    assert all(bool((t == 1).all()) or bool((t == 0).all())
               for t in carried.values())
    got = {n for n, p in model.named_parameters()
           if TE.decay_mask(n, tuple(p.shape))}
    assert got == want
    assert "croco.enc_blocks.1.attn.qkv.bias" in got
    assert "croco.enc_norm.bias" not in got and "head.dpt.head.4.bias" \
        not in got


@pytest.mark.parametrize("epoch_f", [0.0, 0.5, 1.0, 7.3, 32.0])
def test_lr_at_matches_jax(epoch_f):
    assert TT.lr_at(epoch_f, 3e-5, 1e-6, 1, 32) == \
        JT.lr_at(epoch_f, 3e-5, 1e-6, 1, 32)


@pytest.mark.parametrize("task", ["stereo", "flow"])
def test_train_step_matches_jax(task):
    """One FP32 step: the loss, every gradient, the batch metrics, and the
    weights after the AdamW update (no clip, the decay rule above)."""
    spec = ("LaplacianLossBounded2()" if task == "stereo"
            else "LaplacianLossBounded()")
    nc = (1 if task == "stereo" else 2) + 1
    jcfg, tcfg, params, hooks, model = _models(100.0, nc, seed=2)
    i1, i2 = _images(12)
    gt = (np.random.default_rng(13).random((2, *HW, nc - 1)) * 8).astype(
        np.float32)
    gt[0, :4] = np.inf
    jcrit, tcrit = JCR.build_criterion(spec), TCR.build_criterion(spec)
    J32 = JC.Precision(compute_dtype=jnp.float32)
    jopt = JE.make_optimizer(WD)
    jstep = JE.make_train_step(jcfg, hooks, jcrit, task, jopt, J32)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    jp, jstate, jl, jbm = jstep(jax.tree.map(jnp.array, params),
                                jopt.init(params), jnp.asarray(i1),
                                jnp.asarray(i2), jnp.asarray(gt),
                                jnp.float32(LR))
    # the JAX gradients from the first moment after one step: (1 - b1) g
    mu = state_dict_from_stereoflow_params(jax.tree.map(
        np.asarray, jstate[0].mu))
    want_g = {n: m / (1 - 0.9) for n, m in mu.items()}
    batch = [torch.from_numpy(a) for a in (i1, i2, gt)]
    _, grads, _ = TE.stereoflow_loss_and_grads(model, tcfg, tcrit, *batch,
                                               TC.FP32)
    gmax = max(float(v.abs().max()) for v in want_g.values())
    for n, g in grads.items():
        assert float((g - want_g[n]).abs().max()) <= TOL * gmax, n
    opt = TE.make_optimizer(WD)
    tstep = TE.make_train_step(tcfg, tcrit, task, opt, TC.FP32)
    state, tl, tbm = tstep(model, opt.init(dict(model.named_parameters())),
                           *batch, LR)
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    for k in jbm:
        assert abs(float(tbm[k]) - float(jbm[k])) <= \
            TOL * abs(float(jbm[k])) + 1e-6, k
    new = {n: p.detach() for n, p in model.named_parameters()}
    want_new = state_dict_from_stereoflow_params(jax.tree.map(np.asarray, jp))
    _check_updates(new, old, want_new, mu, lr=LR)
    assert int(state.count) == 1


# ---------------------------------------------------------------------------
# test_main on weights carried from the JAX model
# ---------------------------------------------------------------------------

def test_test_main_matches_jax_on_carried_weights(tmp_path, monkeypatch):
    """The JAX test driver on a JAX checkpoint and the port's on the same
    weights carried into a `.pth`: the tiled predictions of a SceneFlow
    fixture's test pair (30 tiles at 120x67, in chunks of 2), saved as npy."""
    from spann3r_tpu.stereoflow import datasets as jsfd
    from spann3r_tpu.stereoflow import driver as JDR
    from spann3r_tpu.training import CheckpointManager as JCM
    from spann3r_torch.stereoflow import datasets as tsfd
    from spann3r_torch.stereoflow import driver as TDR
    from spann3r_torch.tools import stereoflow_fixtures as fx

    data = str(tmp_path / "data")
    fx.write_tree("SceneFlow", data, seed=1, pairs=4, shrink=8)
    monkeypatch.setattr(jsfd, "DATA_ROOT", data)
    monkeypatch.setattr(tsfd, "DATA_ROOT", data)
    jcfg, tcfg, params, _, model = _models(100.0, 2, seed=4)
    meta = {"task": "stereo", "croco_args": TD.croco_kwargs_from_cfg(tcfg),
            "crop": list(HW), "criterion": "LaplacianLossBounded2()",
            "tile_conf_mode": "conf_expsigmoid_15_3", "num_channels": 2}
    runs = {}
    for name in ("jax", "port"):
        out = tmp_path / name
        out.mkdir()
        (out / "stereoflow_args.json").write_text(json.dumps(meta))
        if name == "jax":
            JCM(str(out)).save("last", params, JE.make_optimizer(0.0).init(
                params), 0, 0.0)
        else:
            opt = TE.make_optimizer(0.0)
            TT.CheckpointManager(str(out)).save(
                "last", model, opt.init(dict(model.named_parameters())), 0,
                0.0, None)
        argv = ["--model", str(out), "--dataset",
                "SceneFlow(split='test_finalpass')", "--tile_batch", "2",
                "--fp32", "--save", "pred"]
        if name == "port":
            res = TDR.test_main(TDR.get_test_args_parser().parse_args(
                argv + ["--device", "cpu"]))
        else:
            res = JDR.test_main(JDR.get_test_args_parser().parse_args(argv))
        (dname, metrics), = res.items()
        found = [os.path.join(r, f) for r, _, fs in os.walk(out)
                 for f in fs if f.endswith("_pred.npy")]
        assert len(found) == 1
        runs[name] = (metrics, np.load(found[0]),
                      os.path.relpath(found[0], out))
    (jm, jpred, jrel), (tm, tpred, trel) = runs["jax"], runs["port"]
    assert trel == jrel and tpred.shape == (67, 120)
    _close(tpred, jpred, TILED_TOL)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= TILED_TOL * (1 + abs(jm[k])), k
