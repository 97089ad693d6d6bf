"""The two-view pieces of the port against the JAX package, on the CPU:
the pairwise losses (`regr3d_pair`, `conf_loss_pair`) and the optimal-scale
fit `find_opt_scaling` in each of its fit modes, on the inputs of
tests/test_twoview_losses.py; and `dust3r.forward_mixed` on the tiny
configuration of tests/test_mixed_orientation.py with the JAX weights
carried over by `spann3r_torch.utils.convert`.

Tolerances: the losses and scales within 1e-5 relative (fp32 sums in
another order; the median picks an element); `forward_mixed` within the
port's forward-parity bound (tests/test_torch_model.py TOL, 1e-4 relative
and absolute), and exactly equal to the port's own `forward` on each
orientation group, since it runs that program.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import config as JC
from spann3r_tpu import losses as JL
from spann3r_tpu.models import dust3r as JD
from spann3r_torch import config as TC
from spann3r_torch import losses as TL
from spann3r_torch.models import dust3r as TD
from spann3r_torch.utils import convert
from tests.test_mixed_orientation import cfg as jax_mixed_cfg
from tests.test_torch_model import TOL
from tests.test_twoview_losses import B, H, W, _views

LOSS_TOL = 1e-5


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("norm_mode,gt_scale", [(True, False), (True, True),
                                                (False, False)])
def test_pair_losses_match_jax(norm_mode, gt_scale):
    gt1, gt2, pred1, pred2 = _views(np.random.default_rng(0))
    kw = dict(norm_mode=norm_mode, gt_scale=gt_scale)
    want = JL.regr3d_pair(_j(gt1), _j(gt2), _j(pred1), _j(pred2), **kw)
    got = TL.regr3d_pair(_t(gt1), _t(gt2), _t(pred1), _t(pred2), **kw)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    wl, wd = JL.conf_loss_pair(_j(gt1), _j(gt2), _j(pred1), _j(pred2),
                               alpha=0.2, **kw)
    tl, td = TL.conf_loss_pair(_t(gt1), _t(gt2), _t(pred1), _t(pred2),
                               alpha=0.2, **kw)
    np.testing.assert_allclose(float(tl), float(wl), rtol=LOSS_TOL)
    assert set(td) == set(wd)
    for k in wd:
        np.testing.assert_allclose(float(td[k]), float(wd[k]), rtol=LOSS_TOL)


def test_pair_loss_gradients_match_jax():
    gt1, gt2, pred1, pred2 = _views(np.random.default_rng(1))
    jg = jax.grad(lambda p1, p2: JL.conf_loss_pair(
        _j(gt1), _j(gt2), {**_j(pred1), "pts3d": p1},
        {**_j(pred2), "pts3d_in_other_view": p2})[0], argnums=(0, 1))(
        jnp.asarray(pred1["pts3d"]), jnp.asarray(pred2["pts3d_in_other_view"]))
    p1 = torch.from_numpy(pred1["pts3d"]).requires_grad_(True)
    p2 = torch.from_numpy(pred2["pts3d_in_other_view"]).requires_grad_(True)
    loss = TL.conf_loss_pair(_t(gt1), _t(gt2), {**_t(pred1), "pts3d": p1},
                             {**_t(pred2), "pts3d_in_other_view": p2})[0]
    for a, b in zip(torch.autograd.grad(loss, (p1, p2)), jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=LOSS_TOL * np.abs(b).max())


def _scaling_inputs(seed=0):
    rng = np.random.default_rng(seed)
    gt1 = rng.standard_normal((B, H, W, 3)).astype(np.float32) + 2
    gt2 = rng.standard_normal((B, H, W, 3)).astype(np.float32) + 2
    pr1 = gt1 * 1.7 + 0.05 * rng.standard_normal((B, H, W, 3)).astype(np.float32)
    pr2 = gt2 * 1.7 + 0.05 * rng.standard_normal((B, H, W, 3)).astype(np.float32)
    return gt1, gt2, pr1, pr2, rng.random((B, H, W)) > 0.2, \
        rng.random((B, H, W)) > 0.2


@pytest.mark.parametrize("two_views", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("mode", ["avg", "median", "weiszfeld",
                                  "weiszfeld_stop_grad", "avg_stop_grad"])
def test_find_opt_scaling_matches_jax(mode, masked, two_views):
    gt1, gt2, pr1, pr2, v1, v2 = _scaling_inputs()
    if not two_views:
        gt2 = pr2 = v2 = None
    if not masked:
        v1 = v2 = None
    conv = lambda f, *a: [None if x is None else f(x) for x in a]
    want = JL.find_opt_scaling(*conv(jnp.asarray, gt1, gt2, pr1, pr2),
                               fit_mode=mode,
                               **dict(zip(("valid1", "valid2"),
                                          conv(jnp.asarray, v1, v2))))
    got = TL.find_opt_scaling(*conv(torch.from_numpy, gt1, gt2, pr1, pr2),
                              fit_mode=mode,
                              **dict(zip(("valid1", "valid2"),
                                         conv(torch.from_numpy, v1, v2))))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_TOL)


def test_find_opt_scaling_stop_grad_and_bad_mode():
    gt1, gt2, pr1, pr2, v1, v2 = _scaling_inputs(2)
    p = torch.from_numpy(pr1).requires_grad_(True)
    s = TL.find_opt_scaling(torch.from_numpy(gt1), None, p, None,
                            fit_mode="weiszfeld_stop_grad")
    assert not s.requires_grad
    assert TL.find_opt_scaling(torch.from_numpy(gt1), None, p, None,
                               fit_mode="weiszfeld").requires_grad
    with pytest.raises(ValueError, match="bad fit_mode"):
        TL.find_opt_scaling(torch.from_numpy(gt1), None, p, None,
                            fit_mode="mode")


# ---------------------------------------------------------------------------
# forward_mixed
# ---------------------------------------------------------------------------

def _port_cfg():
    return TC.DUSt3RConfig(img_size=(48, 32), patch_size=16,
                           enc=TC.ViTConfig(dim=64, depth=2, num_heads=4),
                           dec=TC.ViTConfig(dim=48, depth=12, num_heads=4),
                           head_type="linear")


def test_forward_mixed_matches_jax():
    """Samples 0 and 2 landscape, 1 portrait in view 1; view 2's sample 2
    portrait too, so three of the four (portrait1, portrait2) groups run."""
    jcfg, tcfg = jax_mixed_cfg(), _port_cfg()
    params = JD.init_dust3r(jax.random.PRNGKey(0), jcfg)
    sd = {}
    convert._dust3r(sd, "", jax.tree.map(np.asarray, params), tcfg)
    model = TD.DUSt3R(tcfg).eval()
    model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(0)
    imgs1 = rng.standard_normal((3, 32, 48, 3)).astype(np.float32)
    imgs2 = rng.standard_normal((3, 32, 48, 3)).astype(np.float32)
    shapes1 = np.array([[32, 48], [48, 32], [32, 48]], np.int32)
    shapes2 = np.array([[32, 48], [48, 32], [48, 32]], np.int32)

    w1, w2 = JD.forward_mixed(params, imgs1, imgs2, shapes1, shapes2, jcfg,
                              JC.FP32)
    g1, g2 = TD.forward_mixed(model, imgs1, imgs2, shapes1, shapes2, tcfg,
                              TC.FP32)
    for got, want in ((g1, w1), (g2, w2)):
        assert set(got) == set(want)
        for k in want:
            assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float32
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    # the portrait sample is the port's own forward on the transposed
    # pair, transposed back, bit for bit
    p1, p2 = TD.forward(model, torch.from_numpy(imgs1[1:2].swapaxes(1, 2).copy()),
                        torch.from_numpy(imgs2[1:2].swapaxes(1, 2).copy()),
                        tcfg, TC.FP32)
    np.testing.assert_array_equal(g1["pts3d"][1],
                                  p1["pts3d"][0].numpy().swapaxes(0, 1))
    np.testing.assert_array_equal(g2["pts3d_in_other_view"][1],
                                  p2["pts3d_in_other_view"][0].numpy()
                                  .swapaxes(0, 1))
