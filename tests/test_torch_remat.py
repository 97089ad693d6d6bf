"""Activation rematerialisation in the port's trainer, on the CPU: the
gradients with remat off, `remat` (each block recomputed) and `remat_scan`
(each pair's whole body recomputed) agree with memory dropout on, in fp32
and through the bf16 working copy; `remat` with `remat_scan` against the
JAX package's `forward_train(remat=True, remat_scan=True)`; the kernel
launches of each setting against chip_smoke's `train_launches`; the CLI's
--remat and --remat_scan; the environment switches.

Tolerances: the three settings run the same operations on the same inputs
in the same order, so they agree within 1e-6 of the largest |grad| (they
give the same bits here); against JAX, the train-step tolerances of
tests/test_torch_training.py: the loss 1e-4 relative, the gradients 1e-4
of the largest |grad|.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import config as JC
from spann3r_tpu import losses as JL
from spann3r_tpu.models import spann3r as JS
from spann3r_torch import config as TC
from spann3r_torch import training as TT
from spann3r_torch.models import spann3r as TS
from spann3r_torch.utils import convert
from tests.test_torch_chip_smoke import autograd_kernels, chip_smoke  # noqa: F401
from tests.test_torch_training import _cli_args

HW = (32, 32)
SAME_TOL = 1e-6
JAX_TOL = 1e-4
SETTINGS = {"off": (False, False), "remat": (True, False),
            "remat_scan": (True, True), "scan_only": (False, True)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: at these shapes more threads only contend with
    the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(mod, **kw):
    """The convergence test's tiny configuration (memory dropout 0.15)."""
    return mod.Spann3RConfig(
        dust3r=mod.DUSt3RConfig(img_size=HW, patch_size=16,
                                enc=mod.ViTConfig(dim=64, depth=2, num_heads=4),
                                dec=mod.ViTConfig(dim=48, depth=12, num_heads=4),
                                head_type="linear"),
        value_enc_depth=2, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64, **kw)


def _batch(seed, t=4, b=2):
    rng = np.random.default_rng(seed)
    return {"img": (rng.standard_normal((t, b, *HW, 3)) * 0.3).astype(np.float32),
            "pts3d": (rng.standard_normal((t, b, *HW, 3)) + 2.0).astype(np.float32),
            "valid_mask": rng.random((t, b, *HW)) > 0.2,
            "camera_pose": np.broadcast_to(np.eye(4, dtype=np.float32),
                                           (t, b, 4, 4)).copy()}


def _model(cfg, seed=0):
    return TS.build_spann3r(cfg, "cpu", torch.Generator().manual_seed(seed))


def _moved_model(cfg, seed=0):
    """Random weights, each moved off its init by noise, as training moves
    them: the LayerNorm scales and the biases start at 1 and 0, which bf16
    holds exactly, and would hide a recompute that read the fp32
    parameters in place of their bf16 working copy."""
    model = _model(cfg, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def _grads(model, cfg, prec, batch, setting, grads_bf16=False, seed=3):
    remat, scan = SETTINGS[setting]
    gen = torch.Generator().manual_seed(seed)
    loss, _, grads = TT.value_and_grad(
        model, cfg, prec, TT.batch_to_device(batch, "cpu"), gen, 0.4,
        grads_bf16=grads_bf16, remat=remat, remat_scan=scan)
    return float(loss), {k: g.float() for k, g in grads.items()}


_OFF = {}


def _remat_off(prec):
    """(model, cfg, batch, precision, grads_bf16, remat-off loss and
    gradients) for `prec`, computed once for all the settings."""
    if prec not in _OFF:
        cfg = tiny_cfg(TC)
        model = _moved_model(cfg)
        batch = _batch(1)
        p, gb = (TC.FP32, False) if prec == "fp32" else (TC.BF16, True)
        _OFF[prec] = (model, cfg, batch, p, gb,
                      *_grads(model, cfg, p, batch, "off", gb))
    return _OFF[prec]


@pytest.mark.parametrize("setting", ["remat", "remat_scan", "scan_only"])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_remat_gradients_equal_without(setting, prec):
    """With memory dropout on, each remat setting gives the loss and the
    gradients of remat off: in fp32 against the parameters, and under BF16
    against the bf16 working copy (the recomputed forward reads the working
    copy, not the fp32 parameters)."""
    model, cfg, batch, p, gb, want_loss, want = _remat_off(prec)
    assert cfg.memory.mem_dropout > 0
    loss, got = _grads(model, cfg, p, batch, setting, gb)
    gmax = max(float(v.abs().max()) for v in want.values())
    assert abs(loss - want_loss) <= SAME_TOL * (1.0 + abs(want_loss))
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert worst <= SAME_TOL * gmax, (setting, worst, gmax)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_dropout_draw_moves_the_gradients(prec):
    """The dropout mask matters here: another draw moves the gradients of
    remat off far past SAME_TOL, so the equality above holds the mask."""
    model, cfg, batch, p, gb, _, want = _remat_off(prec)
    gmax = max(float(v.abs().max()) for v in want.values())
    _, other = _grads(model, cfg, p, batch, "off", gb, seed=4)
    assert max(float((other[k] - want[k]).abs().max()) for k in want) \
        > 1e3 * SAME_TOL * gmax


def test_remat_forward_outputs_equal_without():
    """forward_train's predictions under autograd, each setting against
    remat off, on the same dropout draws."""
    cfg = tiny_cfg(TC)
    model = _model(cfg)
    frames = torch.from_numpy(_batch(2)["img"]).transpose(0, 1)
    outs = {}
    for name, (remat, scan) in SETTINGS.items():
        outs[name] = TS.forward_train(model, frames, cfg, TC.FP32,
                                      torch.Generator().manual_seed(5),
                                      remat=remat, remat_scan=scan)
    for name in SETTINGS:
        for k, v in outs["off"].items():
            assert outs[name][k].requires_grad
            diff = float((outs[name][k] - v).detach().abs().max())
            assert diff <= SAME_TOL * float(v.detach().abs().max()), \
                (name, k, diff)


def test_remat_scan_matches_jax():
    """remat and remat_scan on both sides, no dropout, FP32, the same
    weights and batch: loss and every gradient."""
    jcfg, tcfg = tiny_cfg(JC), tiny_cfg(TC)
    params = JS.init_spann3r(jax.random.PRNGKey(2), jcfg)
    pnp = jax.tree.map(np.asarray, params)
    model = _model(tcfg)
    model.load_state_dict(convert.state_dict_from_jax_params(pnp, tcfg),
                          strict=True)
    batch = _batch(7, t=3)

    def jloss(p):
        frames = jnp.transpose(jnp.asarray(batch["img"]), (1, 0, 2, 3, 4))
        preds = JS.forward_train(p, frames, jcfg, JC.FP32, rng=None,
                                 remat=True, remat_scan=True)
        gts = {k: jnp.asarray(batch[k])
               for k in ("pts3d", "valid_mask", "camera_pose")}
        loss, _, factor = JL.conf_loss_t(gts, preds, alpha=0.4, norm_mode=True)
        return loss + factor

    jl, jg = jax.value_and_grad(jloss)(params)
    loss, _, grads = TT.value_and_grad(
        model, tcfg, TC.FP32, TT.batch_to_device(batch, "cpu"), None, 0.4,
        remat=True, remat_scan=True)
    assert abs(float(loss) - float(jl)) <= JAX_TOL * abs(float(jl))
    want = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, jg),
                                              tcfg)
    assert set(grads) == set(want)
    gmax = max(float(v.abs().max()) for v in want.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=JAX_TOL * gmax, err_msg=name)


@pytest.mark.parametrize("setting", ["off", "remat", "remat_scan",
                                     "scan_only", "remat_keep_encoder"])
def test_train_launch_counts_remat(autograd_kernels, setting, monkeypatch):
    """chip_smoke's train_launches for each setting is what one train step
    launches, the recomputed forwards included: here with mem_pos_enc, so
    that the value encoder rotates too, and with SPANN3R_NO_REMAT_ENC=1
    (remat_keep_encoder), which keeps the encoder's activations."""
    cfg = dataclasses.replace(tiny_cfg(TC, mem_pos_enc=True), use_feat=True,
                              value_enc_dim=48, value_enc_heads=4)
    cfg = dataclasses.replace(cfg, dust3r=dataclasses.replace(
        cfg.dust3r, dec=TC.ViTConfig(dim=48, depth=3, num_heads=4)))
    keep_enc = setting == "remat_keep_encoder"
    if keep_enc:
        monkeypatch.setenv("SPANN3R_NO_REMAT_ENC", "1")
    remat, scan = SETTINGS["remat" if keep_enc else setting]
    model = _model(cfg)
    t = 4
    opt = TT.make_optimizer(0.05)
    step = TT.make_train_step(cfg, TC.FP32, opt, remat=remat, remat_scan=scan)
    _, m = step(model, opt.init(dict(model.named_parameters())), _batch(8, t),
                torch.Generator().manual_seed(1), 1e-4, 0.4)
    assert torch.isfinite(m["loss"])
    want = chip_smoke.train_launches(cfg, t, remat, scan,
                                     remat_enc=not keep_enc)
    assert autograd_kernels.launch_counts() == want
    off = chip_smoke.train_launches(cfg, t)
    assert {k: want[k] for k in ("sdpa_bwd", "rope2d_bwd")} == \
        {k: off[k] for k in ("sdpa_bwd", "rope2d_bwd")}


def test_remat_scan_environment_default(monkeypatch):
    """SPANN3R_REMAT_SCAN set makes remat_scan the default, as in the JAX
    package: the body then runs again in the backward."""
    cfg = tiny_cfg(TC)
    model = _model(cfg)
    frames = torch.from_numpy(_batch(9, t=3)["img"]).transpose(0, 1)
    calls = []
    real = TS.pair_step

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TS, "pair_step", counting)
    for env, want in ((None, 2), ("1", 2 * 2)):
        if env:
            monkeypatch.setenv("SPANN3R_REMAT_SCAN", env)
        out = TS.forward_train(model, frames, cfg, TC.FP32)
        sum(v.sum() for v in out.values()).backward()
        assert len(calls) == want, (env, len(calls))
        calls.clear()


@pytest.mark.parametrize("flags", [["--remat", "1"],
                                   ["--remat", "1", "--remat_scan", "1"]])
def test_train_cli_remat(tmp_path, flags, monkeypatch):
    """The CLI trains with --remat 1 and --remat_scan 1: finite losses, a
    checkpoint, no raise."""
    from spann3r_torch import train as cli

    from tests.test_torch_training import tiny_cfg as training_cfg
    monkeypatch.setattr(TT, "Spann3RConfig", lambda **kw: training_cfg(TC))
    out = tmp_path / "run"
    cli.main(_cli_args(out, 1, flags))
    lines = [json.loads(x) for x in open(out / "log.txt")]
    assert all(np.isfinite(x["train_loss"]) for x in lines if "train_loss" in x)
    assert any("train_loss" in x for x in lines)
    assert (out / "checkpoint-last.pth").exists()
