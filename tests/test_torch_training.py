"""The port's trainer against the JAX package's, on the CPU: the schedules,
the optimizer (one and three steps, fp32 and bf16 moments, the clip, the
non-finite gate), one train step and one accumulated step on the same
weights and batch, the dataset registry, the CLI end to end (log, `.pth`
layout, resume, warm start), the checkpoint loaders (the reference's
training layout, DUSt3R's missing second decoder), the TF32 policy of
every entry point and the eval's warm-up of the native library.

Tolerances: the optimizer's per-element math in fp32 on the same inputs,
1e-6 relative; the train step's loss and grad norm 1e-4 relative, its Adam
moments 1e-4 of their largest value (they are linear in the gradients,
which carry the model's fp32 differences); the first Adam step moves each
weight by about lr * sign(grad), so a weight whose gradient is within
rounding of zero may move the other way on the other side: the updates
agree within 1e-3 * lr where the gradient is above 1e-5 of the largest,
and elsewhere within 2 * lr * (1 + weight_decay * |w|), each plus one fp32
spacing of the weight: the new weight is rounded to its own ulp (1.19e-7
for a LayerNorm weight near 1.0, above 1e-3 * lr = 1e-7), and whether the
two sides round to the same neighbour depends on the order of their sums.
"""
import argparse
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import config as JC
from spann3r_tpu import training as JT
from spann3r_tpu.datasets import build_dataset as jax_build_dataset
from spann3r_tpu.models import spann3r as JS
from spann3r_torch import config as TC
from spann3r_torch import training as TT
from spann3r_torch.datasets import build_dataset
from spann3r_torch.models import spann3r as TS
from spann3r_torch.utils import convert

HW = (32, 32)
LR, WD = 1e-4, 0.05


def tiny_cfg(mod):
    return mod.Spann3RConfig(
        dust3r=mod.DUSt3RConfig(img_size=HW, patch_size=16,
                                enc=mod.ViTConfig(dim=64, depth=1, num_heads=4),
                                dec=mod.ViTConfig(dim=48, depth=2, num_heads=4),
                                head_type="linear"),
        memory=mod.MemoryConfig(mem_dropout=0.0),
        value_enc_depth=1, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64)


_CACHE = {}


def _models():
    """JAX params and a port model on the same weights (a fresh copy)."""
    if not _CACHE:
        params = JS.init_spann3r(jax.random.PRNGKey(1), tiny_cfg(JC))
        pnp = jax.tree.map(np.asarray, params)
        model = TS.build_spann3r(tiny_cfg(TC), "cpu",
                                 torch.Generator().manual_seed(0))
        model.load_state_dict(convert.state_dict_from_jax_params(
            pnp, tiny_cfg(TC)), strict=True)
        _CACHE["m"] = (pnp, model)
    pnp, model = _CACHE["m"]
    return jax.tree.map(jnp.asarray, pnp), copy.deepcopy(model)


def _batch(seed, t=3, b=2):
    rng = np.random.default_rng(seed)
    return {"img": (rng.standard_normal((t, b, *HW, 3)) * 0.3).astype(np.float32),
            "pts3d": (rng.standard_normal((t, b, *HW, 3)) + 2.0).astype(np.float32),
            "valid_mask": rng.random((t, b, *HW)) > 0.2,
            "camera_pose": np.broadcast_to(np.eye(4, dtype=np.float32),
                                           (t, b, 4, 4)).copy()}


def _as_port(tree_np):
    return convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, tree_np), tiny_cfg(TC))


def _close(got, want, rel, scale=None):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(scale, 1e-12))


def _check_updates(new, old, want_new, mu, lr=LR):
    """The first Adam step's updates: each weight moves by about
    lr * sign(grad). Where the JAX gradient (its first moment `mu`) is
    above 1e-5 of the largest, the two updates agree within 1e-3 * lr;
    below, the gradient is rounding noise on either side (a k-projection
    bias, which softmax ignores) and may have either sign: there within
    2 * lr * (1 + wd * |w|). Both bounds add one fp32 spacing of the
    weight: w + update is rounded to the weight's ulp (1.19e-7 near 1.0,
    above 1e-3 * lr), and the two sides may round it to either
    neighbour."""
    mmax = max(float(v.abs().max()) for v in mu.values())
    for name, w in new.items():
        err = np.abs((w - old[name]).numpy()
                     - (want_new[name].numpy() - old[name].numpy()))
        ulp = np.spacing(np.maximum(np.abs(old[name].numpy()),
                                    np.abs(w.numpy())).astype(np.float32))
        sure = np.abs(mu[name].numpy()) > 1e-5 * mmax
        assert (err[sure] <= 1e-3 * lr + ulp[sure]).all(), name
        assert (err <= 2 * lr * (1 + WD * np.abs(old[name].numpy()))
                + ulp + 1e-9).all()


# ---------------------------------------------------------------------------
# schedules, parser, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epoch_f", [0.0, 2.5, 10.0, 37.25, 119.9, 120.0])
def test_schedules_match_jax(epoch_f):
    e = int(epoch_f)
    assert TT.lr_at(epoch_f, 5e-5, 1e-6, 10, 120) == \
        JT.lr_at(epoch_f, 5e-5, 1e-6, 10, 120)
    assert TT.active_ratio_at(e, 120) == JT.active_ratio_at(e, 120)
    for c2f in (True, False):
        assert TT.alpha_at(e, 120, 0.4, c2f) == JT.alpha_at(e, 120, 0.4, c2f)


def test_parser_has_the_jax_flags():
    """The JAX trainer's flags and defaults, plus --device; --remat defaults
    to 0 (the port keeps the activations)."""
    def flags(p):
        return {a.dest: a.default for a in p._actions
                if not isinstance(a, argparse._HelpAction)}
    port, ref = flags(TT.get_args_parser()), flags(JT.get_args_parser())
    assert set(port) == set(ref) | {"device"} and port["device"] == "cuda"
    assert {k for k in ref if port[k] != ref[k]} == {"remat"}
    assert port["remat"] == 0


def _opt_inputs(seed, scale):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "b": rng.standard_normal((16,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in scale]
    return params, grads


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_optimizer_matches_jax(steps, moments):
    """make_optimizer against JAX's, step for step: big gradients (the clip
    active) then small ones; params, moments and the count."""
    params, grads = _opt_inputs(0, [100.0, 1e-3, 30.0][:steps])
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if moments == "bf16"
                else (None, None))
    jopt, topt = JT.make_optimizer(WD, jdt), TT.make_optimizer(WD, tdt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = {k: jp[k] - LR * ju[k] for k in jp}
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        TT.apply_updates_(tp, tu, LR)
    assert int(ts.count) == int(js.count) == steps
    for k in params:
        _close(tp[k], jp[k], 1e-6)
        assert ts.mu[k].dtype == (tdt or torch.float32)
        _close(ts.mu[k], np.asarray(js.mu[k], np.float32), 1e-6)
        _close(ts.nu[k], np.asarray(js.nu[k], np.float32), 1e-6)


def test_optimizer_nonfinite_gate():
    """A non-finite gradient norm leaves params, moments and the count as
    they were; the next finite step proceeds as if the bad one never
    happened."""
    params, (g1, g2) = _opt_inputs(1, [1.0, 1.0])
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = TT.make_optimizer(WD)
    st = opt.init(tp)
    u, st = opt.update({k: torch.from_numpy(v) for k, v in g1.items()}, st, tp)
    TT.apply_updates_(tp, u, LR)
    snap = ({k: v.clone() for k, v in tp.items()},
            {k: v.clone() for k, v in st.mu.items()}, int(st.count))
    bad = {k: torch.from_numpy(v.copy()) for k, v in g2.items()}
    bad["w"][0, 0] = float("nan")
    u, st = opt.update(bad, st, tp)
    TT.apply_updates_(tp, u, LR)
    assert int(st.count) == snap[2] == 1
    for k in tp:
        assert torch.equal(tp[k], snap[0][k]) and torch.equal(st.mu[k], snap[1][k])
    # the same two finite steps in JAX
    jopt = JT.make_optimizer(WD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    for g in (g1, g2):
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = {k: jp[k] - LR * ju[k] for k in jp}
    u, st = opt.update({k: torch.from_numpy(v) for k, v in g2.items()}, st, tp)
    TT.apply_updates_(tp, u, LR)
    for k in tp:
        _close(tp[k], jp[k], 1e-6)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def test_train_step_matches_jax():
    """One make_train_step on the same weights and batch (FP32, fp32
    gradients and moments): loss, grad norm, moments and updates."""
    jparams, model = _models()
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = _batch(2)
    jopt, topt = JT.make_optimizer(WD), TT.make_optimizer(WD)
    jstep = JT.make_train_step(tiny_cfg(JC), JC.FP32, jopt, remat=False,
                               grads_bf16=False)
    jstate = jopt.init(jparams)
    jparams, jstate, jm = jstep(jparams, jstate,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(0), jnp.float32(LR),
                                jnp.float32(0.4))
    tstep = TT.make_train_step(tiny_cfg(TC), TC.FP32, topt, grads_bf16=False)
    tstate, tm = tstep(model, topt.init(dict(model.named_parameters())),
                       batch, torch.Generator().manual_seed(0), LR, 0.4)
    _close(tm["loss"], jm["loss"], 1e-4)
    _close(tm["grad_norm"], jm["grad_norm"], 1e-4)
    assert set(tm) == set(jm)
    mu, nu = _as_port(jstate.mu), _as_port(jstate.nu)
    for k in mu:
        _close(tstate.mu[k], mu[k].numpy(), 1e-4,
               scale=max(float(v.abs().max()) for v in mu.values()))
        _close(tstate.nu[k], nu[k].numpy(), 1e-4,
               scale=max(float(v.abs().max()) for v in nu.values()))
    _check_updates({k: v.detach() for k, v in model.named_parameters()}, old,
                   _as_port(jparams), mu)


def test_accumulated_step_matches_jax():
    """make_accum_train_step at accum_iter 2: the fp32 accumulator after two
    micro-batches, then the optimizer step."""
    jparams, model = _models()
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    batches = [_batch(3), _batch(4)]
    jopt, topt = JT.make_optimizer(WD), TT.make_optimizer(WD)
    _, jgrad, japply = JT.make_accum_train_step(
        tiny_cfg(JC), JC.FP32, jopt, 2, remat=False, grads_bf16=False)
    jacc = jax.tree.map(jnp.zeros_like, jparams)
    _, tgrad, tapply = TT.make_accum_train_step(tiny_cfg(TC), TC.FP32, topt, 2,
                                                grads_bf16=False)
    tacc = TT.zero_grads(model)
    for i, b in enumerate(batches):
        jacc, _ = jgrad(jparams, jacc, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i), jnp.float32(0.4))
        tacc, _ = tgrad(model, tacc, b, None, 0.4)
    want = _as_port(jacc)
    gmax = max(float(v.abs().max()) for v in want.values())
    for k, v in tacc.items():
        _close(v, want[k].numpy(), 1e-4, scale=gmax)
    jparams, jstate, jzero, jn = japply(jparams, jopt.init(jparams), jacc,
                                        jnp.float32(LR))
    st, tzero, tn = tapply(model, topt.init(dict(model.named_parameters())),
                           tacc, LR)
    _close(tn, jn, 1e-4)
    assert all(float(v.abs().max()) == 0 for v in tzero.values())
    _check_updates({k: v.detach() for k, v in model.named_parameters()}, old,
                   _as_port(jparams), _as_port(jstate.mu))


def test_accumulated_step_skips_a_nonfinite_microbatch():
    _, model = _models()
    _, tgrad, _ = TT.make_accum_train_step(tiny_cfg(TC), TC.FP32,
                                           TT.make_optimizer(WD), 2,
                                           grads_bf16=False)
    bad = _batch(5)
    bad["img"][0, 0, 0, 0, 0] = np.nan
    acc, m = tgrad(model, TT.zero_grads(model), bad, None, 0.4)
    assert not torch.isfinite(m["loss"])
    assert all(float(v.abs().max()) == 0 for v in acc.values())


def test_work_params_bf16_copy():
    """Under BF16 the gradients are taken against a bf16 copy of every
    weight but the pointmap heads', which stay the fp32 parameters."""
    _, model = _models()
    wp = TT.work_params(model, TC.BF16)
    params = dict(model.named_parameters())
    for name, t in wp.items():
        if name.startswith("dust3r.downstream_head"):
            assert t is params[name]
        else:
            assert t.dtype == torch.bfloat16 and t.is_leaf and t.requires_grad
            assert torch.equal(t, params[name].detach().to(torch.bfloat16))
    assert TT.work_params(model, TC.FP32) == params


def test_bf16_train_step_runs():
    """A BF16 step with the trainer's defaults (bf16 gradients, bf16
    moments) and memory dropout: finite loss and grad norm, bf16 moments,
    fp32 weights that moved."""
    _, model = _models()
    cfg = dataclasses.replace(tiny_cfg(TC), memory=TC.MemoryConfig())
    opt = TT.make_optimizer(WD, moment_dtype=torch.bfloat16)
    st = opt.init(dict(model.named_parameters()))
    before = model.value_out.weight.detach().clone()
    st, m = TT.make_train_step(cfg, TC.BF16, opt, grads_bf16=True)(
        model, st, _batch(6), torch.Generator().manual_seed(1), LR, 0.4)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert all(v.dtype == torch.bfloat16 for v in st.mu.values())
    assert model.value_out.weight.dtype == torch.float32
    assert not torch.equal(model.value_out.weight.detach(), before)


# ---------------------------------------------------------------------------
# datasets, CLI, checkpoints
# ---------------------------------------------------------------------------

SYNTH = "SynthRoom(num_seq=3, num_frames=3, resolution=32, seq_len=8, min_thresh=1, max_thresh=2)"


def test_build_dataset_matches_jax():
    seeded = SYNTH.replace(")", ", seed=777)")
    expr = f"4 @ {seeded} + {seeded}"
    ds, jds = build_dataset(expr), jax_build_dataset(expr)
    assert len(ds) == len(jds) == 7
    ds.set_epoch(1)
    jds.set_epoch(1)
    for idx in (0, (5, 0)):
        for a, b in zip(ds[idx], jds[idx]):
            for key in ("img", "pts3d", "camera_pose", "valid_mask"):
                np.testing.assert_array_equal(a[key], b[key])
    for bad in ("Unknown(num_seq=1)", "__import__('os')", "SynthRoom(x=y)"):
        with pytest.raises(ValueError):
            build_dataset(bad)


def _cli_args(out, epochs, extra=()):
    return ["--device", "cpu", "--resolution", "32", "--head_type", "linear",
            "--num_frames", "3", "--batch_size", "2", "--epochs", str(epochs),
            "--warmup_epochs", "0", "--print_freq", "1", "--num_workers", "1",
            "--keep_freq", "1", "--bf16", "0", "--output_dir", str(out),
            "--train_dataset", f"4 @ {SYNTH}",
            "--test_dataset", SYNTH.replace("num_seq=3", "num_seq=2"), *extra]


@pytest.fixture
def tiny_cli(monkeypatch):
    """The CLI's model configuration replaced by the tiny one."""
    monkeypatch.setattr(TT, "Spann3RConfig", lambda **kw: tiny_cfg(TC))


def test_train_cli_trains_saves_resumes_and_warm_starts(tmp_path, tiny_cli,
                                                        capsys):
    from spann3r_torch import train as cli

    out = tmp_path / "run"
    cli.main(_cli_args(out, 2, ["--profile_dir", str(tmp_path / "prof")]))
    assert (tmp_path / "prof" / "trace.json").exists()
    lines = [json.loads(x) for x in open(out / "log.txt")]
    assert [x["epoch"] for x in lines] == [0, 0, 1, 1, 2]
    assert all(np.isfinite(x["train_loss"]) for x in lines if "train_loss" in x)
    assert "test_SynthRoom_loss_med" in lines[2]
    names = sorted(os.listdir(out))
    for name in ("checkpoint-last.pth", "checkpoint-best.pth",
                 "checkpoint-1.pth", "checkpoint-2.pth"):
        assert name in names
    assert os.path.isdir(out / "recording" / "spann3r_torch")
    ck = convert.read_checkpoint(str(out / "checkpoint-last.pth"))
    assert set(ck) == {"model", "optimizer", "scaler", "args", "epoch",
                       "best_so_far"}
    assert ck["epoch"] == 1 and isinstance(ck["args"], argparse.Namespace)
    assert int(ck["optimizer"]["count"]) == 4          # 2 steps an epoch
    assert set(ck["optimizer"]["mu"]) == set(ck["model"])

    # resume from last: epoch 2 only
    capsys.readouterr()
    cli.main(_cli_args(out, 3))
    assert "auto-resumed from epoch 2" in capsys.readouterr().out
    ck3 = convert.read_checkpoint(str(out / "checkpoint-last.pth"))
    assert ck3["epoch"] == 2 and int(ck3["optimizer"]["count"]) == 6

    # warm start from the checkpoint: its weights, a fresh optimizer
    res = TT.train(TT.get_args_parser().parse_args(_cli_args(
        tmp_path / "warm", 0, ["--pretrained",
                               str(out / "checkpoint-last.pth")])))
    for k, v in res["model"].state_dict().items():
        assert torch.equal(v, ck3["model"][k])
    assert int(res["opt_state"].count) == 0


@pytest.mark.parametrize("flags", [["--model_axis", "2"], ["--fsdp", "1"],
                                   ["--model_axis", "2", "--remat", "1"],
                                   ["--fsdp", "1", "--remat_scan", "1"]])
def test_train_refuses_what_is_not_ported(tmp_path, flags):
    args = TT.get_args_parser().parse_args(_cli_args(tmp_path, 1, flags))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.train(args)


def test_training_checkpoint_loads(tmp_path):
    """C2: a Spann3R .pth in the reference's training layout (args as an
    argparse.Namespace) loads with weights_only; so does a DUSt3R .pth
    without a second decoder, whose first decoder fills both."""
    _, model = _models()
    path = tmp_path / "ckpt.pth"
    torch.save({"model": model.state_dict(), "optimizer": {"state": {}},
                "scaler": None, "args": argparse.Namespace(lr=1e-4, seed=0),
                "epoch": 3, "best_so_far": 0.5}, path)
    fresh = TS.build_spann3r(tiny_cfg(TC), "cpu",
                             torch.Generator().manual_seed(5))
    convert.load_spann3r_checkpoint(str(path), fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, model.state_dict()[k])

    sd = {k: v for k, v in model.dust3r.state_dict().items()
          if not k.startswith("dec_blocks2.")}
    sd["mask_token"] = torch.zeros(1, 1, 64)                   # vestigial
    torch.save({"model": sd, "args": argparse.Namespace(x=1)},
               tmp_path / "dust3r.pth")
    convert.load_dust3r_checkpoint(str(tmp_path / "dust3r.pth"), fresh.dust3r)
    for k, v in fresh.dust3r.dec_blocks2.state_dict().items():
        assert torch.equal(v, model.dust3r.dec_blocks.state_dict()[k])


class _Stop(Exception):
    pass


@pytest.mark.parametrize("entry", ["bench", "demo", "eval", "app", "train"])
def test_entry_points_turn_tf32_off(entry, tmp_path, monkeypatch):
    """C1: every entry point sets the port's TF32 policy (off) before it
    builds or loads a model."""
    from spann3r_torch import app, bench, demo
    from spann3r_torch import eval as teval
    from spann3r_torch.models import spann3r as sp

    def stop(*a, **kw):
        raise _Stop

    monkeypatch.setattr(sp, "build_spann3r", stop)
    monkeypatch.setattr(demo, "load_model", stop)
    monkeypatch.setattr(teval, "load_model", stop)
    monkeypatch.setattr(TT, "build_dataset", stop)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    calls = {
        "bench": lambda: bench.run(bench.get_args_parser().parse_args(
            ["--device", "cpu"])),
        "demo": lambda: demo.main(demo.get_args_parser().parse_args(
            ["--demo_path", str(tmp_path), "--save_path", str(tmp_path)])),
        "eval": lambda: teval.main(teval.get_args_parser().parse_args(
            ["--exp_path", str(tmp_path)])),
        "app": lambda: app.reconstruct(str(tmp_path), device="cpu"),
        "train": lambda: TT.train(TT.get_args_parser().parse_args(
            _cli_args(tmp_path, 1))),
    }
    try:
        with pytest.raises(_Stop):
            calls[entry]()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        TC.set_tf32_policy()
    assert TC.set_tf32_policy() == {"matmul": False, "conv": False}


def test_eval_warm_up_builds_the_native_library(monkeypatch):
    """C3: the eval's warm-up builds (loads) the native geometry library,
    so its g++ build stays out of the first scene's clock."""
    from spann3r_torch import api, native
    from spann3r_torch import eval as teval

    calls = []
    monkeypatch.setattr(native, "load", lambda: calls.append("native"))
    monkeypatch.setattr(api, "reconstruct_video",
                        lambda *a, **kw: calls.append("recon"))
    args = teval.get_args_parser().parse_args([])
    teval.warm_up(None, None, None, {"img": np.zeros((20, 1, 8, 8, 3))}, args)
    assert calls == ["native", "recon"]
