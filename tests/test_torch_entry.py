"""The port's entry points on the CPU (`--device cpu`), on the tiny
configurations of tests/test_torch_model.py with the JAX package's weights
(`state_dict_from_jax_params`) at FP32: the demo and eval CLIs end to end
(the artifacts of tests/test_offline_and_demo.py and
tests/test_eval_and_train_cli.py), the bench line (the keys of bench.py,
and its FLOP count against bench.model_flops_per_frame), the app's GLB,
checkpoint loading, and the serving flags.

The bench counts the DPT head with torch's FlopCounterMode (convolutions
and matmuls), the JAX bench with XLA's cost_analysis, which also counts
elementwise work: on the tiny DPT configuration the port's count is 6.5%
(BF16) and 8.2% (BF16_FAST) below XLA's, and HEAD_FLOPS_RANGE holds it
there (PERF.md section 2).
"""
import json
import os
import os.path as osp
import sys
from pathlib import Path

import jax  # noqa: F401  (JAX before torch, as the other port tests)
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench as jax_bench  # noqa: E402
from spann3r_tpu import config as JC  # noqa: E402
from spann3r_tpu.utils import torch_ckpt  # noqa: E402
from spann3r_torch import app as tapp  # noqa: E402
from spann3r_torch import bench as tbench  # noqa: E402
from spann3r_torch import config as TC  # noqa: E402
from spann3r_torch import demo as tdemo  # noqa: E402
from spann3r_torch import eval as teval  # noqa: E402
from spann3r_torch.models import spann3r as TS  # noqa: E402
from spann3r_torch.utils import convert  # noqa: E402
from spann3r_torch.utils.export import read_glb, read_ply  # noqa: E402
from tests.test_torch_eval import image_folder, seven_scenes_root  # noqa: E402,F401
from tests.test_torch_model import HW, _cfg, _models  # noqa: E402

HEAD_FLOPS_RANGE = (0.8, 1.0)   # port count / XLA count of the DPT head


@pytest.fixture
def tiny_model(monkeypatch):
    """The CLIs' load_model on the linear-head tiny model at FP32."""
    _, tcfg, _, _, model = _models("linear")
    for mod in (tdemo, teval):
        monkeypatch.setattr(mod, "load_model",
                            lambda args: (model, tcfg, TC.FP32))
    return model


# ---------------------------------------------------------------------------
# demo, eval, app
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offline", [False, True])
def test_demo_cli_end_to_end(image_folder, tmp_path, tiny_model,  # noqa: F811
                             offline):
    args = tdemo.get_args_parser().parse_args(
        ["--demo_path", image_folder, "--save_path", str(tmp_path),
         "--resolution", "32", "--kf_every", "1", "--device", "cpu"]
        + (["--offline"] if offline else []))
    out, focal, fps = tdemo.main(args)
    assert out == osp.join(str(tmp_path), osp.basename(image_folder))
    assert np.isfinite(focal) and fps > 0
    files = os.listdir(out)
    ply = [f for f in files if f.endswith(".ply")]
    assert ply and "transforms.json" in files
    pts, cols = read_ply(osp.join(out, ply[0]))
    assert pts.shape[1] == 3 and cols.shape == pts.shape
    tj = json.load(open(osp.join(out, "transforms.json")))
    assert len(tj["frames"]) == 4
    npy = [f for f in files if f.endswith(".npy")]
    data = np.load(osp.join(out, npy[0]), allow_pickle=True).item()
    assert data["pts_all"].shape == (4, 32, 32, 3)
    assert data["poses_all"].shape == (4, 4, 4)
    assert data["intrinsic"][0, 0] == pytest.approx(focal)


def test_eval_cli_end_to_end(seven_scenes_root, tmp_path,  # noqa: F811
                             tiny_model, monkeypatch):
    from spann3r_torch.datasets import SevenScenes

    args = teval.get_args_parser().parse_args(
        ["--exp_path", str(tmp_path), "--exp_name", "test", "--resolution",
         "32", "--fp32", "--datasets", "7scenes", "--device", "cpu"])
    monkeypatch.setattr(teval, "build_eval_datasets", lambda a: {
        "7scenes": SevenScenes(split="test", ROOT=seven_scenes_root,
                               resolution=32, num_seq=1, full_video=True,
                               kf_every=2)})
    calls = []
    orig = teval.warm_up
    monkeypatch.setattr(teval, "warm_up",
                        lambda *a: calls.append(a[3]["img"].shape) or orig(*a))
    out = teval.main(args)
    res = out["7scenes"]
    assert len(calls) == 1 and calls[0][0] == 3       # warmed once
    assert np.isfinite(res["metrics"]).all() and len(res["seconds"]) == 1
    save_dir = osp.join(str(tmp_path), "test", "7scenes")
    content = open(osp.join(save_dir, "logs.txt")).read()
    assert "Accuracy" in content and "Average fps" in content
    plys = [f for f in os.listdir(save_dir) if f.endswith(".ply")]
    assert len(plys) >= 2  # pred + gt
    npys = [f for f in os.listdir(save_dir) if f.endswith(".npy")]
    d = np.load(osp.join(save_dir, npys[0]), allow_pickle=True).item()
    assert set(d) == {"images_all", "pts_all", "pts_gt_all", "masks_all",
                      "conf_all"}
    t = d["pts_all"].shape[0]
    assert d["pts_all"].shape == d["pts_gt_all"].shape == (t, 32, 32, 3)
    assert d["images_all"].shape == (t, 32, 32, 3)
    assert d["masks_all"].shape == d["conf_all"].shape == (t, 32, 32)
    assert d["images_all"].min() >= 0.0 and d["images_all"].max() <= 1.0


@pytest.mark.parametrize("as_pointcloud", [False, True])
def test_app_writes_a_glb(image_folder, tmp_path, tiny_model,  # noqa: F811
                          as_pointcloud):
    path = tapp.reconstruct(image_folder, conf_thresh=0.0,
                            as_pointcloud=as_pointcloud, resolution=32,
                            out_dir=str(tmp_path), device="cpu")
    glb = read_glb(path)
    assert glb["positions"].shape[1] == 3 and len(glb["positions"]) > 0
    assert (glb["indices"] is None) == as_pointcloud


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------

def _jax_flops(jcfg, hw, prec, monkeypatch, head: bool):
    import spann3r_tpu.models.heads as jh
    with monkeypatch.context() as m:
        if not head:   # bench.py counts the head inside a try: make it fail
            m.setattr(jh, "init_head", lambda *a, **k: 1 / 0)
        return jax_bench.model_flops_per_frame(jcfg, hw, 2, prec)


@pytest.mark.parametrize("prec", ["BF16", "BF16_FAST"])
def test_bench_flops_match_jax(prec, monkeypatch):
    jcfg, tcfg, _, _, model = _models("dpt")
    hw = HW["dpt"]
    analytic = tbench.transformer_flops_per_frame(tcfg, hw, 2)
    assert analytic == _jax_flops(jcfg, hw, getattr(JC, prec), monkeypatch,
                                  head=False)
    xla_head = _jax_flops(jcfg, hw, getattr(JC, prec), monkeypatch,
                          head=True) - analytic
    head = tbench.head_flops_per_frame(model, tcfg, hw, 2, getattr(TC, prec))
    lo, hi = HEAD_FLOPS_RANGE
    assert lo * xla_head <= head <= hi * xla_head, head / xla_head
    assert tbench.model_flops_per_frame(model, tcfg, hw, 2,
                                        getattr(TC, prec)) == analytic + head


def test_bench_full_width_flops():
    """~1.1 TFLOP per frame at 512x384 outside the head (PERF.md)."""
    f = tbench.transformer_flops_per_frame(TC.Spann3RConfig(), (384, 512), 1)
    assert 1.0e12 < f < 1.2e12


# the keys of the JSON line of the JAX package's bench.py (bench.py:268-289,
# :180-191), plus the card's name and the port's TF32 policy
STREAM_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_frame",
               "mfu_pct", "streams", "precision", "sync", "reps",
               "fps_spread", "tf32", "device"}
OFFLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_frame",
                "frames", "mode", "reps", "fps_spread", "precision", "tf32",
                "device"}


@pytest.mark.parametrize("flags,keys", [
    ([], STREAM_KEYS),
    (["--sync_per_chunk", "--streams", "2", "--bf16_heads"],
     STREAM_KEYS | {"chunk_fps"}),
    (["--offline"], OFFLINE_KEYS)])
def test_bench_line(flags, keys, tmp_path):
    args = tbench.get_args_parser().parse_args(
        ["--height", "64", "--width", "64", "--frames", "4", "--chunk", "2",
         "--reps", "2", "--device", "cpu", "--profile", str(tmp_path)] + flags)
    line = tbench.run(args, cfg=_cfg(TC, "dpt"))
    assert set(line) == keys
    assert line["value"] > 0 and line["reps"] == 2 and line["device"] == "cpu"
    assert line["tf32"] == {"matmul": False, "conv": False}
    assert line["fps_spread"][0] <= line["fps_spread"][1]
    if "--offline" not in flags:
        assert line["mfu_pct"] is None       # no peak for the CPU
        assert line["metric"] == "incremental_recon_fps_64x64"
        assert (tmp_path / "trace.json").exists()
    json.dumps(line)


def test_bench_defaults_match_jax():
    import argparse
    import inspect
    src = inspect.getsource(jax_bench.main)
    port = {a.dest: a.default for a in tbench.get_args_parser()._actions
            if not isinstance(a, argparse._HelpAction)}
    for dest, default in port.items():
        if dest == "device":
            assert default == "cuda"
            continue
        assert f'"--{dest}"' in src, dest
        if default is not None and not isinstance(default, bool):
            assert f'"--{dest}", type={type(default).__name__}, ' \
                   f'default={default!r}' in src, dest


# ---------------------------------------------------------------------------
# model loading and the serving flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli", [tdemo, teval, tbench, tapp])
def test_entry_points_default_to_the_card(cli):
    """--device defaults to cuda; without a card the build raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if cli is tapp:
            tapp.reconstruct("unused", resolution=32)
        elif cli is tbench:
            tbench.run(tbench.get_args_parser().parse_args([]))
        else:
            cli.load_model(cli.get_args_parser().parse_args([]))


@pytest.mark.parametrize("cli", [tdemo, teval])
@pytest.mark.parametrize("flags", [[], ["--fp32"], ["--int8"], ["--int8", "2"]])
def test_load_model_serving_flags(cli, flags, monkeypatch, tmp_path, capsys):
    """bf16 storage unless --fp32; --int8 quantises with the activation
    floor only at 2, through the call's argument and not an environment
    variable; a missing checkpoint gives the seeded random init."""
    from spann3r_torch.ops import quant

    tcfg = _cfg(TC, "linear")
    monkeypatch.setattr(TC, "Spann3RConfig", lambda **kw: tcfg)
    seen = []
    orig = quant.quantize_linear_weights_
    monkeypatch.setattr(quant, "quantize_linear_weights_", lambda m, **kw: (
        seen.append(kw), orig(m, min_dim=16, **kw))[1])
    path = ["--ckpt_path", str(tmp_path / "none.pth")] if cli is tdemo else \
        ["--exp_path", str(tmp_path)]
    args = cli.get_args_parser().parse_args(flags + path + ["--device", "cpu"])
    env = dict(os.environ)
    model, cfg, prec = cli.load_model(args)
    assert os.environ == env
    assert "random init" in capsys.readouterr().out
    assert prec == (TC.FP32 if "--fp32" in flags else TC.BF16)
    int8 = "--int8" in flags and (cli is tdemo or "--fp32" not in flags)
    rows = quant.INT8_ACT_ROWS if "2" in flags else 0
    assert seen == ([{"act_min_rows": rows}] if int8 else [])
    assert (quant.count_quantized(model) > 0) == int8
    dtypes = {p.dtype for n, p in model.named_parameters()
              if n.startswith("dust3r.enc_blocks.0.attn")}
    assert dtypes == ({torch.float32} if "--fp32" in flags and not int8
                      else {torch.bfloat16})
    ref = TS.build_spann3r(tcfg, "cpu", torch.Generator().manual_seed(0))
    w = model.attn_head_1[0].weight
    np.testing.assert_array_equal(
        w.detach().float().numpy(),
        ref.attn_head_1[0].weight.detach().to(w.dtype).float().numpy())


def test_load_spann3r_checkpoint(tmp_path):
    """A .pth written from the JAX parameters, with DDP's `module.` prefix
    and an alias key added, gives the JAX package's predictions."""
    jcfg, tcfg, params, params_np, _ = _models("dpt")
    sd = torch_ckpt.to_torch_state_dict_spann3r(params_np, jcfg)
    state = {"module." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    state["module.dust3r.downstream_head1.dpt.scratch.layer_rn.0.weight"] = \
        state["module.dust3r.downstream_head1.dpt.scratch.layer1_rn.weight"]
    state["module.dust3r.mask_token"] = torch.zeros(1, 1, 16)
    path = tmp_path / "spann3r.pth"
    torch.save({"model": state, "epoch": 3}, path)

    model = TS.build_spann3r(tcfg, "cpu", torch.Generator().manual_seed(7))
    assert convert.load_spann3r_checkpoint(str(path), model) is model
    from spann3r_tpu import api as japi
    from spann3r_torch import api as tapi
    frames = np.random.default_rng(8).standard_normal(
        (3, 1, *HW["dpt"], 3)).astype(np.float32) * 0.3
    want, _, _ = japi.reconstruct_video(params, jcfg, frames, JC.FP32)
    got, _, _ = tapi.reconstruct_video(model, tcfg, frames, TC.FP32)
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=5e-4,
                                       atol=5e-4)

    del state["module.value_norm.bias"]
    torch.save(state, path)
    with pytest.raises(RuntimeError, match="value_norm.bias"):
        convert.load_spann3r_checkpoint(str(path), model)
