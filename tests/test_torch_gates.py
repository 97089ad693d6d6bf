"""The port's gates on the CPU: `synth_chamfer` against the JAX package's on
the same weights, the convergence gate's miniature (the real trainer with
remat, from random init, must improve the held-out eval loss and the
reconstruction), the int8 and BF16_FAST serving gates on random weights,
the readiness drill through the port's eval, and the invariants of the
gate artifacts committed from the card (tests/data/torch_*gate*.json).

Tolerances: synth_chamfer on the same weights and scenes, FP32, 1e-4
relative (the two sides' reconstructions differ by fp32 sums in another
order; the metrics are means of nearest-neighbour distances).
"""
import glob
import json
import os
import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from spann3r_torch import config as TC
from spann3r_torch import training as TT
from spann3r_torch.models import spann3r as TS
from spann3r_torch.tools import bf16fast_gate, convergence, int8_gate
from spann3r_torch.tools import readiness_drill as port_drill
from spann3r_torch.utils import convert

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
DATA = osp.join(REPO, "tests", "data")
CHAMFER_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: at these shapes more threads only contend with
    the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(mod):
    """The convergence test's and the readiness drill's tiny configuration."""
    return mod.Spann3RConfig(
        dust3r=mod.DUSt3RConfig(img_size=(32, 32), patch_size=16,
                                enc=mod.ViTConfig(dim=64, depth=2, num_heads=4),
                                dec=mod.ViTConfig(dim=48, depth=12, num_heads=4),
                                head_type="linear"),
        value_enc_depth=2, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64)


CHAMFER_EXPR = ("SynthRoom(num_seq=2, resolution=32, seq_len=8, kf_every=2, "
                "full_video=True, scene_seed=9)")


def test_synth_chamfer_matches_jax():
    from spann3r_tpu import config as JC
    from spann3r_tpu.datasets import build_dataset as jax_build_dataset
    from spann3r_tpu.models import spann3r as JS
    from spann3r_tpu.tools.convergence import synth_chamfer as jax_chamfer
    from spann3r_torch.datasets import build_dataset

    params = JS.init_spann3r(jax.random.PRNGKey(3), tiny_cfg(JC))
    model = TS.build_spann3r(tiny_cfg(TC), "cpu",
                             torch.Generator().manual_seed(0))
    model.load_state_dict(convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tiny_cfg(TC)), strict=True)
    want = jax_chamfer(params, tiny_cfg(JC), JC.FP32,
                       jax_build_dataset(CHAMFER_EXPR), 2)
    got = convergence.synth_chamfer(model, tiny_cfg(TC), TC.FP32,
                                    build_dataset(CHAMFER_EXPR), 2)
    assert got["n_scenes"] == want["n_scenes"] == 2
    for k in ("acc", "comp", "chamfer"):
        assert abs(got[k] - want[k]) <= CHAMFER_TOL * abs(want[k]), (k, got,
                                                                    want)


def _gate_args(out):
    """The recipe of tests/test_convergence.py's CPU miniature, with remat."""
    args = TT.get_args_parser().parse_args([])
    args.resolution = 32
    args.head_type = "linear"
    args.num_frames = 3
    args.batch_size = 8
    args.batch_size_test = 2
    args.epochs = 3
    args.warmup_epochs = 1
    args.lr = 1e-3
    args.min_lr = 1e-5
    args.eval_freq = 1
    args.save_freq = 1
    args.keep_freq = 0
    args.print_freq = 4
    args.num_workers = 1
    args.bf16 = 0
    args.remat = 1
    args.device = "cpu"
    args.output_dir = str(out)
    args.seed = 0
    args.train_dataset = ("64 @ SynthRoom(num_seq=8, num_frames=3, "
                          "resolution=32, seq_len=12, min_thresh=1, "
                          "max_thresh=2)")
    args.test_dataset = ("SynthRoom(num_seq=4, num_frames=3, resolution=32, "
                         "seq_len=12, scene_seed=5, seed=777, min_thresh=1, "
                         "max_thresh=2)")
    return args


def test_convergence_gate_cpu(tmp_path):
    """The port's run_gate on the miniature recipe (remat = 1): the eval
    loss falls by a clear margin and the reconstruction accuracy (pred to
    GT) improves; the best-on-eval checkpoint and the per-epoch curve are
    written. As in the JAX miniature, completion (GT to pred) starts
    degenerately good on a random-init cloud that sprays points over a
    large volume, so the miniature gates accuracy and the card's gate
    (hundreds of steps) gates the chamfer."""
    args = _gate_args(tmp_path / "gate")
    artifact = convergence.run_gate(args, tiny_cfg(TC), CHAMFER_EXPR,
                                    n_chamfer_scenes=2,
                                    artifact_path=str(tmp_path / "gate.json"))
    before, after = artifact["before"], artifact["after"]
    assert after["eval"]["loss_med"] < 0.9 * before["eval"]["loss_med"], \
        (before["eval"], after["eval"])
    assert artifact["eval_improved"]
    assert after["chamfer"]["acc"] < before["chamfer"]["acc"], \
        (before["chamfer"], after["chamfer"])
    assert osp.exists(osp.join(args.output_dir, "checkpoint-best.pth"))
    assert len(artifact["curve"]) >= args.epochs
    assert artifact["remat"] and artifact["device"] == "cpu"
    assert json.load(open(tmp_path / "gate.json"))["epochs"] == args.epochs


def _serving_args(parser, tmp_path, *extra):
    return parser.parse_args(["--ckpt", str(tmp_path / "missing.pth"),
                              "--resolution", "32", "--n_scenes", "2",
                              "--device", "cpu", *extra])


@pytest.mark.parametrize("act", [0, 16])
def test_int8_gate_random_weights(tmp_path, act):
    """The int8 gate at the tiny size on random weights: both arms run,
    matrices were quantised, and the artifact holds the gate's fields."""
    args = _serving_args(int8_gate.get_args_parser(), tmp_path,
                         "--min_dim", "32", "--act", str(act))
    a = int8_gate.run(args, cfg=tiny_cfg(TC))
    assert a["ckpt"] == "random_init" and a["quantized_matrices"] > 0
    assert a["int8_act_min_rows"] == act
    for arm in ("bf16", "int8"):
        assert a[arm]["n_scenes"] == 2 and np.isfinite(a[arm]["chamfer"])
    rel = (a["int8"]["chamfer"] - a["bf16"]["chamfer"]) / a["bf16"]["chamfer"]
    assert a["chamfer_rel_delta"] == pytest.approx(rel)
    assert a["pass"] == (abs(rel) <= a["rel_bound"])


def test_int8_gate_refuses_a_vacuous_comparison(tmp_path):
    args = _serving_args(int8_gate.get_args_parser(), tmp_path)
    with pytest.raises(AssertionError, match="no matrices quantized"):
        int8_gate.run(args, cfg=tiny_cfg(TC))


def test_bf16fast_gate_random_weights(tmp_path):
    args = _serving_args(bf16fast_gate.get_args_parser(), tmp_path)
    a = bf16fast_gate.run(args, cfg=tiny_cfg(TC))
    for arm in ("bf16", "bf16_fast"):
        assert a[arm]["n_scenes"] == 2 and np.isfinite(a[arm]["chamfer"])
    assert a["pass"] == (abs(a["chamfer_rel_delta"]) <= a["rel_bound"])


def test_readiness_drill_tiny(tmp_path):
    """The port's --tiny drill through `python -m`: fixtures of the four
    datasets, the tiny .pth, the port's eval on the CPU, the table."""
    data, exp = tmp_path / "data", tmp_path / "ckpts"
    proc = subprocess.run(
        [sys.executable, "-m", "spann3r_torch.tools.readiness_drill",
         "--fixtures", str(data), "--tiny", "--exp_path", str(exp),
         "--exp_name", "drill", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "READINESS DRILL PASSED" in proc.stdout
    import zipfile
    assert zipfile.is_zipfile(exp / "spann3r.pth")
    for name in ("7scenes", "NRGBD", "Replica", "DTU"):
        log = (exp / "drill" / name / "logs.txt").read_text()
        assert f"Dataset: {name}, Accuracy:" in log
        assert "Average fps" in log
        assert f"| {name} |" in proc.stdout
    assert "| Dataset | Acc | Comp |" in proc.stdout


def test_readiness_fixtures_match_the_root_tool(tmp_path):
    """The port's fixtures are the root tool's, byte for byte."""
    from tools import readiness_drill as root_drill

    a, b = tmp_path / "root", tmp_path / "port"
    assert root_drill.fabricate_all(str(a)) == port_drill.fabricate_all(str(b))
    files_a = sorted(osp.relpath(p, a) for p in glob.glob(f"{a}/**/*",
                                                          recursive=True)
                     if osp.isfile(p))
    files_b = sorted(osp.relpath(p, b) for p in glob.glob(f"{b}/**/*",
                                                          recursive=True)
                     if osp.isfile(p))
    assert files_a == files_b and len(files_a) > 100
    for rel in files_a:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


# ---------------------------------------------------------------------------
# the artifacts committed from the card
# ---------------------------------------------------------------------------

def _artifact(name):
    with open(osp.join(DATA, name)) as f:
        return json.load(f)


def _on_nvidia(d):
    # nvidia-smi's "name, power.limit", e.g. "NVIDIA H100 80GB HBM3, 700.00 W"
    assert d["device"].startswith("NVIDIA") and d["device"].endswith(" W"), \
        d["device"]


@pytest.mark.parametrize("name", ["torch_convergence_gate.json"] + sorted(
    osp.basename(p) for p in glob.glob(osp.join(
        DATA, "torch_convergence_gate_deep.json"))))
def test_convergence_gate_artifact(name):
    d = _artifact(name)
    _on_nvidia(d)
    assert d["remat"] and d["epochs"] >= 4
    assert d["eval_improved"] and d["chamfer_improved"], d
    assert d["after"]["eval"]["loss_med"] < d["before"]["eval"]["loss_med"]
    assert d["after"]["chamfer"]["chamfer"] < d["before"]["chamfer"]["chamfer"]
    if "kill_resume" in d:
        kr, sched = d["kill_resume"], d["schedule"]
        assert kr["child_rc"] != 0 and kr["curve_continuous"], kr
        assert sched["alpha_c2f_kink_crossed"], sched
        assert sched["active_ratio_decay_crossed"], sched


@pytest.mark.parametrize("name,arm", [("torch_int8_gate.json", "int8"),
                                      ("torch_int8_act_gate.json", "int8"),
                                      ("torch_bf16fast_gate.json",
                                       "bf16_fast")])
def test_serving_gate_artifact(name, arm):
    d = _artifact(name)
    _on_nvidia(d)
    assert d["ckpt"] != "random_init" and d["pass"]
    assert abs(d["chamfer_rel_delta"]) <= d["rel_bound"] == 0.05
    rel = (d[arm]["chamfer"] - d["bf16"]["chamfer"]) / d["bf16"]["chamfer"]
    assert d["chamfer_rel_delta"] == pytest.approx(rel)
    if arm == "int8":
        assert d["quantized_matrices"] > 0
        assert d["int8_act_min_rows"] == (256 if "act" in name else 0)
