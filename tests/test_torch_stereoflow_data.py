"""The port's stereo and flow datasets and drivers on fixture trees, on the
CPU: the SceneFlow, FlyingChairs and KITTI 2015 trees of
`tools/stereoflow_fixtures.py` read bit for bit as the JAX package reads
them (augmentor crops included), and both drivers end to end (train with
tiled validation, resume, --pretrained and --start_from, test with --save
metrics pred visu, the `python -m` entry point, the refusal without a
card).
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spann3r_tpu.stereoflow import datasets as jsfd
from spann3r_torch.models import croco_pretrain as TCP
from spann3r_torch.stereoflow import datasets as tsfd
from spann3r_torch.stereoflow import driver as TDR
from spann3r_torch.tools import stereoflow_fixtures as fx

REPO = Path(__file__).resolve().parent.parent
# head dim 64, RoPE100: K2 and K3 as on the card
NARROW = ("CroCoNet(enc_embed_dim=64, enc_depth=2, enc_num_heads=1, "
          "dec_embed_dim=64, dec_depth=2, dec_num_heads=1, "
          "pos_embed='RoPE100')")
# the train crop by task: SceneFlow's eighth-size frames (120x67) take six
# tiles of it, FlyingChairs' (64x48) two
CROP = {"stereo": ["48", "96"], "flow": ["32", "48"]}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The three fixture trees at an eighth of their raw sizes."""
    root = str(tmp_path_factory.mktemp("stereoflow_data"))
    for seed, kind in enumerate(fx.KINDS):
        fx.write_tree(kind, root, seed=seed, pairs=4, shrink=8)
    return root


@pytest.fixture
def both_roots(data_root, monkeypatch):
    for m in (jsfd, tsfd):
        monkeypatch.setattr(m, "DATA_ROOT", data_root)
    return data_root


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("cls,split,crop", [
    ("SceneFlowDataset", "train_finalpass", (32, 48)),
    ("SceneFlowDataset", "test_finalpass", None),
    ("FlyingChairsDataset", "train", (32, 48)),
    ("FlyingChairsDataset", "val", None),
    ("Kitti15Dataset", "train", (32, 64)),
    ("Kitti15Dataset", "test", None),
    ("Kitti15FlowDataset", "subtrain", (32, 64)),
])
def test_fixture_trees_read_as_in_the_jax_package(both_roots, cls, split,
                                                  crop):
    """Every item (images, gt with its +inf holes or None, pair name) of
    each split, bit for bit, with the augmentor's crops from one seed."""
    kw = dict(split=split)
    if crop is not None:
        kw.update(augmentor=True, crop_size=crop, seed=5)
    jd, td = getattr(jsfd, cls)(**kw), getattr(tsfd, cls)(**kw)
    assert len(td) == len(jd) > 0 and str(td) == str(jd)
    for i in range(len(jd)):
        for a, b in zip(td[i], jd[i]):
            _same(a, b)
    img1, _, gt, _ = td[0]
    if crop is not None:
        assert img1.shape == (*crop, 3)
    if cls == "Kitti15Dataset" and split == "train":
        assert 0.05 < float(np.isinf(gt).mean()) < 0.15


def test_fixture_sizes_and_caches(data_root):
    """Raw sizes divided by the shrink; the split caches in the dataset
    layout (datasets_<task>_cache/<name>.pkl) with every split the real
    scan writes."""
    import PIL.Image
    sf = os.path.join(data_root, "SceneFlow", fx._SCENEFLOW_TRAIN.format(0))
    assert PIL.Image.open(sf).size == (120, 67)
    with open(os.path.join(data_root, "datasets_stereo_cache",
                           "SceneFlow.pkl"), "rb") as f:
        splits = pickle.load(f)
    assert {"train_finalpass", "test_allpass", "test1of100_cleanpass"} <= \
        set(splits) and len(splits["train_finalpass"]) == 4
    with open(os.path.join(data_root, "datasets_flow_cache",
                           "Kitti15.pkl"), "rb") as f:
        assert set(pickle.load(f)) == {"train", "test", "subtrain", "subval"}
    with pytest.raises(ValueError):
        fx.write_tree("Spring", data_root)


def _train_args(task, out, dataset, extra=()):
    return TDR.get_args_parser().parse_args([
        task, "--output_dir", out, "--model", NARROW, "--dataset", dataset,
        "--crop", *CROP[task], "--batch_size", "2", "--img_per_epoch", "2", "--epochs", "1", "--fp32",
        "--tile_batch", "4", "--device", "cpu", *extra])


@pytest.mark.parametrize("task,train,val", [
    ("stereo", "SceneFlow(split='train_finalpass')",
     "SceneFlow(split='test_finalpass')"),
    ("flow", "FlyingChairs(split='train')", "FlyingChairs(split='val')")])
def test_drivers_end_to_end(both_roots, tmp_path, task, train, val):
    """Train one epoch with tiled validation (best and last checkpoints,
    the sidecar, log.txt), resume to a second epoch, then test with --save
    metrics pred visu."""
    out = str(tmp_path / "run")
    res = TDR.main(_train_args(task, out, train, ["--val_dataset", val]))
    assert np.isfinite(res["last_train"]["loss"]) and np.isfinite(res["best"])
    for f in ("checkpoint-last.pth", "checkpoint-best.pth",
              "stereoflow_args.json", "log.txt"):
        assert os.path.isfile(os.path.join(out, f)), f
    meta = json.load(open(os.path.join(out, "stereoflow_args.json")))
    assert meta["task"] == task and meta["num_channels"] == (
        2 if task == "stereo" else 3)

    w1 = {n: p.clone() for n, p in res["model"].named_parameters()}
    res2 = TDR.main(_train_args(task, out, train,
                                ["--val_dataset", val, "--epochs", "2"]))
    assert int(res2["opt_state"].count) == 2 * int(res["opt_state"].count)
    assert any(not torch.equal(w1[n], p)
               for n, p in res2["model"].named_parameters())
    assert len(open(os.path.join(out, "log.txt")).readlines()) == 2

    results = TDR.test_main(TDR.get_test_args_parser().parse_args([
        "--model", out, "--dataset", val, "--tile_batch", "4", "--fp32",
        "--device", "cpu", "--save", "metrics", "pred", "visu"]))
    (dname, metrics), = results.items()
    key = "bad@1.0" if task == "stereo" else "EPE"
    assert key in metrics and np.isfinite(metrics["L1err"])
    found = [f for _, _, fs in os.walk(out) for f in fs]
    assert any(f.endswith("_pred.npy") for f in found)
    assert any(f.endswith("_pred.png") for f in found)
    assert "metrics.pkl" in found


def test_pretrained_and_start_from(both_roots, tmp_path):
    """--pretrained reads a reference CroCo checkpoint (croco_kwargs, the
    mask token, prediction head and stored sin-cos tables dropped);
    --start_from a reference stereoflow one (CroCo keys at the top level,
    the head under head., the DPT scratch's aliases dropped)."""
    cfg, _ = TCP.parse_croco_model(NARROW)
    croco = TCP.build_croco(cfg, "cpu", torch.Generator().manual_seed(7))
    sd = dict(croco.state_dict(), enc_pos_embed=torch.zeros(6, 64))
    pth = str(tmp_path / "croco.pth")
    torch.save({"model": sd, "croco_kwargs": TCP.croco_kwargs_from_cfg(cfg)},
               pth)
    res = TDR.main(_train_args("stereo", str(tmp_path / "a"),
                               "SceneFlow(split='train_finalpass')",
                               ["--pretrained", pth, "--epochs", "0"]))
    model = res["model"]
    for k, v in croco.state_dict().items():
        if not k.startswith(("mask_token", "prediction_head")):
            assert torch.equal(model.croco.state_dict()[k], v), k

    ref = {k[len("croco."):] if k.startswith("croco.") else k: v
           for k, v in model.state_dict().items()}
    ref["head.dpt.scratch.layer_rn.0.weight"] = ref[
        "head.dpt.scratch.layer1_rn.weight"]
    pth2 = str(tmp_path / "stereo.pth")
    torch.save({"model": ref}, pth2)
    res = TDR.main(_train_args("stereo", str(tmp_path / "b"),
                               "SceneFlow(split='train_finalpass')",
                               ["--start_from", pth2, "--epochs", "0",
                                "--seed", "3"]))
    for k, v in model.state_dict().items():
        assert torch.equal(res["model"].state_dict()[k], v), k


def test_test_cli_runs_as_a_module(both_roots, tmp_path):
    """`python -m spann3r_torch.stereoflow_test` on a checkpoint the train
    driver wrote, the data root from the environment."""
    out = str(tmp_path / "run")
    TDR.main(_train_args("stereo", out, "SceneFlow(split='train_finalpass')"))
    env = dict(os.environ, SPANN3R_STEREOFLOW_DATA=both_roots,
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "spann3r_torch.stereoflow_test", "--model",
         out, "--dataset", "SceneFlow(split='test_finalpass')", "--device",
         "cpu", "--fp32", "--save", "metrics"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SceneFlowDataset_test_finalpass" in proc.stdout


def test_drivers_refuse_without_a_card(both_roots, tmp_path):
    args = _train_args("stereo", str(tmp_path / "a"),
                       "SceneFlow(split='train_finalpass')")
    args.device = "cuda"
    with pytest.raises(RuntimeError):
        TDR.main(args)
    with pytest.raises(RuntimeError):
        TDR.test_main(TDR.get_test_args_parser().parse_args([
            "--model", str(tmp_path / "a"), "--dataset",
            "SceneFlow(split='test_finalpass')"]))
