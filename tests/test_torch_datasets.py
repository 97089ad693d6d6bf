"""The port's training datasets against the JAX package's, on the CPU: the
six file-reading datasets (ScanNet, ScanNet++, ARKitScenes, BlendedMVS,
CO3D, Habitat) on trees in each one's layout written from a seed
(`spann3r_torch.tools.dataset_fixtures`, shrunk 8x), their mixture through
both registries, the Habitat generator, the CroCo pair dataset and the
crop extraction. Every comparison is bit for bit: the port's modules are
copies of the JAX package's (held equal by tests/test_torch_eval.py), so
the same files and seeds must give the same arrays.
"""
import os
import os.path as osp

import numpy as np
import PIL.Image
import pytest

from spann3r_torch.datasets import REGISTRY as T_REGISTRY
from spann3r_torch.datasets import build_dataset as t_build
from spann3r_torch.datasets import pairs as TP
from spann3r_torch.habitat_gen import scripts as TS
from spann3r_torch.tools import dataset_fixtures as F
from spann3r_torch.tools import extract_crops as TX
from spann3r_tpu.datasets import REGISTRY as J_REGISTRY
from spann3r_tpu.datasets import build_dataset as j_build
from spann3r_tpu.datasets import pairs as JP
from spann3r_tpu.habitat_gen import scripts as JS
from spann3r_tpu.tools import extract_crops as JX

VIEW_KEYS = ("img", "depthmap", "pts3d", "camera_pose", "camera_intrinsics",
             "valid_mask", "true_shape")
RES = (64, 48)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree per dataset: 2 scenes of 12 frames (Habitat: 3 clips of 5
    views a scene), at 1/8 of the raw sizes; {kind: the kwargs that build
    the dataset}."""
    root = tmp_path_factory.mktemp("train_sets")
    return {kind: F.write_tree(kind, str(root / kind), seed=i, scenes=2,
                               frames=3 if kind == "habitat" else 12,
                               shrink=8)
            for i, kind in enumerate(F.KINDS)}


def _assert_same_views(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in VIEW_KEYS:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (a["label"], a["instance"]) == (b["label"], b["instance"])


def _pair(expr):
    a, b = t_build(expr), j_build(expr)
    a.set_epoch(0)
    b.set_epoch(0)
    return a, b


def test_registries_hold_the_same_datasets():
    assert list(T_REGISTRY) == list(J_REGISTRY)
    for name in ("Scannet", "Scannetpp", "ArkitScene", "BlendMVS", "Co3d",
                 "habitat"):
        assert T_REGISTRY[name].__module__.startswith("spann3r_torch.")


@pytest.mark.parametrize("kind", F.KINDS)
def test_dataset_gives_the_jax_views(trees, kind):
    """Every item of the dataset, built from its registry expression, gives
    the JAX package's views bit for bit (images, depth, pts3d, pose,
    intrinsics, valid masks), with finite poses and valid depth."""
    a, b = _pair(F.expression(kind, trees[kind], 6, RES))
    assert len(a) == len(b) == 6
    for i in range(len(a)):
        views = a[i]
        _assert_same_views(views, b[i])
        assert len(views) == 5
        for v in views:
            assert v["img"].shape == (RES[1], RES[0], 3)
            assert np.isfinite(v["camera_pose"]).all()
            assert v["valid_mask"].mean() > 0.5


def test_co3d_combinatorial_tuples(trees):
    """CO3D's default tuple sampler (stride-5 combinations, +-4 jitter) at
    3 frames a clip: the same views as the JAX package's."""
    kw = dict(trees["Co3d"], use_comb=True)
    expr = F.expression("Co3d", kw, 4, RES, num_frames=3)
    a, b = _pair(expr)
    for i in range(len(a)):
        _assert_same_views(a[i], b[i])


def test_mixture_through_both_registries(trees):
    """The six datasets in one mixture expression (the reference's form)
    give the same length and the same views in both packages."""
    expr = " + ".join(F.expression(k, trees[k], 3, RES) for k in F.KINDS)
    a, b = _pair(expr)
    assert len(a) == len(b) == 18
    for i in range(len(a)):
        _assert_same_views(a[i], b[i])


def _generate(mod, out, **kw):
    mod.generate_multiview_images_for_scene(
        scene_dataset_config_file="", scene="__boxroom__", navmesh="",
        output_dir=out, views_count=3, size=2, generate_depth=True,
        resolution=(24, 32), hfov=70, minimum_covisibility=0.2, seed=3, **kw)


def test_habitat_generator_gives_the_jax_files(tmp_path):
    """The port's generator writes the JAX package's files for the same
    seed: the same names, pixels, depth and camera parameters."""
    _generate(TS, str(tmp_path / "t"))
    _generate(JS, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) > 6
    for n in names:
        a, b = tmp_path / "t" / n, tmp_path / "j" / n
        if n.endswith(".jpeg"):
            np.testing.assert_array_equal(np.asarray(PIL.Image.open(a)),
                                          np.asarray(PIL.Image.open(b)))
        elif n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert a.read_bytes() == b.read_bytes(), n


def test_habitat_cli_output_feeds_both_habitat_datasets(tmp_path, monkeypatch):
    """`python -m spann3r_torch.habitat_gen.scripts --scene __boxroom__`
    (its main) writes clips that the port's and the JAX package's
    `habitat` read into the same views."""
    out = tmp_path / "hab" / "boxroom" / "scene0"
    monkeypatch.setattr("sys.argv", [
        "scripts", "--scene", "__boxroom__", "--output_dir", str(out),
        "--views_count", "5", "--size", "2", "--resolution", "48", "64"])
    TS.main()
    expr = (f"2 @ habitat(num_seq=2, ROOT={str(tmp_path / 'hab')!r}, "
            f"resolution={RES}, seed=5)")
    a, b = _pair(expr)
    for i in range(len(a)):
        _assert_same_views(a[i], b[i])


@pytest.fixture
def habitat_release(tmp_path):
    """A habitat_release of pairs from the port's generator (2 views a
    tuple), with its pairs.txt cache."""
    rel = tmp_path / "habitat_release"
    for s in range(2):
        TS.generate_multiview_images_for_scene(
            scene_dataset_config_file="", scene="__boxroom__", navmesh="",
            output_dir=str(rel / f"scene{s}"), views_count=2, size=3,
            generate_depth=False, resolution=(40, 48), hfov=60,
            minimum_covisibility=0.2, seed=s)
    return tmp_path


def test_pairs_cache_and_dataset_match_jax(habitat_release):
    root = str(habitat_release)
    cache = TP.parse_and_cache_all_pairs("habitat_release", root)
    text = open(cache).read()
    os.remove(cache)
    JP.parse_and_cache_all_pairs("habitat_release", root)
    assert open(cache).read() == text and len(text.splitlines()) == 6
    a = TP.PairsDataset("habitat_release", trfs="crop32+acolor",
                        data_dir=root, seed=4)
    b = JP.PairsDataset("habitat_release", trfs="crop32+acolor",
                        data_dir=root, seed=4)
    assert len(a) == len(b) == 6
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            assert x.shape == (32, 32, 3) and x.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_extract_crops_matches_jax(tmp_path):
    """The crop extraction writes the JAX tool's listing and pixels."""
    root = tmp_path / "root"
    root.mkdir()
    rng = np.random.default_rng(6)
    for name in ("imgA.jpg", "imgB.jpg", "imgC.jpg"):
        PIL.Image.fromarray(rng.integers(0, 255, (70, 90, 3), dtype=np.uint8)
                            ).save(root / name)
    crops = tmp_path / "crops.txt"
    crops.write_text("# crops\nimgA.jpg, imgB.jpg, 179\n"
                     "0, 40, 0, 40, 10, 50, 10, 50\n"
                     "5, 85, 5, 65, 0, 80, 0, 60\n"
                     "imgB.jpg, imgC.jpg, 90\n0, 30, 0, 30, 20, 50, 20, 50\n"
                     "imgA.jpg, missing.jpg, 0\n0, 16, 0, 16, 0, 16, 0, 16\n")
    outs = {}
    for name, mod in (("t", TX), ("j", JX)):
        out = tmp_path / name
        mod.main(mod.arg_parser().parse_args(
            ["--crops", str(crops), "--root-dir", str(root), "--output-dir",
             str(out), "--imsize", "24", "--nthread", "1",
             "--ideal-number-pairs-in-dir", "2"]))
        outs[name] = out
    listing = (outs["t"] / "listing.txt").read_text()
    assert listing == (outs["j"] / "listing.txt").read_text()
    paths = listing.splitlines()[1:]
    assert len(paths) == 3
    for p in paths:
        for s in ("_1.jpg", "_2.jpg"):
            np.testing.assert_array_equal(
                np.asarray(PIL.Image.open(osp.join(outs["t"], p + s))),
                np.asarray(PIL.Image.open(osp.join(outs["j"], p + s))))


def test_nested_mixture_draws_each_epoch(trees):
    """`2 @ (100 @ A + 100 @ B)`: the outer map picks an item of the inner
    mixture, which draws its own maps each epoch, so that an item of the
    nested expression is the flat mixture's item at the outer map's index,
    and the items move between epochs as the flat mixture's do. The JAX
    copy never sets the inner maps and refuses the first item."""
    inner = " + ".join(F.expression(k, trees[k], 100, RES)
                       for k in ("Co3d", "BlendMVS"))
    nested, flat = t_build(f"2 @ ({inner})"), t_build(inner)
    jax_nested = j_build(f"2 @ ({inner})")
    jax_nested.set_epoch(0)
    with pytest.raises(AssertionError, match="set_epoch"):
        jax_nested[0]
    got = []
    for epoch in (0, 1):
        for ds in (nested, flat):
            ds.set_epoch(epoch)
            ds.set_ratio(0.5)
        assert [d.dataset.train_ratio for d in nested.dataset.datasets] == \
            [0.5, 0.5]
        i = int(nested._idxs_mapping[0])
        views = nested[0]
        _assert_same_views(views, flat[i])
        got.append(views)
    assert any(not np.array_equal(a["img"], b["img"])
               for a, b in zip(*got))
