"""Stereo and optical-flow dataset zoo.

Reference: croco/stereoflow/datasets_stereo.py + datasets_flow.py.  Each
dataset is a pairname list (cached to a pickle on first scan) plus
filename-mapping lambdas and a format-specific gt loader; training applies
the stereo/flow augmentor, and __getitem__ yields
(img1, img2, gt, str(pairname)) with images as in1k-normalized HWC float32
(the reference's img_to_tensor transposed), gt as (H, W, 1) disparity /
(H, W, 2) flow with +inf at invalid pixels, or None when the split has no
gt (test/submission splits).

Layout differences from the reference: roots resolve under a module-level
DATA_ROOT (env SPANN3R_STEREOFLOW_DATA, default ./data/stereoflow)
instead of hard-coded relative paths; the dataset-string parser is
ast-based (no eval); dataset algebra `N*ds` and `ds1+ds2` mirrors the
reference's __rmul__ / torch ConcatDataset.
"""
from __future__ import annotations

import ast
import os
import os.path as osp
import pickle
from glob import glob
from typing import Callable, List, Optional

import numpy as np

from . import io as sfio
from .augmentor import FlowAugmentor, StereoAugmentor

DATA_ROOT = os.environ.get("SPANN3R_STEREOFLOW_DATA", "./data/stereoflow")

# subpath under DATA_ROOT per dataset (ref datasets_stereo.py:25-38,
# datasets_flow.py:24-30); entries may be overridden with absolute paths
# via ROOT_OVERRIDES[name]
_SUBPATHS = {
    "CREStereo": "crenet_stereo_trainset/stereo_trainset/crestereo",
    "SceneFlow": "SceneFlow",
    "ETH3DLowRes": "eth3d_lowres",
    "Booster": "booster_gt",
    "Middlebury2021": "middlebury/2021/data",
    "Middlebury2014": "middlebury/2014",
    "Middlebury2006": "middlebury/2006",
    "Middlebury2005": "middlebury/2005/train",
    "MiddleburyEval3": "middlebury/MiddEval3",
    "Spring": "spring",
    "Kitti15": "kitti-stereo-2015",
    "Kitti12": "kitti-stereo-2012",
    "TartanAir": "TartanAir",
    "FlyingChairs": "FlyingChairs",
    "FlyingThings": "SceneFlow/FlyingThings",
    "MPISintel": "MPI-Sintel",
}
ROOT_OVERRIDES: dict = {}
CACHE_DIR: Optional[str] = None  # default: DATA_ROOT/datasets_<task>_cache


def _dataset_root(name: str) -> str:
    if name in ROOT_OVERRIDES:
        return ROOT_OVERRIDES[name]
    return osp.join(DATA_ROOT, _SUBPATHS[name])


# single source for the ImageNet stats shared with the pretraining inputs
# (a drifted copy here would desynchronize finetuning from pretraining)
from ..datasets.pairs import (IMAGENET_MEAN as IN1K_MEAN,  # noqa: E402
                              IMAGENET_STD as IN1K_STD)


def img_to_array(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> in1k-normalized float32 HWC
    (ref datasets_stereo.py:41-47 transposed)."""
    return (img.astype(np.float32) / 255.0 - IN1K_MEAN) / IN1K_STD


class _PairDataset:
    """Common machinery of the reference StereoDataset/FlowDataset
    (datasets_stereo.py:51-135, datasets_flow.py:36-118)."""
    task = None  # 'stereo' | 'flow'

    def __init__(self, split: str, augmentor: bool = False,
                 crop_size=None, tonorm: bool = True, seed: int = None):
        self.split = split
        if not augmentor:
            assert crop_size is None
        if crop_size is not None:
            assert augmentor
        self.crop_size = crop_size
        self.augmentor_str = augmentor
        if augmentor:
            rng = np.random.default_rng(seed)
            self.augmentor = (StereoAugmentor(crop_size, rng=rng)
                              if self.task == "stereo"
                              else FlowAugmentor(crop_size, rng=rng))
        else:
            self.augmentor = None
        self.tonorm = tonorm
        self.rmul = 1
        self.has_constant_resolution = True
        self._prepare_data()
        self._load_or_build_cache()

    # ---- subclass contract ----
    def _prepare_data(self):
        raise NotImplementedError

    def _build_cache(self):
        raise NotImplementedError

    # ---- shared ----
    def _set_root(self):
        self.root = _dataset_root(self.name)
        assert os.path.isdir(self.root), \
            f"missing root for dataset {self.name}: {self.root}"

    def _cache_file(self):
        cd = CACHE_DIR or osp.join(DATA_ROOT, f"datasets_{self.task}_cache")
        return osp.join(cd, self.name + ".pkl")

    def _load_or_build_cache(self):
        cache_file = self._cache_file()
        if osp.isfile(cache_file):
            with open(cache_file, "rb") as fid:
                self.pairnames = pickle.load(fid)[self.split]
        else:
            tosave = self._build_cache()
            os.makedirs(osp.dirname(cache_file), exist_ok=True)
            with open(cache_file, "wb") as fid:
                pickle.dump(tosave, fid)
            self.pairnames = tosave[self.split]

    def __len__(self):
        return len(self.pairnames)

    def __rmul__(self, v: int):
        self.rmul *= v
        self.pairnames = v * self.pairnames
        return self

    def __mul__(self, v: int):
        return self.__rmul__(v)

    def __add__(self, other):
        return CatPairDataset([self, other])

    def __str__(self):
        return f"{self.__class__.__name__}_{self.split}"

    def __repr__(self):
        s = (f"{self.__class__.__name__}(split={self.split}, "
             f"augmentor={self.augmentor_str}, "
             f"crop_size={str(self.crop_size)})")
        if self.rmul == 1:
            s += f"\n\tnum pairs: {len(self.pairnames)}"
        else:
            s += (f"\n\tnum pairs: {len(self.pairnames)} "
                  f"({len(self.pairnames) // self.rmul}x{self.rmul})")
        return s

    def __getitem__(self, index):
        pairname = self.pairnames[index]
        if self.task == "stereo":
            name1 = self.pairname_to_Limgname(pairname)
            name2 = self.pairname_to_Rimgname(pairname)
            gtname = (self.pairname_to_Ldispname(pairname)
                      if self.pairname_to_Ldispname is not None else None)
            load_gt = self.load_disparity
        else:
            name1 = self.pairname_to_img1name(pairname)
            name2 = self.pairname_to_img2name(pairname)
            gtname = (self.pairname_to_flowname(pairname)
                      if self.pairname_to_flowname is not None else None)
            load_gt = self.load_flow
        img1 = sfio.read_img(name1)
        img2 = sfio.read_img(name2)
        gt = load_gt(gtname) if gtname is not None else None

        if gt is not None and self.task == "stereo" and self.name != "Spring":
            assert np.all(gt[np.isfinite(gt)] > 0), (self.name, pairname)

        if self.augmentor is not None:
            img1, img2, gt = self.augmentor(img1, img2, gt, self.name)

        if self.tonorm:
            img1 = img_to_array(img1)
            img2 = img_to_array(img2)
            if gt is not None:
                gt = np.asarray(gt, np.float32)
                if gt.ndim == 2:
                    gt = gt[:, :, None]
        return img1, img2, gt, str(pairname)


class CatPairDataset:
    """`ds1 + ds2` concatenation (the reference relies on torch's
    ConcatDataset via Dataset.__add__)."""

    def __init__(self, datasets):
        self.datasets = []
        for d in datasets:
            if isinstance(d, CatPairDataset):
                self.datasets.extend(d.datasets)
            else:
                self.datasets.append(d)
        self.has_constant_resolution = all(
            getattr(d, "has_constant_resolution", True)
            for d in self.datasets)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __add__(self, other):
        return CatPairDataset([self, other])

    def __repr__(self):
        return "\n".join(repr(d) for d in self.datasets)

    def __str__(self):
        return "+".join(str(d) for d in self.datasets)

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        for d in self.datasets:
            if idx < len(d):
                return d[idx]
            idx -= len(d)
        raise IndexError(idx)


# ============================ stereo datasets ============================

class StereoDataset(_PairDataset):
    task = "stereo"


class CREStereoDataset(StereoDataset):
    """ref datasets_stereo.py:137-155."""

    def _prepare_data(self):
        self.name = "CREStereo"
        self._set_root()
        assert self.split in ["train"]
        self.pairname_to_Limgname = lambda p: osp.join(
            self.root, p + "_left.jpg")
        self.pairname_to_Rimgname = lambda p: osp.join(
            self.root, p + "_right.jpg")
        self.pairname_to_Ldispname = lambda p: osp.join(
            self.root, p + "_left.disp.png")
        self.pairname_to_str = lambda p: p
        self.load_disparity = sfio.read_crestereo_disp

    def _build_cache(self):
        allpairs = [s + "/" + f[:-len("_left.jpg")]
                    for s in sorted(os.listdir(self.root))
                    for f in sorted(os.listdir(osp.join(self.root, s)))
                    if f.endswith("_left.jpg")]
        assert len(allpairs) == 200000, "incorrect parsing of CREStereo"
        return {"train": allpairs}


class SceneFlowDataset(StereoDataset):
    """ref datasets_stereo.py:156-202 (Driving + Monkaa + FlyingThings)."""

    def _prepare_data(self):
        self.name = "SceneFlow"
        self._set_root()
        assert self.split in [
            f"{s}_{p}pass" for s in ["train", "test", "test1of100"]
            for p in ["final", "clean", "all"]]
        self.pairname_to_Limgname = lambda p: osp.join(self.root, p)
        self.pairname_to_Rimgname = lambda p: osp.join(self.root, p).replace(
            "/left/", "/right/")
        self.pairname_to_Ldispname = lambda p: osp.join(self.root, p).replace(
            "/frames_finalpass/", "/disparity/").replace(
            "/frames_cleanpass/", "/disparity/")[:-4] + ".pfm"
        self.pairname_to_str = lambda p: p[:-4]
        self.load_disparity = sfio.read_sceneflow_disp

    def _build_cache(self):
        root = self.root.rstrip("/") + "/"
        trainpairs = []
        for sub, want in [("Driving/frames_finalpass/*/*/*/left/*.png", 4400),
                          ("Monkaa/frames_finalpass/*/left/*.png", 8664),
                          ("FlyingThings/frames_finalpass/TRAIN/*/*/left/"
                           "*.png", 22390)]:
            pairs = sorted(glob(root + sub))
            pairs = [x[len(root):] for x in pairs]
            assert len(pairs) == want, "incorrect parsing of SceneFlow"
            trainpairs += pairs
        assert len(trainpairs) == 35454
        testpairs = sorted(
            glob(root + "FlyingThings/frames_finalpass/TEST/*/*/left/*.png"))
        testpairs = [x[len(root):] for x in testpairs]
        assert len(testpairs) == 4370, "incorrect parsing of SceneFlow"
        test1of100 = testpairs[::100]
        tosave = {
            "train_finalpass": trainpairs,
            "train_cleanpass": [x.replace("frames_finalpass",
                                          "frames_cleanpass")
                                for x in trainpairs],
            "test_finalpass": testpairs,
            "test_cleanpass": [x.replace("frames_finalpass",
                                         "frames_cleanpass")
                               for x in testpairs],
            "test1of100_finalpass": test1of100,
            "test1of100_cleanpass": [x.replace("frames_finalpass",
                                               "frames_cleanpass")
                                     for x in test1of100],
        }
        tosave["train_allpass"] = (tosave["train_finalpass"]
                                   + tosave["train_cleanpass"])
        tosave["test_allpass"] = (tosave["test_finalpass"]
                                  + tosave["test_cleanpass"])
        return tosave


class Md21Dataset(StereoDataset):
    """ref datasets_stereo.py:203-227 (Middlebury 2021, ambient lightings)."""

    def _prepare_data(self):
        self.name = "Middlebury2021"
        self._set_root()
        assert self.split in ["train", "subtrain", "subval"]
        self.pairname_to_Limgname = lambda p: osp.join(self.root, p)
        self.pairname_to_Rimgname = lambda p: osp.join(
            self.root, p.replace("/im0", "/im1"))
        self.pairname_to_Ldispname = lambda p: osp.join(
            self.root, p.split("/")[0], "disp0.pfm")
        self.pairname_to_str = lambda p: p[:-4]
        self.load_disparity = sfio.read_middlebury_disp

    def _build_cache(self):
        seqs = sorted(os.listdir(self.root))
        trainpairs = []
        for s in seqs:
            trainpairs += [
                s + "/ambient/" + b + "/" + a
                for b in sorted(os.listdir(osp.join(self.root, s, "ambient")))
                for a in sorted(os.listdir(osp.join(self.root, s, "ambient",
                                                    b)))
                if a.startswith("im0")]
        assert len(trainpairs) == 355
        subtrain = [p for p in trainpairs
                    if any(p.startswith(s + "/") for s in seqs[:-2])]
        subval = [p for p in trainpairs
                  if any(p.startswith(s + "/") for s in seqs[-2:])]
        assert len(subtrain) == 335 and len(subval) == 20
        return {"train": trainpairs, "subtrain": subtrain, "subval": subval}


class Md14Dataset(StereoDataset):
    """ref datasets_stereo.py:228-253 (Middlebury 2014)."""

    def _prepare_data(self):
        self.name = "Middlebury2014"
        self._set_root()
        assert self.split in ["train", "subtrain", "subval"]
        self.pairname_to_Limgname = lambda p: osp.join(
            self.root, osp.dirname(p), "im0.png")
        self.pairname_to_Rimgname = lambda p: osp.join(self.root, p)
        self.pairname_to_Ldispname = lambda p: osp.join(
            self.root, osp.dirname(p), "disp0.pfm")
        self.pairname_to_str = lambda p: p[:-4]
        self.load_disparity = sfio.read_middlebury_disp
        self.has_constant_resolution = False

    def _build_cache(self):
        seqs = sorted(os.listdir(self.root))
        trainpairs = []
        for s in seqs:
            trainpairs += [s + "/im1.png", s + "/im1E.png", s + "/im1L.png"]
        assert len(trainpairs) == 138
        valseqs = ["Umbrella-imperfect", "Vintage-perfect"]
        assert all(s in seqs for s in valseqs)
        subtrain = [p for p in trainpairs
                    if not any(p.startswith(s + "/") for s in valseqs)]
        subval = [p for p in trainpairs
                  if any(p.startswith(s + "/") for s in valseqs)]
        assert len(subtrain) == 132 and len(subval) == 6
        return {"train": trainpairs, "subtrain": subtrain, "subval": subval}


class _Md0506Base(StereoDataset):
    """Shared Illum/Exp grid of Middlebury 2005/2006
    (ref datasets_stereo.py:255-310)."""
    _total = None
    _valseqs = None

    def _prepare_data(self):
        self._set_root()
        assert self.split in ["train", "subtrain", "subval"]
        self.pairname_to_Limgname = lambda p: osp.join(self.root, p)
        self.pairname_to_Rimgname = lambda p: osp.join(
            self.root, osp.dirname(p), "view5.png")
        self.pairname_to_Ldispname = lambda p: osp.join(
            self.root, p.split("/")[0], "disp1.png")
        self.pairname_to_str = lambda p: p[:-4]
        self.load_disparity = sfio.read_middlebury20052006_disp

    def _build_cache(self):
        seqs = sorted(os.listdir(self.root))
        trainpairs = [osp.join(s, i, e, "view1.png") for s in seqs
                      for i in ["Illum1", "Illum2", "Illum3"]
                      for e in ["Exp0", "Exp1", "Exp2"]]
        assert len(trainpairs) == self._total, self.name
        assert all(s in seqs for s in self._valseqs)
        subtrain = [p for p in trainpairs
                    if not any(p.startswith(s + "/") for s in self._valseqs)]
        subval = [p for p in trainpairs
                  if any(p.startswith(s + "/") for s in self._valseqs)]
        return {"train": trainpairs, "subtrain": subtrain, "subval": subval}


class Md06Dataset(_Md0506Base):
    _total = 189
    _valseqs = ["Rocks1", "Wood2"]

    def _prepare_data(self):
        self.name = "Middlebury2006"
        super()._prepare_data()
        self.has_constant_resolution = False


class Md05Dataset(_Md0506Base):
    _total = 54
    _valseqs = ["Reindeer"]

    def _prepare_data(self):
        self.name = "Middlebury2005"
        super()._prepare_data()


class MdEval3Dataset(StereoDataset):
    """ref datasets_stereo.py:311-359 (MiddEval3 + benchmark submission)."""

    def _prepare_data(self):
        self.name = "MiddleburyEval3"
        self._set_root()
        assert self.split in [
            f"{s}_{r}" for s in ["train", "subtrain", "subval", "test", "all"]
            for r in ["full", "half", "quarter"]]
        if self.split.endswith("_full"):
            self.root = self.root.replace("/MiddEval3", "/MiddEval3_F")
        elif self.split.endswith("_half"):
            self.root = self.root.replace("/MiddEval3", "/MiddEval3_H")
        self.pairname_to_Limgname = lambda p: osp.join(self.root, p, "im0.png")
        self.pairname_to_Rimgname = lambda p: osp.join(self.root, p, "im1.png")
        self.pairname_to_Ldispname = lambda p: (
            None if p.startswith("test")
            else osp.join(self.root, p, "disp0GT.pfm"))
        self.pairname_to_str = lambda p: p
        self.load_disparity = sfio.read_middlebury_disp
        self.submission_methodname = "CroCo-Stereo"
        self.submission_sresolution = (
            "F" if self.split.endswith("_full")
            else ("H" if self.split.endswith("_half") else "Q"))

    def _build_cache(self):
        trainpairs = ["train/" + s
                      for s in sorted(os.listdir(osp.join(self.root,
                                                          "train")))]
        testpairs = ["test/" + s
                     for s in sorted(os.listdir(osp.join(self.root, "test")))]
        assert len(trainpairs) == 15 and len(testpairs) == 15
        tosave = {}
        for r in ["full", "half", "quarter"]:
            tosave.update(**{"train_" + r: trainpairs,
                             "subtrain_" + r: trainpairs[:-1],
                             "subval_" + r: trainpairs[-1:],
                             "test_" + r: testpairs,
                             "all_" + r: trainpairs + testpairs})
        return tosave

    def submission_save_pairname(self, pairname, prediction, outdir, time):
        assert prediction.ndim == 2 and prediction.dtype == np.float32
        outfile = osp.join(
            outdir,
            pairname.split("/")[0].replace("train", "training")
            + self.submission_sresolution, pairname.split("/")[1],
            "disp0" + self.submission_methodname + ".pfm")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        sfio.write_pfm(outfile, prediction)
        with open(osp.join(osp.dirname(outfile),
                           "time" + self.submission_methodname + ".txt"),
                  "w") as fid:
            fid.write(str(time))

    def finalize_submission(self, outdir):
        print(f'to submit: cd {outdir}/; zip -r '
              f'"{self.submission_methodname}.zip" .')


class ETH3DLowResDataset(StereoDataset):
    """ref datasets_stereo.py:360-399."""

    def _prepare_data(self):
        self.name = "ETH3DLowRes"
        self._set_root()
        assert self.split in ["train", "test", "subtrain", "subval", "all"]
        self.pairname_to_Limgname = lambda p: osp.join(self.root, p, "im0.png")
        self.pairname_to_Rimgname = lambda p: osp.join(self.root, p, "im1.png")
        self.pairname_to_Ldispname = (
            None if self.split == "test" else lambda p:
            None if p.startswith("test/")
            else osp.join(self.root, p.replace("train/", "train_gt/"),
                          "disp0GT.pfm"))
        self.pairname_to_str = lambda p: p
        self.load_disparity = sfio.read_eth3d_disp
        self.has_constant_resolution = False

    def _build_cache(self):
        trainpairs = ["train/" + s
                      for s in sorted(os.listdir(osp.join(self.root,
                                                          "train")))]
        testpairs = ["test/" + s
                     for s in sorted(os.listdir(osp.join(self.root, "test")))]
        assert len(trainpairs) == 27 and len(testpairs) == 20
        subval = ["train/delivery_area_3s", "train/electro_3l",
                  "train/playground_3l"]
        assert all(p in trainpairs for p in subval)
        subtrain = [p for p in trainpairs if p not in subval]
        return {"train": trainpairs, "test": testpairs,
                "subtrain": subtrain, "subval": subval,
                "all": trainpairs + testpairs}

    def submission_save_pairname(self, pairname, prediction, outdir, time):
        assert prediction.ndim == 2 and prediction.dtype == np.float32
        outfile = osp.join(outdir, "low_res_two_view",
                           pairname.split("/")[1] + ".pfm")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        sfio.write_pfm(outfile, prediction)
        with open(outfile[:-4] + ".txt", "w") as fid:
            fid.write("runtime " + str(time))

    def finalize_submission(self, outdir):
        print(f'to submit: cd {outdir}/; zip -r '
              f'"eth3d_low_res_two_view_results.zip" low_res_two_view')


class BoosterDataset(StereoDataset):
    """ref datasets_stereo.py:400-423 (balanced split only)."""

    def _prepare_data(self):
        self.name = "Booster"
        self._set_root()
        assert self.split in ["train_balanced", "test_balanced",
                              "subtrain_balanced", "subval_balanced"]
        self.pairname_to_Limgname = lambda p: osp.join(self.root, p)
        self.pairname_to_Rimgname = lambda p: osp.join(self.root, p).replace(
            "/camera_00/", "/camera_02/")
        self.pairname_to_Ldispname = lambda p: osp.join(
            self.root, osp.dirname(p), "../disp_00.npy")
        self.pairname_to_str = lambda p: p[:-4].replace("/camera_00/", "/")
        self.load_disparity = sfio.read_booster_disp

    def _build_cache(self):
        trainseqs = sorted(os.listdir(osp.join(self.root, "train/balanced")))
        trainpairs = [
            "train/balanced/" + s + "/camera_00/" + imname
            for s in trainseqs
            for imname in sorted(os.listdir(osp.join(
                self.root, "train/balanced", s, "camera_00")))]
        testpairs = [
            "test/balanced/" + s + "/camera_00/" + imname
            for s in sorted(os.listdir(osp.join(self.root, "test/balanced")))
            for imname in sorted(os.listdir(osp.join(
                self.root, "test/balanced", s, "camera_00")))]
        assert len(trainpairs) == 228 and len(testpairs) == 191
        subtrain = [p for p in trainpairs
                    if any(s in p for s in trainseqs[:-2])]
        subval = [p for p in trainpairs
                  if any(s in p for s in trainseqs[-2:])]
        return {"train_balanced": trainpairs, "test_balanced": testpairs,
                "subtrain_balanced": subtrain, "subval_balanced": subval}


class SpringStereoDataset(StereoDataset):
    """ref datasets_stereo.py:424-467 (hdf5 .dsp5 gt; requires h5py)."""

    def _prepare_data(self):
        self.name = "Spring"
        self._set_root()
        assert self.split in ["train", "test", "subtrain", "subval"]
        self.pairname_to_Limgname = lambda p: osp.join(self.root, p + ".png")
        self.pairname_to_Rimgname = lambda p: osp.join(
            self.root, p + ".png").replace("frame_right", "<r>").replace(
            "frame_left", "frame_right").replace("<r>", "frame_left")
        self.pairname_to_Ldispname = lambda p: (
            None if p.startswith("test")
            else osp.join(self.root, p + ".dsp5").replace(
                "frame_left", "disp1_left").replace("frame_right",
                                                    "disp1_right"))
        self.pairname_to_str = lambda p: p
        self.load_disparity = sfio.read_hdf5_disp

    def _build_cache(self):
        trainseqs = sorted(os.listdir(osp.join(self.root, "train")))
        trainpairs = [
            osp.join("train", s, "frame_left", f[:-4])
            for s in trainseqs
            for f in sorted(os.listdir(osp.join(self.root, "train", s,
                                                "frame_left")))]
        testseqs = sorted(os.listdir(osp.join(self.root, "test")))
        testpairs = [
            osp.join("test", s, "frame_left", f[:-4])
            for s in testseqs
            for f in sorted(os.listdir(osp.join(self.root, "test", s,
                                                "frame_left")))]
        testpairs += [p.replace("frame_left", "frame_right")
                      for p in testpairs]
        subtrain = [p for p in trainpairs if p.split("/")[1] != "0041"]
        subval = [p for p in trainpairs if p.split("/")[1] == "0041"]
        assert (len(trainpairs) == 5000 and len(testpairs) == 2000
                and len(subtrain) == 4904 and len(subval) == 96)
        return {"train": trainpairs, "test": testpairs,
                "subtrain": subtrain, "subval": subval}

    def submission_save_pairname(self, pairname, prediction, outdir, time):
        assert prediction.ndim == 2 and prediction.dtype == np.float32
        outfile = osp.join(outdir, pairname + ".dsp5").replace(
            "frame_left", "disp1_left").replace("frame_right", "disp1_right")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        sfio.write_dsp5(outfile, prediction)

    def finalize_submission(self, outdir):
        print(f"run the Spring disp1_subsampling tool in {outdir}/test")


class _KittiStereoBase(StereoDataset):
    _img_dir = None
    _disp_dir = None
    _ntrain = _ntest = None
    _nsubval = 0

    def _prepare_data(self):
        self._set_root()
        self.pairname_to_Limgname = lambda p: osp.join(self.root, p + "_10.png")
        self.pairname_to_Rimgname = lambda p: osp.join(
            self.root, p.replace(self._img_dir, self._img_dir_right)
            + "_10.png")
        self.pairname_to_Ldispname = (
            None if self.split == "test" else lambda p: osp.join(
                self.root, p.replace(self._img_dir, self._disp_dir)
                + "_10.png"))
        self.pairname_to_str = lambda p: p.replace(self._img_dir, "/")
        self.load_disparity = sfio.read_kitti_disp

    def _build_cache(self):
        trainseqs = [f"training{self._img_dir}%06d" % i
                     for i in range(self._ntrain)]
        testseqs = [f"testing{self._img_dir}%06d" % i
                    for i in range(self._ntest)]
        tosave = {"train": trainseqs, "test": testseqs}
        if self._nsubval:
            tosave["subtrain"] = trainseqs[:-self._nsubval]
            tosave["subval"] = trainseqs[-self._nsubval:]
        return tosave

    def submission_save_pairname(self, pairname, prediction, outdir, time):
        assert prediction.ndim == 2 and prediction.dtype == np.float32
        outfile = osp.join(outdir, *self._submission_subdir,
                           pairname.split("/")[-1] + "_10.png")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        from PIL import Image
        Image.fromarray((prediction * 256).astype("uint16")).save(outfile)


class Kitti12Dataset(_KittiStereoBase):
    """ref datasets_stereo.py:468-501."""
    _img_dir = "/colored_0/"
    _img_dir_right = "/colored_1/"
    _disp_dir = "/disp_occ/"
    _ntrain, _ntest = 194, 195
    _submission_subdir = ()

    def _prepare_data(self):
        self.name = "Kitti12"
        assert self.split in ["train", "test"]
        super()._prepare_data()


class Kitti15Dataset(_KittiStereoBase):
    """ref datasets_stereo.py:502-539."""
    _img_dir = "/image_2/"
    _img_dir_right = "/image_3/"
    _disp_dir = "/disp_occ_0/"
    _ntrain, _ntest = 200, 200
    _nsubval = 5
    _submission_subdir = ("disp_0",)

    def _prepare_data(self):
        self.name = "Kitti15"
        assert self.split in ["train", "subtrain", "subval", "test"]
        super()._prepare_data()


# ============================= flow datasets =============================

class FlowDataset(_PairDataset):
    task = "flow"


class TartanAirDataset(FlowDataset):
    """ref datasets_flow.py:120-138."""

    def _prepare_data(self):
        self.name = "TartanAir"
        self._set_root()
        assert self.split in ["train"]
        self.pairname_to_img1name = lambda p: osp.join(
            self.root, p[0], "image_left/{:06d}_left.png".format(p[1]))
        self.pairname_to_img2name = lambda p: osp.join(
            self.root, p[0], "image_left/{:06d}_left.png".format(p[2]))
        self.pairname_to_flowname = lambda p: osp.join(
            self.root, p[0],
            "flow/{:06d}_{:06d}_flow.npy".format(p[1], p[2]))
        self.pairname_to_str = lambda p: osp.join(
            p[0][p[0].find("/") + 1:], "{:06d}_{:06d}".format(p[1], p[2]))
        self.load_flow = sfio.read_numpy_flow

    def _build_cache(self):
        seqs = sorted(os.listdir(self.root))
        pairs = [
            (osp.join(s, s, difficulty, pxxx), int(a[:6]), int(a[:6]) + 1)
            for s in seqs for difficulty in ["Easy", "Hard"]
            for pxxx in sorted(os.listdir(osp.join(self.root, s, s,
                                                   difficulty)))
            for a in sorted(os.listdir(osp.join(
                self.root, s, s, difficulty, pxxx, "image_left")))[:-1]]
        assert len(pairs) == 306268, "incorrect parsing of TartanAir"
        return {"train": pairs}


class FlyingChairsDataset(FlowDataset):
    """ref datasets_flow.py:139-159."""

    def _prepare_data(self):
        self.name = "FlyingChairs"
        self._set_root()
        assert self.split in ["train", "val"]
        self.pairname_to_img1name = lambda p: osp.join(
            self.root, "data", p + "_img1.ppm")
        self.pairname_to_img2name = lambda p: osp.join(
            self.root, "data", p + "_img2.ppm")
        self.pairname_to_flowname = lambda p: osp.join(
            self.root, "data", p + "_flow.flo")
        self.pairname_to_str = lambda p: p
        self.load_flow = sfio.read_flo

    def _build_cache(self):
        split_list = np.loadtxt(osp.join(self.root, "chairs_split.txt"),
                                dtype=np.int32)
        trainpairs = ["{:05d}".format(i)
                      for i in np.where(split_list == 1)[0] + 1]
        valpairs = ["{:05d}".format(i)
                    for i in np.where(split_list == 2)[0] + 1]
        assert len(trainpairs) == 22232 and len(valpairs) == 640, \
            "incorrect parsing of FlyingChairs"
        return {"train": trainpairs, "val": valpairs}


class FlyingThingsDataset(FlowDataset):
    """ref datasets_flow.py:160-201 (into_future/into_past x left/right x
    clean/final, + the unimatch test1024 split)."""

    def _prepare_data(self):
        self.name = "FlyingThings"
        self._set_root()
        assert self.split in [
            f"{set_}_{pass_}pass{camstr}"
            for set_ in ["train", "test", "test1024"]
            for camstr in ["", "_rightcam"]
            for pass_ in ["clean", "final", "all"]]
        self.pairname_to_img1name = lambda p: osp.join(
            self.root, f"frames_{p[3]}pass",
            p[0].replace("into_future", "").replace("into_past", ""),
            "{:04d}.png".format(p[1]))
        self.pairname_to_img2name = lambda p: osp.join(
            self.root, f"frames_{p[3]}pass",
            p[0].replace("into_future", "").replace("into_past", ""),
            "{:04d}.png".format(p[2]))
        self.pairname_to_flowname = lambda p: osp.join(
            self.root, "optical_flow", p[0],
            "OpticalFlowInto{f:s}_{i:04d}_{c:s}.pfm".format(
                f="Future" if "future" in p[0] else "Past", i=p[1],
                c="L" if "left" in p[0] else "R"))
        self.pairname_to_str = lambda p: osp.join(
            p[3] + "pass", p[0],
            "Into{f:s}_{i:04d}_{c:s}".format(
                f="Future" if "future" in p[0] else "Past", i=p[1],
                c="L" if "left" in p[0] else "R"))
        self.load_flow = sfio.read_pfm_flow

    def _build_cache(self):
        tosave = {}
        for set_ in ["train", "test"]:
            sroot = osp.join(self.root, "optical_flow", set_.upper())
            fname_to_i = lambda f: int(
                f[len("OpticalFlowIntoFuture_"):-len("_L.pfm")])
            pp = [
                (osp.join(set_.upper(), d, s, "into_future/left"),
                 fname_to_i(fname))
                for d in sorted(os.listdir(sroot))
                for s in sorted(os.listdir(osp.join(sroot, d)))
                for fname in sorted(os.listdir(osp.join(
                    sroot, d, s, "into_future/left")))[:-1]]
            pairs = [(a, i, i + 1) for a, i in pp]
            pairs += [(a.replace("into_future", "into_past"), i + 1, i)
                      for a, i in pp]
            assert len(pairs) == {"train": 40302, "test": 7866}[set_], \
                "incorrect parsing of FlyingThings"
            for cam in ["left", "right"]:
                camstr = "" if cam == "left" else f"_{cam}cam"
                for pass_ in ["final", "clean"]:
                    tosave[f"{set_}_{pass_}pass{camstr}"] = [
                        (a.replace("left", cam), i, j, pass_)
                        for a, i, j in pairs]
                tosave[f"{set_}_allpass{camstr}"] = (
                    tosave[f"{set_}_cleanpass{camstr}"]
                    + tosave[f"{set_}_finalpass{camstr}"])
        # unimatch validation subset: drop the remainder, stride the rest
        alltest = len(tosave["test_cleanpass"])
        stride = alltest // 1024
        remove = alltest % 1024
        for cam in ["left", "right"]:
            camstr = "" if cam == "left" else f"_{cam}cam"
            for pass_ in ["final", "clean"]:
                tosave[f"test1024_{pass_}pass{camstr}"] = sorted(
                    tosave[f"test_{pass_}pass{camstr}"])[:-remove][::stride]
            assert len(tosave[f"test1024_cleanpass{camstr}"]) == 1024
            tosave[f"test1024_allpass{camstr}"] = (
                tosave[f"test1024_cleanpass{camstr}"]
                + tosave[f"test1024_finalpass{camstr}"])
        return tosave


class MPISintelDataset(FlowDataset):
    """ref datasets_flow.py:202-252."""

    def _prepare_data(self):
        self.name = "MPISintel"
        self._set_root()
        assert self.split in [
            s + "_" + p for s in ["train", "test", "subval", "subtrain"]
            for p in ["cleanpass", "finalpass", "allpass"]]
        self.pairname_to_img1name = lambda p: osp.join(
            self.root, p[0], "frame_{:04d}.png".format(p[1]))
        self.pairname_to_img2name = lambda p: osp.join(
            self.root, p[0], "frame_{:04d}.png".format(p[1] + 1))
        self.pairname_to_flowname = lambda p: (
            None if p[0].startswith("test/")
            else osp.join(self.root,
                          p[0].replace("/clean/", "/flow/").replace(
                              "/final/", "/flow/"),
                          "frame_{:04d}.flo".format(p[1])))
        self.pairname_to_str = lambda p: osp.join(
            p[0], "frame_{:04d}".format(p[1]))
        self.load_flow = sfio.read_flo

    def _build_cache(self):
        trainseqs = sorted(os.listdir(osp.join(self.root, "training/clean")))
        trainpairs = [
            (osp.join("training/clean", s), i) for s in trainseqs
            for i in range(1, len(os.listdir(osp.join(
                self.root, "training/clean", s))))]
        subvalseqs = ["temple_2", "temple_3"]
        subval = [(p, i) for p, i in trainpairs
                  if any(s in p for s in subvalseqs)]
        subtrain = [(p, i) for p, i in trainpairs
                    if not any(s in p for s in subvalseqs)]
        testseqs = sorted(os.listdir(osp.join(self.root, "test/clean")))
        testpairs = [
            (osp.join("test/clean", s), i) for s in testseqs
            for i in range(1, len(os.listdir(osp.join(self.root,
                                                      "test/clean", s))))]
        assert (len(trainpairs) == 1041 and len(testpairs) == 552
                and len(subval) == 98 and len(subtrain) == 943), \
            "incorrect parsing of MPI-Sintel"
        tosave = {"train_cleanpass": trainpairs,
                  "test_cleanpass": testpairs,
                  "subval_cleanpass": subval,
                  "subtrain_cleanpass": subtrain}
        for t in ["train", "test", "subval", "subtrain"]:
            tosave[t + "_finalpass"] = [
                (p.replace("/clean/", "/final/"), i)
                for p, i in tosave[t + "_cleanpass"]]
            tosave[t + "_allpass"] = (tosave[t + "_cleanpass"]
                                      + tosave[t + "_finalpass"])
        return tosave

    def submission_save_pairname(self, pairname, prediction, outdir, _time):
        assert prediction.shape[2] == 2
        outfile = osp.join(outdir, "submission",
                           self.pairname_to_str(pairname) + ".flo")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        sfio.write_flo(outfile, prediction)

    def finalize_submission(self, outdir):
        print("bundle clean+final results with the MPI-Sintel bundler "
              f"from {outdir}/submission")


class SpringFlowDataset(FlowDataset):
    """ref datasets_flow.py:253-306 (hdf5 .flo5 gt; requires h5py)."""

    def _prepare_data(self):
        self.name = "Spring"
        self._set_root()
        assert self.split in ["train", "test", "subtrain", "subval"]
        self.pairname_to_img1name = lambda p: osp.join(
            self.root, p[0], p[1], "frame_" + p[3],
            "frame_{:s}_{:04d}.png".format(p[3], p[4]))
        self.pairname_to_img2name = lambda p: osp.join(
            self.root, p[0], p[1], "frame_" + p[3],
            "frame_{:s}_{:04d}.png".format(
                p[3], p[4] + (1 if p[2] == "FW" else -1)))
        self.pairname_to_flowname = lambda p: (
            None if p[0] == "test"
            else osp.join(self.root, p[0], p[1], f"flow_{p[2]}_{p[3]}",
                          f"flow_{p[2]}_{p[3]}_{p[4]:04d}.flo5"))
        self.pairname_to_str = lambda p: osp.join(
            p[0], p[1], f"flow_{p[2]}_{p[3]}",
            f"flow_{p[2]}_{p[3]}_{p[4]:04d}")
        self.load_flow = sfio.read_hdf5_flow

    def _build_cache(self):
        trainseqs = sorted(os.listdir(osp.join(self.root, "train")))
        trainpairs = []
        for leftright in ["left", "right"]:
            for fwbw in ["FW", "BW"]:
                trainpairs += [
                    ("train", s, fwbw, leftright,
                     int(f[len(f"flow_{fwbw}_{leftright}_"):-len(".flo5")]))
                    for s in trainseqs
                    for f in sorted(os.listdir(osp.join(
                        self.root, "train", s, f"flow_{fwbw}_{leftright}")))]
        testseqs = sorted(os.listdir(osp.join(self.root, "test")))
        testpairs = []
        for leftright in ["left", "right"]:
            frames = {s: sorted(os.listdir(osp.join(
                self.root, "test", s, f"frame_{leftright}")))[:-1]
                for s in testseqs}
            testpairs += [
                ("test", s, "FW", leftright,
                 int(f[len(f"frame_{leftright}_"):-len(".png")]))
                for s in testseqs for f in frames[s]]
            testpairs += [
                ("test", s, "BW", leftright,
                 int(f[len(f"frame_{leftright}_"):-len(".png")]) + 1)
                for s in testseqs for f in frames[s]]
        subtrain = [p for p in trainpairs if p[1] != "0041"]
        subval = [p for p in trainpairs if p[1] == "0041"]
        assert (len(trainpairs) == 19852 and len(testpairs) == 3960
                and len(subtrain) == 19472 and len(subval) == 380), \
            "incorrect parsing of Spring"
        return {"train": trainpairs, "test": testpairs,
                "subtrain": subtrain, "subval": subval}

    def submission_save_pairname(self, pairname, prediction, outdir, time):
        assert prediction.ndim == 3 and prediction.shape[2] == 2
        assert prediction.dtype == np.float32
        outfile = osp.join(outdir, pairname[0], pairname[1],
                           f"flow_{pairname[2]}_{pairname[3]}",
                           f"flow_{pairname[2]}_{pairname[3]}_"
                           f"{pairname[4]:04d}.flo5")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        sfio.write_flo5(outfile, prediction)

    def finalize_submission(self, outdir):
        print(f"run the Spring flow_subsampling tool in {outdir}/test")


class _KittiFlowBase(FlowDataset):
    _img_dir = None
    _flow_dir = None
    _ntrain = _ntest = None
    _nsubval = 0

    def _prepare_data(self):
        self._set_root()
        self.pairname_to_img1name = lambda p: osp.join(self.root,
                                                       p + "_10.png")
        self.pairname_to_img2name = lambda p: osp.join(self.root,
                                                       p + "_11.png")
        self.pairname_to_flowname = (
            None if self.split == "test" else lambda p: osp.join(
                self.root, p.replace(self._img_dir, self._flow_dir)
                + "_10.png"))
        self.pairname_to_str = lambda p: p.replace(self._img_dir, "/")
        self.load_flow = sfio.read_kitti_flow

    def _build_cache(self):
        trainseqs = [f"training{self._img_dir}%06d" % i
                     for i in range(self._ntrain)]
        testseqs = [f"testing{self._img_dir}%06d" % i
                    for i in range(self._ntest)]
        tosave = {"train": trainseqs, "test": testseqs}
        if self._nsubval:
            tosave["subtrain"] = trainseqs[:-self._nsubval]
            tosave["subval"] = trainseqs[-self._nsubval:]
        return tosave

    def submission_save_pairname(self, pairname, prediction, outdir, time):
        assert prediction.ndim == 3 and prediction.shape[2] == 2
        outfile = osp.join(outdir, *self._submission_subdir,
                           pairname.split("/")[-1] + "_10.png")
        os.makedirs(osp.dirname(outfile), exist_ok=True)
        sfio.write_kitti_flow(outfile, prediction)


class Kitti12FlowDataset(_KittiFlowBase):
    """ref datasets_flow.py:307-340."""
    _img_dir = "/colored_0/"
    _flow_dir = "/flow_occ/"
    _ntrain, _ntest = 194, 195
    _submission_subdir = ()

    def _prepare_data(self):
        self.name = "Kitti12"
        assert self.split in ["train", "test"]
        super()._prepare_data()


class Kitti15FlowDataset(_KittiFlowBase):
    """ref datasets_flow.py:341-377."""
    _img_dir = "/image_2/"
    _flow_dir = "/flow_occ/"
    _ntrain, _ntest = 200, 200
    _nsubval = 10
    _submission_subdir = ("flow",)

    def _prepare_data(self):
        self.name = "Kitti15"
        assert self.split in ["train", "subtrain", "subval", "test"]
        super()._prepare_data()


# ============================ dataset getters ============================

_STEREO_REGISTRY = {
    "CREStereo": CREStereoDataset, "SceneFlow": SceneFlowDataset,
    "Md21": Md21Dataset, "Middlebury2021": Md21Dataset,
    "Md14": Md14Dataset, "Md06": Md06Dataset, "Md05": Md05Dataset,
    "MdEval3": MdEval3Dataset, "ETH3DLowRes": ETH3DLowResDataset,
    "Booster": BoosterDataset, "Spring": SpringStereoDataset,
    "Kitti12": Kitti12Dataset, "Kitti15": Kitti15Dataset,
}
_FLOW_REGISTRY = {
    "TartanAir": TartanAirDataset, "FlyingChairs": FlyingChairsDataset,
    "FlyingThings": FlyingThingsDataset, "MPISintel": MPISintelDataset,
    "Spring": SpringFlowDataset, "Kitti12": Kitti12FlowDataset,
    "Kitti15": Kitti15FlowDataset,
}


def _build_one(node: ast.expr, registry, extra_kwargs, seed_state=None):
    """Evaluate `Name(kwargs)`, `int * expr`, `expr + expr` recursively —
    the algebra the reference reaches through eval()
    (datasets_stereo.py:664-674).  seed_state ({'next': int} or None)
    hands each constructed dataset a distinct augmentor seed so summed
    mixtures don't share identical augmentation streams."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        left = ast.literal_eval(node.left)
        assert isinstance(left, int), "expected int * Dataset(...)"
        return left * _build_one(node.right, registry, extra_kwargs,
                                 seed_state)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return (_build_one(node.left, registry, extra_kwargs, seed_state)
                + _build_one(node.right, registry, extra_kwargs, seed_state))
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        name = node.func.id
        if name.endswith("Dataset"):
            name = name[:-len("Dataset")]
        if name not in registry:
            raise ValueError(f"unknown dataset {name!r}; options: "
                             f"{sorted(registry)}")
        kwargs = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
        args = [ast.literal_eval(a) for a in node.args]
        kwargs.update(extra_kwargs)
        if seed_state is not None and seed_state.get("next") is not None:
            kwargs["seed"] = seed_state["next"]
            seed_state["next"] += 1
        return registry[name](*args, **kwargs)
    raise ValueError(f"cannot parse dataset expression: {ast.dump(node)}")


def _get_train_dataset(dataset_str: str, registry, crop_size=None,
                       seed=None):
    node = ast.parse(dataset_str.strip(), mode="eval").body
    return _build_one(node, registry,
                      {"augmentor": True, "crop_size": crop_size},
                      {"next": seed})


def get_train_dataset_stereo(dataset_str: str, crop_size=None, seed=None):
    """ref datasets_stereo.py:664-670.  `seed` makes augmentation
    reproducible (the reference relies on train.py:94-97's global
    np.random.seed; here the augmentor rng is explicit)."""
    return _get_train_dataset(dataset_str, _STEREO_REGISTRY, crop_size, seed)


def get_train_dataset_flow(dataset_str: str, crop_size=None, seed=None):
    """ref datasets_flow.py:620-626.  See get_train_dataset_stereo re seed."""
    return _get_train_dataset(dataset_str, _FLOW_REGISTRY, crop_size, seed)


def _get_test_datasets(dataset_str: str, registry):
    out = []
    for s in dataset_str.split("+"):
        node = ast.parse(s.strip(), mode="eval").body
        out.append(_build_one(node, registry, {}))
    return out


def get_test_datasets_stereo(dataset_str: str):
    """ref datasets_stereo.py:672-674."""
    return _get_test_datasets(dataset_str, _STEREO_REGISTRY)


def get_test_datasets_flow(dataset_str: str):
    """ref datasets_flow.py:628-630."""
    return _get_test_datasets(dataset_str, _FLOW_REGISTRY)
