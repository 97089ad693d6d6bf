"""The datasets of the port: image folders (`Demo`), 7-Scenes, NRGBD /
Replica and DTU (evaluation), the training sets that read files from disk
(ScanNet, ScanNet++, ARKitScenes, BlendedMVS, CO3D, Habitat: the
reference's training recipe), and the procedural `SynthRoom`, all numpy
views in the reference's contract, collated by `loader.collate_views`; and
the dataset registry with its safe expression parser and the training
sampler. The CroCo pretraining pairs are `pairs.PairsDataset`.

The reference builds dataset mixtures by `eval()`ing strings like
    "10000 @ Co3d(split='train', ROOT=..., resolution=224) + 10000 @ ..."
(ref spann3r/datasets/__init__.py:21-22, training.py:289-295). The JAX
package parses the expression with `ast` against a registry instead, with
no arbitrary code execution, and so does the port, against the same
registry.
"""
from __future__ import annotations

import ast
from typing import Any, Dict

from .arkit import ArkitScene
from .base import (BaseManyViewDataset, BaseViewDataset, CatDataset,  # noqa: F401
                   ColorJitter, EasyDataset, MulDataset, ResizedDataset,
                   img_norm)
from .blendedmvs import BlendMVS
from .co3d import Co3d
from .demo import Demo
from .dtu import DTU
from .habitat import habitat
from .nrgbd import NRGBD, Replica
from .sampler import BatchedRandomSampler
from .scannet import Scannet
from .scannetpp import Scannetpp
from .seven_scenes import SevenScenes
from .synth import SynthRoom

REGISTRY: Dict[str, Any] = {
    "Demo": Demo,
    "SevenScenes": SevenScenes,
    "NRGBD": NRGBD,
    "Replica": Replica,
    "DTU": DTU,
    "Scannet": Scannet,
    "Scannetpp": Scannetpp,
    "ArkitScene": ArkitScene,
    "BlendMVS": BlendMVS,
    "Co3d": Co3d,
    "habitat": habitat,
    "SynthRoom": SynthRoom,
}

# names allowed as bare identifiers inside dataset expressions
NAMED_VALUES: Dict[str, Any] = {
    "ColorJitter": "ColorJitter",
    "ImgNorm": "ImgNorm",
    "True": True, "False": False, "None": None,
}


def _literal(node: ast.AST):
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        if node.id in NAMED_VALUES:
            return NAMED_VALUES[node.id]
        raise ValueError(f"unknown name {node.id!r} in dataset expression")
    if isinstance(node, (ast.List, ast.Tuple)):
        vals = [_literal(e) for e in node.elts]
        return vals if isinstance(node, ast.List) else tuple(vals)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_literal(node.operand)
    raise ValueError(f"unsupported literal {ast.dump(node)}")


def _build(node: ast.AST):
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            return _build(node.left) + _build(node.right)
        if isinstance(node.op, ast.MatMult):
            return _literal(node.left) @ _build(node.right)
        if isinstance(node.op, ast.Mult):
            return _literal(node.left) * _build(node.right)
        raise ValueError(f"unsupported operator {node.op}")
    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name):
            raise ValueError("dataset call must be a bare registry name")
        name = node.func.id
        if name not in REGISTRY:
            raise ValueError(f"unknown dataset {name!r}; known: {list(REGISTRY)}")
        args = [_literal(a) for a in node.args]
        kwargs = {kw.arg: _literal(kw.value) for kw in node.keywords}
        return REGISTRY[name](*args, **kwargs)
    raise ValueError(f"unsupported node {ast.dump(node)}")


def build_dataset(expr: str):
    """Parse a dataset-algebra expression into an EasyDataset tree."""
    tree = ast.parse(expr.strip(), mode="eval")
    ds = _build(tree.body)
    print(f"Built dataset: {ds!r} ({len(ds)} items)")
    return ds


def make_sampler(dataset, batch_size: int, world_size: int = 1, rank: int = 0,
                 drop_last: bool = True) -> BatchedRandomSampler:
    return BatchedRandomSampler(len(dataset), batch_size,
                                len(dataset._resolutions),
                                world_size=world_size, rank=rank,
                                drop_last=drop_last)
