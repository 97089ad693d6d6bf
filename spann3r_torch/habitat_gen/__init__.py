"""Multiview crossview-pair data generator (ref croco/datasets/habitat_sim/).

The reference renders overlapping view tuples from habitat-sim scenes to
pretrain CroCo; everything except the rasterizer itself is
renderer-independent geometry (camera sampling, covisibility via depth
unprojection + KD-tree overlap, metadata bookkeeping).  Here that logic is
a pure-numpy `MultiviewSceneGenerator` over a pluggable `SceneBackend`:
`HabitatSimBackend` reproduces the reference exactly when habitat-sim is
installed (it is not in this image), and `BoxRoomBackend` is a
dependency-free ray-cast room renderer that exercises the full pipeline in
tests and produces training-ready output for the habitat consumer
datasets (datasets/habitat.py, datasets/pairs.py).
"""
from .generator import MultiviewSceneGenerator, NoNavigableSpaceError  # noqa: F401
from .backends import BoxRoomBackend, HabitatSimBackend, SceneBackend  # noqa: F401
