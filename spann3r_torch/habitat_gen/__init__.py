"""Procedural scene renderers for the port's synthetic datasets: the
dependency-free ray-cast `BoxRoomBackend` that `datasets.SynthRoom` renders
with, and the habitat-sim backend behind its import gate."""
from .backends import BoxRoomBackend, HabitatSimBackend, SceneBackend  # noqa: F401


class NoNavigableSpaceError(RuntimeError):
    pass
