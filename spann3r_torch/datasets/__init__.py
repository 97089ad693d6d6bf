"""The evaluation and demo datasets: image folders (`Demo`), 7-Scenes,
NRGBD / Replica, DTU and the procedural `SynthRoom`, all numpy views in the
reference's contract, collated by `loader.collate_views`. The training
datasets come with training."""
from .base import (BaseManyViewDataset, BaseViewDataset, CatDataset,  # noqa: F401
                   ColorJitter, EasyDataset, MulDataset, ResizedDataset,
                   img_norm)
from .demo import Demo  # noqa: F401
from .dtu import DTU  # noqa: F401
from .nrgbd import NRGBD, Replica  # noqa: F401
from .seven_scenes import SevenScenes  # noqa: F401
from .synth import SynthRoom  # noqa: F401
