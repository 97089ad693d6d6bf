"""Spann3R streaming 3D reconstruction in PyTorch with CUDA kernels.

A port of `spann3r_tpu` (the JAX reference, which it never imports). Plain
tensor code is PyTorch; the attention, RoPE2D and memory-readout kernels
are CUDA C++ in `csrc/`, built at first use on the card. On CPU tensors
every kernel wrapper runs its plain PyTorch version.

Each module keeps its JAX counterpart's name and place: `models/` (the
streaming model and engine, offline mode, pairwise inference and
`global_align`, the global alignment of pairwise pointmaps), `losses`
(the sequence and two-view losses), `parallel/` (the process mesh,
sharded training and `streams`, the multi-stream scan dealt over ranks),
`datasets/`, `utils/` (`viz3d` among them), `tools/` (`render_dtu`,
`serving_table` among them) and the entry points.
"""
from .api import reconstruct_video
from .config import (BF16, BF16_FAST, FP32, DUSt3RConfig, MemoryConfig,
                     Precision, Spann3RConfig, ViTConfig)

__all__ = [
    "reconstruct_video", "Spann3RConfig", "DUSt3RConfig", "MemoryConfig",
    "ViTConfig", "Precision", "BF16", "BF16_FAST", "FP32",
]
