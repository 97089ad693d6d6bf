"""Model and precision configuration for the PyTorch port.

Frozen dataclasses with the same fields and defaults as
`spann3r_tpu.config`, so a configuration reads the same in both packages;
`Precision` holds torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """One transformer stack (encoder or decoder side)."""
    dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    rope_base: float = 100.0  # RoPE100; <=0 disables rope

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class DUSt3RConfig:
    """Two-view pointmap backbone. The defaults are the published 512-dpt
    architecture: ViT-Large encoder, dual ViT-Base decoders, DPT heads."""
    img_size: Tuple[int, int] = (512, 512)
    patch_size: int = 16
    enc: ViTConfig = ViTConfig(dim=1024, depth=24, num_heads=16)
    dec: ViTConfig = ViTConfig(dim=768, depth=12, num_heads=12)
    head_type: str = "dpt"          # 'dpt' | 'linear'
    depth_mode: Tuple[str, float, float] = ("exp", -float("inf"), float("inf"))
    conf_mode: Tuple[str, float, float] = ("exp", 1.0, float("inf"))
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128
    dpt_layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    out_channels: int = 4           # 3 xyz + 1 conf

    @property
    def dpt_hooks(self) -> Tuple[int, int, int, int]:
        # hooks over the 1 + depth collected decoder states
        d = self.dec.depth
        return (0, d * 2 // 4, d * 3 // 4, d)

    @property
    def dpt_hook_dims(self) -> Tuple[int, int, int, int]:
        return (self.enc.dim, self.dec.dim, self.dec.dim, self.dec.dim)


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Spatial memory hyper-parameters."""
    long_mem_size: int = 4000
    work_mem_size: int = 5
    attn_thresh: float = 5e-4
    sim_thresh: float = 0.95
    # age (in frames) below which slots are protected from pruning;
    # None derives work_mem_size + 5
    prune_protect_age: Optional[int] = None
    mem_dropout: float = 0.15

    @property
    def protect_age(self) -> int:
        if self.prune_protect_age is not None:
            return self.prune_protect_age
        return self.work_mem_size + 5

    def capacity(self, num_patches: int) -> int:
        """Static token capacity of the bank: the bank right before a prune
        holds at most long_mem_size + (work_mem_size + 1) * P tokens,
        rounded up to a multiple of 128 (8704 at 512x384, 5248 at 224)."""
        cap = self.long_mem_size + (self.work_mem_size + 1) * num_patches
        return -(-cap // 128) * 128


@dataclasses.dataclass(frozen=True)
class Spann3RConfig:
    dust3r: DUSt3RConfig = DUSt3RConfig()
    memory: MemoryConfig = MemoryConfig()
    # memory value encoder: 6 blocks at dim 1024
    value_enc_depth: int = 6
    value_enc_dim: int = 1024
    value_enc_heads: int = 16
    use_feat: bool = False          # if True, value = decoder feats (dim 768)
    mem_pos_enc: bool = False
    # attn-head MLPs: (1024+768) -> same -> 1024
    attn_head_in: int = 1024 + 768
    attn_head_out: int = 1024

    @property
    def value_in_dim(self) -> int:
        return 768 if self.use_feat else 1024


@dataclasses.dataclass(frozen=True)
class Precision:
    """Parameters stay fp32; transformer compute runs in `compute_dtype`;
    the pointmap heads run in `head_dtype`."""
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    head_dtype: torch.dtype = torch.float32


FP32 = Precision(compute_dtype=torch.float32, head_dtype=torch.float32)
BF16 = Precision(compute_dtype=torch.bfloat16, head_dtype=torch.float32)
# serving mode: bf16 everywhere, the head convolutions included
# (`downstream_head` casts its states to head_dtype)
BF16_FAST = Precision(compute_dtype=torch.bfloat16, head_dtype=torch.bfloat16)

