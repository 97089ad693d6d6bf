"""The port's hand-written kernels: their names in a device trace, the
operations and bytes each launch needs (chip_smoke.py's arithmetic: each
input read once, each output written once), the launch shapes of each
path, and the card's peaks.

K2 is `ops.attention.sdpa` (csrc/sdpa.cu), K1 `ops.memory_read` (csrc/memory_read.cu, several
kernels a launch); K3 (`ops.rope`) has no reader yet.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# published peaks of one NVIDIA H100 SXM (data sheet, dense): the bf16
# tensor-core rate and the HBM3 rate, keyed by torch.cuda.get_device_name()
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes": 3.35e12}}

# substrings of each kernel's device-trace names
TRACE_NAMES = {
    "sdpa": ("sdpa_wgmma_kernel", "sdpa_f32_kernel"),
    "memory_read": ("scores_wgmma_kernel", "scores_f32_kernel",
                    "weights_kernel", "readout_wgmma_kernel",
                    "readout_f32_kernel", "finish_out_kernel", "colsum_kernel"),
}

# (B, H, N, M, D, bytes an element)
SdpaShape = Tuple[int, int, int, int, int, int]
# (P, valid slots, capacity, D, bytes an element) of one stream
ReadShape = Tuple[int, int, int, int, int]


def is_kernel(name: str, kernel: str) -> bool:
    return any(s in name for s in TRACE_NAMES[kernel])


def sdpa_work(s: SdpaShape) -> Tuple[float, float]:
    b, h, n, m, d, es = s
    return 4.0 * b * h * n * m * d, es * 2.0 * b * h * (n + m) * d


def memory_read_work(streams: List[ReadShape]) -> Tuple[float, float]:
    """One launch over its streams: QK^T and AV over the valid slots;
    reads q, the valid keys and values, writes the output and every
    slot's attention sum (fp32)."""
    flops = nbytes = 0.0
    for p, size, cap, d, es in streams:
        flops += 4.0 * p * size * d
        nbytes += es * (2.0 * p * d + 2.0 * size * d) + 4.0 * cap
    return flops, nbytes


def bound_s(work: Tuple[float, float], peaks: Dict[str, float]) -> float:
    """The least time the card could take: operations over the bf16 peak
    or bytes over the memory rate, whichever is larger."""
    return max(work[0] / peaks["bf16_flops"], work[1] / peaks["bytes"])


# -- launch shapes of the paths ------------------------------------------------

def _heads(cfg):
    e, d = cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    return ((cfg["enc_num_heads"], e // cfg["enc_num_heads"]),
            (cfg["dec_num_heads"], d // cfg["dec_num_heads"]))


def encoder_sdpa(cfg, b, p, es=2) -> List[SdpaShape]:
    (he, de), _ = _heads(cfg)
    return [(b, he, p, p, de, es)] * cfg["enc_depth"]


def decoder_sdpa(cfg, b, p, es=2) -> List[SdpaShape]:
    """Both decoders of b pairs: a self and a cross attention a block."""
    _, (hd, dd) = _heads(cfg)
    return [(b, hd, p, p, dd, es)] * (4 * cfg["dec_depth"])


def value_sdpa(cfg, b, p, es=2) -> List[SdpaShape]:
    h = cfg["value_enc_heads"]
    return [(b, h, p, p, cfg["value_enc_dim"] // h, es)] * cfg["value_enc_depth"]


def stream_step_sdpa(cfg, b, p, pair: bool, es=2) -> List[SdpaShape]:
    """One frame of b streams, its encoder alone or with the pair step."""
    out = encoder_sdpa(cfg, b, p, es)
    return out + (decoder_sdpa(cfg, b, p, es) + value_sdpa(cfg, b, p, es)
                  if pair else [])
