"""High-level reconstruction API."""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from .config import BF16, Precision, Spann3RConfig
from .models.spann3r import InferenceEngine


def reconstruct_video(model, cfg: Spann3RConfig, frames: np.ndarray,
                      prec: Precision = BF16, offline: bool = False,
                      chunk: int = 16) -> Tuple[List[Dict], List[int], float]:
    """frames: (T, B, H, W, 3) -> (preds list, frame order, fps).

    Online mode runs the chunked streaming loop on the model's device.
    `preds` follows the reference contract: preds[0] has 'pts3d', the rest
    'pts3d_in_other_view', all in frame-0 coordinates. fps is frames over
    the wall time of the call, outputs on the host included.
    """
    if offline:
        raise NotImplementedError(
            "offline reconstruction is not ported yet: ROADMAP queue A item "
            "'offline mode and pairwise dust3r.forward'")
    hw = tuple(frames.shape[2:4])
    t0 = time.perf_counter()
    engine = InferenceEngine(model, cfg, hw, prec, batch=frames.shape[1])
    preds = engine.run_video(frames, chunk=chunk)
    elapsed = time.perf_counter() - t0
    return preds, list(range(frames.shape[0])), frames.shape[0] / max(elapsed, 1e-9)
