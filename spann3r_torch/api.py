"""High-level reconstruction API."""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from .config import BF16, Precision, Spann3RConfig
from .models.spann3r import InferenceEngine


def reconstruct_video(model, cfg: Spann3RConfig, frames: np.ndarray,
                      prec: Precision = BF16, offline: bool = False,
                      scene_graph: str = "complete", chunk: int = 16
                      ) -> Tuple[List[Dict], List[int], float]:
    """frames: (T, B, H, W, 3) -> (preds list, frame order, fps).

    Online mode runs the chunked streaming loop on the model's device over
    B independent streams. Offline mode (single stream, normalised float
    frames) runs the pairwise-confidence scan over the `scene_graph` pairs
    and the greedy next-best-view loop; the frame order is the order it
    chose. `preds` follows the reference contract: preds[0] has 'pts3d',
    the rest 'pts3d_in_other_view', all in the first frame's coordinates,
    as fp32 numpy arrays. fps is frames over the wall time of the call,
    outputs on the host included.
    """
    hw = tuple(frames.shape[2:4])
    t0 = time.perf_counter()
    if offline:
        if frames.shape[1] != 1:
            raise ValueError("offline reconstruction is single-stream; got "
                             f"B={frames.shape[1]}")
        from .models.offline import offline_reconstruction
        preds, _, order = offline_reconstruction(
            model, frames[:, 0], cfg, hw, scene_graph=scene_graph, prec=prec)
    else:
        engine = InferenceEngine(model, cfg, hw, prec, batch=frames.shape[1])
        preds = engine.run_video(frames, chunk=chunk)
        order = list(range(frames.shape[0]))
    elapsed = time.perf_counter() - t0
    return preds, order, frames.shape[0] / max(elapsed, 1e-9)
