"""Scene-graph pair construction for pairwise inference and offline mode.

The port's own copy of the JAX package's `models/pairs.py` (the reference
rule of dust3r's `image_pairs.py`): complete, swin-N, oneref-N and prev
graphs, optional symmetrisation and the seq-N / cyc-N prefilters.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def make_pairs(n_or_items, scene_graph: str = "complete", prefilter=None,
               symmetrize: bool = True) -> List[Tuple]:
    """(i, j) pairs over items (or range(n)) by the scene-graph rule."""
    if isinstance(n_or_items, int):
        items: Sequence = list(range(n_or_items))
    else:
        items = list(n_or_items)
    n = len(items)
    pairs: List[Tuple] = []

    if scene_graph == "complete":
        for i in range(n):
            for j in range(i):
                pairs.append((items[i], items[j]))
    elif scene_graph.startswith("swin"):
        winsize = int(scene_graph.split("-")[1]) if "-" in scene_graph else 3
        pairsid = set()
        for i in range(n):
            for j in range(1, winsize + 1):
                idx = (i + j) % n  # the window closes the loop
                pairsid.add((i, idx) if i < idx else (idx, i))
        for i, j in sorted(pairsid):
            pairs.append((items[i], items[j]))
    elif scene_graph.startswith("oneref"):
        refid = int(scene_graph.split("-")[1]) if "-" in scene_graph else 0
        for j in range(n):
            if j != refid:
                pairs.append((items[refid], items[j]))
    elif scene_graph.startswith("prev"):
        for i in range(1, n):
            for j in range(i):
                pairs.append((items[j], items[i]))
    else:
        raise ValueError(f"unknown scene graph {scene_graph!r}")

    if symmetrize:
        pairs += [(b, a) for a, b in pairs]

    if isinstance(prefilter, str) and prefilter.startswith(("seq", "cyc")):
        cyclic = prefilter.startswith("cyc")
        thr = int(prefilter[3:])

        def idx_of(item):
            # items are ints or view dicts with an 'idx' field
            return int(item["idx"]) if isinstance(item, dict) else int(item)

        kept = []
        for a, b in pairs:
            ia, ib = idx_of(a), idx_of(b)
            dis = abs(ia - ib)
            if cyclic:
                dis = min(dis, abs(ia + n - ib), abs(ia - n - ib))
            if dis <= thr:
                kept.append((a, b))
        pairs = kept
    return pairs
