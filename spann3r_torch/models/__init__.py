"""Model modules and the streaming engine; offline mode, pairwise
inference (`inference`, `pairs`) and the global alignment of pairwise
pointmaps (`global_align`, the JAX package's `models/global_align.py`)."""
