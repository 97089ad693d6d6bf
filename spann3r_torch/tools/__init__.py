"""Evaluation tools: the per-scene pipeline, ICP, reconstruction metrics
and visualisation; the convergence gate, the int8 and BF16_FAST serving
gates, the readiness drill, and remat's memory and step-time
measurement; DTU's ground-truth depth rasteriser (`render_dtu`, a copy of
the JAX package's) and the serving table (`serving_table`, the root
`tools/serving_table.py` over the port's bench)."""
