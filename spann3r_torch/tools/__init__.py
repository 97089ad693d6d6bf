"""Evaluation tools: the per-scene pipeline, ICP, reconstruction metrics
and visualisation; the convergence gate, the int8 and BF16_FAST serving
gates, the readiness drill, and remat's memory and step-time
measurement."""
