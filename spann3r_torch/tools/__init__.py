"""Evaluation tools: the per-scene pipeline, ICP, reconstruction metrics
and visualisation."""
