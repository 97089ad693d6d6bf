"""Weight and state conversion, geometry, masked statistics, PnP, export
and 3D scene visualisation (`viz3d`, a copy of the JAX package's
`utils/viz3d.py`)."""
