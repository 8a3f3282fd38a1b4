"""Parallel building blocks of the port: the stacked worker backend
(mesh.py), the flat state geometry and per-leaf wire (buckets.py), the
gradient aggregation (collectives.py), the PS train step (ps.py), and the
within-device reference attention of the serving slice."""
