"""Parallel building blocks of the port: the stacked worker backend
(mesh.py), the flat state geometry and the piece stream of the per-leaf
and bucketed wires (buckets.py), the gradient aggregation wires
(collectives.py), the PS train step (ps.py), and the
within-device reference attention of the serving slice."""
