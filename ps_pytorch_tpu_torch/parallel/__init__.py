"""Parallel building blocks of the port (serving slice: the flat weight
geometry and the within-device reference attention)."""
