"""CUDA kernels a step that ran on the card, counted in the capture: the
count that cutting launches (CUDA graphs, fusion) moves."""

from portbench.harness.readers import kernels_per_step


def read(facts):
    return kernels_per_step(facts["trace"])
