"""Kernel launches (``kernels.common.LAUNCHES``, a CUDA graph's launches
counted at every replay) of the window's requests, per image."""
from bench.yardstick import rates


def read(run):
    return rates.launches_per_image(run)
