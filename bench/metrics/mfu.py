"""Counted FLOPs of the images answered inside the traced slice, over the
slice's length times the TF32 peak."""
from bench.yardstick import rates


def read(run):
    return rates.mfu_in_slice(run)
