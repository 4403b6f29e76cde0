"""Counted FLOPs of the images sent to the card inside the traced slice,
over the card's busy time in it times the TF32 peak: under open-loop
traffic the wall clock is set by the arrivals, the busy time by the
program."""
from bench.yardstick import rates


def read(run):
    return rates.mfu_of_busy(run)
