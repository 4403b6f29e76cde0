"""Images answered inside the window, over its length: a closed loop on a
card-bound cell."""
from bench.yardstick import rates


def read(run):
    return rates.images_in_window_per_s(run)
