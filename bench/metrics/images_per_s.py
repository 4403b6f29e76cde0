"""Images answered per second of the window: a closed loop on a card-bound
cell (``rates.images_in_window_per_s``)."""
from bench.yardstick import rates


def read(run):
    return rates.images_in_window_per_s(run)
