"""The network's counted bound (``yardstick.work``) over the kernels' time
on the card, for the batches that began inside the traced slice."""
from bench.yardstick import work


def read(run):
    return work.roofline_share(run)
