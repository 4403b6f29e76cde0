"""Share of the traced slice in which no operation ran on the card."""
from bench.yardstick import rates


def read(run):
    return rates.idle_share(run)
