"""Share of the rows sent to the card that were real images, not padding to
a bucket, over the window (``SessionStats``)."""


def read(run):
    real, pad = run.stats["dispatched_rows"], run.stats["padded_rows"]
    return 100.0 * real / (real + pad) if real + pad else None
