"""Images a device batch carried, over the window (``SessionStats``)."""


def read(run):
    batches = run.stats["batches"]
    return run.stats["dispatched_rows"] / batches if batches else None
