"""Host seconds of ``Accelerator.build``: DSE, compile, validation and the
load of the weights."""


def read(run):
    return run.build_s
