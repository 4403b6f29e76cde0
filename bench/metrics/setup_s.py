"""Seconds from the process's start to the window's first request: imports,
the card, the kernel library (built on a checkout's first run), weights and
images, the build and the session's warm-up."""


def read(run):
    return run.setup_s
