"""The session's warm-up (``SessionStats.compile_ms``): one run and one CUDA
graph capture per bucket."""


def read(run):
    return run.capture_s
