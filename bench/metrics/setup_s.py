"""Seconds from the process's start to the window's start: imports,
weights made on the card, the kernels' build where it is not cached, the
engine and its warm-up traffic (every CUDA-graph capture).  Host clock."""

SOURCE = "host_clock"


def read(run):
    return run.setup_s
