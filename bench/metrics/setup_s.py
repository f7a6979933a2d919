"""Seconds from the process's start to the window's start: imports, the
CUDA context, kernels loaded (or built, in a checkout's first run),
weights made on the device, the cell's shapes warmed up."""


def read(rec, run):
    return rec.setup_s
