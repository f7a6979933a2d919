"""The median over the window's steps of the device milliseconds of the
program's ``train.backward`` span (``launch/steps.py::loss_and_grads``: the
gradient, each layer recomputed)."""

from bench.spans import device_ms


def read(rec, run):
    return device_ms("train.backward")
