"""The median over the window's steps of the device milliseconds of the
program's ``train.forward`` span (``launch/steps.py::loss_and_grads``: the
loss under autograd)."""

from bench.spans import device_ms


def read(rec, run):
    return device_ms("train.forward")
