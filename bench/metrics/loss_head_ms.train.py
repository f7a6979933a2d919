"""The median over the window's steps of the device milliseconds of the
program's ``model.loss_head`` span (``models/model.py::loss_fn``: the
chunked logits and token losses and their mean, in the forward pass)."""

from bench.spans import device_ms


def read(rec, run):
    return device_ms("model.loss_head")
