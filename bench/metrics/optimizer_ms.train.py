"""The median over the window's steps of the device milliseconds of the
program's ``train.optimizer`` span (``launch/steps.py::build_train_step``:
``opt.update``)."""

from bench.spans import device_ms


def read(rec, run):
    return device_ms("train.optimizer")
