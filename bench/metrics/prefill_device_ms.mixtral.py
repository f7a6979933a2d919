"""The median over the window's requests of the device milliseconds of
the program's ``serve.prefill`` span (``launch/steps.py::build_prefill_step``):
from the CUDA event at its entry to the one at its exit. The reading of
``prefill_device_ms.serve``, in the mixture-of-experts cell."""

from bench.spans import device_ms


def read(rec, run):
    return device_ms("serve.prefill")
