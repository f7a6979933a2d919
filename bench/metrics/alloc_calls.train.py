"""The caching allocator's calls to the device (``cudaMalloc`` and
``cudaFree``: ``num_device_alloc + num_device_free``) inside a
``train.step`` span, over the window's steps."""

from bench.spans import per_span


def read(rec, run):
    return per_span("train.step", "alloc.device_calls")
