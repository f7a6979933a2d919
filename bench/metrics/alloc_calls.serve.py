"""The caching allocator's calls to the device (``cudaMalloc`` and
``cudaFree``: ``num_device_alloc + num_device_free``) inside a
``serve.prefill`` span, over the window's requests."""

from bench.spans import per_span


def read(rec, run):
    return per_span("serve.prefill", "alloc.device_calls")
