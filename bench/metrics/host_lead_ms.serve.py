"""The median over the window's requests of the smallest host lead among a
request's ``model.block`` spans (``models/model.py::prefill_fn``, one a
layer): the block's device start less its host start. A lead near a
launch's latency (about 0.01 ms) means the device had drained its queue
and waited for the host there."""

from bench.spans import host_lead_ms


def read(rec, run):
    return host_lead_ms("serve.prefill", "model.block")
