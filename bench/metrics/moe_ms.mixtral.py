"""The median over the window's requests of a request's summed device
milliseconds of the program's ``model.moe`` spans (``models/model.py::
_ffn_apply``: one an expert layer, around ``moe.moe_apply``: routing, the
dispatch with its host read, the experts and the combine)."""

import statistics

from bench.spans import timeline


def read(rec, run):
    by_request = {}
    for r in timeline() or ():
        if r.name == "model.moe" and r.device_start_ns is not None:
            ms = (r.device_end_ns - r.device_start_ns) / 1e6
            by_request[r.request] = by_request.get(r.request, 0.0) + ms
    return statistics.median(by_request.values()) if by_request else None
