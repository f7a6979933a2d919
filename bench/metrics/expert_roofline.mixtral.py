"""The expert FFN (``models/moe.py::expert_ffn``, a ``moe.experts`` span
inside each ``model.moe``): the least time its calls' work needs at the
H100's peaks over their device time (the span's CUDA events), in percent.
A call's work is ``bench/moe_yardstick.py::expert_work`` of the rows each
expert computed, the counts ``moe.rows{expert=e}`` of the ``model.moe``
span that holds it."""

from bench.moe_yardstick import expert_work
from bench.spans import timeline
from bench.yardstick import BYTES, bound_s

ROWS = "moe.rows{expert="


def read(rec, run):
    spans = timeline()
    cfg = run.cfg
    bound = busy = 0.0
    for r in spans or ():
        if r.name != "moe.experts" or r.device_start_ns is None or r.parent < 0:
            continue
        counts = spans[r.parent].counts or {}
        rows = [n for key, n in counts.items() if key.startswith(ROWS)]
        if not rows:
            continue
        bound += bound_s(*expert_work(rows, cfg["hidden_size"], cfg["intermediate_size"],
                                      BYTES[cfg["torch_dtype"]]))
        busy += (r.device_end_ns - r.device_start_ns) / 1e9
    return 100.0 * bound / busy if busy > 0 else None
