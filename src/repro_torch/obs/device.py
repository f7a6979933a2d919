"""Spans of the port's steps, with their time on the device (the torch
side of :mod:`repro_torch.obs.metrics`).

A site in the port opens ``span(name, ...)`` around a stage of a step
(``serve.prefill``, ``train.step`` and its ``train.forward``,
``train.backward`` and ``train.optimizer``, each ``model.block``,
``model.loss_head``, an MoE block's ``model.moe`` and its
``moe.experts``). The span records into a
:class:`~repro_torch.obs.metrics.MetricsRecorder`'s timeline in two cases:

* the installed recorder is enabled (``obs.recording(MetricsRecorder())``):
  it records there;
* a ``torch.profiler`` session is on (``torch._C._autograd.
  _profiler_enabled()``, the rule ``record_function`` follows), and the
  installed recorder is not enabled: it records into the profiler's
  recorder that this module keeps (:func:`session`), which outlives the
  profiler session, until :func:`new_session` starts another.

A site's counter (``model.logits_products``) goes to the same recorder,
where :func:`active` finds one; :func:`count` (the MoE block's
``moe.rows``, ``moe.dropped_rows``, ``moe.host_reads``) also adds it to
the ``counts`` of every span open there, so a span holds what moved
inside it.

Otherwise a site costs that one check and gets the shared null span: no
label dict, no CUDA event, no timestamp. Nothing records inside a step
that would change its outputs; with CUDA initialised, a span records a
CUDA event on the current stream at entry and one at exit, and, in the
recorder's first span, one reference event on an idle device (the one
synchronise a recorder asks for). :func:`resolve` reads the events after a
synchronise and sets each span's device start and end on the host's
``time.time_ns()`` clock, which is also the clock of ``torch.profiler``'s
timestamps. ``alloc=True`` also reads the caching allocator's
``num_device_alloc + num_device_free`` (calls to ``cudaMalloc`` and
``cudaFree``, which synchronises) at entry and exit, into the span's
``counts["alloc.device_calls"]`` and the recorder's ``alloc.device_calls``
counter, its ``num_alloc_retries`` as a label.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from repro_torch.obs import metrics
from repro_torch.obs.metrics import _NULL_SPAN, MetricsRecorder, SpanRecord, _Span

ALLOC_CALLS = "alloc.device_calls"

_profiler_enabled = torch._C._autograd._profiler_enabled

# the recorder of the spans made under torch.profiler: one a process, as
# the profiler is
_SESSION: Optional[MetricsRecorder] = None


def session() -> Optional[MetricsRecorder]:
    """The recorder of the spans made while ``torch.profiler`` was on
    (and no enabled recorder installed), since :func:`new_session`; None
    before such a span."""
    return _SESSION


def new_session() -> None:
    """Start the profiler's recorder anew: the next span made under the
    profiler opens a new one, with a new reference event."""
    global _SESSION
    _SESSION = None


def active() -> Optional[MetricsRecorder]:
    """The recorder a span made now records into, or None. A site that
    counts (``rec.counter``) asks this once and records only where it is
    not None."""
    global _SESSION
    rec = metrics.get_recorder()
    if rec.enabled:
        return rec
    if not _profiler_enabled():
        return None
    if _SESSION is None:
        _SESSION = MetricsRecorder()
    return _SESSION


class DeviceClock:
    """The reference for one recorder's device times: an event recorded on
    an idle device, and the host ``time.time_ns()`` once it is seen done.
    Device times derived from it read late by at most that round trip."""

    def __init__(self):
        self.ref, self.ref_ns = _anchor()
        self.drift_ppm = 0.0  # the device timer against the host clock, last resolve

    def to_host(self, ev, scale: float) -> int:
        return self.ref_ns + round(self.ref.elapsed_time(ev) * 1e6 * scale)


def _anchor():
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    ev.synchronize()
    return ev, time.time_ns()


def _alloc_stats():
    s = torch.cuda.memory.memory_stats_as_nested_dict()
    return s["num_device_alloc"] + s["num_device_free"], s["num_alloc_retries"]


_STREAMS: dict = {}


def _current_stream():
    """``torch.cuda.current_stream()``, one ``Stream`` object a stream kept
    here: the public call builds a new one each time, a fifth of a span's
    host cost."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                   device_type=key[2])
    return stream


class _DeviceSpan(_Span):
    """A recorder's span with a CUDA event at entry and at exit on the
    current stream (where the recorder's clock is on a card), and the
    allocator's calls inside it (``alloc``)."""

    __slots__ = ("_clock", "_alloc", "_stream", "_start", "_before")

    def __init__(self, rec: MetricsRecorder, key, alloc: bool):
        super().__init__(rec, key)
        if rec.device_clock is None:
            rec.device_clock = (DeviceClock() if torch.cuda.is_available()
                                and torch.cuda.is_initialized() else False)
        self._clock = rec.device_clock
        self._alloc = alloc and bool(self._clock)

    def __enter__(self):
        if self._alloc:
            self._before = _alloc_stats()
        super().__enter__()
        if self._clock:
            self._stream = _current_stream()
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        return self

    def __exit__(self, *exc):
        r = self.record
        if self._clock:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            r.marks = (self._start, end)
        super().__exit__(*exc)
        if self._alloc:
            calls, retries = _alloc_stats()
            moved = calls - self._before[0]
            r.counts = {**(r.counts or {}), ALLOC_CALLS: moved}
            self._rec.counter(ALLOC_CALLS, moved, span=r.name,
                              alloc_retries=retries - self._before[1])
        return False


def span(name: str, *, request: Optional[int] = None, step: Optional[int] = None,
         tokens: Optional[int] = None, layer: Optional[int] = None, alloc: bool = False):
    """A span of the port's step (see the module's docstring): the shared
    null span unless a recorder records now. ``request``, ``step``,
    ``tokens`` and ``layer`` are its labels where given; ``alloc`` counts
    the allocator's calls to the device inside it."""
    rec = active()
    if rec is None:
        return _NULL_SPAN
    labels = tuple((k, str(v)) for k, v in (("layer", layer), ("request", request),
                                            ("step", step), ("tokens", tokens)) if v is not None)
    return _DeviceSpan(rec, (name, labels), alloc)  # labels in label_key's (sorted) order


def count_key(name: str, **labels) -> str:
    """The key of counter ``name`` with ``labels`` in a span's ``counts``:
    ``moe.rows{expert=3}``; ``name`` alone without labels."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def count(rec: MetricsRecorder, name: str, value: float = 1.0, **labels) -> None:
    """``value`` added to ``rec``'s counter ``name`` (``labels``) and to the
    ``counts`` of every span open in ``rec``, under ``name`` and, with
    labels, under :func:`count_key` too. The site asks :func:`active` for
    ``rec`` once and counts only where it is not None."""
    rec.counter(name, value, **labels)
    keys = (name,) if not labels else (name, count_key(name, **labels))
    for i in rec.open_spans:
        r = rec.timeline[i]
        if r.counts is None:
            r.counts = {}
        for k in keys:
            r.counts[k] = r.counts.get(k, 0) + value


def resolve(rec: MetricsRecorder) -> List[SpanRecord]:
    """``rec``'s timeline with every closed span's device start and end
    set (host ``time.time_ns()`` clock), where it recorded device events.
    Synchronises once, then maps the device timer onto the host clock
    through the reference event and one more recorded now, so that a
    drift between the two clocks over the session cancels."""
    pending = [r for r in rec.timeline if r.marks is not None]
    clock = rec.device_clock
    if pending and clock:
        now, now_ns = _anchor()
        device_ns = clock.ref.elapsed_time(now) * 1e6
        scale = (now_ns - clock.ref_ns) / device_ns if device_ns > 0 else 1.0
        clock.drift_ppm = (scale - 1.0) * 1e6
        for r in pending:
            a, b = r.marks
            r.device_start_ns, r.device_end_ns = clock.to_host(a, scale), clock.to_host(b, scale)
            r.marks = None
    return rec.timeline
