"""Zero-perturbation metrics/span/event recording (port of
``repro.obs.metrics``, copied in full).

A lightweight in-process registry of **counters**, **gauges** and
**histograms** (with labels and snapshot/merge semantics, so fork-pool
shards record independently and reconcile), a **span** context manager for
wall-clock profiling of named stages, and a structured **event** log (one
``(t, subsystem, kind, labels)`` record per state transition — brake edges,
planner probes).

Observability *observes, never perturbs*:

* instrumentation call sites are write-only — they never read recorder
  state back into control flow, never touch an RNG, and never reorder
  events — so recorder-on and recorder-off simulations are bit-identical;
* the default recorder is a :class:`NullRecorder` whose methods are
  no-op ``pass`` bodies, so an uninstrumented run pays one dynamic global
  read plus an empty call per site and nothing else;
* recorders are plain Python objects — no threads, no sockets, no global
  side effects beyond the module-level "current recorder" slot managed by
  :func:`set_recorder` / :func:`recording`.

Timestamps: simulation-domain events carry *simulation* time in ``t`` so
event traces are deterministic across runs and worker counts; wall-clock
lives only in spans (which are aggregated, and excluded from determinism
guarantees by nature).
"""

from __future__ import annotations

import time
from bisect import bisect_left
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]
MetricKey = Tuple[str, LabelKey]

# Default histogram upper bounds (seconds-flavored but unit-agnostic):
# roughly geometric from 1 ms to 10 min, wide enough for queueing delays and
# span durations alike. The +inf overflow bucket is implicit.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)


def label_key(labels: Dict[str, object]) -> LabelKey:
    """Canonical hashable form of a label set: sorted (key, str(value))
    pairs. Values are stringified once here so merge/export never depend on
    the original Python type."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


@dataclass
class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus-style): ``counts[i]``
    tallies observations <= ``bounds[i]``, with one implicit +inf overflow
    bucket at the end. Mergeable iff the bucket bounds match."""

    bounds: Tuple[float, ...] = DEFAULT_BUCKETS
    counts: List[int] = field(default_factory=list)  # len(bounds) + 1
    sum: float = 0.0
    count: int = 0

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def merge(self, other: "Histogram") -> None:
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def cumulative(self) -> List[int]:
        """Cumulative counts per bound (Prometheus ``_bucket`` semantics),
        overflow excluded — the +Inf bucket is ``count``."""
        out, acc = [], 0
        for c in self.counts[:-1]:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Approximate quantile from the buckets (upper bound of the bucket
        holding the q-th observation; +inf overflow reports the last finite
        bound). Good enough for report headlines, not for gating."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
        return self.bounds[-1]


@dataclass
class SpanStats:
    """Aggregated wall-clock stats for one named stage."""

    count: int = 0
    total_s: float = 0.0
    min_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.min_s = dt if self.count == 0 else min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        self.count += 1
        self.total_s += dt

    def merge(self, other: "SpanStats") -> None:
        if other.count == 0:
            return
        self.min_s = other.min_s if self.count == 0 else min(self.min_s, other.min_s)
        self.max_s = max(self.max_s, other.max_s)
        self.count += other.count
        self.total_s += other.total_s


@dataclass(frozen=True)
class Event:
    """One structured trace record: *simulation* (or logical) time ``t``,
    the emitting subsystem, an event kind, and a label dict. Events are
    kept in emission order; the JSONL exporter writes them verbatim."""

    t: float
    subsystem: str
    kind: str
    labels: LabelKey = ()

    def labels_dict(self) -> Dict[str, str]:
        return dict(self.labels)


@dataclass
class MetricsSnapshot:
    """A detached, mergeable copy of a recorder's state. ``merge`` is the
    fork-pool reconciliation primitive: counters and histograms add, gauges
    take the **max** per key (order-independent — the gauges the stack
    records are peaks/extents, so max is the only fold that makes merging
    per-member snapshots commutative; last-write-wins would depend on
    worker scheduling), spans fold their aggregates, events concatenate in
    order — so merging per-member snapshots in member order yields a
    worker-count-invariant result."""

    counters: Dict[MetricKey, float] = field(default_factory=dict)
    gauges: Dict[MetricKey, float] = field(default_factory=dict)
    hists: Dict[MetricKey, Histogram] = field(default_factory=dict)
    spans: Dict[MetricKey, SpanStats] = field(default_factory=dict)
    events: List[Event] = field(default_factory=list)

    def merge(self, other: "MetricsSnapshot") -> "MetricsSnapshot":
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0.0) + v
        for k, v in other.gauges.items():
            self.gauges[k] = v if k not in self.gauges \
                else max(self.gauges[k], v)
        for k, h in other.hists.items():
            if k in self.hists:
                self.hists[k].merge(h)
            else:
                self.hists[k] = Histogram(h.bounds, list(h.counts), h.sum, h.count)
        for k, s in other.spans.items():
            if k in self.spans:
                self.spans[k].merge(s)
            else:
                self.spans[k] = SpanStats(s.count, s.total_s, s.min_s, s.max_s)
        self.events.extend(other.events)
        return self

    @property
    def n_events(self) -> int:
        return len(self.events)

    def counter_total(self, name: str) -> float:
        """Sum of one counter across all label sets."""
        return sum(v for (n, _), v in self.counters.items() if n == name)

    def events_of(self, subsystem: Optional[str] = None,
                  kind: Optional[str] = None) -> List[Event]:
        return [e for e in self.events
                if (subsystem is None or e.subsystem == subsystem)
                and (kind is None or e.kind == kind)]


class _NullSpan:
    """Reusable no-op context manager (one shared instance, zero allocs)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The default recorder: every method is a no-op, so instrumentation
    costs one global read + one empty call per site when observability is
    off. ``enabled`` is the cheap gate for sites that would otherwise build
    labels eagerly."""

    enabled = False

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        pass

    def counter_k(self, name: str, value: float = 1.0,
                  labels: LabelKey = ()) -> None:
        pass

    def gauge(self, name: str, value: float, **labels) -> None:
        pass

    def observe(self, name: str, value: float, **labels) -> None:
        pass

    def observe_k(self, name: str, value: float,
                  labels: LabelKey = ()) -> None:
        pass

    def event(self, subsystem: str, kind: str, t: float = 0.0, **labels) -> None:
        pass

    def span(self, name: str, **labels):
        return _NULL_SPAN

    def snapshot(self) -> MetricsSnapshot:
        return MetricsSnapshot()

    def merge_snapshot(self, snap: MetricsSnapshot) -> None:
        pass


NULL_RECORDER = NullRecorder()


class _Span:
    """Wall-clock timing context for one named stage; folds into the
    recorder's per-(name, labels) :class:`SpanStats` on exit."""

    __slots__ = ("_rec", "_key", "_t0")

    def __init__(self, rec: "MetricsRecorder", key: MetricKey):
        self._rec = rec
        self._key = key

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        stats = self._rec.spans.get(self._key)
        if stats is None:
            stats = self._rec.spans[self._key] = SpanStats()
        stats.add(dt)
        return False


class MetricsRecorder(NullRecorder):
    """The real recorder: dict-backed registries keyed by
    ``(name, sorted-labels)``. Single-threaded by design (the whole stack
    is); fork-pool workers each get their own instance and snapshots are
    merged after the join."""

    enabled = True

    def __init__(self, hist_bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.hist_bounds = tuple(hist_bounds)
        self.counters: Dict[MetricKey, float] = {}
        self.gauges: Dict[MetricKey, float] = {}
        self.hists: Dict[MetricKey, Histogram] = {}
        self.spans: Dict[MetricKey, SpanStats] = {}
        self.events: List[Event] = []

    # -- write paths ---------------------------------------------------------
    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, label_key(labels))
        self.counters[key] = self.counters.get(key, 0.0) + value

    def counter_k(self, name: str, value: float = 1.0,
                  labels: LabelKey = ()) -> None:
        """Counter with a pre-canonicalized label key (sorted
        ``(key, str-value)`` pairs) — the per-request hot-site fast path,
        skipping the kwargs build + sort + stringify of :meth:`counter`."""
        key = (name, labels)
        self.counters[key] = self.counters.get(key, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        self.gauges[(name, label_key(labels))] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, label_key(labels))
        h = self.hists.get(key)
        if h is None:
            h = self.hists[key] = Histogram(self.hist_bounds)
        h.observe(float(value))

    def observe_k(self, name: str, value: float,
                  labels: LabelKey = ()) -> None:
        """Histogram observation with a pre-canonicalized label key (see
        :meth:`counter_k`)."""
        key = (name, labels)
        h = self.hists.get(key)
        if h is None:
            h = self.hists[key] = Histogram(self.hist_bounds)
        h.observe(float(value))

    def event(self, subsystem: str, kind: str, t: float = 0.0, **labels) -> None:
        self.events.append(Event(float(t), subsystem, kind, label_key(labels)))

    def span(self, name: str, **labels) -> _Span:
        return _Span(self, (name, label_key(labels)))

    # -- snapshot / merge ----------------------------------------------------
    def snapshot(self) -> MetricsSnapshot:
        """A detached copy safe to pickle across a process boundary."""
        return MetricsSnapshot(
            counters=dict(self.counters),
            gauges=dict(self.gauges),
            hists={k: Histogram(h.bounds, list(h.counts), h.sum, h.count)
                   for k, h in self.hists.items()},
            spans={k: SpanStats(s.count, s.total_s, s.min_s, s.max_s)
                   for k, s in self.spans.items()},
            events=list(self.events),
        )

    def merge_snapshot(self, snap: MetricsSnapshot) -> None:
        """Fold a (worker) snapshot into this recorder, with snapshot-merge
        semantics (counters/hists add, gauges take the per-key max, events
        append in order)."""
        mine = MetricsSnapshot(self.counters, self.gauges, self.hists,
                               self.spans, self.events)
        mine.merge(snap)


# ---------------------------------------------------------------------------
# the current recorder (module-level, single slot)
# ---------------------------------------------------------------------------

_CURRENT: NullRecorder = NULL_RECORDER


def get_recorder() -> NullRecorder:
    """The currently installed recorder (the :data:`NULL_RECORDER` no-op by
    default). Instrumentation sites call this dynamically so Monte-Carlo
    shards can re-route recording per member."""
    return _CURRENT


def set_recorder(rec: Optional[NullRecorder]) -> NullRecorder:
    """Install ``rec`` (None restores the null recorder); returns the
    previously installed recorder so callers can restore it."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = rec if rec is not None else NULL_RECORDER
    return prev


@contextmanager
def recording(rec: Optional[NullRecorder]) -> Iterator[NullRecorder]:
    """Scope ``rec`` as the current recorder for the ``with`` body."""
    prev = set_recorder(rec)
    try:
        yield _CURRENT
    finally:
        set_recorder(prev)
