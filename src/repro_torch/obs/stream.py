"""Streaming window aggregation riding the telemetry tick (port of
``repro.obs.stream``, copied in full; DESIGN.md §15).

POLCA's control plane is alert-driven: detect cap proximity under a 40 s
out-of-band actuation delay, then mitigate. The recorder (``obs.metrics``)
is the *passive* half — it remembers everything and reads nothing. This
module is the online half's substrate: windowed aggregates over the fleet's
telemetry tick stream that an alerting engine (``obs.alerts``) can evaluate
*during* the run, with strictly bounded state:

* :class:`P2Quantile` — the P² (Jain & Chlamtac) online quantile estimator:
  five markers, O(1) memory and O(1) per observation, no sample buffer;
* :class:`EwmaSlope` — Holt-style double exponential smoothing (EWMA level
  + EWMA trend) whose :meth:`~EwmaSlope.projected` value looks exactly one
  OOB actuation horizon ahead (40 s, the same horizon
  :class:`~repro_torch.fleet.controller.PowerForecaster` forecasts over) — the
  streaming analogue of the controller's least-squares extrapolation;
* :class:`TumblingWindow` — fixed-width aligned windows with running
  count/mean/min/max and one P² digest per requested quantile; closing a
  window emits an immutable :class:`WindowStats`;
* :class:`SlidingCounter` — a ring buffer of per-tick increments giving an
  O(1)-per-tick rolling sum over the trailing window (rates: brake edges
  per minute, shed per offered);
* :class:`FleetStream` — the composite the fleet tick feeds once per
  telemetry sample: per-node power-fraction windows, the root-envelope
  EWMA slope, brake/shed/offered sliding channels, and a queue-age window.

Everything here is plain arithmetic over values the caller already holds:
no RNG, no recorder reads, no extra passes over history — feeding a stream
cannot perturb a simulation (the alerts-on/off bit-parity contract in
``tests/test_alerts.py`` rides on that).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: The paper's out-of-band telemetry/actuation latency (Table 1) — the
#: horizon `EwmaSlope.projected` looks ahead by default, matching
#: ``PowerForecaster(horizon_s=...)`` so streaming detection and controller
#: actuation reason about the same future instant.
OOB_HORIZON_S = 40.0


class P2Quantile:
    """The P² algorithm: estimate one quantile online with five markers.

    Exact for the first five observations, then maintains marker heights by
    piecewise-parabolic interpolation — O(1) state, O(1) per observation,
    no buffer. Deterministic: same observation sequence, same estimate.
    """

    __slots__ = ("q", "n", "_h", "_pos", "_des", "_inc")

    def __init__(self, q: float):
        if not (0.0 < q < 1.0):
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.n = 0
        self._h: List[float] = []  # marker heights (first 5 obs, sorted)
        self._pos: List[float] = []
        self._des: List[float] = []
        self._inc: List[float] = []

    def observe(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.n <= 5:
            # exact phase: keep the sorted sample
            lo, hi = 0, len(self._h)
            while lo < hi:
                mid = (lo + hi) // 2
                if self._h[mid] < x:
                    lo = mid + 1
                else:
                    hi = mid
            self._h.insert(lo, x)
            if self.n == 5:
                q = self.q
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._des = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                             3.0 + 2.0 * q, 5.0]
                self._inc = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]
            return
        h, pos = self._h, self._pos
        # locate the cell (extending the extremes when x falls outside)
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and not (h[k] <= x < h[k + 1]):
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._des[i] += self._inc[i]
        # adjust the three interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._des[i] - pos[i]
            if ((d >= 1.0 and pos[i + 1] - pos[i] > 1.0)
                    or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0)):
                d = 1.0 if d > 0 else -1.0
                hp = self._parabolic(i, d)
                if not (h[i - 1] < hp < h[i + 1]):
                    hp = h[i] + d * ((h[i + int(d)] - h[i])
                                     / (pos[i + int(d)] - pos[i]))
                h[i] = hp
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, pos = self._h, self._pos
        return h[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i])
            / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1])
            / (pos[i] - pos[i - 1]))

    def value(self) -> float:
        """The current estimate (NaN with no observations; exact while
        n <= 5)."""
        if self.n == 0:
            return math.nan
        if self.n <= 5:
            idx = min(len(self._h) - 1,
                      max(0, int(math.ceil(self.q * self.n)) - 1))
            return self._h[idx]
        return self._h[2]


class EwmaSlope:
    """Holt-style double exponential smoothing over an irregular tick
    stream: an EWMA level plus an EWMA trend (per-second slope), projected
    one OOB actuation horizon ahead. O(1) state; deterministic."""

    __slots__ = ("horizon_s", "alpha", "beta", "level", "slope", "_t_prev")

    def __init__(self, *, horizon_s: float = OOB_HORIZON_S,
                 alpha: float = 0.3, beta: float = 0.1):
        if not (0.0 < alpha <= 1.0 and 0.0 < beta <= 1.0):
            raise ValueError("alpha/beta must be in (0, 1]")
        self.horizon_s = float(horizon_s)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.level: Optional[float] = None
        self.slope = 0.0  # per second
        self._t_prev: Optional[float] = None

    def observe(self, t: float, x: float) -> None:
        t, x = float(t), float(x)
        if self.level is None:
            self.level, self._t_prev = x, t
            return
        dt = t - self._t_prev
        if dt <= 0.0:
            return  # duplicate tick: nothing to extrapolate over
        self._t_prev = t
        prev = self.level
        self.level = (self.alpha * x
                      + (1.0 - self.alpha) * (prev + self.slope * dt))
        inst = (self.level - prev) / dt
        self.slope = self.beta * inst + (1.0 - self.beta) * self.slope

    def projected(self, horizon_s: Optional[float] = None) -> float:
        """Level extrapolated ``horizon_s`` (default: the OOB horizon)
        seconds ahead — NaN until the first observation."""
        if self.level is None:
            return math.nan
        h = self.horizon_s if horizon_s is None else float(horizon_s)
        return self.level + self.slope * h


@dataclass(frozen=True)
class WindowStats:
    """One closed window's aggregates: span, count, running moments, and
    the P² quantile estimates that were live when the window rolled."""

    t_start: float
    t_end: float
    count: int
    mean: float
    minimum: float
    maximum: float
    quantiles: Tuple[Tuple[float, float], ...] = ()  # (q, estimate)

    def quantile(self, q: float) -> float:
        for qq, v in self.quantiles:
            if qq == q:
                return v
        raise KeyError(f"window has no q={q} digest "
                       f"(tracked: {[qq for qq, _ in self.quantiles]})")


class TumblingWindow:
    """Fixed-width windows aligned to multiples of ``width_s``: running
    count/sum/min/max plus one :class:`P2Quantile` per requested quantile.
    ``observe`` returns the just-closed :class:`WindowStats` when the
    observation lands in a new window, else ``None``; the most recent
    closed window stays readable at :attr:`last`."""

    __slots__ = ("width_s", "qs", "last", "_k", "_count", "_sum", "_min",
                 "_max", "_digests")

    def __init__(self, width_s: float, quantiles: Sequence[float] = (0.5, 0.99)):
        if width_s <= 0.0:
            raise ValueError(f"window width must be positive, got {width_s}")
        self.width_s = float(width_s)
        self.qs = tuple(float(q) for q in quantiles)
        self.last: Optional[WindowStats] = None
        self._k: Optional[int] = None
        self._reset()

    def _reset(self) -> None:
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._digests = [P2Quantile(q) for q in self.qs]

    def _close(self) -> WindowStats:
        k = self._k
        return WindowStats(
            t_start=k * self.width_s,
            t_end=(k + 1) * self.width_s,
            count=self._count,
            mean=self._sum / self._count if self._count else math.nan,
            minimum=self._min if self._count else math.nan,
            maximum=self._max if self._count else math.nan,
            quantiles=tuple((q, d.value())
                            for q, d in zip(self.qs, self._digests)),
        )

    def observe(self, t: float, x: float) -> Optional[WindowStats]:
        k = int(math.floor(float(t) / self.width_s))
        closed = None
        if self._k is None:
            self._k = k
        elif k != self._k:
            closed = self.last = self._close()
            self._k = k
            self._reset()
        x = float(x)
        self._count += 1
        self._sum += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        for d in self._digests:
            d.observe(x)
        return closed

    @property
    def live_count(self) -> int:
        """Observations in the currently-open window."""
        return self._count


class SlidingCounter:
    """Rolling sum of per-tick increments over the trailing ``width_s``
    seconds: a fixed ring of ``round(width_s / tick_s)`` slots, one
    :meth:`push` per telemetry tick, O(1) each. ``total`` is the windowed
    sum; ``filled`` says whether a full window has elapsed yet."""

    __slots__ = ("n_slots", "_ring", "_idx", "_pushed", "total")

    def __init__(self, width_s: float, tick_s: float):
        if width_s <= 0.0 or tick_s <= 0.0:
            raise ValueError("width_s and tick_s must be positive")
        self.n_slots = max(1, int(round(width_s / tick_s)))
        self._ring = [0.0] * self.n_slots
        self._idx = 0
        self._pushed = 0
        self.total = 0.0

    def push(self, x: float) -> None:
        x = float(x)
        self.total += x - self._ring[self._idx]
        self._ring[self._idx] = x
        self._idx = (self._idx + 1) % self.n_slots
        self._pushed += 1

    @property
    def filled(self) -> bool:
        return self._pushed >= self.n_slots


class FleetStream:
    """The fleet's per-tick streaming aggregate, fed once per telemetry
    sample by :meth:`observe` with values the fleet driver already computed
    (no extra passes over history, no recorder reads, no RNG):

    * latest per-node power fractions + one :class:`TumblingWindow` with a
      P² digest per tracked node (``window_nodes``; default every node — a
      caller that only consumes instantaneous fractions and rate channels,
      like the alert engine, passes ``()`` and pays nothing per tick);
    * :class:`EwmaSlope` on the root (site) fraction, projected over the
      OOB horizon;
    * per-tick deltas for brake edges / shed / offered, fanned into any
      registered :class:`SlidingCounter` channels (rules size their own
      windows via :meth:`sliding`);
    * a queue-age tumbling window over the oldest queued request's age.

    State is O(tracked nodes + registered windows), independent of run
    length.
    """

    CHANNELS = ("brake_edges", "shed", "offered")

    def __init__(self, tick_s: float, *, window_s: float = 60.0,
                 horizon_s: float = OOB_HORIZON_S,
                 quantiles: Sequence[float] = (0.5, 0.99),
                 window_nodes: Optional[Sequence[int]] = None):
        self.tick_s = float(tick_s)
        self.window_s = float(window_s)
        self.quantiles = tuple(quantiles)
        self.window_nodes = (None if window_nodes is None
                             else tuple(int(i) for i in window_nodes))
        self.t: Optional[float] = None
        self.n_ticks = 0
        self.node_frac: Optional[np.ndarray] = None  # latest [N]
        self.braked: Optional[np.ndarray] = None  # latest [R] bool
        self.queue_depth = 0
        self.root_slope = EwmaSlope(horizon_s=horizon_s)
        self.queue_age = TumblingWindow(self.window_s, self.quantiles)
        self.node_windows: Dict[int, TumblingWindow] = {}
        # per-tick deltas of the most recent observe() call
        self.brake_edges_tick = 0
        self.shed_tick = 0
        self.offered_tick = 0
        self._prev_braked: Optional[np.ndarray] = None
        self._prev_shed = 0
        self._prev_offered = 0
        self._sliding: Dict[str, List[SlidingCounter]] = {
            c: [] for c in self.CHANNELS}

    def sliding(self, channel: str, width_s: float) -> SlidingCounter:
        """Register (and return) a sliding window over one per-tick delta
        channel (``brake_edges`` / ``shed`` / ``offered``); the stream
        pushes into it on every subsequent tick."""
        if channel not in self._sliding:
            raise KeyError(f"unknown stream channel {channel!r} "
                           f"(known: {sorted(self._sliding)})")
        c = SlidingCounter(width_s, self.tick_s)
        self._sliding[channel].append(c)
        return c

    def observe(self, t: float, node_frac: np.ndarray, braked: np.ndarray,
                shed_total: int, offered_total: int, queue_depth: int = 0,
                max_queue_age_s: Optional[float] = None) -> None:
        """Fold one telemetry tick into every window. ``node_frac`` is the
        full leaves-first node power-fraction vector (root last) measured
        against the budgets in force this tick — exactly the per-tick rows
        of ``FleetResult.node_power_frac``. ``max_queue_age_s=None`` skips
        the queue-age window (callers that don't scan queues pay
        nothing)."""
        self.t = float(t)
        self.n_ticks += 1
        self.node_frac = node_frac
        self.braked = braked
        self.queue_depth = int(queue_depth)
        if self.window_nodes is None or self.window_nodes:
            idxs = (range(len(node_frac)) if self.window_nodes is None
                    else (i if i >= 0 else len(node_frac) + i
                          for i in self.window_nodes))
            for i in idxs:
                w = self.node_windows.get(i)
                if w is None:
                    w = self.node_windows[i] = TumblingWindow(
                        self.window_s, self.quantiles)
                w.observe(t, float(node_frac[i]))
        self.root_slope.observe(t, float(node_frac[-1]))
        if max_queue_age_s is not None:
            self.queue_age.observe(t, float(max_queue_age_s))
        if self._prev_braked is None:
            self.brake_edges_tick = int(np.count_nonzero(braked))
        else:
            self.brake_edges_tick = int(
                np.count_nonzero(braked != self._prev_braked))
        self._prev_braked = braked
        self.shed_tick = int(shed_total) - self._prev_shed
        self._prev_shed = int(shed_total)
        self.offered_tick = int(offered_total) - self._prev_offered
        self._prev_offered = int(offered_total)
        sliding = self._sliding
        for c in sliding["brake_edges"]:
            c.push(float(self.brake_edges_tick))
        for c in sliding["shed"]:
            c.push(float(self.shed_tick))
        for c in sliding["offered"]:
            c.push(float(self.offered_tick))

    def projected_root_frac(self) -> float:
        """The root power fraction one OOB horizon ahead (NaN before the
        first tick)."""
        return self.root_slope.projected()
