"""Discrete-event simulator of an LLM inference row under POLCA (paper §6;
port of ``repro.core.simulator``, copied in full: plain Python and numpy,
the same float operations in the same order, so its results equal the JAX
package's bit for bit).

Model (matches §6.1):
  * a row of N servers, each dedicated to one workload class (Table 4 mix)
    with a one-request buffer (load-balanced arrivals, queueing delays);
  * each request: prefill phase (compute-bound power spike) then
    ``out_tokens`` of decode (memory-bound, low flat power) — timings and
    per-phase power from ``core.workload`` (roofline-derived);
  * a rack power manager samples row power every ``telemetry_s`` (2 s, Table 1)
    and runs a policy (Algorithm 1 or a baseline); frequency-cap commands take
    effect after ``oob_latency_s`` (40 s), powerbrake after ``brake_latency_s``
    (5 s);
  * oversubscription: provisioned row power is set for ``n_provisioned``
    servers; the row actually hosts N >= n_provisioned.

Everything is deterministic given the trace (seeded), so policy comparisons
diff per-request latencies against an uncapped reference run.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.power_model import FREQ_UNCAPPED, ServerPower
from repro_torch.core.slo import LatencyStats
from repro_torch.core.telemetry import Telemetry, dispatch
from repro_torch.core.workload import RequestTiming
from repro_torch.obs.metrics import get_recorder


@dataclass(frozen=True)
class Request:
    t_arrival: float
    wl: int  # workload-class index
    prompt: int
    out_tokens: int
    priority: str  # "high" | "low"
    rid: int


@dataclass(frozen=True)
class WorkloadClass:
    name: str
    timing: RequestTiming  # from core.workload.request_timing
    priority_mix: float  # fraction of requests that are high priority


@dataclass
class SimConfig:
    telemetry_s: float = 2.0
    oob_latency_s: float = 40.0
    brake_latency_s: float = 5.0
    power_scale: float = 1.0  # robustness runs: x1.05 = +5% workload power
    record_power: bool = True
    power_sample_s: float = 2.0


@dataclass
class SimResult:
    latency: LatencyStats
    n_brakes: int
    n_dropped: int
    n_completed: int
    served_tokens: float
    peak_power_frac: float
    mean_power_frac: float
    power_t: np.ndarray = field(default=None, repr=False)
    power_w: np.ndarray = field(default=None, repr=False)
    # per-sample powerbrake state on the power_t grid (True while the row's
    # policy holds the brake) — the signal runtime.fault_tolerance's
    # BrakeSentinel turns into sustained-brake power events
    braked_series: np.ndarray = field(default=None, repr=False)
    latencies: Dict[int, float] = field(default_factory=dict, repr=False)
    cap_events: int = 0
    # time each completed request waited before prefill started (fleet
    # routing attributes queueing delay per dispatch decision from this)
    queue_delays: Dict[int, float] = field(default_factory=dict, repr=False)

    def spike(self, window_s: float) -> float:
        """Max increase of power (fraction of provisioned) over any window."""
        if self.power_w is None or len(self.power_w) < 3:
            return 0.0
        dt = self.power_t[1] - self.power_t[0]
        k = max(1, int(round(window_s / dt)))
        w = self.power_w
        diffs = w[k:] - w[:-k]
        return float(diffs.max()) if len(diffs) else 0.0


class _Server:
    __slots__ = ("idx", "wl", "priority", "state", "queue", "cur", "work_left",
                 "epoch", "freq", "t_service_start", "power_w", "t_last",
                 "power_state")

    def __init__(self, idx, wl, priority):
        self.idx = idx
        self.wl = wl
        self.priority = priority
        self.state = "idle"  # idle | prefill | decode
        self.queue: List[Request] = []
        self.cur: Optional[Request] = None
        self.work_left = 0.0  # seconds of f=1 work in current phase
        self.epoch = 0
        self.freq = FREQ_UNCAPPED
        self.t_service_start = 0.0
        self.power_w = 0.0
        self.t_last = 0.0
        self.power_state = "idle"  # state the power buckets last attributed


class RowSimulator:
    def __init__(self, workloads: List[WorkloadClass], server_power: ServerPower,
                 n_servers: int, n_provisioned: int, policy, requests: List[Request],
                 wl_server_share: List[float], sim_cfg: SimConfig = None,
                 duration: float = None, rng_seed: int = 0,
                 provisioned_w: float = None, row_index: int = 0):
        self.workloads = workloads
        self.sp = server_power
        self.policy = policy
        self.cfg = sim_cfg or SimConfig()
        self.provisioned_w = provisioned_w or (n_provisioned * server_power.provisioned_w)
        self.requests = requests
        self.duration = duration or (requests[-1].t_arrival + 600 if requests else 600)
        self.rng = np.random.default_rng(rng_seed)
        self.row_index = row_index
        # ancestor budget fractions, published by the hierarchy driver
        # (ClusterSimulator / FleetSimulator) before each lockstep tick (one
        # tick stale — rack managers aggregate with delay): a level-indexed
        # vector ordered nearest enclosure first (rack, [pdu-set, ...], root).
        # (None, None) on standalone rows. Read/write through the
        # ``group_fracs`` property (legacy 2-tuple view) or
        # ``group_frac_vec`` (the full vector).
        self._group_frac_vec: Tuple[Optional[float], ...] = (None, None)

        # dedicate servers to workload classes per the Table-4 share
        self.servers: List[_Server] = []
        counts = [max(1, int(round(s * n_servers))) for s in wl_server_share]
        while sum(counts) > n_servers:
            counts[counts.index(max(counts))] -= 1
        while sum(counts) < n_servers:
            counts[counts.index(min(counts))] += 1
        idx = 0
        self.by_wl: Dict[int, List[_Server]] = {i: [] for i in range(len(workloads))}
        for w, c in enumerate(counts):
            n_hp = int(round(c * workloads[w].priority_mix))
            for j in range(c):
                prio = "high" if j < n_hp else "low"
                s = _Server(idx, w, prio)
                self.servers.append(s)
                self.by_wl[w].append(s)
                idx += 1

        self.row_power = sum(self._server_power(s) for s in self.servers)
        self.prio_power = {"high": 0.0, "low": 0.0}
        self.phase_power = {"idle": 0.0, "prefill": 0.0, "decode": 0.0}
        for s in self.servers:
            s.power_w = self._server_power(s)
            s.power_state = s.state
            self.prio_power[s.priority] += s.power_w
            self.phase_power[s.state] += s.power_w

        self.lp_freq = FREQ_UNCAPPED
        self.hp_freq = FREQ_UNCAPPED
        self.events: List[Tuple[float, int, str, tuple]] = []
        self._eid = 0
        self.result = SimResult(LatencyStats(), 0, 0, 0, 0.0, 0.0, 0.0)
        self._power_samples_t: List[float] = []
        self._power_samples_w: List[float] = []
        self._braked_samples: List[bool] = []
        # last brake state seen on the telemetry grid, for edge events
        # (matches braked_series semantics: initial state is unbraked)
        self._last_braked = False
        self._power_integral = 0.0
        self._last_power_t = 0.0
        self._peak = 0.0
        self._t = 0.0
        self._started = False
        self._past_end = False
        # budget-era accounting, only engaged once set_budget() is called
        # (the fleet rebalancing controller): peak/mean power *fractions*
        # must be measured against the budget in force when the power was
        # drawn, not the final budget
        self._budget_moved = False
        self._era_peak = 0.0
        self._era_integral0 = 0.0
        self._frac_peak = 0.0
        self._frac_integral = 0.0

    # ------------------------------------------------------------------
    @property
    def group_frac_vec(self) -> Tuple[Optional[float], ...]:
        """Ancestor budget fractions, nearest level first, root last."""
        return self._group_frac_vec

    @property
    def group_fracs(self) -> Tuple[Optional[float], Optional[float]]:
        """Back-compat 2-tuple view of :attr:`group_frac_vec`:
        ``(rack_frac, cluster_frac)`` = (nearest enclosure, root). On the
        classic two-level tree this is exactly the full vector; on deeper
        trees the intermediate levels are visible via ``group_frac_vec``."""
        vec = self._group_frac_vec
        if not vec:
            return (None, None)
        return (vec[0], vec[-1])

    @group_fracs.setter
    def group_fracs(self, vec) -> None:
        """Accepts a tuple of any depth >= 1 (hierarchy publishers write the
        full ancestor vector here; legacy writers pass the 2-tuple)."""
        self._group_frac_vec = tuple(vec)

    def _push(self, t, kind, args=()):
        self._eid += 1
        heapq.heappush(self.events, (t, self._eid, kind, args))

    def _server_power(self, s: _Server) -> float:
        dev = self.sp.device
        n = self.sp.n_devices
        if s.state == "idle":
            p = n * dev.idle_w + self.sp.other_w
        else:
            wl = self.workloads[s.wl]
            point = wl.timing.prefill_point if s.state == "prefill" else wl.timing.token_point
            p = point.power_at(self.sp, s.freq)
        return p * self.cfg.power_scale

    def _update_power(self, s: _Server, t: float):
        new_p = self._server_power(s)
        if new_p != s.power_w or s.state != s.power_state:
            self._account_power(t)
            self.row_power += new_p - s.power_w
            self.prio_power[s.priority] += new_p - s.power_w
            self.phase_power[s.power_state] -= s.power_w
            self.phase_power[s.state] += new_p
            s.power_state = s.state
            s.power_w = new_p
            self._peak = max(self._peak, self.row_power)
            if self._budget_moved:
                self._era_peak = max(self._era_peak, self.row_power)

    def _account_power(self, t: float):
        self._power_integral += self.row_power * (t - self._last_power_t)
        self._last_power_t = t

    def set_budget(self, budget_w: float, t: float):
        """Change the row power budget at time ``t`` (the fleet rebalancing
        controller's actuation point). Closes the current budget *era* so
        ``peak_power_frac``/``mean_power_frac`` stay measured against the
        budget in force when the power was drawn: the watts-integral and
        running peak accumulated so far are folded into fraction space at
        the old budget before the new one takes effect. Rows that never see
        a ``set_budget`` call keep the original (bit-identical) single-era
        accounting."""
        self._account_power(t)  # fold the open watts segment at the old budget
        if not self._budget_moved:
            self._budget_moved = True
            self._era_peak = self._peak
        self._frac_peak = max(self._frac_peak,
                              self._era_peak / self.provisioned_w)
        self._frac_integral += ((self._power_integral - self._era_integral0)
                                / self.provisioned_w)
        self._era_integral0 = self._power_integral
        self._era_peak = self.row_power  # the standing draw opens the new era
        self.provisioned_w = float(budget_w)

    # ------------------------------------------------------------------
    def _start_next(self, s: _Server, t: float):
        if not s.queue:
            s.state = "idle"
            s.cur = None
            self._update_power(s, t)
            return
        req = s.queue.pop(0)
        s.cur = req
        s.state = "prefill"
        s.t_service_start = t
        wl = self.workloads[s.wl]
        s.work_left = wl.timing.t_prefill
        s.epoch += 1
        self._schedule_phase_end(s, t)
        self._update_power(s, t)

    def _rate(self, s: _Server) -> float:
        """Work-seconds per wall-second at the current frequency."""
        wl = self.workloads[s.wl]
        point = wl.timing.prefill_point if s.state == "prefill" else wl.timing.token_point
        return 1.0 / self.sp.device.perf_scale(point.compute_frac, s.freq)

    def _schedule_phase_end(self, s: _Server, t: float):
        s.t_last = t
        dt = s.work_left / self._rate(s)
        self._push(t + dt, "phase_end", (s.idx, s.epoch))

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        """Standalone run: start, drain every event, finalize."""
        self.start()
        self.advance_to(self.duration)
        return self.finalize()

    def start(self):
        """Seed the event queue. Idempotent so run() after start() is safe."""
        if self._started:
            return
        self._started = True
        for r in self.requests:
            self._push(r.t_arrival, "arrival", (r,))
        self._push(self.cfg.telemetry_s, "telemetry", ())

    def inject(self, req: Request):
        """Accept an externally dispatched request (the fleet routing layer).

        The arrival rides the same event queue as trace arrivals, so a row
        fed one request at a time by a dispatcher reproduces the standalone
        trace run bit-for-bit (arrival times are continuous, so relative
        event order is decided by time alone).
        Must be called after ``start()``; the arrival must lie within the
        row's duration. A row that already drained past its duration (its
        next queued event overshot — possible in the final partial telemetry
        window when duration is not a multiple of telemetry_s) is revived:
        the overshoot event was discarded, but any event beyond the duration
        is side-effect-free by definition, so processing the late arrival is
        exactly what the standalone trace path would have done."""
        if not self._started:
            raise RuntimeError("inject() before start()")
        if req.t_arrival > self.duration:
            raise ValueError(
                f"inject() at t={req.t_arrival:.1f} beyond the row duration "
                f"({self.duration:.1f})")
        self._past_end = False
        self._push(req.t_arrival, "arrival", (req,))

    def advance_to(self, t_target: float) -> bool:
        """Process every event with t <= min(t_target, duration). Returns
        False once the row is past its duration (no more work will happen).

        ``run()`` is exactly ``advance_to(duration)``; ClusterSimulator calls
        this tick-by-tick to lockstep N rows, which therefore reproduces the
        standalone event sequence bit-for-bit."""
        if self._past_end:
            return False
        while self.events:
            item = heapq.heappop(self.events)
            t = item[0]
            if t > self.duration:
                self._t = t  # matches the standalone loop's break-with-overshoot
                self._past_end = True
                return False
            if t > t_target:
                heapq.heappush(self.events, item)  # same eid: order preserved
                return True
            self._t = t
            self._handle(t, item[2], item[3])
        return False

    def finalize(self) -> SimResult:
        res = self.result
        t = self._t
        self._account_power(t if t <= self.duration else self.duration)
        res.n_brakes = self.policy.n_brakes
        dur = max(1e-9, self._last_power_t)
        if self._budget_moved:
            # per-era fractions: each watt-second against its era's budget
            res.peak_power_frac = max(self._frac_peak,
                                      self._era_peak / self.provisioned_w)
            res.mean_power_frac = (self._frac_integral
                                   + (self._power_integral - self._era_integral0)
                                   / self.provisioned_w) / dur
        else:
            res.peak_power_frac = self._peak / self.provisioned_w
            res.mean_power_frac = self._power_integral / dur / self.provisioned_w
        if self.cfg.record_power:
            res.power_t = np.asarray(self._power_samples_t)
            res.power_w = np.asarray(self._power_samples_w)
            res.braked_series = np.asarray(self._braked_samples, dtype=bool)
        return res

    def candidates(self, wl: int, priority: str) -> List[_Server]:
        """The server pool a request of (wl, priority) is served from: the
        workload class AND the request's priority pool — HP requests must not
        land on LP-capped servers — falling back to the whole class when the
        priority sub-pool is empty. The fleet router scores rows against this
        same pool (single source of the eligibility rule)."""
        cands = [s for s in self.by_wl[wl] if s.priority == priority]
        return cands if cands else self.by_wl[wl]

    def sample_telemetry(self, t: float) -> Telemetry:
        """The structured controller sample at time t (see core.telemetry)."""
        rack_frac, cluster_frac = self.group_fracs
        vec = self._group_frac_vec
        group_vec = vec if (vec and vec[0] is not None) else None
        return Telemetry(
            t=t,
            power_frac=self.row_power / self.provisioned_w,
            hp_power_frac=self.prio_power["high"] / self.provisioned_w,
            lp_power_frac=self.prio_power["low"] / self.provisioned_w,
            prefill_power_frac=self.phase_power["prefill"] / self.provisioned_w,
            lp_freq=self.lp_freq,
            hp_freq=self.hp_freq,
            braked=bool(getattr(self.policy, "braked", False)),
            row_index=self.row_index,
            rack_power_frac=rack_frac,
            cluster_power_frac=cluster_frac,
            group_power_fracs=group_vec,
        )

    def _handle(self, t: float, kind: str, args: tuple):
        res = self.result
        if kind == "arrival":
            (req,) = args
            cands = self.candidates(req.wl, req.priority)
            idle = [s for s in cands if s.state == "idle"]
            buf = [s for s in cands if s.state != "idle" and len(s.queue) < 1]
            if idle:
                s = idle[int(self.rng.integers(len(idle)))]
                s.queue.append(req)
                self._start_next(s, t)
            elif buf:
                s = min(buf, key=lambda x: len(x.queue))
                s.queue.append(req)
            else:
                res.n_dropped += 1
        elif kind == "phase_end":
            sid, epoch = args
            s = self.servers[sid]
            if epoch != s.epoch or s.state == "idle":
                return  # stale event
            if s.state == "prefill":
                s.state = "decode"
                wl = self.workloads[s.wl]
                s.work_left = s.cur.out_tokens * wl.timing.t_token
                s.epoch += 1
                self._schedule_phase_end(s, t)
                self._update_power(s, t)
            else:
                req = s.cur
                wl = self.workloads[s.wl]
                # unqueued, uncapped ideal latency
                ideal = wl.timing.t_prefill + req.out_tokens * wl.timing.t_token
                actual = t - req.t_arrival
                res.latency.add(req.priority, actual, ideal)
                res.latencies[req.rid] = actual
                qd = s.t_service_start - req.t_arrival
                res.queue_delays[req.rid] = qd
                res.n_completed += 1
                res.served_tokens += req.out_tokens
                # write-only observability: a no-op on the NullRecorder
                # default, never read back into simulation state
                get_recorder().observe_k("row_queue_delay_seconds", qd,
                                         (("priority", req.priority),))
                self._start_next(s, t)
        elif kind == "telemetry":
            tel = self.sample_telemetry(t)
            for cmd in dispatch(self.policy, tel):
                lat = self.cfg.brake_latency_s if cmd.brake else self.cfg.oob_latency_s
                self._push(t + lat, "apply", (cmd.lp_freq, cmd.hp_freq))
                res.cap_events += 1
            if self.cfg.record_power:
                self._power_samples_t.append(t)
                self._power_samples_w.append(tel.power_frac)
                braked = bool(tel.braked)
                self._braked_samples.append(braked)
                if braked != self._last_braked:
                    # brake engage/release *edge* events, emitted at the
                    # same sample point braked_series records — so edge
                    # counts in the event trace reconcile exactly with
                    # braked_series transitions
                    self._last_braked = braked
                    rec = get_recorder()
                    rec.event("row",
                              "brake_engage" if braked else "brake_release",
                              t=t, row=self.row_index)
                    rec.counter("row_brake_edges_total",
                                edge="engage" if braked else "release",
                                row=self.row_index)
            self._push(t + self.cfg.telemetry_s, "telemetry", ())
        elif kind == "apply":
            lp, hp = args
            if lp is not None:
                self.lp_freq = lp
            if hp is not None:
                self.hp_freq = hp
            for s in self.servers:
                f = self.lp_freq if s.priority == "low" else self.hp_freq
                if f != s.freq:
                    if s.state != "idle":
                        # bank progress at the old rate, then re-plan
                        s.work_left = max(
                            0.0, s.work_left - (t - s.t_last) * self._rate(s))
                        s.freq = f
                        s.epoch += 1
                        self._schedule_phase_end(s, t)
                    else:
                        s.freq = f
                    self._update_power(s, t)
