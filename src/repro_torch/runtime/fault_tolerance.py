"""Training runtime: crash-restart, stragglers, power events, re-placement
(PyTorch port of ``repro.runtime.fault_tolerance``).

The mechanisms run against an injectable fault source and are exercised
by tests; they are the control logic a multi-host launcher runs per host:

  * ``TrainSupervisor``: the step loop with checkpoint/restart semantics;
    any exception (an injected device loss, a preemption) triggers
    restore-from-latest and replay (the data pipeline is step-addressable,
    so the replay is exact).
  * ``StragglerMonitor``: per-step wall time against the trailing median; a
    step slower than ``threshold x`` the median is flagged for mitigation.
  * ``elastic_reshard``: a host-resident state re-placed onto a device
    when the device set changed between restarts (the reference re-shards
    onto a new mesh; the port trains on one device).

POLCA's power plane reaches the loop through :meth:`TrainSupervisor.
power_event`: :class:`BrakeSentinel` turns N consecutive braked telemetry
ticks (``SimResult.braked_series`` of the port's simulator, or live
samples) into one ``"sustained-brake"`` event, and delivering it
checkpoints and drains the run at the next step boundary (training on a
braked row wastes power-capped cycles; the launcher reschedules it).
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import checkpointer


@dataclass
class StragglerMonitor:
    threshold: float = 2.0  # x trailing median
    window: int = 16
    times: List[float] = field(default_factory=list)
    flagged_steps: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        hist = self.times[-self.window:]
        self.times.append(dt)
        if len(hist) >= 4 and dt > self.threshold * statistics.median(hist):
            self.flagged_steps.append(step)
            return True
        return False


@dataclass
class TrainSupervisor:
    """Crash-restart step loop. ``step_fn(state, batch) -> (state, metrics)``
    may raise (injected faults); the supervisor restores the newest
    checkpoint and replays from its step."""

    step_fn: Callable
    pipeline: Any  # step-addressable: batch_at(step)
    ckpt_dir: str
    ckpt_interval: int = 50
    max_restarts: int = 10
    straggler: StragglerMonitor = field(default_factory=StragglerMonitor)
    on_power_event: Optional[Callable[[str], None]] = None

    n_restarts: int = 0
    history: List[Dict] = field(default_factory=list)
    power_events: List[str] = field(default_factory=list)
    _drain_requested: bool = field(default=False, repr=False)

    def power_event(self, event: str) -> None:
        """Deliver a power-plane signal (typically a :class:`BrakeSentinel`
        ``"sustained-brake"``). Every event is recorded and forwarded to
        ``on_power_event``; a sustained brake also requests checkpoint +
        drain: the run loop saves and returns at the next step boundary."""
        self.power_events.append(event)
        if self.on_power_event is not None:
            self.on_power_event(event)
        if event == "sustained-brake":
            self._drain_requested = True

    def run(self, state, n_steps: int, start_step: int = 0,
            place_batch: Callable = None):
        """Steps ``start_step .. n_steps - 1``, then a checkpoint of the
        final state (unless the interval just wrote it: a train state is
        gigabytes); returns (state, next step). A step's wall time includes
        reading its metrics as floats, which waits for the device, so it is
        the step's time on the card, not the time to enqueue it."""
        step = start_step
        while step < n_steps:
            if self._drain_requested:
                # sustained powerbrake: checkpoint and hand control back to
                # the launcher (drain), as straggler mitigation does
                self._drain_requested = False
                checkpointer.save(self.ckpt_dir, step, state)
                return state, step
            try:
                batch = self.pipeline.batch_at(step)
                if place_batch is not None:
                    batch = place_batch(batch)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
                dt = time.perf_counter() - t0
                slow = self.straggler.observe(step, dt)
                self.history.append({"step": step, "dt": dt, "straggler": slow, **metrics})
                step += 1
                if step % self.ckpt_interval == 0:
                    checkpointer.save(self.ckpt_dir, step, state)
            except Exception:
                self.n_restarts += 1
                if self.n_restarts > self.max_restarts:
                    raise
                restored_step, state = checkpointer.restore_latest(self.ckpt_dir, state)
                step = restored_step if restored_step is not None else start_step
        if step % self.ckpt_interval or step == start_step:  # else just saved
            checkpointer.save(self.ckpt_dir, step, state)
        return state, step


class FaultInjector:
    """Deterministic fault source for tests: raises at the given steps."""

    def __init__(self, fail_at: List[int]):
        self.fail_at = set(fail_at)
        self.seen: set = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.seen:
            self.seen.add(step)
            raise RuntimeError(f"injected fault at step {step}")

    def reset(self) -> None:
        """Forget which steps already fired, so one injector can drive
        repeated supervisor runs (each run re-injects the same timeline)."""
        self.seen.clear()


@dataclass
class BrakeSentinel:
    """Turns row brake telemetry into supervisor power events: N
    consecutive braked samples are one sustained brake (one 2 s blip is
    the brake doing its job; ``sustain_ticks`` of them mean the row is
    pinned at the brake floor). Feed live samples through :meth:`observe`,
    or scan a finished run's ``braked_series`` with :meth:`scan`."""

    sustain_ticks: int = 3
    events: List[float] = field(default_factory=list)
    _run_len: int = field(default=0, repr=False)

    def observe(self, t: float, braked: bool) -> Optional[str]:
        """One telemetry sample. Returns ``"sustained-brake"`` on the
        sample that completes a run of ``sustain_ticks`` braked ticks
        (once per run: a longer brake does not fire again)."""
        self._run_len = self._run_len + 1 if braked else 0
        if self._run_len == self.sustain_ticks:
            self.events.append(float(t))
            return "sustained-brake"
        return None

    def scan(self, result, supervisor=None) -> List[float]:
        """Scan a finished run's ``braked_series`` on its ``power_t`` grid.
        Returns the sustained-brake times; with ``supervisor`` given, each
        event is also delivered to ``supervisor.power_event``."""
        fired: List[float] = []
        if result.braked_series is None:
            return fired
        for t, b in zip(result.power_t, result.braked_series):
            ev = self.observe(float(t), bool(b))
            if ev is not None:
                fired.append(float(t))
                if supervisor is not None:
                    supervisor.power_event(ev)
        return fired


def elastic_reshard(state_template_fn: Callable[[Any], Any], host_state: Any,
                    device) -> Any:
    """Re-place a host-resident state onto ``device``.

    ``state_template_fn(device) -> template``: a tree of tensors (the meta
    device's :func:`~repro_torch.launch.steps.abstract_state` will do) whose
    leaves give each leaf's dtype; the values come from ``host_state`` (numpy
    arrays or tensors, the template's layout). This is the restart path
    when the device set changed."""
    device = torch.device(device)
    template = state_template_fn(device)

    def place(t, v):
        if isinstance(t, dict):
            return {k: place(t[k], v[k]) for k in t}
        return torch.as_tensor(v).to(device=device, dtype=t.dtype)

    return place(template, host_state)
