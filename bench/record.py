"""What a run records for its metrics to read: the completions of the
measured window on the host's clock, the host's spans, and in a traced run
the device's trace and CUDA events around the calls that roofline metrics
name. Nothing here synchronises inside the window: events are read, and
the trace reduced, once it has closed.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


def now() -> float:
    return time.perf_counter()


@dataclass
class Completion:
    """One request or step of the window: when it was dispatched and when
    its answer was on the host (host clock, seconds), the tokens it
    carried and the model operations it needed."""
    dispatched: float
    done: float
    tokens: int
    flops: float


@dataclass
class Record:
    setup_s: float = 0.0
    window_start: float = 0.0
    completions: List[Completion] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    spans: List[Tuple[str, int, int]] = field(default_factory=list)  # label, wall ns
    # key -> (flops, bytes, device seconds, start and end in wall ns) a call
    calls: Dict[str, List[Tuple[float, float, float, int, int]]] = field(default_factory=dict)
    device: Optional["DeviceSummary"] = None

    @property
    def window_s(self) -> float:
        """From the window's start to the last completion in it."""
        return max(c.done for c in self.completions) - self.window_start

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((label, t0, time.time_ns()))


class CallTimer:
    """CUDA events around every call of the wrappers ``targets`` names,
    ``{key: (module, attribute, work)}``: the module attribute is replaced
    for the traced window, and ``work(args, kwargs) -> (flops, bytes)``
    reckons each call's work from its shapes. Records (flops, bytes,
    device seconds, start, end) a call under ``key`` in ``record.calls``,
    start and end on the host's wall clock through an event recorded on an
    idle device when the timer starts."""

    def __init__(self, targets: Dict[str, Tuple[str, str, Callable]], record: Record):
        self.targets, self.record = targets, record
        self.pending: Dict[str, list] = {k: [] for k in targets}
        self.saved: list = []

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self.ref = torch.cuda.Event(enable_timing=True)
        self.ref.record()
        self.ref_ns = time.time_ns()
        for key, (mod_name, attr, work) in self.targets.items():
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            pending = self.pending[key]

            def timed(*args, _orig=orig, _work=work, _pending=pending, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _orig(*args, **kwargs)
                end.record()
                _pending.append((*_work(args, kwargs), start, end))
                return out

            # a wrapper counts its launches on the function its module names
            # (``flash_attention.launches``): the stand-in carries them
            functools.update_wrapper(timed, orig)
            self.saved.append((mod, attr, orig, timed))
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig, timed in reversed(self.saved):
            orig.__dict__.update({k: v for k, v in timed.__dict__.items() if k != "__wrapped__"})
            setattr(mod, attr, orig)
        self.saved.clear()
        return False

    def collect(self) -> None:
        """After a synchronise: each call's device seconds."""
        for key, calls in self.pending.items():
            out = []
            for f, b, s, e in calls:
                a = self.ref_ns + int(self.ref.elapsed_time(s) * 1e6)
                z = self.ref_ns + int(self.ref.elapsed_time(e) * 1e6)
                out.append((f, b, (z - a) / 1e9, a, z))
            self.record.calls[key] = out
            calls.clear()


@dataclass
class DeviceSummary:
    busy_s: float
    window_s: float
    ops: List[Tuple[str, float]]  # kernel name, seconds in the window
    gaps: List[Tuple[str, float]]  # what the host was doing, idle seconds
    seen: Dict[str, bool]  # key of a timed wrapper: did the trace see its kernels


class DeviceTrace:
    """``torch.profiler`` over the traced window, device activity only
    (CUPTI's kernel, copy and set records), reduced once it closes."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def summary(self, record: Record, kernels: Dict[str, Tuple[str, ...]]) -> DeviceSummary:
        """Busy seconds (the union of device activity in the window), the
        operations that took most time, the longest idle gaps named by the
        host span they began in, and whether the trace saw the kernels of
        each timed wrapper (``kernels``: key -> kernel name fragments).
        Where it did not, those calls' event intervals join the device's:
        the program runs on one stream, so nothing overlaps them."""
        import torch
        t0, t1 = self.t0, self.t1
        ivs, by_name = [], {}
        events = [e for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        names = {e.name() for e in events}
        seen = {key: any(f in n for n in names for f in frags) for key, frags in kernels.items()}
        for key, ok in seen.items():
            if ok:
                continue
            total = 0
            for _, _, _, a, b in record.calls.get(key, ()):
                a, b = max(a, t0), min(b, t1)
                if b > a:
                    ivs.append((a, b))
                    total += b - a
            by_name[f"{key} (CUDA events)"] = total
        for e in events:
            a = max(e.start_ns(), t0)
            b = min(e.start_ns() + e.duration_ns(), t1)
            if b <= a:
                continue
            ivs.append((a, b))
            by_name[e.name()] = by_name.get(e.name(), 0) + (b - a)
        ivs.sort()
        busy, gaps, cur_a, cur_b = 0, [], None, None
        last_end = t0
        for a, b in ivs:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                if a > last_end:
                    gaps.append((last_end, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
            last_end = max(last_end, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        if t1 > last_end:
            gaps.append((last_end, t1))
        ops = sorted(((n, ns / 1e9) for n, ns in by_name.items()), key=lambda x: -x[1])[:10]
        named = sorted(((_host_label(record.spans, a), (b - a) / 1e9) for a, b in gaps),
                       key=lambda x: -x[1])[:10]
        return DeviceSummary(busy_s=busy / 1e9, window_s=(t1 - t0) / 1e9, ops=ops, gaps=named,
                             seen=seen)


def _host_label(spans, t_ns: int) -> str:
    """The innermost host span open at ``t_ns``."""
    best = None
    for label, a, b in spans:
        if a <= t_ns <= b and (best is None or a >= best[1]):
            best = (label, a)
    return best[0] if best else "outside the host's spans"
