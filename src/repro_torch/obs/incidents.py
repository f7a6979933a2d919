"""Offline incident reconstruction from the exported event trace (port of
``repro.obs.incidents``, copied in full).

The artifacts pipeline leaves behind ``events.jsonl`` — chaos fault
transitions, row brake edges, controller rebalances, and alert
engage/release pairs, all on simulation time. This module folds that flat
trace back into *causal incident timelines*: one :class:`Incident` per
fault, carrying the alerts it triggered, detection latency against the
ground-truth schedule (the chaos events' ``t_sched`` label — a ramped
derate's apply record only lands when the ramp completes, but detection is
measured from when the fault *began*), time-to-mitigation (the first
rebalance after the fault began), time-to-clear (the last attached alert
release after restore), and the brake activity inside the window.

Reconstruction is a pure function of the trace: two passes, no simulator
state. Pass one pairs fault events into incidents (``row-crash`` closes on
the matching ``row-revive`` apply; budget derates close on their
``fault_restore``); pass two attributes every alert engage to *all*
incidents whose active window contains it (overlapping faults share their
alerts — attribution is causal-candidate, not exclusive), leaving the rest
as unattributed engages (the false-alarm count the ``chaos-noop`` gate
rides on). Events are stably sorted by ``(t, input order)`` first, so
out-of-order JSONL lines — merged traces, shard interleavings — cannot
change the result; an empty trace yields an empty report.

The reference's ``tools/incidents.py`` CLI renders the markdown section
and the machine-readable ``incidents.json`` into an artifacts directory;
the port has no CLI of its own yet, and its callers use these functions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.metrics import Event

#: artifacts-dir filename the CLI writes (next to events.jsonl etc.)
INCIDENTS_NAME = "incidents.json"

_ROW_OPEN = "row-crash"
_ROW_CLOSE = "row-revive"


@dataclass
class AttributedAlert:
    """One alert engage attributed to an incident, with its eventual
    release (``t_release`` stays None for an alert that never clears)."""

    name: str
    kind: str
    target: str
    t_engage: float
    value: float = math.nan
    t_release: Optional[float] = None

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "target": self.target,
                "t_engage": self.t_engage, "value": self.value,
                "t_release": self.t_release}


@dataclass
class Incident:
    """One reconstructed fault timeline. Times are simulation seconds;
    ``t_sched`` is the ground-truth fault start (schedule), ``t_apply``
    when the transition record landed (ramp end for ramped derates),
    ``t_restore`` the restore/revive instant (None while unresolved)."""

    iid: int
    kind: str
    target: str
    t_sched: float
    t_apply: float
    t_restore: Optional[float] = None
    alerts: List[AttributedAlert] = field(default_factory=list)
    n_brake_edges: int = 0
    n_rebalances: int = 0
    t_first_rebalance: Optional[float] = None

    # -- derived timeline metrics -------------------------------------------
    def t_end(self) -> float:
        return self.t_restore if self.t_restore is not None else math.inf

    def contains(self, t: float) -> bool:
        return self.t_sched <= t < self.t_end()

    def first_detection(self) -> Optional[AttributedAlert]:
        """The first telemetry-driven alert engage (``fault-active`` is
        ground truth, not detection — it only counts when nothing else
        fired at all)."""
        telemetry = [a for a in self.alerts if a.kind != "fault-active"]
        pool = telemetry or self.alerts
        return min(pool, key=lambda a: a.t_engage) if pool else None

    def detection_latency_s(self) -> Optional[float]:
        """Seconds from the scheduled fault start to the first detection —
        includes ramp time and the OOB telemetry delay by construction."""
        det = self.first_detection()
        return None if det is None else det.t_engage - self.t_sched

    def detection_after_apply_s(self) -> Optional[float]:
        """Seconds from the apply record to the first detection — negative
        when a ramping fault was caught before it fully landed."""
        det = self.first_detection()
        return None if det is None else det.t_engage - self.t_apply

    def detection_latency_ticks(self, tick_s: float) -> Optional[float]:
        lat = self.detection_latency_s()
        return None if lat is None else lat / tick_s

    def time_to_mitigation_s(self) -> Optional[float]:
        """Fault start to the first controller rebalance after it (None
        under a static controller — nothing ever responds)."""
        if self.t_first_rebalance is None:
            return None
        return self.t_first_rebalance - self.t_sched

    def time_to_clear_s(self) -> Optional[float]:
        """Restore to the *last* attached alert release (0 floor: alerts
        that released during the fault don't make clearing negative); None
        while the fault is unresolved or an attached alert never
        released."""
        if self.t_restore is None or not self.alerts:
            return None
        if any(a.t_release is None for a in self.alerts):
            return None
        return max(0.0, max(a.t_release for a in self.alerts) - self.t_restore)

    @property
    def unresolved(self) -> bool:
        """Still open at end of trace: never restored, or an attached
        alert never released."""
        return (self.t_restore is None
                or any(a.t_release is None for a in self.alerts))

    def to_dict(self, tick_s: float) -> dict:
        return {
            "id": self.iid,
            "kind": self.kind,
            "target": self.target,
            "t_sched": self.t_sched,
            "t_apply": self.t_apply,
            "t_restore": self.t_restore,
            "unresolved": self.unresolved,
            "alerts": [a.to_dict() for a in self.alerts],
            "n_brake_edges": self.n_brake_edges,
            "n_rebalances": self.n_rebalances,
            "detection_latency_s": self.detection_latency_s(),
            "detection_latency_ticks": self.detection_latency_ticks(tick_s),
            "detection_after_apply_s": self.detection_after_apply_s(),
            "time_to_mitigation_s": self.time_to_mitigation_s(),
            "time_to_clear_s": self.time_to_clear_s(),
        }


@dataclass
class IncidentReport:
    """The full reconstruction: incidents in schedule order, plus every
    alert engage that matched no incident window (false alarms)."""

    incidents: List[Incident] = field(default_factory=list)
    unattributed_engages: List[Event] = field(default_factory=list)
    n_events: int = 0

    @property
    def n_incidents(self) -> int:
        return len(self.incidents)

    @property
    def n_false_alarms(self) -> int:
        return len(self.unattributed_engages)


def _f(labels: Dict[str, str], key: str, default: float) -> float:
    try:
        return float(labels[key])
    except (KeyError, ValueError):
        return default


def reconstruct_incidents(events: Sequence[Event]) -> IncidentReport:
    """Fold a flat event trace into :class:`IncidentReport` (see module
    docstring for the pairing and attribution rules)."""
    ordered = sorted(enumerate(events), key=lambda ie: (ie[1].t, ie[0]))
    trace = [e for _, e in ordered]

    # pass one: fault transitions -> incidents
    incidents: List[Incident] = []
    open_by_key: Dict[tuple, Incident] = {}  # (fault kind, target) -> open
    for e in trace:
        if e.subsystem != "chaos":
            continue
        lab = e.labels_dict()
        fault, target = lab.get("fault", "?"), lab.get("target", "?")
        t_sched = _f(lab, "t_sched", e.t)
        if e.kind == "fault_apply" and fault != _ROW_CLOSE:
            inc = Incident(iid=len(incidents), kind=fault, target=target,
                           t_sched=t_sched, t_apply=e.t)
            incidents.append(inc)
            open_by_key[(fault, target)] = inc
        elif e.kind == "fault_apply" and fault == _ROW_CLOSE:
            inc = open_by_key.pop((_ROW_OPEN, target), None)
            if inc is not None:
                inc.t_restore = t_sched
        elif e.kind == "fault_restore":
            inc = open_by_key.pop((fault, target), None)
            if inc is not None:
                inc.t_restore = t_sched

    # pass two: attribute alerts / brakes / rebalances to incident windows
    unattributed: List[Event] = []
    open_alerts: Dict[str, List[AttributedAlert]] = {}
    for e in trace:
        if e.subsystem == "alert" and e.kind == "alert_engage":
            lab = e.labels_dict()
            hits = [inc for inc in incidents if inc.contains(e.t)]
            if not hits:
                unattributed.append(e)
                continue
            refs = []
            for inc in hits:
                a = AttributedAlert(
                    name=lab.get("alert", "?"), kind=lab.get("rule", "?"),
                    target=lab.get("target", ""), t_engage=e.t,
                    value=_f(lab, "value", math.nan))
                inc.alerts.append(a)
                refs.append(a)
            open_alerts.setdefault(lab.get("alert", "?"), []).extend(refs)
        elif e.subsystem == "alert" and e.kind == "alert_release":
            name = e.labels_dict().get("alert", "?")
            for a in open_alerts.pop(name, ()):
                a.t_release = e.t
        elif e.subsystem == "row" and e.kind in ("brake_engage",
                                                 "brake_release"):
            for inc in incidents:
                if inc.contains(e.t):
                    inc.n_brake_edges += 1
        elif e.subsystem == "controller" and e.kind == "rebalance":
            for inc in incidents:
                if e.t >= inc.t_sched:
                    inc.n_rebalances += 1
                    if inc.t_first_rebalance is None:
                        inc.t_first_rebalance = e.t

    incidents.sort(key=lambda i: (i.t_sched, i.iid))
    return IncidentReport(incidents=incidents,
                          unattributed_engages=unattributed,
                          n_events=len(trace))


def incidents_json(report: IncidentReport, *, tick_s: float = 2.0) -> dict:
    """The machine-readable form ``incidents.json`` carries."""
    return {
        "tick_s": tick_s,
        "n_events": report.n_events,
        "n_incidents": report.n_incidents,
        "n_false_alarms": report.n_false_alarms,
        "false_alarms": [
            {"t": e.t, **e.labels_dict()} for e in report.unattributed_engages],
        "incidents": [inc.to_dict(tick_s) for inc in report.incidents],
    }


def _fmt(v: Optional[float], unit: str = "s") -> str:
    if v is None:
        return "—"
    return f"{v:g}{unit}"


def render_incidents_markdown(report: IncidentReport, *,
                              tick_s: float = 2.0) -> str:
    """The human-readable incident section (the reference's
    ``tools/incidents.py`` prints it; its ``tools/report.py`` inlines it
    into ``report.md``)."""
    out = ["## Incidents", ""]
    out.append(f"{report.n_incidents} incident(s), "
               f"{report.n_false_alarms} unattributed alert engage(s), "
               f"{report.n_events} trace events.")
    out.append("")
    if report.incidents:
        out.append("| # | fault | target | t_sched | detect (s / ticks) | "
                   "mitigate | clear | alerts | brakes | rebalances |")
        out.append("|---|---|---|---|---|---|---|---|---|---|")
        for inc in report.incidents:
            lat = inc.detection_latency_s()
            ticks = inc.detection_latency_ticks(tick_s)
            det = ("—" if lat is None
                   else f"{lat:g} / {ticks:g}")
            flag = " (open)" if inc.unresolved else ""
            out.append(
                f"| {inc.iid} | {inc.kind} | {inc.target} "
                f"| {inc.t_sched:g}s | {det} "
                f"| {_fmt(inc.time_to_mitigation_s())} "
                f"| {_fmt(inc.time_to_clear_s())}{flag} "
                f"| {len(inc.alerts)} | {inc.n_brake_edges} "
                f"| {inc.n_rebalances} |")
        out.append("")
        for inc in report.incidents:
            if not inc.alerts:
                continue
            out.append(f"**Incident {inc.iid}** ({inc.kind} on "
                       f"{inc.target}):")
            for a in sorted(inc.alerts, key=lambda a: (a.t_engage, a.name)):
                rel = (f"released {a.t_release:g}s" if a.t_release is not None
                       else "never released")
                out.append(f"- `{a.name}` engaged {a.t_engage:g}s "
                           f"(value {a.value:g}), {rel}")
            out.append("")
    if report.unattributed_engages:
        out.append("**Unattributed engages** (no fault window matched — "
                   "false alarms):")
        for e in report.unattributed_engages:
            lab = e.labels_dict()
            out.append(f"- `{lab.get('alert', '?')}` at {e.t:g}s "
                       f"(value {lab.get('value', '?')})")
        out.append("")
    return "\n".join(out).rstrip() + "\n"
