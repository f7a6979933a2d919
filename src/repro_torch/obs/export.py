"""Artifact export: Prometheus text exposition, JSONL event traces, and
per-run manifests (port of ``repro.obs.export``; DESIGN.md §14).

Three interchange formats, written under one ``--artifacts DIR``:

* ``metrics.prom`` — Prometheus text exposition (v0.0.4) of every counter,
  gauge, histogram, and span aggregate in a :class:`MetricsSnapshot`.
  Spans export as ``<name>_seconds`` summaries (``_count``/``_sum``) plus
  ``_max``/``_min`` gauges; histograms as cumulative ``_bucket`` series.
* ``events.jsonl`` — the structured event trace, one JSON object per line
  (``ts``, ``subsystem``, ``kind``, ``labels``), in emission order with
  sorted keys — byte-deterministic for deterministic runs.
* ``manifest.json`` — what produced the artifacts: argv, seed, git sha,
  interpreter/numpy/torch/CUDA versions, the card, platform, and
  wall-clock. The paper-trail record that turns a results directory into
  a reproducible claim.

The manifest is the one change from the reference: it records ``torch``
(``torch.__version__``), ``cuda`` (``torch.version.cuda``) and ``device``
(the card's name when CUDA is available, else ``None``) where the
reference records its array library's version. Every other key and the
JSON layout are the reference's.

Parsers for all three live here too (``read_prometheus``, ``read_events``,
``read_manifest``) so the round-trip tests share one implementation with
the writers.
"""

from __future__ import annotations

import json
import os
import platform
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional, TextIO, Tuple

from repro_torch.obs.metrics import Event, LabelKey, MetricsSnapshot

MANIFEST_NAME = "manifest.json"
METRICS_NAME = "metrics.prom"
EVENTS_NAME = "events.jsonl"


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _sanitize(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z0-9_:]."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: LabelKey, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = tuple(labels) + tuple(extra)
    if not pairs:
        return ""
    body = ",".join(f'{_sanitize(k)}="{_escape(str(v))}"' for k, v in pairs)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(snap: MetricsSnapshot) -> str:
    """The snapshot in Prometheus text exposition format, deterministically
    ordered (by metric name, then label set)."""
    lines: List[str] = []

    def emit_family(kind: str, entries: Dict, fmt) -> None:
        by_name: Dict[str, List] = {}
        for (name, labels), value in entries.items():
            by_name.setdefault(_sanitize(name), []).append((labels, value))
        for name in sorted(by_name):
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in sorted(by_name[name]):
                fmt(name, labels, value)

    emit_family("counter", snap.counters,
                lambda n, l, v: lines.append(f"{n}{_fmt_labels(l)} {_fmt_value(v)}"))
    emit_family("gauge", snap.gauges,
                lambda n, l, v: lines.append(f"{n}{_fmt_labels(l)} {_fmt_value(v)}"))

    def fmt_hist(name, labels, h):
        cum = h.cumulative()
        for bound, c in zip(h.bounds, cum):
            lines.append(f"{name}_bucket{_fmt_labels(labels, (('le', repr(float(bound))),))} {c}")
        lines.append(f"{name}_bucket{_fmt_labels(labels, (('le', '+Inf'),))} {h.count}")
        lines.append(f"{name}_sum{_fmt_labels(labels)} {repr(h.sum)}")
        lines.append(f"{name}_count{_fmt_labels(labels)} {h.count}")

    emit_family("histogram", snap.hists, fmt_hist)

    def fmt_span(name, labels, s):
        lines.append(f"{name}_seconds_count{_fmt_labels(labels)} {s.count}")
        lines.append(f"{name}_seconds_sum{_fmt_labels(labels)} {repr(s.total_s)}")
        lines.append(f"{name}_seconds_min{_fmt_labels(labels)} {repr(s.min_s)}")
        lines.append(f"{name}_seconds_max{_fmt_labels(labels)} {repr(s.max_s)}")

    emit_family("summary", snap.spans, fmt_span)
    return "\n".join(lines) + ("\n" if lines else "")


def read_prometheus(path: str) -> Dict[str, Dict[str, List[Tuple[Dict[str, str], float]]]]:
    """Parse a ``metrics.prom`` file back into
    ``{type: {name: [(labels, value), ...]}}``. Minimal but sufficient for
    the files :func:`prometheus_text` writes (one metric per line, string
    label values, no exemplars)."""
    out: Dict[str, Dict[str, List[Tuple[Dict[str, str], float]]]] = {}
    types: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("# TYPE "):
                _, _, name, kind = line.split(None, 3)
                types[name] = kind
                continue
            if line.startswith("#"):
                continue
            if "{" in line:
                name, rest = line.split("{", 1)
                body, value = rest.rsplit("} ", 1)
                labels = {
                    m.group(1): m.group(2).replace('\\"', '"')
                                 .replace("\\n", "\n").replace("\\\\", "\\")
                    for m in re.finditer(
                        r'([a-zA-Z0-9_:]+)="((?:[^"\\]|\\.)*)"', body)}
            else:
                name, value = line.rsplit(" ", 1)
                labels = {}
            # histogram/summary samples carry suffixed names (_bucket,
            # _sum, _seconds_count, ...) while TYPE declares the base —
            # resolve the kind via the longest declared prefix
            kind = types.get(name)
            if kind is None:
                for t_name in types:
                    if name.startswith(t_name + "_"):
                        if kind is None or len(t_name) > best:
                            kind, best = types[t_name], len(t_name)
            out.setdefault(kind or "untyped", {}).setdefault(name, []).append(
                (labels, float(value)))
    return out


# ---------------------------------------------------------------------------
# JSONL event trace
# ---------------------------------------------------------------------------

def event_lines(snap: MetricsSnapshot) -> List[str]:
    """One JSON line per event, emission order, sorted keys (deterministic
    byte-for-byte given a deterministic run)."""
    return [json.dumps({"ts": e.t, "subsystem": e.subsystem, "kind": e.kind,
                        "labels": e.labels_dict()}, sort_keys=True)
            for e in snap.events]


def write_events(snap: MetricsSnapshot, fp: TextIO) -> int:
    n = 0
    for line in event_lines(snap):
        fp.write(line + "\n")
        n += 1
    return n


def read_events(path: str) -> List[Event]:
    """Round-trip parser for ``events.jsonl``."""
    out: List[Event] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(Event(
                t=float(d["ts"]), subsystem=d["subsystem"], kind=d["kind"],
                labels=tuple(sorted((k, str(v))
                             for k, v in d.get("labels", {}).items()))))
    return out


# ---------------------------------------------------------------------------
# run manifest
# ---------------------------------------------------------------------------

def _git_sha() -> str:
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        r = subprocess.run(["git", "rev-parse", "HEAD"], cwd=here,
                           capture_output=True, text=True, timeout=10)
        return r.stdout.strip() if r.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_manifest(*, seed: Optional[int] = None, scenario=None,
                 argv: Optional[List[str]] = None,
                 extra: Optional[Dict] = None) -> Dict:
    """The per-run provenance record: pass ``scenario`` (a serializable
    :class:`~repro_torch.experiments.scenario.Scenario`) to pin the exact
    experiment, ``seed`` for CLI-pinned seeds, ``extra`` for caller fields
    (wall-clock, row counts). torch is probed lazily — the power-plane
    stack runs without it."""
    import numpy as np
    try:
        import torch
        torch_version, cuda_version = torch.__version__, torch.version.cuda
        device = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                  else None)
    except Exception:  # not installed / CUDA init failure: still record
        torch_version = cuda_version = device = None
    m: Dict = {
        "argv": list(sys.argv if argv is None else argv),
        "seed": seed,
        "git_sha": _git_sha(),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "numpy": np.__version__,
        "torch": torch_version,
        "cuda": cuda_version,
        "device": device,
        "created_unix_s": time.time(),
    }
    if scenario is not None:
        m["scenario"] = (scenario.to_dict() if hasattr(scenario, "to_dict")
                         else str(scenario))
    if extra:
        m.update(extra)
    return m


def read_manifest(artifacts_dir: str) -> Dict:
    with open(os.path.join(artifacts_dir, MANIFEST_NAME)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the artifacts directory
# ---------------------------------------------------------------------------

def write_artifacts(artifacts_dir: str, snap: MetricsSnapshot,
                    manifest: Dict) -> Dict[str, str]:
    """Write ``manifest.json`` + ``metrics.prom`` + ``events.jsonl`` under
    ``artifacts_dir`` (created if needed). Returns {kind: path}."""
    os.makedirs(artifacts_dir, exist_ok=True)
    paths = {
        "manifest": os.path.join(artifacts_dir, MANIFEST_NAME),
        "metrics": os.path.join(artifacts_dir, METRICS_NAME),
        "events": os.path.join(artifacts_dir, EVENTS_NAME),
    }
    with open(paths["manifest"], "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    with open(paths["metrics"], "w") as f:
        f.write(prometheus_text(snap))
    with open(paths["events"], "w") as f:
        write_events(snap, f)
    return paths
