#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the NVIDIA card(s) of this machine.

    python3 bench/run.py --workload neox20b.prefill --seed 7 --seconds 30 --trace 0

The cell names a configuration (``bench/configs/<file>``), a traffic mix
(``bench/traffic/<traffic>.json``, whose ``kind`` names its driver in
``bench/drivers``) and its limits (``bench/cells/<cell>.json``). Set-up
makes the weights and inputs from ``--seed`` on the device and warms up the
cell's shapes; the window then measures for ``--seconds``. With
``--trace 1`` the window runs under ``torch.profiler`` with CUDA events
around the calls the roofline metrics name, and the per-layer metrics are
printed; with ``--trace 0`` the end-to-end ones. After the window the
program's outputs are held against the plain reference
(``bench/reference``) and each compared number is printed beside its limit,
as the last lines of standard error and, under ``checks``, last in the
result: one JSON object, the last line of standard output.

Exits non-zero, printing no result, without as many CUDA devices as the cell
asks for, without the program (``src/repro_torch``), or if JAX or the JAX
package was loaded. Kernel caches stay inside the checkout
(``build/``).
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from types import ModuleType  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level module names that may not be loaded: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The wall time this process started (``/proc``), else the time this
    module was first run."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def banned_modules(names=None) -> List[str]:
    """The banned top-level names among ``names`` (the loaded modules'),
    each compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(BANNED))


@dataclass
class Run:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    driver: ModuleType
    reference: ModuleType
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]
    seed: int = 0
    device: str = "cuda"
    record: object = None
    metrics: Dict[str, ModuleType] = field(default_factory=dict)
    started: float = field(default_factory=time.time)

    def log(self, stage: str) -> None:
        """A stage of the run on standard error, with the seconds since
        the process started."""
        print(f"bench: {time.time() - self.started:.2f} s {stage}", file=sys.stderr, flush=True)


def load_metric(name: str) -> ModuleType:
    """The reader of metric ``name``: ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, kind: str, cell: str) -> List[str]:
    return [m["name"] for m in manifest[kind] if cell in m.get("workloads", [cell])]


def load_run(manifest: dict, workload: str) -> Run:
    """A cell of the manifest with every file it names loaded."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the manifest has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "cells" / f"{workload}.json").read_text())["limits"]
    run = Run(name=workload, chips=w["chips"], cfg=cfg, traffic=traffic,
              limits={k: v["limit"] for k, v in limits.items()},
              driver=importlib.import_module(f"bench.drivers.{traffic['kind']}"),
              reference=importlib.import_module(f"bench.reference.{cfg['reference']}"),
              end_to_end=cell_metrics(manifest, "end_to_end", workload),
              per_layer=cell_metrics(manifest, "per_layer", workload),
              units={m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]})
    run.metrics = {m: load_metric(m) for m in run.end_to_end + run.per_layer}
    return run


def execute(run: Run, seconds: float, trace: bool, started: float) -> dict:
    """Set-up, the window, the metrics and the check of one run; returns
    the result (without the import check)."""
    import torch

    from bench.record import CallTimer, DeviceTrace, Record

    run.record = rec = Record()
    run.started = started
    on_card = torch.device(run.device).type == "cuda"
    run.log("set-up starts")
    state = run.driver.setup(run)
    timed = {}
    if trace:
        for name in run.per_layer:
            mod = run.metrics[name]
            if hasattr(mod, "WRAP"):
                timed[":".join(mod.WRAP)] = (*mod.WRAP, mod.work, mod.KERNELS)
    gc.collect()  # set-up's garbage is not the window's to collect
    if on_card:
        torch.cuda.synchronize()
    rec.setup_s = time.time() - started
    if trace and on_card:
        timer = CallTimer({k: v[:3] for k, v in timed.items()}, rec)
        with timer, DeviceTrace() as dt:
            run.driver.window(run, state, seconds)
        timer.collect()
        rec.device = dt.summary(rec, {k: v[3] for k, v in timed.items()})
    else:
        run.driver.window(run, state, seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run.log(f"window closed: {len(rec.completions)} completions")
    names = run.per_layer if trace else run.end_to_end
    metrics = {}
    for name in names:
        value = run.metrics[name].read(rec, run) if rec.completions else None
        if value is not None:
            metrics[name] = {"value": value, "unit": run.units[name]}
    readings = run.driver.check(run, state)
    del state
    run.log("checked against the reference")
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in run.limits.items()}
    correct = bool(rec.completions) and rec.failed == 0 and all(
        c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": run.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": device}
    if rec.device is not None:
        device["busy_s"] = rec.device.busy_s
        device["window_s"] = rec.device.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in rec.device.ops],
                               "idle_gaps": [list(x) for x in rec.device.gaps]}
        result["trace_saw_hand_kernels"] = rec.device.seen
    result["readings"] = {k: v for k, v in readings.items() if k not in run.limits}
    result["checks"] = checks
    return result


def main(argv: Optional[List[str]] = None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the caches a run builds stay inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "bench-cache" / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    run = load_run(manifest, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < run.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {run.name} needs {run.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the program (src/repro_torch) is not here: {e}", file=sys.stderr)
        return 3
    run.seed = args.seed
    result = execute(run, args.seconds, bool(args.trace), started)
    found = banned_modules()
    if found:
        print(f"bench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    print(f"bench: {card_line()}", file=sys.stderr)
    for k, v in result["readings"].items():
        print(f"reading {k} {v!r}", file=sys.stderr)
    for k, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False)
        return out.stdout.strip().replace("\n", "; ") or "nvidia-smi printed nothing"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


if __name__ == "__main__":
    sys.exit(main())
