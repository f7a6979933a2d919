#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card,
drives the main path at full size — ``run_ensemble`` over a 10^5-member
dense tail of the repo's dense-tail bench scenario, then a ``plan_capacity``
bisection on 1024-member probes — and checks that the main path launched
every kernel. It prints one line per phase, then a JSON line of per-kernel
measurements, and last ``{"ok": true, "device": {...}}``. Any failed phase
raises and exits non-zero; without a CUDA device it exits non-zero before
printing any result.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the non-tensor FP64 rate
H100_BYTES_PER_S = 3.35e12
H100_FP64_FLOPS = 34e12

# the tick kernel's work per (member, row) lane and tick: reads occ (8 B),
# writes row_w, f_lp, f_hp (8 B each) and fire (1 B); the power fold does
# two pow(), four multiplies, one add and one divide (pow counted as one op)
TICK_BYTES_PER_LANE_TICK = 8 + 3 * 8 + 1
TICK_FLOPS_PER_LANE_TICK = 10

# the kernel shapes of tests/test_kernels.py (N not a block multiple, R=1
# and R=3, a short ring with fast escalation, hot cases where brakes fire)
TICK_CONSTS = dict(t1=0.90, t2=0.97, t1_buf=0.02, t2_buf=0.02,
                   lp_t1=0.85, lp_t2=0.70, hp_t2=0.85, brake_freq=0.50,
                   p0_srv_w=180.0, k_lp_w=300.0, k_hp_w=150.0,
                   lp_share=0.6, gamma=1.6, n_servers=24.0,
                   power_scale=1.10)
TICK_CASES = [
    # (N, T, R, block_members, oob, brake, esc, power_scale)
    (8, 96, 2, 8, 20, 3, 25, 1.10),
    (5, 96, 2, 8, 20, 3, 25, 1.10),
    (13, 64, 3, 4, 20, 3, 25, 1.18),
    (3, 48, 1, 8, 5, 2, 4, 1.05),
    (16, 32, 2, 16, 20, 3, 25, 0.95),
]
ROW_W_RTOL = 1e-6  # the oracle contract's power tolerance (DESIGN.md §15)

MAIN_MEMBERS = 100_000  # benchmarks/batched_engine.py's full-mode tail
PLAN_SEEDS = 1024


def main_scenario():
    """The dense-tail bench scenario of benchmarks/batched_engine.py: 1800 s,
    20 provisioned servers +30%, 2 rows, diurnal traffic at 0.97 peak,
    power_scale 1.15, nominal budget."""
    from repro_torch.experiments.scenario import FleetSpec, Scenario, TrafficSpec
    return Scenario(
        name="batched-bench-diurnal", duration_s=1800.0,
        fleet=FleetSpec(n_provisioned=20, added_frac=0.30, n_rows=2,
                        rows_per_rack=2),
        traffic=TrafficSpec(occ_peak=0.97, generator="diurnal"),
        budget="nominal", power_scale=1.15, compare_to_reference=False)


def planner_scenario():
    """The planner case of tests/test_batched_parity.py (0.5 h, 10
    provisioned servers, 2 rows, 0.95 peak)."""
    from repro_torch.experiments.scenario import FleetSpec, Scenario, TrafficSpec
    return Scenario(
        name="parity-diurnal", duration_s=1800.0,
        fleet=FleetSpec(n_provisioned=10, added_frac=0.0, n_rows=2,
                        rows_per_rack=1),
        traffic=TrafficSpec(occ_peak=0.95, generator="diurnal"),
        budget="nominal", power_scale=1.08, compare_to_reference=False)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs (CUDA
    events around the runs, after a synchronize)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_tick(got, want, label: str) -> float:
    """Kernel vs plain version: fire/f_lp/f_hp/n_brakes bit-identical,
    row_w within ROW_W_RTOL relative. Returns the max absolute row_w gap."""
    import torch
    for k in ("fire", "f_lp", "f_hp", "n_brakes"):
        if not torch.equal(got[k], want[k]):
            n_diff = int((got[k] != want[k]).sum())
            raise AssertionError(f"{label}: {k} differs from the plain "
                                 f"version at {n_diff} elements")
    gap = (got["row_w"] - want["row_w"]).abs()
    rel = float((gap / want["row_w"].abs()).max())
    if not rel <= ROW_W_RTOL:
        raise AssertionError(f"{label}: row_w max relative gap {rel:.3e} "
                             f"> {ROW_W_RTOL}")
    max_abs = float(gap.max())
    print(f"kernel tick {label}: fire/f_lp/f_hp/n_brakes bit-identical, "
          f"row_w max rel gap {rel:.3e} (max abs {max_abs:.3e} W), "
          f"brakes {int(want['n_brakes'].sum())}")
    return max_abs


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels import _build, tick
    from repro_torch.provisioning.batched import (
        effective_occupancy, lower_ensemble, run_tick_model, tick_consts)
    from repro_torch.provisioning.montecarlo import EnsembleSpec, run_ensemble
    from repro_torch.provisioning.planner import RiskConstraints, plan_capacity

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")

    # 2. build every kernel (one nvcc per source, started together)
    names = _build.sources()
    t0 = time.perf_counter()
    _build.build(names)
    print(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s")
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 3. each kernel against its plain version, on the card
    f64 = dict(dtype=torch.float64, device=dev)
    for N, T, R, _, oob, brake, esc, ps in TICK_CASES:
        consts = tick.TickConsts(**{**TICK_CONSTS, "power_scale": ps})
        rng = np.random.default_rng(N * 1000 + T)
        occ = torch.as_tensor(rng.uniform(0.3, 1.0, (N, T, R)), **f64)
        bscale = torch.as_tensor(rng.uniform(0.9, 1.0, (T, R)), **f64)
        rb = torch.full((R,), consts.n_servers
                        * (consts.p0_srv_w + 0.8 * consts.k_lp_w), **f64)
        kw = dict(oob_ticks=oob, brake_ticks=brake,
                  ring_depth=max(oob, brake) + 1, esc=esc)
        got = tick.polca_tick_loop(occ, bscale, rb, consts, **kw)
        want = tick.polca_tick_plain(occ, bscale, rb, consts, **kw)
        torch.cuda.synchronize()
        compare_tick(got, want, f"N={N} T={T} R={R} oob={oob} "
                                f"brake={brake} esc={esc}")

    sc = main_scenario()
    spec = EnsembleSpec(sc, n_seeds=MAIN_MEMBERS, seed0=1)
    t0 = time.perf_counter()
    model, _, _ = lower_ensemble(spec)
    lowering_s = time.perf_counter() - t0
    occ = effective_occupancy(model, dev)
    bscale = torch.as_tensor(model.budget_scale, **f64)
    rb = torch.as_tensor(model.row_budget_w, **f64)
    kw = dict(oob_ticks=model.oob_ticks, brake_ticks=model.brake_ticks,
              ring_depth=model.ring_depth, esc=model.escalation_ticks)
    consts = tick_consts(model)
    N, T, R = occ.shape
    got = tick.polca_tick_loop(occ, bscale, rb, consts, **kw)
    want = tick.polca_tick_plain(occ, bscale, rb, consts, **kw)
    torch.cuda.synchronize()
    tick_abs = compare_tick(got, want, f"main path N={N} T={T} R={R}")
    del got, want
    tick_ms = cuda_ms(lambda: tick.polca_tick_loop(occ, bscale, rb, consts,
                                                   **kw), reps=5)
    plain_ms = cuda_ms(lambda: tick.polca_tick_plain(occ, bscale, rb, consts,
                                                     **kw), reps=2)
    lane_ticks = N * T * R
    # occ and the outputs per lane-tick; bscale and row_budget (f64) and
    # n_brakes (int32) once
    tick_bytes = (lane_ticks * TICK_BYTES_PER_LANE_TICK + 8 * (T * R + R)
                  + 4 * N * R)
    bytes_ms = tick_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = lane_ticks * TICK_FLOPS_PER_LANE_TICK / H100_FP64_FLOPS * 1e3
    tick_bound_ms = max(bytes_ms, ops_ms)
    print(f"kernel tick at the main-path shape: {tick_ms:.3f} ms "
          f"(plain version {plain_ms:.3f} ms; bound {tick_bound_ms:.3f} ms "
          f"by {'bytes' if bytes_ms >= ops_ms else 'operations'}: "
          f"{tick_bytes / 1e9:.3f} GB)")
    engine_ms = cuda_ms(lambda: run_tick_model(model, keep_series=False,
                                               device=dev), reps=1)
    del occ
    torch.cuda.empty_cache()

    # 4. the main path at full size: run_ensemble on a 10^5-member tail
    tick.polca_tick_loop.launches = 0
    t0 = time.perf_counter()
    res = run_ensemble(spec, engine="cuda")
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    main_launches = tick.polca_tick_loop.launches
    if main_launches < 1:
        raise AssertionError("run_ensemble did not launch the tick kernel")
    if res.n_members != MAIN_MEMBERS:
        raise AssertionError(f"{res.n_members} members, want {MAIN_MEMBERS}")
    if not (np.isfinite(res.peak_fracs).all()
            and np.isfinite(res.mean_fracs).all()):
        raise AssertionError("non-finite power fractions")
    bp = res.brake_prob()
    cvars = [res.brake_cvar(a) for a in (0.0, 0.9, 0.999)]
    if not (0.0 <= bp <= 1.0 and cvars[0] <= cvars[1] <= cvars[2]
            and math.isfinite(res.slo_cvar("low", 0.999))):
        raise AssertionError(f"implausible statistics: brake_prob={bp}, "
                             f"brake CVaR(0, .9, .999)={cvars}")
    print(f"main path run_ensemble({MAIN_MEMBERS} members, T={T}, R={R}, "
          f"engine='cuda'): lowering {lowering_s:.2f} s, device engine "
          f"{engine_ms / 1e3:.3f} s, end to end {e2e_s:.2f} s = "
          f"{MAIN_MEMBERS / e2e_s:.0f} members/s; brake_prob {bp:.4f}, "
          f"brake CVaR(0.999) {cvars[2]:.3f}, peak max "
          f"{res.peak_fracs.max():.4f}; tick kernel launches {main_launches}")

    # the same path on a small, hotter input (brakes fire), card against CPU
    # (the kernel's plain version)
    small = EnsembleSpec(sc.with_(power_scale=1.30), n_seeds=64, seed0=1)
    a = run_ensemble(small, engine="cuda")
    b = run_ensemble(small, engine="cuda", device="cpu")
    if not (np.array_equal(a.brake_counts, b.brake_counts)
            and b.brake_counts.sum() > 0):
        raise AssertionError("small ensemble: brake counts differ card vs "
                             "CPU, or no brake fired")
    for name in ("peak_fracs", "mean_fracs", "power_frac"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                   rtol=ROW_W_RTOL, err_msg=name)
    np.testing.assert_allclose(a.slo_cvar("low", 0.5), b.slo_cvar("low", 0.5),
                               rtol=ROW_W_RTOL, atol=1e-9)
    print(f"small ensemble (64 members) card vs CPU: brake counts identical "
          f"({int(a.brake_counts.sum())} brakes), power within {ROW_W_RTOL}")

    # 5. the planner on the card
    cons = RiskConstraints(max_brakes=0, max_slo_violation_prob=1.0,
                           slo_cvar_alpha=0.5, max_slo_cvar=2.0,
                           slo_cvar_priority="low")
    tick.polca_tick_loop.launches = 0
    t0 = time.perf_counter()
    plan = plan_capacity(planner_scenario(), n_seeds=PLAN_SEEDS, seed0=42,
                         engine="cuda", constraints=cons, max_added_frac=0.4)
    plan_s = time.perf_counter() - t0
    plan_launches = tick.polca_tick_loop.launches
    if plan_launches != len(plan.probes):
        raise AssertionError(f"{plan_launches} tick launches for "
                             f"{len(plan.probes)} probes")
    verdicts = ", ".join(
        f"+{p.added_servers}:{'ok' if p.feasible else 'no'}"
        f"(brake_p={p.brake_prob:.3f}, slo_cvar={p.slo_cvar:.3f})"
        for p in plan.probes)
    print(f"planner plan_capacity({PLAN_SEEDS} seeds, engine='cuda'): "
          f"safe_added_servers={plan.safe_added_servers} in {plan_s:.2f} s; "
          f"probes {verdicts}; tick kernel launches {plan_launches}")

    print(json.dumps({"kernels": [{
        "name": "polca_tick",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tick.cu",
        "replaces": "src/repro/kernels/tick.py:211",
        "launches": main_launches,
        "max_abs_err": tick_abs,
        "ms": tick_ms,
        "plain_ms": plain_ms,
        "bound_ms": tick_bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
