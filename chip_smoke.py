#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` and holds each kernel against its plain PyTorch version on the card
at the kernel test shapes of ``tests/test_kernels.py`` (and, for the tick
kernel, :data:`TICK_EDGE_CASES`) and at the main-path shapes. It then drives
the port's two paths at full size and checks that each launched its
kernels:

* the capacity planner's path: ``run_ensemble`` over a 10^5-member dense
  tail of the repo's dense-tail bench scenario, then a ``plan_capacity``
  bisection on 1024-member probes (the tick kernel);
* the calibrated planner family (phase 5a): the six ``mc-*`` budgets
  calibrated on the event-driven simulator, ``plan_scenarios`` over the
  family at 1024 seeds on the tick kernel (one launch a probe), a torch
  grid against the CUDA engine, and the event-driven engine's fork pool
  (``engine="numpy"``) beside the CUDA engine;
* the torch scan engine (``engine="torch"``, PyTorch code, no kernel of
  its own): (a) against the CUDA engine on that 10^5-member model, (b) the
  predictive policy's 10^5-member tail through ``run_ensemble`` and its
  card-vs-CPU check, (c) a 4-generator x 10^3-member grid against a loop,
  (d) member chunking and two shards on the one card against one block,
  (e) a fault timeline on a (2, 2) power hierarchy against the CUDA engine,
  (f) a predictive ``plan_capacity`` bisection at 1024 seeds; each line
  ends with the card's name and power limit;
* routed fleets, rebalancing and chaos (phase g, host numpy as in the
  reference, no kernel): the batched engines' refusal of a routed scenario
  (the reference's message, no tick launch), the ``fleet-rebalance-*``
  family at its registered 6 rows x 21 servers and 6 h with the
  static/no-controller parity, two ``chaos-*`` runs at 2 h, routed members
  on the fork pool against one worker, the survivability gate and
  ``plan_controller_comparison``;
* the serving path: ``ServeEngine`` on full-width llama3.2-1b with random
  weights, 8 requests of 1024-token prompts and 128 new tokens (the flash
  prefill and split-KV decode kernels), its prefill->decode consistency,
  and a card-vs-CPU check of the same engine on the smoke config.

It prints one line per phase, then a JSON line of per-kernel measurements,
and last ``{"ok": true, "device": {...}}``. Kernel times (``ms``) are device
times: calls captured in a CUDA graph and replayed between CUDA events;
``call_ms`` is a Python loop of calls, host included. Any failed phase
raises and exits non-zero; without a CUDA device it exits non-zero before printing any
result.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# three multiplies, one add and one divide. pow() is taken once per value of
# the frequency table (five a block), and busy = k_lp f_lp^g + k_hp f_hp^g
# only when a command changes a frequency, so neither is counted per tick
TICK_BYTES_PER_LANE_TICK = 8 + 3 * 8 + 1
TICK_FLOPS_PER_LANE_TICK = 5

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
# the redesigned kernel's edges: rings deeper than 21 slots (oob 40, past 64
# slots, the deepest the kernel takes), R = 1 and R = 3, ragged last blocks,
# two table frequencies that coincide, occ contiguous [N, T, R] or a view of
# time-major [T, N, R] storage
TICK_EDGE_CASES = [
    # (N, T, R, oob, brake, esc, power_scale, consts overrides, occ layout)
    (37, 300, 1, 40, 3, 25, 1.18, {}, "time-major"),
    (300, 200, 3, 40, 3, 25, 1.18, {}, "contiguous"),
    (29, 400, 3, 100, 7, 25, 1.18, {}, "time-major"),
    (21, 300, 1, 70, 5, 10, 1.18, {}, "contiguous"),
    (19, 250, 3, 40, 3, 25, 1.12, {"lp_t1": 1.0}, "time-major"),
    (9, 1000, 2, 895, 3, 25, 1.18, {}, "time-major"),  # ring of 896 slots
]
ROW_W_RTOL = 1e-6  # the oracle contract's power tolerance (DESIGN.md §15)

MAIN_MEMBERS = 100_000  # benchmarks/batched_engine.py's full-mode tail
CPU_CHECK_MEMBERS = 10_000  # members of the main path held against the CPU
PLAN_SEEDS = 1024

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate
H100_BF16_FLOPS = 989e12

# the attention kernel shapes of tests/test_kernels.py, dtypes by name
FLASH_CASES = [
    # (B, Sq, Skv, H, KV, hd, dtype, causal, window, softcap, bq, bk)
    (2, 128, 128, 4, 2, 64, "bfloat16", True, 0, 0.0, 64, 64),
    (2, 128, 128, 4, 2, 64, "float32", True, 0, 0.0, 64, 64),
    (1, 256, 256, 8, 8, 64, "bfloat16", True, 64, 0.0, 64, 64),
    (1, 256, 256, 8, 4, 64, "bfloat16", True, 100, 0.0, 64, 32),
    (1, 128, 128, 4, 1, 128, "bfloat16", True, 0, 50.0, 64, 64),
    (1, 128, 128, 4, 1, 128, "float32", True, 0, 30.0, 32, 64),
    (2, 64, 192, 4, 2, 64, "bfloat16", True, 0, 0.0, 64, 64),  # q_offset
    (1, 128, 128, 2, 2, 32, "float32", False, 0, 0.0, 64, 64),  # bidir
    (1, 64, 64, 16, 2, 64, "bfloat16", True, 0, 0.0, 64, 64),  # G=8
    (1, 256, 256, 4, 4, 256, "bfloat16", True, 128, 30.0, 128, 128),  # gemma2-like
]
DECODE_CASES = [
    # (B, T, H, KV, hd, valid_len, softcap, bk)
    (2, 512, 8, 2, 64, 300, 0.0, 128),
    (1, 1024, 4, 4, 128, 1024, 0.0, 256),
    (3, 512, 16, 8, 64, 17, 0.0, 128),
    (1, 256, 4, 1, 64, 128, 50.0, 64),
    (2, 512, 2, 2, 256, 511, 0.0, 512),
    (1, 128, 32, 4, 64, 1, 0.0, 128),  # single valid slot
]
# shapes the Pallas wrapper refuses (tiles do not divide the sequences) and
# a tile whose every query is past its window (those rows give 0)
# (B, Sq, Skv, H, KV, hd, dtype, causal, window, softcap, q_offset)
RAGGED_FLASH_CASES = [
    (2, 200, 200, 8, 2, 64, "bfloat16", True, 0, 0.0, 0),
    (1, 77, 333, 4, 1, 128, "float32", True, 100, 0.0, 256),
    (1, 200, 200, 8, 8, 16, "float32", True, 0, 0.0, 0),
    (1, 64, 64, 4, 2, 64, "float32", True, 16, 0.0, 200),
]
ATTN_TOL = {"bfloat16": 3e-2, "float32": 2e-5}  # tests/test_kernels.py's

# the serving main path: full-width llama3.2-1b, 8 requests, 1024-token
# prompts, 128 new tokens (a cache of cache_len(1152) = 1536 slots)
SERVE_ARCH = "llama3.2-1b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_OUT = 8, 1024, 128
SERVE_VALID_LEN = 1100  # the decode kernel's main-path timing shape
SERVE_REL_TOL = 0.06  # tests/test_system.py's prefill->decode bound


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
    events around the runs, after a synchronize). For a call of tens of
    microseconds this is what a Python caller pays per call, host included."""
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


def device_ms(fns, calls: int, replays: int = 5) -> float:
    """Mean device milliseconds of one call: ``calls`` calls, cycling through
    the callables ``fns``, captured in one CUDA graph after a warm-up call of
    each, and the graph replayed ``replays`` times between CUDA events. One
    replay is one host call, so the time is the device's. Cycling through
    inputs whose total exceeds the 50 MB L2 makes each call find its data in
    device memory, as a layer of the served model does."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def ptxas_report(name: str) -> list:
    """One line per kernel instance of ``csrc/<name>.cu`` from its build log:
    registers and spill bytes, as ``nvcc -Xptxas -v`` reported them."""
    import shutil
    from repro_torch.kernels import _build
    rows, fn, spill = [], None, ""
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            rows.append((fn, regs, spill))
            fn = None
    names = [r[0] for r in rows]
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                             capture_output=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = out
    return [f"ptxas {name}: {n.replace('(anonymous namespace)::', '')}: {regs}; {spill}"
            for n, (_, regs, spill) in zip(names, rows)]


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


def reset_counts() -> None:
    """Zero every kernel wrapper's launch count."""
    from repro_torch.kernels import decode_attention, flash_attention, tick
    tick.polca_tick_loop.launches = 0
    flash_attention.flash_attention.launches = 0
    decode_attention.decode_attention.launches = 0
    for fn in (flash_attention.flash_attention, decode_attention.decode_attention):
        for variant in fn.launches_by_variant:
            fn.launches_by_variant[variant] = 0


def counts() -> dict:
    from repro_torch.kernels import decode_attention, flash_attention, tick
    return {"polca_tick": tick.polca_tick_loop.launches,
            "flash_attention": flash_attention.flash_attention.launches,
            "decode_attention": decode_attention.decode_attention.launches}


def compare_close(got, want, tol: float, label: str) -> float:
    """|got - want| <= tol + tol * |want| elementwise (assert_allclose with
    atol = rtol = tol), both finite. Returns the max absolute gap."""
    import torch
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{label}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f"{label}: non-finite values")
    gap = (g - w).abs()
    n_bad = int((gap > tol + tol * w.abs()).sum())
    if n_bad:
        raise AssertionError(f"{label}: {n_bad} elements beyond {tol} (max "
                             f"gap {float(gap.max()):.3e})")
    return float(gap.max())


def randn(rng, shape, dtype: str, dev):
    """Standard normal numpy draws as a tensor of ``dtype`` on ``dev``."""
    import torch
    return torch.as_tensor(rng.standard_normal(shape, dtype="float32"),
                           device=dev).to(getattr(torch, dtype))


def check_tick_cases(dev) -> None:
    """The tick kernel against its plain version on the card at the kernel
    test shapes of tests/test_kernels.py (occ contiguous [N, T, R]) and at
    :data:`TICK_EDGE_CASES`."""
    import numpy as np
    import torch
    from repro_torch.kernels import tick

    f64 = dict(dtype=torch.float64, device=dev)
    cases = ([(N, T, R, oob, brake, esc, ps, {}, "contiguous")
              for N, T, R, _, oob, brake, esc, ps in TICK_CASES]
             + TICK_EDGE_CASES)
    for N, T, R, oob, brake, esc, ps, over, layout in cases:
        consts = tick.TickConsts(**{**TICK_CONSTS, "power_scale": ps, **over})
        rng = np.random.default_rng(N * 1000 + T)
        occ = torch.as_tensor(rng.uniform(0.3, 1.0, (N, T, R)), **f64)
        if layout == "time-major":
            occ = occ.permute(1, 0, 2).contiguous().permute(1, 0, 2)
        bscale = torch.as_tensor(rng.uniform(0.9, 1.0, (T, R)), **f64)
        rb = torch.full((R,), consts.n_servers
                        * (consts.p0_srv_w + 0.8 * consts.k_lp_w), **f64)
        kw = dict(oob_ticks=oob, brake_ticks=brake,
                  ring_depth=max(oob, brake) + 1, esc=esc)
        got = tick.polca_tick_loop(occ, bscale, rb, consts, **kw)
        want = tick.polca_tick_plain(occ, bscale, rb, consts, **kw)
        torch.cuda.synchronize()
        compare_tick(got, want, f"N={N} T={T} R={R} oob={oob} brake={brake} "
                                f"esc={esc} D={kw['ring_depth']} {layout} occ"
                                + "".join(f" {k}={v}" for k, v in over.items()))


def check_attention_cases(dev) -> None:
    """Both attention kernels against their plain versions on the card, at
    the test shapes of tests/test_kernels.py and the ragged shapes; the
    decode shapes in bf16 and in float32 (every instance of the CUDA-core
    decode kernel's float32 path: G = 1, 2, 4, 8 and hd 64, 128, 256)."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    flash = [(*c[:10], c[2] - c[1]) for c in FLASH_CASES] + RAGGED_FLASH_CASES
    for i, (B, Sq, Skv, H, KV, hd, dt, causal, window, cap, q_off) in enumerate(flash):
        rng = np.random.default_rng(100 + i)
        q = randn(rng, (B, Sq, H, hd), dt, dev)
        k = randn(rng, (B, Skv, KV, hd), dt, dev)
        v = randn(rng, (B, Skv, KV, hd), dt, dev)
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_off)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        gap = compare_close(got, want, ATTN_TOL[dt], f"flash case {i}")
        print(f"kernel flash_attention B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} "
              f"hd={hd} {dt} causal={causal} window={window} softcap={cap} "
              f"q_offset={q_off}: max abs gap {gap:.3e}")
    decode = [(*c[:7], dt) for dt in ("bfloat16", "float32") for c in DECODE_CASES]
    for i, (B, T, H, KV, hd, vl, cap, dt) in enumerate(decode):
        rng = np.random.default_rng(200 + i)
        q = randn(rng, (B, H, hd), dt, dev)
        k = randn(rng, (B, T, KV, hd), dt, dev)
        v = randn(rng, (B, T, KV, hd), dt, dev)
        got = dec.decode_attention(q, k, v, vl, softcap=cap)
        want = dec.decode_attention_plain(q, k, v, vl, softcap=cap)
        torch.cuda.synchronize()
        gap = compare_close(got, want, ATTN_TOL[dt], f"decode case {i}")
        print(f"kernel decode_attention B={B} T={T} H={H} KV={KV} hd={hd} {dt} "
              f"valid_len={vl} softcap={cap}: max abs gap {gap:.3e}")


def rel_gap(a, b) -> float:
    """max |a - b| / max |a| (tests/test_system.py's measure)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (a.abs().max() + 1e-6))


def serve_main_path(dev) -> dict:
    """ServeEngine on full-width llama3.2-1b: prefill and decode timings,
    launch counts, determinism and prefill->decode consistency."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import ServeEngine

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, SERVE_PROMPT + SERVE_OUT, SERVE_REQUESTS, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)
    toks = torch.as_tensor(tokens, dtype=torch.long, device=dev)

    eng.prefill(eng.params, {"tokens": toks})  # warm-up (library loads, cuBLAS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_full, cache = eng.prefill(eng.params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del cache

    reset_counts()
    t0 = time.perf_counter()
    out1 = eng.generate(tokens, SERVE_OUT)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = counts()
    want = {"polca_tick": 0, "flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * SERVE_OUT}
    if launches != want:
        raise AssertionError(f"generate launched {launches}, want {want}")
    by_variant = {"flash": dict(fa.flash_attention.launches_by_variant),
                  "decode": dict(dec.decode_attention.launches_by_variant)}
    if by_variant != {"flash": {"tensor_core": want["flash_attention"], "cuda_core": 0},
                      "decode": {"tensor_core": want["decode_attention"], "cuda_core": 0}}:
        raise AssertionError(f"generate launched the kernel variants {by_variant}, "
                             f"want all on the tensor cores")
    t0 = time.perf_counter()
    out2 = eng.generate(tokens, SERVE_OUT)
    gen2_s = time.perf_counter() - t0
    if out1.shape != (SERVE_REQUESTS, SERVE_OUT) or not np.array_equal(out1, out2):
        raise AssertionError("two greedy generate runs differ (or bad shape)")
    if not ((out1 >= 0).all() and (out1 < cfg.vocab_size).all()):
        raise AssertionError("generated token ids out of range")

    decode_ms = (gen_s - prefill_s) / SERVE_OUT * 1e3
    print(f"serving main path ServeEngine({SERVE_ARCH}, full width, "
          f"{cfg.num_layers} layers, random weights seed 0): init {init_s:.2f} s; "
          f"{SERVE_REQUESTS} x {SERVE_PROMPT}-token prompts, {SERVE_OUT} new "
          f"tokens: prefill {prefill_s:.4f} s, generate {gen_s:.3f} s (second "
          f"run {gen2_s:.3f} s), decode {decode_ms:.3f} ms/token step "
          f"(derived: (generate - prefill) / {SERVE_OUT}), "
          f"{SERVE_REQUESTS * SERVE_OUT / gen_s:.1f} output tokens/s; "
          f"launches {launches} (by variant {by_variant}); greedy tokens "
          f"identical over two runs; "
          f"sample {out1[0, :8].tolist()}")
    del eng, logits_full
    torch.cuda.empty_cache()
    return launches


def prefill_decode_gap(eng, toks, logits_full) -> float:
    """Prefill of the prompt minus its last token, then one decode step of
    that token, against the full prefill's last logits (rel_gap)."""
    import torch
    _, cache = eng.prefill(eng.params, {"tokens": toks[:, :-1]})
    logits_dec, _ = eng.decode(eng.params, toks[:, -1:], toks.shape[1] - 1, cache)
    a, b = logits_full[:, -1], logits_dec[:, -1]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite logits")
    return rel_gap(a, b)


def condition_attention(cfg, params) -> None:
    """Rescale the attention weights in place from the JAX package's init,
    whose fan-in is the second-to-last dim (the head count for ``wq [D, H,
    hd]``, the head dim for ``wo [H, hd, D]``), to a fan-in over each
    product's contraction dims (D for wq/wk/wv, H * hd for wo)."""
    D, H, KV = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads
    for blk in params["decoder"].values():
        a = blk["attn"]
        a["wq"].mul_((H / D) ** 0.5)
        a["wk"].mul_((KV / D) ** 0.5)
        a["wv"].mul_((KV / D) ** 0.5)
        a["wo"].mul_(H ** -0.5)


def serve_consistency(dev) -> None:
    """Prefill->decode consistency of the full-width model through the
    kernels, in bf16 and float32. With the JAX package's init the attention
    scores have a standard deviation of ~85 and each layer multiplies a
    perturbation several times, so any two computation orders of the
    16-layer random model (GEMM against GEMV rounding, in either dtype)
    end O(1) apart: that gap is printed, not gated. The gated check runs
    the same model with its attention weights rescaled to a fan-in over
    their contraction dims (:func:`condition_attention`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeEngine

    rng = np.random.default_rng(0)
    for dt in (torch.bfloat16, torch.float32):
        cfg = get_config(SERVE_ARCH).replace(dtype=dt)
        eng = ServeEngine(cfg, SERVE_PROMPT + SERVE_OUT, SERVE_REQUESTS, device="cuda")
        toks = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT)), device=dev)
        reset_counts()
        full, _ = eng.prefill(eng.params, {"tokens": toks})
        rel_init = prefill_decode_gap(eng, toks, full)
        condition_attention(cfg, eng.params)
        full, _ = eng.prefill(eng.params, {"tokens": toks})
        rel = prefill_decode_gap(eng, toks, full)
        launches = counts()
        if not (launches["flash_attention"] == 4 * cfg.num_layers
                and launches["decode_attention"] == 2 * cfg.num_layers):
            raise AssertionError(f"consistency check launched {launches}")
        if not rel < SERVE_REL_TOL:
            raise AssertionError(f"{dt} prefill->decode mismatch rel={rel:.3e}")
        print(f"serving {SERVE_ARCH} full width {str(dt)[6:]}: prefill->decode "
              f"rel gap {rel:.3e} < {SERVE_REL_TOL} with attention weights at "
              f"contraction fan-in; {rel_init:.3e} with the JAX init (not gated)")
        del eng, full
        torch.cuda.empty_cache()


def serve_card_vs_cpu(dev) -> None:
    """The smoke config served in float32 on the card (the kernels) and on
    the CPU (their plain versions) with the same weights: logits within
    1e-4 relative and the same greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import ServeEngine

    cfg = smoke_config(SERVE_ARCH).replace(dtype=torch.float32)
    gpu = ServeEngine(cfg, 64, 2, device="cuda", seed=3)
    cpu = ServeEngine(cfg, 64, 2, device="cpu", seed=3)

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()

    cpu.params = to_cpu(gpu.params)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    lg, _ = gpu.prefill(gpu.params, {"tokens": torch.as_tensor(tokens, device=dev)})
    lc, _ = cpu.prefill(cpu.params, {"tokens": torch.as_tensor(tokens)})
    rel = rel_gap(lc, lg.cpu())
    if not rel < 1e-4:
        raise AssertionError(f"smoke prefill logits card vs CPU rel {rel:.3e}")
    a, b = gpu.generate(tokens, 8), cpu.generate(tokens, 8)
    if not np.array_equal(a, b):
        raise AssertionError(f"smoke greedy tokens differ card vs CPU: {a} {b}")
    print(f"serving {cfg.name} float32 card vs CPU: prefill logits rel gap "
          f"{rel:.3e}, 8 greedy tokens identical")


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(least milliseconds, what bounds it): the larger of bf16 operations
    at the tensor-core peak and bytes at the HBM rate."""
    ops_ms = flops / H100_BF16_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def time_flash(dev, rng, B: int, S: int, H: int, KV: int, hd: int) -> dict:
    """The flash kernel at one bf16 causal prefill shape: device time, call
    time, its plain version's and scaled_dot_product_attention's device
    times (a yardstick the port never calls), the bound and the error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    q = randn(rng, (B, S, H, hd), "bfloat16", dev)
    k = randn(rng, (B, S, KV, hd), "bfloat16", dev)
    v = randn(rng, (B, S, KV, hd), "bfloat16", dev)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = compare_close(got, want, ATTN_TOL["bfloat16"], f"flash B={B} S={S} hd={hd}")
    del got, want
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kernel = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    row = dict(
        ms=device_ms([kernel], calls=20),
        call_ms=cuda_ms(kernel, reps=20),
        plain_ms=device_ms([lambda: fa.flash_attention_plain(q, k, v, causal=True)],
                           calls=3, replays=2),
        library_ms=device_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)], calls=20),
        max_abs_err=err)
    flops = 4 * B * H * hd * S * (S + 1) / 2
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)  # q, o, k, v in bf16
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    print(f"kernel flash_attention B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal: "
          f"device {row['ms']:.4f} ms, call {row['call_ms']:.4f} ms (plain version "
          f"{row['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{row['library_ms']:.4f} ms, device times; bound {row['bound_ms']:.4f} ms "
          f"by {row['bound_by']}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
          f"max abs gap {err:.3e}")
    return row


DECODE_SETS = 4  # cache sets the decode timing cycles through: 100 MB > L2


def time_decode(dev, rng, B: int, T: int, H: int, KV: int, hd: int, vl: int) -> dict:
    """The decode kernel at one bf16 shape, as :func:`time_flash`, the
    timed calls cycling through :data:`DECODE_SETS` caches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec

    sets = [tuple(randn(rng, s, "bfloat16", dev)
                  for s in ((B, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
            for _ in range(DECODE_SETS)]
    q, k, v = sets[0]
    got = dec.decode_attention(q, k, v, vl)
    want = dec.decode_attention_plain(q, k, v, vl)
    torch.cuda.synchronize()
    err = compare_close(got, want, ATTN_TOL["bfloat16"], "decode main-path shape")
    mask = (torch.arange(T, device=dev) < vl)[None, None, None, :]
    lib_sets = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)) for q, k, v in sets]
    row = dict(
        ms=device_ms([lambda s=s: dec.decode_attention(*s, vl) for s in sets], calls=64),
        call_ms=cuda_ms(lambda: dec.decode_attention(q, k, v, vl), reps=50),
        plain_ms=device_ms([lambda s=s: dec.decode_attention_plain(*s, vl) for s in sets],
                           calls=8),
        library_ms=device_ms([lambda s=s: F.scaled_dot_product_attention(
            *s, attn_mask=mask, enable_gqa=True) for s in lib_sets], calls=64),
        max_abs_err=err)
    nbytes = 2 * (2 * B * vl * KV * hd + 2 * B * H * hd)  # valid k, v; q, o
    flops = 4 * B * H * hd * vl
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    print(f"kernel decode_attention B={B} T={T} H={H} KV={KV} hd={hd} valid_len={vl} "
          f"bf16: device {row['ms']:.5f} ms, call {row['call_ms']:.5f} ms (plain "
          f"version {row['plain_ms']:.5f} ms, scaled_dot_product_attention "
          f"{row['library_ms']:.5f} ms, device times over {DECODE_SETS} caches; bound "
          f"{row['bound_ms']:.5f} ms by {row['bound_by']}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP); max abs gap {err:.3e}")
    return row


def time_attention(dev, rng_seed: int = 7) -> list:
    """Both attention kernels at the serving main-path shapes (llama3.2-1b),
    and the flash kernel also at the qwen3-8b / yi-34b head dim of 128."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import cache_len

    cfg = get_config(SERVE_ARCH)
    B, S, H, KV, hd = (SERVE_REQUESTS, SERVE_PROMPT, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(rng_seed)
    flash = time_flash(dev, rng, B, S, H, KV, hd)
    flash["hd128"] = time_flash(dev, rng, B, S, 32, 8, 128)
    decode = time_decode(dev, rng, B, cache_len(SERVE_PROMPT + SERVE_OUT), H, KV, hd,
                         SERVE_VALID_LEN)
    flash.update(name="flash_attention",
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:32")
    decode.update(name="decode_attention",
                  source="src/repro_torch/kernels/csrc/decode_attention.cu",
                  replaces="src/repro/kernels/decode_attention.py:28")
    return [flash, decode]


# ---------------------------------------------------------------------------
# the torch scan engine (engine="torch"): predictive policies, grids, member
# chunking and sharding, fault timelines and the power hierarchy
# ---------------------------------------------------------------------------

CARD = "card not read yet"  # the nvidia-smi name,power.limit line, set by main
GRID_GENERATORS = ("diurnal", "bursty", "colocated", "nighttime")
GRID_MEMBERS = 1000
INVARIANCE_MEMBERS = 10_000
INVARIANCE_CHUNK = 4096
SHARD_DEVICES = ["cuda:0", "cuda:0"]  # two member shards on the one card
PROFILE_TICKS = 100  # ticks of the torch engine traced by torch.profiler
CARD_VS_CPU_MEMBERS = 256
FAULT_MEMBERS = 2048
SLO_RTOL, SLO_ATOL = 1e-6, 1e-9  # the oracle contract's SLO-impact tolerance


def say(line: str) -> None:
    """Print a measurement line with the card's name and power limit."""
    print(f"{line} [{CARD}]")


@contextlib.contextmanager
def timed_calls(module, name: str):
    """Sum the wall seconds (card work included) of every call of
    ``module.name`` made inside the block; yields a one-item list."""
    import torch
    real = getattr(module, name)
    spent = [0.0]

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0

    setattr(module, name, timed)
    try:
        yield spent
    finally:
        setattr(module, name, real)


def compare_runs(got, want, label: str) -> dict:
    """Two BatchedRuns of one model under the oracle contract: brake-tick
    sets (when both kept them) and counts bit-identical, power (peak and
    mean fractions, series and node folds when kept) within ROW_W_RTOL, SLO
    impacts within SLO_RTOL / SLO_ATOL. Returns the largest relative power
    gap and absolute impact gap."""
    import numpy as np
    if not np.array_equal(got.n_brakes, want.n_brakes):
        raise AssertionError(f"{label}: brake counts differ")
    if (got.brake_fire is not None and want.brake_fire is not None
            and not np.array_equal(got.brake_fire, want.brake_fire)):
        raise AssertionError(f"{label}: brake-tick sets differ")
    rel = 0.0
    for name in ("peak_frac", "mean_frac", "total_frac", "row_w", "node_w"):
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None):
            raise AssertionError(f"{label}: {name} kept by one run only")
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=ROW_W_RTOL, atol=0.0,
                                       err_msg=f"{label}: {name}")
            rel = max(rel, float((np.abs(a - b) / np.abs(b)).max()))
    imp = 0.0
    for name in ("impacts_hp", "impacts_lp"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_allclose(a, b, rtol=SLO_RTOL, atol=SLO_ATOL,
                                   err_msg=f"{label}: {name}")
        imp = max(imp, float(np.abs(a - b).max()))
    return {"power_rel": rel, "impact_abs": imp,
            "brakes": int(want.n_brakes.sum())}


def assert_runs_identical(a, b, label: str) -> None:
    """Every field two BatchedRuns kept, bit for bit."""
    import numpy as np
    for name in ("brake_fire", "n_brakes", "peak_frac", "mean_frac",
                 "impacts_hp", "impacts_lp", "total_frac", "row_w", "node_w"):
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None) or (
                x is not None and not np.array_equal(x, y)):
            raise AssertionError(f"{label}: {name} differs")


def check_no_tick_launch(label: str) -> None:
    """The torch engine is PyTorch code: a path on it launches no tick
    kernel (its counts were zeroed just before)."""
    if counts()["polca_tick"] != 0:
        raise AssertionError(f"{label} launched the tick kernel")


def torch_vs_cuda(dev, model) -> None:
    """(a) engine="torch" against engine="cuda" on the main path's lowered
    10^5-member model (non-predictive)."""
    import torch
    from repro_torch.provisioning.batched import run_tick_model

    warm = dataclasses.replace(model, n_members=64, occ60=model.occ60[:64],
                               seeds=model.seeds[:64])
    run_tick_model(warm, engine="torch", device=dev)  # first-call set-up
    reset_counts()
    t0 = time.perf_counter()
    cu = run_tick_model(model, engine="cuda", keep_series=False, device=dev)
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    if counts()["polca_tick"] != 1:
        raise AssertionError(f"engine='cuda' launched {counts()}")
    reset_counts()
    t0 = time.perf_counter()
    tr = run_tick_model(model, engine="torch", keep_series=False, device=dev)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    check_no_tick_launch("engine='torch'")
    gap = compare_runs(tr, cu, "torch vs cuda engine at the main shape")
    say(f"(a) engine='torch' vs engine='cuda' on the main path's model "
        f"(N={model.n_members}, T={model.n_ticks}, R={model.n_rows}, polca): "
        f"torch engine {torch_s:.3f} s, cuda engine {cuda_s:.3f} s "
        f"(ratio {torch_s / cuda_s:.2f}); brake-tick sets and counts "
        f"bit-identical ({gap['brakes']} brakes), power max rel gap "
        f"{gap['power_rel']:.3e}, SLO impacts max abs gap "
        f"{gap['impact_abs']:.3e}")


def torch_engine_breakdown(dev, model) -> None:
    """Where the torch engine's time goes at the main shape, for the
    model's policy and its predictive twin (same occupancy): lane set-up
    (occupancy on the card, tables), the T-tick loop and the copy of the
    outputs to the host, timed apart; then over :data:`PROFILE_TICKS`
    ticks under ``torch.profiler``, the kernel launches a tick and the
    device time a tick, and from these the device's busy share of the
    unprofiled loop."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.provisioning import batched

    members = np.arange(model.n_members)
    for m in (model, dataclasses.replace(model, predictive=True)):
        def lanes():
            return batched._Lanes([m], members, dev, keep_series=False,
                                  keep_fire=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ln = lanes()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for k in range(m.n_ticks):
            ln.step(k)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ln.results()
        copy_s = time.perf_counter() - t0
        del ln
        ln = lanes()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k in range(PROFILE_TICKS):
                ln.step(k)
            torch.cuda.synchronize()
        del ln
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.device_time for e in kernels) / PROFILE_TICKS
        per_tick_us = loop_s / m.n_ticks * 1e6
        busy = (f"device busy {device_us:.1f} us a tick = "
                f"{100 * device_us / per_tick_us:.1f} % of the unprofiled "
                f"tick" if device_us > 0 else "device time not measured "
                "(the profiler saw no device event)")
        say(f"(a) torch engine breakdown, {'polca-predictive' if m.predictive else 'polca'}, "
            f"N={m.n_members}, T={m.n_ticks}, R={m.n_rows}: set-up "
            f"{setup_s:.3f} s, tick loop {loop_s:.3f} s ({per_tick_us:.0f} us "
            f"a tick), outputs to the host {copy_s:.3f} s; over "
            f"{PROFILE_TICKS} profiled ticks {len(kernels) / PROFILE_TICKS:.1f} "
            f"device operations a tick, {busy}")
        torch.cuda.empty_cache()


def predictive_tail(dev, sc) -> None:
    """(b) the predictive dense tail: polca-predictive on the main scenario
    at 10^5 members through run_ensemble(engine="torch"), then the card
    against the CPU at 256 members."""
    import numpy as np
    from repro_torch.provisioning import batched
    from repro_torch.provisioning.montecarlo import EnsembleSpec, run_ensemble

    pred = sc.with_policy("polca-predictive").with_(name="bench-predictive")
    reset_counts()
    with timed_calls(batched, "lower_ensemble") as lower_s, \
            timed_calls(batched, "_run_models") as engine_s:
        t0 = time.perf_counter()
        res = run_ensemble(EnsembleSpec(pred, n_seeds=MAIN_MEMBERS, seed0=1),
                           engine="torch")
        e2e_s = time.perf_counter() - t0
    check_no_tick_launch("run_ensemble(engine='torch')")
    cvars = [res.brake_cvar(a) for a in (0.0, 0.9, 0.999)]
    if not (res.n_members == MAIN_MEMBERS and np.isfinite(res.peak_fracs).all()
            and np.isfinite(res.mean_fracs).all()
            and cvars[0] <= cvars[1] <= cvars[2]
            and math.isfinite(res.slo_cvar("low", 0.999))):
        raise AssertionError("predictive tail: implausible result")
    say(f"(b) predictive tail run_ensemble({MAIN_MEMBERS} members, "
        f"polca-predictive, engine='torch'): lowering {lower_s[0]:.2f} s, "
        f"engine {engine_s[0]:.3f} s, end to end {e2e_s:.2f} s = "
        f"{MAIN_MEMBERS / e2e_s:.0f} members/s; brakes "
        f"{int(res.brake_counts.sum())}, brake_prob {res.brake_prob():.4f}, "
        f"peak max {res.peak_fracs.max():.4f}")
    for ps in (sc.power_scale, 1.30):
        model = batched.lower_ensemble(EnsembleSpec(
            pred.with_(power_scale=ps), n_seeds=CARD_VS_CPU_MEMBERS,
            seed0=1))[0]
        card = batched.run_tick_model(model, engine="torch", device=dev)
        cpu = batched.run_tick_model(model, engine="torch", device="cpu")
        gap = compare_runs(card, cpu, f"predictive card vs CPU ps={ps}")
        say(f"(b) predictive {CARD_VS_CPU_MEMBERS} members power_scale {ps}: "
            f"card vs CPU brake-tick sets bit-identical ({gap['brakes']} "
            f"brakes), power max rel gap {gap['power_rel']:.3e}, SLO impacts "
            f"max abs gap {gap['impact_abs']:.3e}")


def grid_vs_loop(dev, sc) -> None:
    """(c) four generator families x 10^3 members: one run_tick_models call
    against a loop of run_tick_model, bit for bit."""
    import torch
    from repro_torch.provisioning.batched import (
        lower_ensemble, run_tick_model, run_tick_models)
    from repro_torch.provisioning.montecarlo import EnsembleSpec

    models = [lower_ensemble(EnsembleSpec(sc.with_(
        name=f"grid-{g}", traffic=dataclasses.replace(sc.traffic, generator=g)),
        n_seeds=GRID_MEMBERS, seed0=1))[0] for g in GRID_GENERATORS]
    reset_counts()
    t0 = time.perf_counter()
    loop = [run_tick_model(m, engine="torch", device=dev) for m in models]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = run_tick_models(models, device=dev)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    check_no_tick_launch("the torch grid")
    for m, g, l in zip(models, grid, loop):
        assert_runs_identical(g, l, f"grid vs loop {m.base_name}")
    say(f"(c) grid {len(models)} generators x {GRID_MEMBERS} members "
        f"(T={models[0].n_ticks}, R={models[0].n_rows}): one run_tick_models "
        f"{grid_s:.3f} s, loop of run_tick_model {loop_s:.3f} s (loop first; "
        f"ratio {loop_s / grid_s:.2f}); every field bit-identical; brakes "
        f"{[int(r.n_brakes.sum()) for r in grid]}")


def invariance(dev, sc) -> None:
    """(d) 10^4 members: member_chunk=4096 and two shards on the one card
    against one flat block, bit for bit."""
    import torch
    from repro_torch.provisioning.batched import lower_ensemble, run_tick_model
    from repro_torch.provisioning.montecarlo import EnsembleSpec

    model = lower_ensemble(EnsembleSpec(sc, n_seeds=INVARIANCE_MEMBERS,
                                        seed0=1))[0]
    times = {}
    runs = {}
    for label, kw in (("flat", dict(member_chunk=0, device=dev)),
                      (f"member_chunk={INVARIANCE_CHUNK}",
                       dict(member_chunk=INVARIANCE_CHUNK, device=dev)),
                      (f"devices={SHARD_DEVICES}",
                       dict(devices=SHARD_DEVICES))):
        t0 = time.perf_counter()
        runs[label] = run_tick_model(model, engine="torch", keep_series=False,
                                     **kw)
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
    for label, run in runs.items():
        assert_runs_identical(run, runs["flat"], f"{label} vs flat")
    say(f"(d) invariance at {INVARIANCE_MEMBERS} members: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
        + f"; all bit-identical to flat ({int(runs['flat'].n_brakes.sum())} "
        f"brakes)")


def faults_and_hierarchy(dev, sc) -> None:
    """(e) a 4-row site under HierarchySpec((2, 2)) with a node-derate and a
    row crash, lowered by the port: the CUDA and torch engines agree."""
    import torch
    from repro_torch.chaos import FaultEvent
    from repro_torch.provisioning.batched import lower_ensemble, run_tick_model
    from repro_torch.provisioning.montecarlo import EnsembleSpec

    fsc = sc.with_hierarchy((2, 2)).with_faults([
        FaultEvent("node-derate", t=600.0, node="pdu1", factor=0.7,
                   until=1400.0, ramp_s=120.0),
        FaultEvent("row-crash", t=300.0, row=2),
        FaultEvent("row-revive", t=900.0, row=2),
    ]).with_(name="faults-hierarchy")
    model = lower_ensemble(EnsembleSpec(fsc, n_seeds=FAULT_MEMBERS,
                                        seed0=1))[0]
    if model.node_matrix is None or (model.alive == 1.0).all() or (
            model.budget_scale == 1.0).all():
        raise AssertionError("faults/hierarchy did not reach the lowering")
    reset_counts()
    cu = run_tick_model(model, engine="cuda", device=dev)
    if counts()["polca_tick"] != 1:
        raise AssertionError(f"engine='cuda' launched {counts()}")
    reset_counts()
    t0 = time.perf_counter()
    tr = run_tick_model(model, engine="torch", device=dev)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    check_no_tick_launch("engine='torch' on faults/hierarchy")
    if cu.node_w is None or tr.node_w is None:
        raise AssertionError("node_w missing")
    gap = compare_runs(tr, cu, "faults/hierarchy torch vs cuda")
    say(f"(e) faults + hierarchy (2, 2), {FAULT_MEMBERS} members, node-derate "
        f"pdu1 + row crash/revive: torch {torch_s:.3f} s; torch vs cuda "
        f"brake-tick sets bit-identical ({gap['brakes']} brakes), power and "
        f"node_w ({len(model.node_names)} nodes) max rel gap "
        f"{gap['power_rel']:.3e}, SLO impacts max abs gap "
        f"{gap['impact_abs']:.3e}")


def torch_planner(cons) -> None:
    """(f) plan_capacity(engine="torch") on the predictive planner scenario
    at 1024 seeds."""
    from repro_torch.provisioning.planner import plan_capacity

    reset_counts()
    t0 = time.perf_counter()
    plan = plan_capacity(planner_scenario().with_policy("polca-predictive"),
                         n_seeds=PLAN_SEEDS, seed0=42, engine="torch",
                         constraints=cons, max_added_frac=0.4)
    plan_s = time.perf_counter() - t0
    check_no_tick_launch("plan_capacity(engine='torch')")
    if not (plan.probes and 0 <= plan.safe_added_servers <= 4):
        raise AssertionError(f"implausible plan {plan}")
    verdicts = ", ".join(
        f"+{p.added_servers}:{'ok' if p.feasible else 'no'}"
        f"(brake_p={p.brake_prob:.3f}, slo_cvar={p.slo_cvar:.3f})"
        for p in plan.probes)
    say(f"(f) planner plan_capacity({PLAN_SEEDS} seeds, polca-predictive, "
        f"engine='torch'): safe_added_servers={plan.safe_added_servers}, "
        f"{len(plan.probes)} probes in {plan_s:.2f} s; probes {verdicts}")


# ---------------------------------------------------------------------------
# the calibrated planner family: the paper's mc-* scenarios under the
# envelope calibrated on the event-driven simulator
# ---------------------------------------------------------------------------

FAMILY_SEEDS = 1024  # members a probe
FAMILY_SEED0 = 1000  # benchmarks/capacity_planning.py's seed0
FAMILY_GRID_S = 3600.0  # the torch-vs-cuda grid's horizon (the torch loop is host-bound)
FAMILY_NUMPY_SEEDS = 16  # the event-driven engine's timing run
FAMILY_ONE_WORKER_SEEDS = 4  # its first members, rerun on one worker


@contextlib.contextmanager
def per_call(module, name: str):
    """Record ``(scenario name, wall seconds, tick launches)`` for every call
    of ``module.name(base, ...)`` made inside the block (card work included);
    yields the list."""
    import torch
    real = getattr(module, name)
    calls = []

    def wrapped(base, *args, **kwargs):
        torch.cuda.synchronize()
        n0, t0 = counts()["polca_tick"], time.perf_counter()
        try:
            return real(base, *args, **kwargs)
        finally:
            torch.cuda.synchronize()
            calls.append((base.name, time.perf_counter() - t0,
                          counts()["polca_tick"] - n0))

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def kept_runs(batched):
    """Keep the BatchedRun behind every EnsembleResult made inside the block,
    by engine and scenario name (its brake-tick set included)."""
    real = batched._to_ensemble_result
    runs = {}

    def keep(model, members, budget_w, run, member_stats=True):
        runs.setdefault(run.engine, {})[model.base_name] = run
        return real(model, members, budget_w, run, member_stats=member_stats)

    batched._to_ensemble_result = keep
    try:
        yield runs
    finally:
        batched._to_ensemble_result = real


def calibrated_planner_family(dev) -> int:
    """The six mc-* scenarios at their registered size (12 h, 40 provisioned
    servers, one row): (1) their calibrated budgets on the host, (2)
    plan_scenarios at FAMILY_SEEDS seeds on engine="cuda" under the
    mc-diurnal envelope, one tick launch a probe, (3) one torch-engine grid
    over the family at the diurnal plan's safe size, cut to FAMILY_GRID_S,
    against engine="cuda" per scenario, (4) the event-driven engine against
    engine="cuda" at FAMILY_NUMPY_SEEDS seeds. Returns the planner's tick
    launches."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.experiments.scenario import get_scenario
    from repro_torch.provisioning import batched, montecarlo, planner
    from repro_torch.provisioning.ensembles import MC_BASE_NAME, MC_SCENARIO_FAMILY
    from repro_torch.provisioning.montecarlo import (
        EnsembleSpec, resolve_ensemble_budget, run_ensemble, run_ensemble_grid)

    bases = [get_scenario(name) for name in MC_SCENARIO_FAMILY]
    n_prov = bases[0].fleet.n_provisioned
    n_ticks = int(bases[0].duration_s / bases[0].telemetry.telemetry_s)
    budgets = {}
    for sc in bases:
        t0 = time.perf_counter()
        budgets[sc.name] = resolve_ensemble_budget(sc)
        say(f"calibrated planner family: budget {sc.name} = "
            f"{budgets[sc.name]!r} W, resolved in "
            f"{time.perf_counter() - t0:.3f} s on the host")
    envelope = budgets[MC_BASE_NAME]

    # (2) the planner over the family on the tick kernel
    reset_counts()
    with per_call(planner, "plan_capacity") as plans_s, \
            timed_calls(batched, "lower_ensemble") as lower_s, \
            timed_calls(batched, "_run_models") as engine_s, \
            timed_calls(batched.kops, "polca_tick") as tick_s, \
            timed_calls(batched, "_slo_impacts") as slo_s:
        t0 = time.perf_counter()
        plans = planner.plan_scenarios(bases, n_seeds=FAMILY_SEEDS,
                                       seed0=FAMILY_SEED0, budget_w=envelope,
                                       engine="cuda")
        total_s = time.perf_counter() - t0
    launches = counts()["polca_tick"]
    n_probes = sum(len(p.probes) for p in plans.values())
    for (name, s, n), p in zip(plans_s, plans.values()):
        if name != p.scenario_name or n != len(p.probes) or p.budget_w != envelope:
            raise AssertionError(f"{name}: {n} tick launches for "
                                 f"{len(p.probes)} probes, budget {p.budget_w}")
        verdicts = ", ".join(
            f"+{q.added_servers}:{'ok' if q.feasible else 'no'}"
            f"(brake_p={q.brake_prob:.4f}, slo_p={q.slo_violation_prob:.4f})"
            for q in p.probes)
        say(f"calibrated planner family: plan_capacity {name} "
            f"({FAMILY_SEEDS} seeds, T={n_ticks}, engine='cuda'): "
            f"safe_added_servers={p.safe_added_servers} "
            f"(+{p.safe_added_frac:.1%}{', capped' if p.capped else ''}"
            f"{'' if p.feasible_at_zero else ', infeasible at 0'}), "
            f"{len(p.probes)} probes in {s:.2f} s; tick kernel launches {n}; "
            f"probes {verdicts}")
    if launches != n_probes:
        raise AssertionError(f"{launches} tick launches for {n_probes} probes")
    rest_s = total_s - lower_s[0] - engine_s[0]
    say(f"calibrated planner family: plan_scenarios over {len(plans)} "
        f"scenarios in {total_s:.2f} s, {n_probes} probes = "
        f"{total_s / n_probes:.3f} s a probe: lowering {lower_s[0]:.2f} s, "
        f"device engine {engine_s[0]:.2f} s (of which tick kernel calls "
        f"{tick_s[0]:.2f} s, SLO proxy loop {slo_s[0]:.2f} s), the rest "
        f"{rest_s:.2f} s; outside the tick kernel "
        f"{100 * (total_s - tick_s[0]) / total_s:.1f} %; tick kernel "
        f"launches {launches}")

    # (3) the torch engine's grid against the CUDA engine at the diurnal
    # plan's safe size
    safe = plans[MC_BASE_NAME].safe_added_servers
    grid_bases = [b.with_fleet(added_frac=safe / n_prov)
                  .with_(duration_s=FAMILY_GRID_S) for b in bases]
    with kept_runs(batched) as runs:
        reset_counts()
        t0 = time.perf_counter()
        grid = run_ensemble_grid(grid_bases, n_seeds=FAMILY_SEEDS,
                                 seed0=FAMILY_SEED0, budget_w=envelope,
                                 engine="torch")
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        check_no_tick_launch("run_ensemble_grid(engine='torch')")
        t0 = time.perf_counter()
        cuda = {b.name: run_ensemble(EnsembleSpec(b, n_seeds=FAMILY_SEEDS,
                                                  seed0=FAMILY_SEED0),
                                     budget_w=envelope, engine="cuda")
                for b in grid_bases}
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t0
    if counts()["polca_tick"] != len(grid_bases):
        raise AssertionError(f"engine='cuda' launched {counts()}")
    brakes, power_rel, impact_abs = [], 0.0, 0.0
    for b in grid_bases:
        tr, cu = runs["torch"][b.name], runs["cuda"][b.name]
        if tr.brake_fire is None or cu.brake_fire is None:
            raise AssertionError(f"{b.name}: a brake-tick set was not kept")
        gap = compare_runs(tr, cu, f"family grid {b.name} torch vs cuda")
        g, c = grid[b.name], cuda[b.name]
        for stat in ("n_members", "budget_w"):
            if getattr(g, stat) != getattr(c, stat):
                raise AssertionError(f"{b.name}: {stat} differs")
        if not np.array_equal(g.brake_counts, c.brake_counts):
            raise AssertionError(f"{b.name}: brake counts differ")
        for stat in (lambda r: r.brake_prob(), lambda r: r.brake_cvar(0.9),
                     lambda r: r.meets_fraction(),
                     lambda r: r.slo_violation_prob()):
            if stat(g) != stat(c):
                raise AssertionError(f"{b.name}: ensemble statistics differ")
        for name in ("peak_fracs", "mean_fracs"):
            np.testing.assert_allclose(getattr(g, name), getattr(c, name),
                                       rtol=ROW_W_RTOL, err_msg=name)
        brakes.append(gap["brakes"])
        power_rel = max(power_rel, gap["power_rel"])
        impact_abs = max(impact_abs, gap["impact_abs"])
    say(f"calibrated planner family: torch grid vs cuda at +{safe} servers, "
        f"{len(grid_bases)} scenarios x {FAMILY_SEEDS} members, "
        f"T={int(FAMILY_GRID_S / bases[0].telemetry.telemetry_s)}: one "
        f"run_ensemble_grid(engine='torch') {grid_s:.2f} s, "
        f"{len(grid_bases)} run_ensemble(engine='cuda') {cuda_s:.2f} s; "
        f"brake-tick sets and counts bit-identical (brakes {brakes}), "
        f"brake_prob/CVaR/meets/slo_violation_prob equal, power max rel gap "
        f"{power_rel:.3e}, SLO impacts max abs gap {impact_abs:.3e}")

    # (4) the event-driven engine (host, fork pool) against the CUDA engine
    spec = EnsembleSpec(bases[0].with_fleet(added_frac=safe / n_prov),
                        n_seeds=FAMILY_NUMPY_SEEDS, seed0=FAMILY_SEED0)
    workers = montecarlo._default_workers(FAMILY_NUMPY_SEEDS, None)
    if workers < 2:
        raise AssertionError(f"{workers} worker(s): the fork pool is not run")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        ev = run_ensemble(spec, budget_w=envelope, engine="numpy")
        numpy_s = time.perf_counter() - t0
    inline = [w for w in caught if "process pool unavailable" in str(w.message)]
    if inline:
        raise AssertionError(f"the fork pool did not run: {inline[0].message}")
    # members are independent, so the first ones rerun on one worker must
    # equal the pool's
    k = FAMILY_ONE_WORKER_SEEDS
    t0 = time.perf_counter()
    ev1 = run_ensemble(dataclasses.replace(spec, n_seeds=k, n_workers=1),
                       budget_w=envelope, engine="numpy")
    numpy1_s = time.perf_counter() - t0
    for name in ("brake_counts", "peak_fracs", "mean_fracs", "power_frac"):
        if not np.array_equal(getattr(ev, name)[:k], getattr(ev1, name)):
            raise AssertionError(f"event-driven engine: {name} differs "
                                 f"between {workers} workers and 1")
    if [m.result.latencies for m in ev.members[:k]] != \
            [m.result.latencies for m in ev1.members]:
        raise AssertionError("event-driven engine: latencies differ between "
                             f"{workers} workers and 1")
    reset_counts()
    t0 = time.perf_counter()
    cu = run_ensemble(spec, budget_w=envelope, engine="cuda")
    torch.cuda.synchronize()
    cu_s = time.perf_counter() - t0
    if counts()["polca_tick"] != 1:
        raise AssertionError(f"engine='cuda' launched {counts()}")
    say(f"calibrated planner family: mc-diurnal at +{safe} servers, "
        f"{spec.base.duration_s / 3600:g} h, "
        f"{FAMILY_NUMPY_SEEDS} seeds: event-driven engine='numpy' "
        f"{numpy_s:.2f} s on {workers} fork workers = "
        f"{FAMILY_NUMPY_SEEDS / numpy_s:.2f} members/s (its first {k} on 1 "
        f"worker {numpy1_s:.2f} s, bit-identical), engine='cuda' {cu_s:.3f} s = "
        f"{FAMILY_NUMPY_SEEDS / cu_s:.1f} members/s "
        f"(ratio {numpy_s / cu_s:.1f}); brake_prob numpy {ev.brake_prob():.4f} "
        f"/ cuda {cu.brake_prob():.4f}, peak max numpy "
        f"{ev.peak_fracs.max():.4f} / cuda {cu.peak_fracs.max():.4f}")
    return launches


# ---------------------------------------------------------------------------
# (g) routed fleets, budget rebalancing and chaos: host numpy, as in the
# reference; the batched engines refuse routed scenarios
# ---------------------------------------------------------------------------

FLEET_REFUSAL = ("batched engine runs unrouted row/cluster scenarios; "
                 "{name!r} carries a RoutingSpec (use engine='numpy' — the "
                 "event-driven fleet path)")
SURVIVE_REFUSAL = ("RiskConstraints.survive needs engine='numpy': the "
                   "survivability gate runs the routed FleetSimulator, which "
                   "the batched tick engines do not model (got "
                   "engine='cuda')")
REBALANCE_KINDS = ("static", "proportional", "predictive", "forecast-router")
DERATED_ROW = 5  # fleet-rebalance-*'s 0.7 row_budget_fracs entry
PARITY_S = 1800.0  # benchmarks/fleet_rebalance.py's static-parity horizon
CHAOS_S = 2 * 3600.0  # benchmarks/chaos_resilience.py's quick horizon
CHAOS_RUNS = ("chaos-pdu-loss-static", "chaos-pdu-loss-tree")
ROUTED_POOL_S = 3600.0
ROUTED_POOL_SEEDS = 8
ROUTED_ONE_WORKER_SEEDS = 2
SURVIVE_SEEDS = 3
COMPARISON_S = 3600.0  # benchmarks/fleet_rebalance.py's full-mode planner
COMPARISON_SEEDS = 2


def expect_refusal(call, message: str, label: str) -> None:
    """``call`` raises ValueError with exactly ``message`` (the JAX
    package's text) and launches no tick kernel."""
    reset_counts()
    try:
        call()
    except ValueError as e:
        if str(e) != message:
            raise AssertionError(f"{label}: refused with {e!s}, want "
                                 f"{message}") from e
    else:
        raise AssertionError(f"{label}: a routed scenario was not refused")
    check_no_tick_launch(label)


def routed_fleets(dev) -> None:
    """(g) the routed-fleet families on the host at their registered width:
    (1) the batched engines refuse a routed scenario with the reference's
    message and no tick launch, (2) the fleet-rebalance-* family at 6 h under
    the static scenario's calibrated envelope and the static/no-controller
    parity, (3) two chaos-* runs at the quick horizon, (4) routed members on
    the fork pool, (5) the survivability gate, (6)
    plan_controller_comparison. Only horizons and seed counts are cut."""
    import warnings
    import numpy as np
    from repro_torch.chaos import FaultEvent, FaultSpec
    from repro_torch.experiments.runner import (
        build_workloads, resolve_budget, run_experiment)
    from repro_torch.experiments.scenario import (
        ControllerSpec, FleetSpec, HierarchySpec, PolicySpec, RoutingSpec,
        Scenario, TrafficSpec, get_scenario)
    from repro_torch.provisioning import montecarlo, planner
    from repro_torch.provisioning.montecarlo import (
        EnsembleSpec, run_ensemble, run_ensemble_grid)

    # (1) refusals, with no fallback to the host
    fleet = get_scenario("fleet-cap-aware")
    refusal = FLEET_REFUSAL.format(name=fleet.name)
    crash2 = FaultSpec((FaultEvent("row-crash", t=600.0, row=0),
                        FaultEvent("row-crash", t=700.0, row=1),
                        FaultEvent("row-revive", t=1500.0, row=0),
                        FaultEvent("row-revive", t=1500.0, row=1)))
    spec = EnsembleSpec(fleet, n_seeds=2)
    for label, call, message in (
            ("run_ensemble(engine='cuda')",
             lambda: run_ensemble(spec, engine="cuda", device=dev), refusal),
            ("run_ensemble(engine='torch')",
             lambda: run_ensemble(spec, engine="torch", device=dev),
             refusal),
            ("run_ensemble_grid (default engine)",
             lambda: run_ensemble_grid([fleet], n_seeds=2, device=dev),
             refusal),
            ("plan_capacity(survive=..., engine='cuda')",
             lambda: planner.plan_capacity(
                 fleet, n_seeds=2, engine="cuda",
                 constraints=planner.RiskConstraints(survive=crash2)),
             SURVIVE_REFUSAL)):
        expect_refusal(call, message, label)
    say(f"(g) routed fleets: {fleet.name} refused by run_ensemble "
        f"engine='cuda' and 'torch', run_ensemble_grid's default engine and "
        f"plan_capacity(survive=..., engine='cuda'), each with the "
        f"reference's ValueError and no tick launch")

    # (2) the rebalance family at its registered size under one envelope
    base = get_scenario("fleet-rebalance-static")
    wls, shares = build_workloads(base)
    t0 = time.perf_counter()
    budget = resolve_budget(base, wls, shares, base.fleet.server())
    say(f"(g) fleet-rebalance-static: calibrated envelope {budget!r} W "
        f"({base.fleet.n_rows} rows x {base.fleet.n_servers} servers, "
        f"{base.duration_s / 3600:g} h) in {time.perf_counter() - t0:.2f} s")
    reset_counts()
    for kind in REBALANCE_KINDS:
        sc = get_scenario(f"fleet-rebalance-{kind}").with_(budget=budget)
        t0 = time.perf_counter()
        o = run_experiment(sc)
        run_s = time.perf_counter() - t0
        s, f = o.stats.summary(), o.fleet
        if not (np.isfinite(f.cluster_power_frac).all()
                and f.n_admitted + f.n_shed_total == f.n_offered
                and (f.n_rebalances == 0) == (kind == "static")):
            raise AssertionError(f"fleet-rebalance-{kind}: implausible fleet")
        say(f"(g) fleet-rebalance-{kind} ({sc.fleet.n_rows} x "
            f"{sc.fleet.n_servers}, {sc.duration_s / 3600:g} h): "
            f"{run_s:.2f} s; HP p99 impact {s['hp_p99']:.4f}, LP p99 impact "
            f"{s['lp_p99']:.4f}; brakes on the derated row "
            f"{f.row_results[DERATED_ROW].n_brakes} (all rows {f.n_brakes}); "
            f"rebalances {f.n_rebalances} moving "
            f"{f.budget_moved_w() / 1e3:.1f} kW; shed {f.n_shed_total} of "
            f"{f.n_offered}")
    check_no_tick_launch("the fleet-rebalance family")
    par = base.with_(duration_s=PARITY_S, budget=budget,
                     compare_to_reference=False)
    a, b = run_experiment(par), run_experiment(par.with_(controller=None))
    fa, fb = a.fleet, b.fleet
    if not (a.result.latencies == b.result.latencies
            and np.array_equal(fa.cluster_power_frac, fb.cluster_power_frac)
            and np.array_equal(fa.row_power_frac, fb.row_power_frac)
            and fa.decisions == fb.decisions and fa.n_rebalances == 0):
        raise AssertionError("static controller differs from no controller")
    say(f"(g) fleet-rebalance-static == controller=None bit for bit at "
        f"{PARITY_S:g} s ({len(fa.decisions)} decisions)")

    # (3) chaos at the benchmark's quick horizon, one explicit envelope
    chaos_budget = get_scenario(CHAOS_RUNS[0]).budget
    reset_counts()
    for name in CHAOS_RUNS:
        sc = get_scenario(name).with_(duration_s=CHAOS_S, budget=chaos_budget)
        t0 = time.perf_counter()
        o = run_experiment(sc)
        run_s = time.perf_counter() - t0
        f = o.fleet
        if not f.fault_events or f.n_admitted + f.n_shed_total != f.n_offered:
            raise AssertionError(f"{name}: no fault applied, or work lost")
        records = "; ".join(
            f"t={r.t:g} {r.kind} {r.target} {r.phase} x{r.factor:g} "
            f"({r.detail})" for r in f.fault_events)
        by_rule = {}
        for ev in f.alert_events:
            by_rule[f"{ev.name}/{ev.phase}"] = \
                by_rule.get(f"{ev.name}/{ev.phase}", 0) + 1
        say(f"(g) {name} ({sc.fleet.n_rows} rows {sc.hierarchy.shape}, "
            f"{CHAOS_S / 3600:g} h): {run_s:.2f} s; brakes {f.n_brakes}, "
            f"shed {f.n_shed_total}, rebalances {f.n_rebalances}; faults: "
            f"{records}; alerts by rule: {by_rule}")
    check_no_tick_launch("the chaos runs")

    # (4) routed members on the fork pool
    pool_spec = EnsembleSpec(
        get_scenario("fleet-rebalance-predictive").with_(
            duration_s=ROUTED_POOL_S),
        n_seeds=ROUTED_POOL_SEEDS, n_workers=ROUTED_POOL_SEEDS,
        with_reference=True)
    workers = montecarlo._default_workers(pool_spec.n_seeds,
                                          pool_spec.n_workers)
    if workers < 2:
        raise AssertionError(f"{workers} worker(s): the fork pool is not run")
    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        ens = run_ensemble(pool_spec, engine="numpy")
        pool_s = time.perf_counter() - t0
    inline = [w for w in caught if "process pool unavailable" in str(w.message)]
    if inline:
        raise AssertionError(f"the fork pool did not run: {inline[0].message}")
    k = ROUTED_ONE_WORKER_SEEDS
    t0 = time.perf_counter()
    one = run_ensemble(dataclasses.replace(pool_spec, n_seeds=k, n_workers=1),
                       budget_w=ens.budget_w, engine="numpy")
    one_s = time.perf_counter() - t0
    check_no_tick_launch("routed members on engine='numpy'")
    for name in ("brake_counts", "peak_fracs", "mean_fracs", "power_frac"):
        if not np.array_equal(getattr(ens, name)[:k], getattr(one, name)):
            raise AssertionError(f"routed members: {name} differs between "
                                 f"{workers} workers and 1")
    if [(m.result.latencies, m.stats.hp_impacts, m.stats.lp_impacts)
            for m in ens.members[:k]] != \
            [(m.result.latencies, m.stats.hp_impacts, m.stats.lp_impacts)
             for m in one.members]:
        raise AssertionError("routed members: results differ between "
                             f"{workers} workers and 1")
    say(f"(g) run_ensemble(fleet-rebalance-predictive, {pool_spec.n_seeds} "
        f"seeds, {ROUTED_POOL_S / 3600:g} h, with_reference, "
        f"engine='numpy'): {pool_s:.2f} s on {workers} fork workers = "
        f"{pool_spec.n_seeds / pool_s:.3f} members/s (calibration included); "
        f"its first {k} on 1 worker {one_s:.2f} s, bit-identical; brake_prob "
        f"{ens.brake_prob():.4f}, peak max {ens.peak_fracs.max():.4f}")

    # (5) the survivability gate on benchmarks/chaos_resilience.py's
    # chaos-plan scenario
    plan_base = Scenario(
        name="chaos-plan", duration_s=1800.0,
        fleet=FleetSpec(n_provisioned=8, added_frac=0.0, n_rows=4),
        policy=PolicySpec("polca"), traffic=TrafficSpec(occ_peak=0.62),
        routing=RoutingSpec("cap-aware", admission="shed-lp",
                            admission_params={"shed_above": 0.97}),
        controller=ControllerSpec("predictive", scope="tree"),
        hierarchy=HierarchySpec(shape=(2, 2)), budget="calibrated")
    reset_counts()
    plans = {}
    for label, cons in (("free", planner.RiskConstraints()),
                        ("survive", planner.RiskConstraints(survive=crash2))):
        t0 = time.perf_counter()
        p = planner.plan_capacity(plan_base, constraints=cons,
                                  n_seeds=SURVIVE_SEEDS, max_added_frac=0.5,
                                  engine="numpy")
        plans[label] = p
        probes = ", ".join(
            f"+{q.added_servers}:{'ok' if q.feasible else 'no'}"
            f"(brake_p={q.brake_prob:.3f}, slo_p={q.slo_violation_prob:.3f}"
            + ("" if q.fault_brake_prob is None
               else f", fault_brake_p={q.fault_brake_prob:.3f}") + ")"
            for q in p.probes)
        say(f"(g) chaos-plan {label} plan_capacity({SURVIVE_SEEDS} seeds, "
            f"{plan_base.duration_s:g} s, engine='numpy'): "
            f"safe_added_servers={p.safe_added_servers} "
            f"(+{p.safe_added_frac:.1%}) in {time.perf_counter() - t0:.2f} s; "
            f"probes {probes}")
    check_no_tick_launch("the survivability gate")
    if plans["survive"].safe_added_servers > plans["free"].safe_added_servers:
        raise AssertionError("the survivable plan exceeds the fault-free plan")
    if any(q.fault_brake_prob is None for q in plans["survive"].probes):
        raise AssertionError("a survive probe has no faulted ensemble")

    # (6) how much oversubscription rebalancing buys back
    reset_counts()
    t0 = time.perf_counter()
    cmp = planner.plan_controller_comparison(
        base.with_(duration_s=COMPARISON_S), ("static", "predictive"),
        n_seeds=COMPARISON_SEEDS, seed0=1000, max_added_frac=0.30,
        budget_w=budget)
    cmp_s = time.perf_counter() - t0
    check_no_tick_launch("plan_controller_comparison")
    say(f"(g) plan_controller_comparison(fleet-rebalance-static, "
        f"{COMPARISON_S / 3600:g} h, {COMPARISON_SEEDS} seeds, up to +30 %): "
        + ", ".join(f"{kind} safe_added_servers={p.safe_added_servers} "
                    f"(+{p.safe_added_frac:.1%}, {len(p.probes)} probes)"
                    for kind, p in cmp.items())
        + f" in {cmp_s:.2f} s")


def main() -> int:
    global CARD
    import numpy as np
    import torch

    from repro_torch.kernels import _build, tick
    from repro_torch.provisioning.batched import (
        _slo_impacts, effective_occupancy, lower_ensemble, run_tick_model,
        tick_consts)
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
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")

    # 2. build every kernel (one nvcc per source, started together)
    names = _build.sources()
    t0 = time.perf_counter()
    _build.build(names)
    print(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s")
    for name in names:
        for line in ptxas_report(name):
            print(f"  {line}")

    # 3. each kernel against its plain version, on the card
    check_tick_cases(dev)
    check_attention_cases(dev)

    sc = main_scenario()
    spec = EnsembleSpec(sc, n_seeds=MAIN_MEMBERS, seed0=1)
    t0 = time.perf_counter()
    model, _, _ = lower_ensemble(spec)
    lowering_s = time.perf_counter() - t0
    f64 = dict(dtype=torch.float64, device=dev)
    occ_ms = cuda_ms(lambda: effective_occupancy(model, dev), reps=2)
    occ = effective_occupancy(model, dev)
    if not occ.permute(1, 0, 2).is_contiguous():
        raise AssertionError("the main path's occ is not time-major")
    bscale = torch.as_tensor(model.budget_scale, **f64)
    rb = torch.as_tensor(model.row_budget_w, **f64)
    kw = dict(oob_ticks=model.oob_ticks, brake_ticks=model.brake_ticks,
              ring_depth=model.ring_depth, esc=model.escalation_ticks)
    consts = tick_consts(model)
    N, T, R = occ.shape
    tick_plan = tick.launch_plan(N, R, model.ring_depth, dev)
    if tick_plan["max_ring_depth"] != tick.MAX_RING_DEPTH:
        raise AssertionError(f"csrc/tick.cu takes rings of up to "
                             f"{tick_plan['max_ring_depth']} slots, the wrapper "
                             f"{tick.MAX_RING_DEPTH}")
    print(f"kernel tick launch plan at the main shape (N={N}, R={R}, "
          f"D={model.ring_depth}): {tick_plan['threads']} threads x "
          f"{tick_plan['lanes_per_thread']} lanes a thread, {tick_plan['blocks']} "
          f"blocks, {tick_plan['blocks_per_sm']} resident a SM x {tick_plan['sms']} "
          f"SMs, {tick_plan['waves']:.3f} waves, ring {tick_plan['ring_bytes']} B a "
          f"block (deepest ring {tick_plan['max_ring_depth']}); "
          + "; ".join(ptxas_report("tick")))
    got = tick.polca_tick_loop(occ, bscale, rb, consts, **kw)
    want = tick.polca_tick_plain(occ, bscale, rb, consts, **kw)
    torch.cuda.synchronize()
    if not all(got[k].permute(1, 0, 2).is_contiguous()
               for k in ("row_w", "fire", "f_lp", "f_hp")):
        raise AssertionError("the tick kernel's planes are not time-major")
    tick_abs = compare_tick(got, want, f"main path N={N} T={T} R={R}")
    del got, want
    kernel = lambda: tick.polca_tick_loop(occ, bscale, rb, consts, **kw)  # noqa: E731
    tick_ms = device_ms([kernel], calls=4)
    tick_call_ms = cuda_ms(kernel, reps=5)
    plain_ms = device_ms([lambda: tick.polca_tick_plain(occ, bscale, rb, consts, **kw)],
                         calls=1, replays=1)
    lane_ticks = N * T * R
    # occ and the outputs per lane-tick; bscale and row_budget (f64) and
    # n_brakes (int32) once
    tick_bytes = (lane_ticks * TICK_BYTES_PER_LANE_TICK + 8 * (T * R + R)
                  + 4 * N * R)
    bytes_ms = tick_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = lane_ticks * TICK_FLOPS_PER_LANE_TICK / H100_FP64_FLOPS * 1e3
    tick_bound_ms = max(bytes_ms, ops_ms)
    print(f"kernel tick at the main-path shape: device {tick_ms:.4f} ms, call "
          f"{tick_call_ms:.4f} ms (plain version {plain_ms:.3f} ms, device "
          f"time; bound {tick_bound_ms:.4f} ms by "
          f"{'bytes' if bytes_ms >= ops_ms else 'operations'}: "
          f"{tick_bytes / 1e9:.3f} GB)")

    # the device engine, its parts, and its statistics against the plain
    # path's (the same lowered model on the CPU)
    out = kernel()
    slo_ms = cuda_ms(lambda: _slo_impacts(model, occ, out["f_lp"], out["f_hp"]),
                     reps=1)
    imp = _slo_impacts(model, occ, out["f_lp"], out["f_hp"])
    copy_ms = cuda_ms(lambda: [t.cpu().numpy() for t in imp], reps=1)
    del out, occ, imp
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run_tick_model(model, keep_series=False, keep_brake_fire=False,
                          device=dev)
    torch.cuda.synchronize()
    engine_ms = (time.perf_counter() - t0) * 1e3
    # the plain path on the CPU over the model's first CPU_CHECK_MEMBERS
    # members (members are independent lanes)
    k = CPU_CHECK_MEMBERS
    head = dataclasses.replace(model, n_members=k, occ60=model.occ60[:k],
                               seeds=model.seeds[:k])
    t0 = time.perf_counter()
    cpu = run_tick_model(head, keep_series=False, keep_brake_fire=False,
                         device="cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(card.n_brakes[:k], cpu.n_brakes):
        raise AssertionError("main path: brake counts differ card vs CPU")
    for name in ("peak_frac", "mean_frac", "impacts_hp", "impacts_lp"):
        np.testing.assert_allclose(getattr(card, name)[:k], getattr(cpu, name),
                                   rtol=ROW_W_RTOL, atol=1e-9, err_msg=name)
    rest_ms = engine_ms - occ_ms - tick_ms - slo_ms - copy_ms
    print(f"device engine at the main shape: {engine_ms:.1f} ms (occupancy "
          f"{occ_ms:.1f} ms, tick kernel {tick_ms:.2f} ms, SLO proxy "
          f"{slo_ms:.1f} ms, copying its impact planes to the host "
          f"{copy_ms:.1f} ms, the rest {rest_ms:.1f} ms: row sums, small "
          f"copies, allocation); the plain path on the CPU over its first "
          f"{k} members ({cpu_s:.1f} s): brake counts identical "
          f"({int(cpu.n_brakes.sum())} brakes), peak/mean fractions and SLO "
          f"impacts within {ROW_W_RTOL}")
    del card, cpu

    # 3a. the torch scan engine against the CUDA engine on the same model
    torch_vs_cuda(dev, model)
    torch_engine_breakdown(dev, model)
    del model

    # 4. the planner's main path at full size: run_ensemble on a 10^5-member tail
    reset_counts()
    t0 = time.perf_counter()
    res = run_ensemble(spec, engine="cuda")
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    main_launches = counts()["polca_tick"]
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
    reset_counts()
    t0 = time.perf_counter()
    plan = plan_capacity(planner_scenario(), n_seeds=PLAN_SEEDS, seed0=42,
                         engine="cuda", constraints=cons, max_added_frac=0.4)
    plan_s = time.perf_counter() - t0
    plan_launches = counts()["polca_tick"]
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

    # 5a. the calibrated planner family (mc-*) at its registered size
    family_launches = calibrated_planner_family(dev)

    # 5b-f. the torch scan engine: the predictive tail, the grid, chunk and
    # shard invariance, faults and the hierarchy, the predictive planner
    predictive_tail(dev, sc)
    grid_vs_loop(dev, sc)
    invariance(dev, sc)
    faults_and_hierarchy(dev, sc)
    torch_planner(cons)

    # 5g. routed fleets, rebalancing and chaos (host numpy, no kernel)
    t0 = time.perf_counter()
    routed_fleets(dev)
    say(f"(g) routed fleets, rebalancing and chaos: phase total "
        f"{time.perf_counter() - t0:.2f} s on the host")

    # 6. the serving main path at full width, then the card against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    serve_launches = serve_main_path(dev)
    serve_consistency(dev)
    serve_card_vs_cpu(dev)

    # 7. the attention kernels at the serving main-path shapes
    attn = time_attention(dev)

    kernels = [{
        "name": "polca_tick",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tick.cu",
        "replaces": "src/repro/kernels/tick.py:211",
        "launches": main_launches,
        "family_launches": family_launches,
        "max_abs_err": tick_abs,
        "ms": tick_ms,
        "call_ms": tick_call_ms,
        "plain_ms": plain_ms,
        "bound_ms": tick_bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "plan": tick_plan,
    }]
    for row in attn:
        kernels.append({"name": row["name"], "route": "cuda", "source": row["source"],
                        "replaces": row["replaces"],
                        "launches": serve_launches[row["name"]],
                        **{k: row[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")},
                        **({"hd128": row["hd128"]} if "hd128" in row else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
