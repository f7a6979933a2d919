#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` and holds each kernel against its plain PyTorch version on the card
at the kernel test shapes of ``tests/test_kernels.py`` (and, for the tick
kernel, :data:`TICK_EDGE_CASES`) and at the main-path shapes; the loss
head's split kernel also at roberta-large's loss chunk, timed there beside
the chunk's products on the tensor cores and in float32. It then drives
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
  ``plan_controller_comparison``, and the static chaos run again under the
  recorder (the same counts), its artifacts written and read back and its
  incidents reconstructed;
* the serving path: ``ServeEngine`` on full-width llama3.2-1b with random
  weights, 8 requests of 1024-token prompts and 128 new tokens (the flash
  prefill and split-KV decode kernels), its prefill->decode consistency,
  and a card-vs-CPU check of the same engine on the smoke config;
* the paper's dense decoders and gemma2 (phase h): gemma2-9b whole with
  prompts past its sliding window (its ring cache), gpt-neox-20b whole (head
  dim 96) and opt-30b at 24 of its 48 layers, each through ``ServeEngine``
  with its launches by kernel variant, prefill->decode consistency and a
  card-vs-CPU check of its smoke config;
* MoE, Mamba2/SSD and hybrid decoders (phase i): mixtral-8x7b at 16 of
  its 32 layers with prompts past its sliding window, kimi-k2-1t-a32b at 1
  of its 61 layers (384 experts, top-8, a shared expert) and mamba2-370m
  whole (no attention kernel), each through ``ServeEngine`` with its
  launches by kernel variant, prefill->decode consistency (where MoE
  routing flips, with the full prefill's expert choices), one MoE or SSD block's
  time split into its steps, and the mixtral, kimi-k2, mamba2 and jamba
  smoke configs card vs CPU;
* encoders, cross-attention and the modality stubs (phase j), every
  layer: roberta-large served by its prefill alone, flan-t5-xxl over 512
  encoder positions and whisper-base over its 1500 frames (the encoder and
  the cross-attention prefill on the flash kernel without a mask, cross
  decode on the decode kernel over every encoder position), internvl2-1b
  with 256 image embeddings before the prompt (GQA 14/2), each through
  ``ServeEngine`` with its launches by kernel variant and prefill->decode
  consistency, then their smoke configs card vs CPU; the attention kernels
  are also held against their plain versions and timed at these shapes;
* training (phase k): the flash backward kernel
  (``csrc/flash_attention_bwd.cu``) against its plain version at the
  training tests' shapes and at roberta-large's and llama3.2-1b's training
  shapes, two launches bit-equal, and timed beside SDPA's backward (the
  training forward beside SDPA's forward); one
  float32 train step of every registry arch's smoke config card vs CPU; a
  bf16 train step at full width cut to 2 layers with the kernels against
  autograd of the plain attention (and failing with the backward zeroed);
  roberta-large at full width and depth, B 32 x S 2048, through the
  launcher's supervisor with a checkpoint and an injected crash replayed to
  the clean state; llama3.2-1b at B 8 x S 1024;
* the dry run (phase l, ``launch/dryrun.py``, CPU work on ``meta``
  tensors): the two training steps of phase (k) on a 1 x 1 layout, their
  predicted bytes a device beside the step's own ``max_memory_allocated``
  and the H100 roofline's bound beside the measured step and its MFU; then
  the production grid of both layouts (16 x 16 and 2 x 16 x 16) but its two
  slowest train cells, each cell traced or skipped with the shape table's
  reason (the memory from rank 0's sharded step in a fake world of the
  layout's ranks: every cell gets a verdict; the two layouts in two
  processes at once), the records in ``out/dryrun_l.jsonl``;
* the sharded step (phase m) on a 1 x 1 ``DeviceMesh`` over NCCL:
  ``decode_attention_lse`` against its plain version, llama3.2-1b's and
  roberta-large's train steps and llama3.2-1b's and kimi-k2's engines
  against the plain ones (bit-equal steps, identical tokens, gated times);
* its second half (phase n) on the same kind of mesh:
  ``decode_attention_lse`` at gemma2-9b's ring (hd 256, softcap 50) and
  mixtral-8x7b's (hd 128), each ring also cut into four slices merged by
  their log-sum-exps; the sharded engines of gemma2-9b (ring cache),
  whisper-base (encoder, cross attention) and mamba2-370m (SSD) against
  the plain ones (identical tokens and launches by kernel and variant,
  decode ms both ways); mamba2-370m's sharded train step bit-equal to the
  plain one.

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
# a tile whose every query is past its window (those rows give 0); the
# tensor-core instances at hd 96 and 256 with Sq not a multiple of 128 and
# Skv not a multiple of the 64-key tile
# (B, Sq, Skv, H, KV, hd, dtype, causal, window, softcap, q_offset)
RAGGED_FLASH_CASES = [
    (2, 200, 200, 8, 2, 64, "bfloat16", True, 0, 0.0, 0),
    (1, 77, 333, 4, 1, 128, "float32", True, 100, 0.0, 256),
    (1, 200, 200, 8, 8, 16, "float32", True, 0, 0.0, 0),
    (1, 64, 64, 4, 2, 64, "float32", True, 16, 0.0, 200),
    (2, 200, 200, 8, 8, 96, "bfloat16", True, 0, 0.0, 0),
    (1, 77, 333, 8, 4, 96, "bfloat16", True, 100, 0.0, 256),
    (1, 64, 64, 4, 2, 96, "bfloat16", True, 16, 0.0, 200),
    (1, 130, 130, 8, 8, 256, "bfloat16", False, 0, 0.0, 0),
    (2, 200, 261, 16, 2, 256, "bfloat16", True, 0, 50.0, 61),
    (1, 64, 64, 4, 2, 256, "bfloat16", True, 16, 0.0, 200),
]
# the served models' attention shapes the test shapes above lack:
# gpt-neox-20b's head dim of 96 (causal, and causal with a window; G = 1, 2,
# 4, 8), gemma2-9b's hd 256 (G = 2 with its window and softcap 50 over more
# than one key tile before the window; G = 1 and 4) and its ring decode (a
# full ring of W = 4096 slots, hd 256, softcap 50)
# (B, Sq, Skv, H, KV, hd, dtype, causal, window, softcap, q_offset)
SERVED_FLASH_CASES = [
    (2, 256, 256, 8, 8, 96, dt, True, 0, 0.0, 0) for dt in ("bfloat16", "float32")
] + [
    (1, 300, 300, 8, 4, 96, dt, True, 64, 0.0, 0) for dt in ("bfloat16", "float32")
] + [
    (1, 77, 333, 16, 2, 96, "bfloat16", True, 100, 30.0, 256),
    (1, 520, 520, 16, 8, 256, "bfloat16", True, 128, 50.0, 0),
    (1, 300, 300, 8, 8, 256, "bfloat16", True, 0, 50.0, 0),
    (2, 200, 200, 16, 4, 256, "bfloat16", True, 0, 30.0, 0),
    (1, 200, 200, 8, 8, 256, "float32", True, 128, 50.0, 0),
]
# (B, T, H, KV, hd, valid_len, softcap, dtype)
SERVED_DECODE_CASES = [
    (2, 512, 8, 8, 96, 300, 0.0, dt) for dt in ("bfloat16", "float32")
] + [
    (1, 1024, 16, 4, 96, 1000, 0.0, dt) for dt in ("bfloat16", "float32")
] + [
    (3, 256, 16, 2, 96, 77, 20.0, dt) for dt in ("bfloat16", "float32")
] + [
    (4, 4096, 16, 8, 256, 4096, 50.0, "bfloat16"),  # gemma2-9b's full ring
]
# the shapes of phase (j) the cases above lack: bidirectional flash at hd 64
# and G = 1 (an encoder: 512 positions, and whisper's ragged 1500 frames),
# cross flash with Sq != Skv and no mask (flan-t5's 64 decoder positions
# over 512 encoder ones, whisper's 32 over 1500), causal flash at
# internvl2's G = 7; decode over every slot of whisper's 1500-slot cross
# cache (valid_len = T, not a multiple of 16) at G = 1, and decode at G = 7
# (B, Sq, Skv, H, KV, hd, dtype, causal, window, softcap, q_offset)
ENCODER_FLASH_CASES = [
    (B, Sq, Skv, H, KV, 64, dt, causal, 0, 0.0, 0)
    for dt in ("bfloat16", "float32")
    for B, Sq, Skv, H, KV, causal in ((2, 512, 512, 8, 8, False),
                                      (1, 1500, 1500, 8, 8, False),
                                      (2, 64, 512, 16, 16, False),
                                      (2, 32, 1500, 8, 8, False),
                                      (2, 300, 300, 14, 2, True))]
# (B, T, H, KV, hd, valid_len, softcap, dtype)
ENCODER_DECODE_CASES = [
    (B, T, H, KV, 64, vl, 0.0, dt)
    for dt in ("bfloat16", "float32")
    for B, T, H, KV, vl in ((2, 1500, 8, 8, 1500), (3, 1536, 14, 2, 1100))]
ATTN_TOL = {"bfloat16": 3e-2, "float32": 2e-5}  # tests/test_kernels.py's
# (rows, d_model, vocab) of roberta-large's loss chunk in the benchmark's
# training cell: 41 positions x B 128 (models/model.py LOSS_CHUNK_BYTES)
LOSS_CHUNK = (41 * 128, 1024, 50265)

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


def kernel_split(fn, calls: int = 3) -> dict:
    """Device milliseconds a call of ``fn`` spends in each CUDA kernel it
    launches, by kernel name: torch.profiler's device events over ``calls``
    calls after a warm-up one, read as :func:`torch_engine_breakdown` reads
    them. Empty when the profiler saw no device event (not measured)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name).split("(")[0]
            split[name] = split.get(name, 0.0) + e.device_time / calls / 1e3
    return split


def ptxas_report(name: str) -> list:
    """One line per kernel instance of ``csrc/<name>.cu`` from its build log:
    registers and spill bytes, as ``nvcc -Xptxas -v`` reported them, then
    ptxas's performance notes (a wgmma chain it serialized, C7512) and
    warnings (a setmaxnreg it ignored)."""
    import shutil
    from repro_torch.kernels import _build
    rows, fn, spill, notes = [], None, "", []
    for line in _build.build_log(name).splitlines():
        if "Potential Performance Loss" in line or "warning" in line.lower():
            notes.append(f"ptxas {name}: {line.split(':', 1)[1].strip()}")
        elif "Compiling entry function" in line:
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
            for n, (_, regs, spill) in zip(names, rows)] + notes


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
    from repro_torch.kernels import bf16_split, decode_attention, flash_attention, rmsnorm, tick
    tick.polca_tick_loop.launches = 0
    bf16_split.split3.launches = 0
    rmsnorm.rmsnorm_fwd.launches = rmsnorm.rmsnorm_bwd.launches = 0
    wrappers = (flash_attention.flash_attention, flash_attention.flash_attention_lse,
                flash_attention.flash_attention_bwd, decode_attention.decode_attention,
                decode_attention.decode_attention_lse)
    for fn in wrappers:
        fn.launches = 0
        for variant in fn.launches_by_variant:
            fn.launches_by_variant[variant] = 0


def counts() -> dict:
    from repro_torch.kernels import decode_attention, flash_attention, tick
    return {"polca_tick": tick.polca_tick_loop.launches,
            "flash_attention": flash_attention.flash_attention.launches,
            "decode_attention": decode_attention.decode_attention.launches}


def compare_close(got, want, tol: float, label: str) -> float:
    """|got - want| <= tol + tol * |want| elementwise (assert_allclose with
    atol = rtol = tol), and also <= tol * (|want| + RMS of its row), where a
    row is the last axis (one query head's output); both finite. The second
    bound holds the gap to the output's own size: a softmax over thousands
    of keys gives outputs of RMS ~0.03, under the first bound's atol, where
    a kernel that drops a block of keys would pass it. Returns the max
    absolute gap."""
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
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    n_bad = int((gap > tol * (w.abs() + rms)).sum())
    if n_bad:
        raise AssertionError(f"{label}: {n_bad} elements beyond {tol} x (|want| "
                             f"+ its row's RMS) (max gap {float(gap.max()):.3e}, "
                             f"least row RMS {float(rms.min()):.3e})")
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
    the test shapes of tests/test_kernels.py, the ragged shapes and the
    served shapes (:data:`SERVED_FLASH_CASES`, :data:`SERVED_DECODE_CASES`,
    :data:`ENCODER_FLASH_CASES`, :data:`ENCODER_DECODE_CASES`);
    the decode test shapes in bf16 and in float32 (every instance of the
    CUDA-core decode kernel's float32 path: G = 1, 2, 4, 8 and hd 64, 96,
    128, 256)."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    flash = ([(*c[:10], c[2] - c[1]) for c in FLASH_CASES] + RAGGED_FLASH_CASES
             + SERVED_FLASH_CASES + ENCODER_FLASH_CASES)
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
              f"q_offset={q_off} ({fa.kernel_variant(q.dtype, hd)}): max abs gap {gap:.3e}")
    # a bf16 view whose head stride is not a multiple of 16 bytes: the
    # tensor-core instances raise before any launch, never reroute
    for hd in fa.TC_HEAD_DIMS:
        rows = torch.zeros((1, 64, 4, hd + 4), dtype=torch.bfloat16, device=dev)
        view = rows[..., :hd]
        before = dict(fa.flash_attention.launches_by_variant)
        try:
            fa.flash_attention(view, view, view)
        except ValueError:
            pass
        else:
            raise AssertionError(f"flash_attention took a misaligned hd-{hd} bf16 view")
        if fa.flash_attention.launches_by_variant != before:
            raise AssertionError(f"flash_attention launched on a misaligned hd-{hd} view")
    print(f"kernel flash_attention: misaligned bf16 views at hd {fa.TC_HEAD_DIMS} raise "
          f"ValueError, no launch")
    decode = ([(*c[:7], dt) for dt in ("bfloat16", "float32") for c in DECODE_CASES]
              + SERVED_DECODE_CASES + ENCODER_DECODE_CASES)
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


def check_loss_head(dev) -> dict:
    """The loss head's tensor-core path (``models/model.py::
    TensorCoreLogits``) on the card: the split kernel (``csrc/bf16_split.cu``)
    against its plain version bit for bit at small and ragged shapes in
    four layouts (a slice of wider rows, a row broadcast, a transpose, a
    column step) and at roberta-large's loss chunk (:data:`LOSS_CHUNK`), its
    pieces summing to the cotangent exactly; its device time beside its
    bound and the plain version's; the chunk's products on the tensor cores
    (the forward; the backward's split, ``dh`` and ``dw``) beside the
    float32 products they replace. The kernels row of the split."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bf16_split
    from repro_torch.models import model as model_mod

    gen = torch.Generator(device=dev).manual_seed(31)
    for rows, cols, out_cols in ((1, 1, 4), (3, 7, 8), (5, 9, 12), (64, 251, 256)):
        base = torch.randn(rows, cols + 3, device=dev, generator=gen) * 1e-3
        wide = torch.randn(cols, rows + 3, device=dev, generator=gen)
        layouts = {"row slice": base[:, :cols],  # read in place, rows cols + 3 apart
                   "row broadcast": base[:1, :cols].expand(rows, cols),  # stride (0, 1)
                   "transposed": wide[:, :rows].T,  # columns strided
                   "column step": torch.randn(rows, 2 * cols, device=dev, generator=gen)[:, ::2]}
        for name, x in layouts.items():
            if not torch.equal(bf16_split.split3(x, out_cols),
                               bf16_split.split3_plain(x.contiguous(), out_cols)):
                raise AssertionError(f"bf16_split3 {rows} x {cols} -> {out_cols} ({name}): "
                                     f"kernel != plain")
    M, D, V = LOSS_CHUNK
    Vp = -(-V // model_mod.VOCAB_PAD) * model_mod.VOCAB_PAD
    h = torch.randn(M, D, device=dev, generator=gen).bfloat16()
    w = (torch.randn(D, V, device=dev, generator=gen) / D ** 0.5).bfloat16()
    wp = F.pad(w, (0, Vp - V))
    g = torch.softmax(3 * torch.randn(M, V, device=dev, generator=gen), -1) / (M * 41)
    g[torch.arange(M, device=dev), torch.randint(0, V, (M,), device=dev, generator=gen)] -= \
        1 / (M * 41)
    pieces = bf16_split.split3(g, Vp)
    if not torch.equal(pieces, bf16_split.split3_plain(g, Vp)):
        raise AssertionError("bf16_split3 at the loss chunk: kernel != plain")
    if not torch.equal(pieces[:, :, :V].double().sum(0), g.double()):
        raise AssertionError("bf16_split3 at the loss chunk: the pieces miss the cotangent")
    del pieces
    ms = device_ms([lambda: bf16_split.split3(g, Vp)], calls=4)
    plain_ms = device_ms([lambda: bf16_split.split3_plain(g, Vp)], calls=2)
    bound, by = bound_ms(0.0, 4 * M * V + 3 * 2 * M * Vp)
    flops = 2 * M * D * V
    prod = {
        "tc_forward_ms": device_ms([lambda: model_mod.TensorCoreLogits.apply(h, w)], 4),
        "tc_backward_ms": device_ms([lambda: model_mod.cotangent_products(g, h, wp)], 2),
        "f32_forward_ms": device_ms([lambda: torch.matmul(h.float(), w.float())], 2),
        "f32_backward_ms": device_ms([lambda: (g @ w.float().T, h.float().T @ g)], 2),
        "forward_bound_ms": bound_ms(flops, 0.0)[0],
        "backward_bound_ms": bound_ms(2 * 3 * flops, 0.0)[0]}
    say(f"(loss head) bf16_split3 at M {M} x V {V} (Vp {Vp}): bit-equal to plain, exact; "
        f"{ms:.4f} ms (bound {bound:.4f}, {by}; plain {plain_ms:.4f}); products: forward "
        f"{prod['tc_forward_ms']:.4f} ms on the tensor cores (bound "
        f"{prod['forward_bound_ms']:.4f}) against {prod['f32_forward_ms']:.4f} in float32, "
        f"backward (split, dh, dw) {prod['tc_backward_ms']:.4f} (bound "
        f"{prod['backward_bound_ms']:.4f}) against {prod['f32_backward_ms']:.4f}")
    return {"name": "bf16_split3", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bf16_split.cu", "replaces": None,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "loss_chunk": list(LOSS_CHUNK), **prod}


# the norm at the cells' shapes: (label, x's shape, x's dtype, w's dtype);
# each cell's norm weights are float32 (the configurations' param dtype)
RMSNORM_SHAPES = (("roberta-large train", (128 * 512, 1024), "bfloat16", "float32"),
                  ("gpt-neox-20b prefill", (2048, 6144), "bfloat16", "float32"),
                  ("mixtral-8x7b prefill", (8192, 4096), "bfloat16", "float32"),
                  ("qwen3-8b qk-norm", (8, 1024, 32, 128), "bfloat16", "float32"))
# widths and rows of the edge cases: one thread a row (8, 24) to 512 (16384)
RMSNORM_EDGES = ((1, 8), (3, 24), (77, 64), (5, 96), (33, 128), (7, 256), (9, 1000),
                 (2, 3584), (3, 7168), (2, 8192), (1, 16384), (0, 1024))
RMSNORM_EPS = 1e-5
# the kernels against the plain chain on the card: y entry by entry (one
# bf16 unit in the last place; float32 1e-5: the row's sum is taken in
# another order); dx and dw by the norm of their gap, within REL of the
# plain chain's norm plus one unit in the last place of its largest entry
# (a single rounding that lands the other way, which alone moves a small
# case's norm by more than REL). bf16 dx reads 1.6e-5 to 1.8e-5 at the
# cells' shapes on an H100: a kernel rounding g or w to bf16 reads ~1e-3.
RMSNORM_DX_REL = {"bfloat16": 1e-4, "float32": 1e-5}
RMSNORM_DW_REL = {"bfloat16": 4e-3, "float32": 1e-4}
RMSNORM_UNIT = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -23}
# each of y, dx and dw no further from float64 than the plain chain's is,
# norm against norm: within this factor of the chain's gap (outputs in bf16
# read 1.000, float32 dw up to 1.3 where only the sum's order differs),
# plus a floor of float32 rounding
RMSNORM_F64_RATIO = {"bfloat16": 1.05, "float32": 2.0}
RMSNORM_F64_FLOOR = 2.0 ** -22


def rmsnorm_grad_gap(got, want, rel_limit) -> tuple:
    """(gap, limit): ``got``'s gap from ``want`` by norm, and its limit:
    ``rel_limit[dtype]`` of ``want``'s norm plus :data:`RMSNORM_UNIT` of its
    largest entry."""
    d = str(want.dtype).split(".")[1]
    w = want.double()
    gap = float((got.double() - w).norm())
    return gap, rel_limit[d] * float(w.norm()) + RMSNORM_UNIT[d] * float(w.abs().max())


def within_ulp(got, want) -> bool:
    """Each entry of ``got`` within one unit in the last place of
    ``want``'s entry (bf16: 2**-8 of its binade's top; float32: 1e-5
    relative)."""
    import torch
    g, w = got.double(), want.double()
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        return bool(((g - w).abs() <= torch.ldexp(torch.ones_like(w), e - 8)).all())
    return bool(((g - w).abs() <= 1e-5 * w.abs() + 1e-30).all())


def rmsnorm_counts() -> dict:
    from repro_torch.kernels import rmsnorm
    return {"rmsnorm_fwd": rmsnorm.rmsnorm_fwd.launches,
            "rmsnorm_bwd": rmsnorm.rmsnorm_bwd.launches}


def norm_counts(rec) -> dict:
    """The recorder's ``model.rmsnorm`` counts by path ("kernel", "plain")."""
    from repro_torch.models.layers import RMSNORM
    return {dict(labels)["path"]: int(v) for (name, labels), v in rec.counters.items()
            if name == RMSNORM}


def prefill_norms(eng, batch) -> tuple:
    """:func:`norm_counts` of one ``eng.prefill`` of ``batch`` under a
    recorder, and the norm kernels' launches in it (:func:`rmsnorm_counts`)."""
    from repro_torch.obs import metrics as obs_metrics
    reset_counts()
    with obs_metrics.recording(obs_metrics.MetricsRecorder()) as rec:
        eng.prefill(eng.params, batch)
    return norm_counts(rec), rmsnorm_counts()


def check_rmsnorm(dev) -> dict:
    """The fused RMSNorm (``csrc/rmsnorm.cu``) against the plain chain
    (autograd of ``kernels/rmsnorm.py::rmsnorm_plain``) on the card, at
    :data:`RMSNORM_EDGES` in every dtype pair and at :data:`RMSNORM_SHAPES`:
    ``y`` within one unit in the last place (:func:`within_ulp`), ``dx``
    and ``dw`` within :data:`RMSNORM_DX_REL` and :data:`RMSNORM_DW_REL` of
    their norms (:func:`rmsnorm_grad_gap`), two backward runs bit-equal, and
    each of ``y``, ``dx`` and ``dw`` no further from float64 than the
    chain's (:data:`RMSNORM_F64_RATIO`);
    then each shape's forward (``y`` alone, as serving runs it), forward
    with ``r`` saved and backward timed against its bytes at 3.35 TB/s and
    the plain chain's, and PyTorch's ``F.rms_norm`` beside them. The
    kernels row of the norm (the roberta shape's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rms

    gen = torch.Generator(device=dev).manual_seed(33)

    def draw(shape, xd, wd):
        x = (torch.randn(shape, device=dev, generator=gen) * 2).to(getattr(torch, xd))
        w = (1 + 0.3 * torch.randn(shape[-1], device=dev, generator=gen)).to(getattr(torch, wd))
        dy = torch.randn(shape, device=dev, generator=gen).to(x.dtype)
        return x, w, dy

    def plain_grads(x, w, dy):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = rms.rmsnorm_plain(xg, wg, RMSNORM_EPS)
        return (y.detach(), *torch.autograd.grad(y, (xg, wg), dy))

    def f64_grads(x, w, dy):
        xg, wg = x.double().requires_grad_(), w.double().requires_grad_()
        y = xg * torch.rsqrt((xg * xg).mean(-1, keepdim=True) + RMSNORM_EPS) * wg
        return (y.detach(), *torch.autograd.grad(y, (xg, wg), dy.double()))

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))

    def check(label, x, w, dy) -> dict:
        xd, wd = str(x.dtype).split(".")[1], str(w.dtype).split(".")[1]
        y, r = rms.rmsnorm_fwd(x, w, RMSNORM_EPS, save=True)
        y_serve, none = rms.rmsnorm_fwd(x, w, RMSNORM_EPS)
        dx, dw = rms.rmsnorm_bwd(x, dy, r, w)
        dx2, dw2 = rms.rmsnorm_bwd(x, dy, r, w)
        yp, dxp, dwp = plain_grads(x, w, dy)
        torch.cuda.synchronize()
        if none is not None or not torch.equal(y, y_serve):
            raise AssertionError(f"(rmsnorm) {label}: y differs with and without r saved")
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise AssertionError(f"(rmsnorm) {label}: two backward runs differ")
        if x.numel() == 0:
            return {}
        if not within_ulp(y, yp):
            raise AssertionError(f"(rmsnorm) {label}: y beyond one unit in the last place of "
                                 f"the plain chain's (max gap "
                                 f"{float((y.float() - yp.float()).abs().max()):.3e})")
        e = {"dx_rel": rel(dx, dxp), "dw_rel": rel(dw, dwp)}
        for name, got, want, lim in (("dx", dx, dxp, RMSNORM_DX_REL),
                                     ("dw", dw, dwp, RMSNORM_DW_REL)):
            gap, limit = rmsnorm_grad_gap(got, want, lim)
            if not gap <= limit:
                raise AssertionError(f"(rmsnorm) {label}: {name} {gap:.3e} from the plain "
                                     f"chain's by norm, limit {limit:.3e} ({e[name + '_rel']:.3e} "
                                     f"of its norm)")
        y64, dx64, dw64 = f64_grads(x, w, dy)
        e.update(y_rel_f64=rel(y, y64), plain_y_rel_f64=rel(yp, y64),
                 dx_rel_f64=rel(dx, dx64), plain_dx_rel_f64=rel(dxp, dx64),
                 dw_rel_f64=rel(dw, dw64), plain_dw_rel_f64=rel(dwp, dw64),
                 y_max_abs_err=float((y.float() - yp.float()).abs().max()))
        for name, d in (("y", xd), ("dx", xd), ("dw", wd)):
            own, chain = e[name + "_rel_f64"], e[f"plain_{name}_rel_f64"]
            if not own <= RMSNORM_F64_RATIO[d] * chain + RMSNORM_F64_FLOOR:
                raise AssertionError(f"(rmsnorm) {label}: {name} {own:.3e} of its norm from "
                                     f"float64, the plain chain's {chain:.3e}")
        return e

    for rows, cols in RMSNORM_EDGES:
        for xd in ("bfloat16", "float32"):
            for wd in ("bfloat16", "float32"):
                check(f"{rows} x {cols} x {xd} w {wd}", *draw((rows, cols), xd, wd))
    # a row-sliced x (read through a copy), a weight at an odd offset
    x, w, dy = draw((64, 1032), "bfloat16", "float32")
    check("a column slice", x[:, 1:1025], w[1:1025], dy[:, 1:1025].contiguous())
    say(f"(rmsnorm) {len(RMSNORM_EDGES) * 4 + 1} edge cases (rows of 8 to 16384, every "
        f"dtype pair, an empty input, x and w sliced off 16 bytes): y within one unit in the "
        f"last place of the plain chain's, dx and dw within {RMSNORM_DX_REL} / "
        f"{RMSNORM_DW_REL} of their norms (plus one unit of the largest entry), each no "
        f"further from float64 than {RMSNORM_F64_RATIO} x the chain's (+ "
        f"{RMSNORM_F64_FLOOR:.1e}), backward bit-equal run to run")

    rows_out = {}
    for label, shape, xd, wd in RMSNORM_SHAPES:
        x, w, dy = draw(shape, xd, wd)
        e = check(label, x, w, dy)
        n, D = x.numel(), shape[-1]
        rows = n // D
        sx, sw = x.element_size(), w.element_size()
        fwd_bytes = 2 * n * sx + D * sw
        fwd_saved_bytes = fwd_bytes + 4 * rows
        bwd_bytes = 3 * n * sx + 4 * rows + 2 * D * sw
        _, r = rms.rmsnorm_fwd(x, w, RMSNORM_EPS, save=True)
        t = {"fwd_ms": device_ms([lambda: rms.rmsnorm_fwd(x, w, RMSNORM_EPS)], calls=8),
             "fwd_saved_ms": device_ms([lambda: rms.rmsnorm_fwd(x, w, RMSNORM_EPS,
                                                                save=True)], calls=8),
             "bwd_ms": device_ms([lambda: rms.rmsnorm_bwd(x, dy, r, w)], calls=8),
             "plain_fwd_ms": device_ms([lambda: rms.rmsnorm_plain(x, w, RMSNORM_EPS)],
                                       calls=4)}
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()

        def plain_step():
            y = rms.rmsnorm_plain(xg, wg, RMSNORM_EPS)
            return torch.autograd.grad(y, (xg, wg), dy)

        def kernel_step():
            y = rms.RMSNorm.apply(xg, wg, RMSNORM_EPS)
            return torch.autograd.grad(y, (xg, wg), dy)

        t["plain_fwd_bwd_ms"] = cuda_ms(plain_step, reps=10)
        t["fwd_bwd_ms"] = cuda_ms(kernel_step, reps=10)
        t["fwd_bound_ms"] = bound_ms(0.0, fwd_bytes)[0]
        t["fwd_saved_bound_ms"] = bound_ms(0.0, fwd_saved_bytes)[0]
        t["bwd_bound_ms"] = bound_ms(0.0, bwd_bytes)[0]
        try:
            wl = w.to(x.dtype)
            t["library_ms"] = device_ms([lambda: F.rms_norm(x, (D,), wl, RMSNORM_EPS)],
                                        calls=4)
        except (RuntimeError, AttributeError, TypeError) as err:
            t["library_ms"], t["library_error"] = None, str(err).splitlines()[0]
        rows_out[label] = {"shape": list(shape), "x_dtype": xd, "w_dtype": wd,
                           "parts": rms._parts(rms._DTYPES[x.dtype], rms._DTYPES[w.dtype],
                                               rows, D, dev.index), **e, **t}
        lib = ("not timed: " + t["library_error"] if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        say(f"(rmsnorm) {label} {list(shape)} x {xd}, w {wd}: forward {t['fwd_ms']:.4f} ms "
            f"(bound {t['fwd_bound_ms']:.4f}; with r saved {t['fwd_saved_ms']:.4f}, bound "
            f"{t['fwd_saved_bound_ms']:.4f}; plain chain {t['plain_fwd_ms']:.4f}), backward "
            f"{t['bwd_ms']:.4f} ms (bound {t['bwd_bound_ms']:.4f}, "
            f"{rows_out[label]['parts']} partial rows of dw); forward and backward through "
            f"autograd, host included: {t['fwd_bwd_ms']:.4f} ms against the plain chain's "
            f"{t['plain_fwd_bwd_ms']:.4f}; F.rms_norm (bf16 weights) {lib}; y max gap "
            f"{e['y_max_abs_err']:.3e}, dx / dw {e['dx_rel']:.3e} / {e['dw_rel']:.3e} of their "
            f"norms from the plain chain's; from float64: y {e['y_rel_f64']:.3e} (plain "
            f"{e['plain_y_rel_f64']:.3e}), dx {e['dx_rel_f64']:.3e} "
            f"({e['plain_dx_rel_f64']:.3e}), dw {e['dw_rel_f64']:.3e} "
            f"({e['plain_dw_rel_f64']:.3e})")
        del x, w, dy, r, xg, wg
        torch.cuda.empty_cache()
    main = rows_out["roberta-large train"]
    return {"name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": None, "max_abs_err": main["y_max_abs_err"], "ms": main["fwd_saved_ms"],
            "plain_ms": main["plain_fwd_ms"], "bound_ms": main["fwd_saved_bound_ms"],
            "bound_by": "bytes", "library_ms": main["library_ms"], "shapes": rows_out}


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


def split_path(eng, toks, extra=None):
    """The logits of a prefill of the prompt ``toks`` minus its last token
    (with the model's other inputs ``extra``), then one decode step of that
    token at its position (after a vision stub's image)."""
    extra = extra or {}
    _, cache = eng.prefill(eng.params, {"tokens": toks[:, :-1], **extra})
    pos = toks.shape[1] - 1 + prefix_len(extra)
    logits, _ = eng.decode(eng.params, toks[:, -1:], pos, cache)
    return logits


def prefill_decode_gap(eng, toks, logits_full) -> float:
    """:func:`split_path` against the full prefill's last logits
    (rel_gap)."""
    import torch
    logits_dec = split_path(eng, toks)
    a, b = logits_full[:, -1], logits_dec[:, -1]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite logits")
    return rel_gap(a, b)


def condition_attention(cfg, params) -> None:
    """Rescale the attention weights in place (the decoder's self and cross
    attention, the encoder's self attention) from the JAX package's init,
    whose fan-in is the second-to-last dim (the head count for ``wq [D, H,
    hd]``, the head dim for ``wo [H, hd, D]``), to a fan-in over each
    product's contraction dims (D for wq/wk/wv, H * hd for wo)."""
    D, H, KV = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads
    blocks = list(params["decoder"].values()) + (
        [params["encoder"]] if "encoder" in params else [])
    for a in (blk[k] for blk in blocks for k in ("attn", "cross") if k in blk):
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


def serve_card_vs_cpu(dev, arch: str = SERVE_ARCH) -> None:
    """``arch``'s smoke config served in float32 on the card (the kernels)
    and on the CPU (their plain versions) with the same weights: logits
    within 1e-4 relative and the same greedy tokens. The 40-token prompt is
    longer than gemma2's smoke window of 16, so its ring placement and ring
    decode run; an encoder-decoder model takes :data:`SMOKE_ENCODER_LEN`
    encoder positions, a vision stub its image embeddings."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import ServeEngine

    cfg = smoke_config(arch).replace(dtype=torch.float32)
    gpu = ServeEngine(cfg, 64, 2, device="cuda", seed=3)
    cpu = ServeEngine(cfg, 64, 2, device="cpu", seed=3)

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()

    cpu.params = to_cpu(gpu.params)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    extra = extra_inputs(cfg, 2, SMOKE_ENCODER_LEN, np.random.default_rng(2), dev)
    extra_cpu = to_cpu(extra)
    lg, _ = gpu.prefill(gpu.params, {"tokens": torch.as_tensor(tokens, device=dev), **extra})
    lc, _ = cpu.prefill(cpu.params, {"tokens": torch.as_tensor(tokens), **extra_cpu})
    rel = rel_gap(lc, lg.cpu())
    if not rel < 1e-4:
        raise AssertionError(f"smoke prefill logits card vs CPU rel {rel:.3e}")
    a, b = gpu.generate(tokens, 8, extra), cpu.generate(tokens, 8, extra_cpu)
    if not np.array_equal(a, b):
        raise AssertionError(f"smoke greedy tokens differ card vs CPU: {a} {b}")
    print(f"serving {cfg.name} float32 card vs CPU: prefill logits rel gap "
          f"{rel:.3e}, 8 greedy tokens identical")


# (h) the paper's dense decoders and gemma2 at full width, random weights
# from seed 0 in bf16: (arch, layers served (None: all), requests, prompt
# tokens, new tokens, the variant each attention kernel must run: every
# prefill on the tensor-core flash kernel; decode on the CUDA cores at hd 96
# and 256). gemma2's prompt is longer than its 4096-token window, so the
# windowed flash mask bites, the ring placement has S - W = 64 and decode
# wraps the ring. opt-30b is cut to 24 of its 48 layers: its 60 GB of bf16
# weights and the float32 draw of its largest stacked leaf ([48, 7168,
# 28672], 39 GB) exceed the card's 80 GB.
PAPER_SERVE = [
    ("gemma2-9b", None, 4, 4160, 64, {"flash": "tensor_core", "decode": "cuda_core"}),
    ("gpt-neox-20b", None, 8, 1024, 32, {"flash": "tensor_core", "decode": "cuda_core"}),
    ("opt-30b", 24, 8, 1024, 32, {"flash": "tensor_core", "decode": "tensor_core"}),
]


# (i) MoE, Mamba2/SSD and hybrid decoders at full width, random weights from
# seed 0 in bf16: (arch, layers served (None: all), requests, prompt tokens,
# new tokens, the variant each attention kernel must run, None for an
# attention-free model). Widths are published; depth is cut only as far as
# one card forces. mixtral-8x7b: 16 of 32 layers (2.90 GB of bf16 weights a
# layer; the float32 draw of its last stacked expert leaf, [16, 8, 4096,
# 14336] = 30 GB, beside the rest brings init to ~77 GB); every layer has a
# 4096 window, so the 4160-token prompt passes it (windowed flash mask, ring
# placement, ring decode). kimi-k2-1t-a32b: 1 of 61 layers (384 experts
# top-8 and a shared expert: 33.8 GB of experts, 4.7 GB of embeddings).
# mamba2-370m whole: no attention kernel, the SSD in plain PyTorch.
# jamba-1.5-large-398b (one pattern group is ~90 GB of bf16) runs its smoke
# config card vs CPU only.
MOE_SSM_SERVE = [
    ("mixtral-8x7b", 16, 4, 4160, 64, {"flash": "tensor_core", "decode": "tensor_core"}),
    ("kimi-k2-1t-a32b", 1, 8, 1024, 32, {"flash": "tensor_core", "decode": "tensor_core"}),
    ("mamba2-370m", None, 8, 1024, 128, None),
]
# a prefill's model.rmsnorm counts where a cell runs the same model and
# depth: 2 a block and the final norm, all on the kernel
CELL_NORMS = {"gpt-neox-20b": 2 * 44 + 1, "mixtral-8x7b": 2 * 16 + 1}
MOE_SSM_SMOKE = ("mixtral-8x7b", "kimi-k2-1t-a32b", "mamba2-370m", "jamba-1.5-large-398b")
# (j) the encoder-only, encoder-decoder and vision-stub models at full
# width, every layer, random weights from seed 0 in bf16: (arch, layers
# served (None: all), requests, prompt tokens, new tokens, the variant each
# attention kernel must run). roberta-large is served by its prefill alone
# (0 new tokens; causal, as the JAX prefill_fn runs it); flan-t5-xxl and
# whisper-base attend ENCODER_LEN encoder positions (whisper's
# max_encoder_len of 1500 frames) in their encoder and cross-attention;
# internvl2-1b puts its 256 image embeddings before the prompt (GQA 14/2: G
# = 7). flan-t5-xxl is ~11.1 B parameters, 22.3 GB of bf16; its largest
# stacked leaf ([24, 4096, 10240]) draws 4.0 GB in float32.
TENSOR_CORES = {"flash": "tensor_core", "decode": "tensor_core"}
ENCODER_SERVE = [
    ("roberta-large", None, 8, 512, 0, TENSOR_CORES),
    ("flan-t5-xxl", None, 8, 64, 64, TENSOR_CORES),
    ("whisper-base", None, 8, 32, 128, TENSOR_CORES),
    ("internvl2-1b", None, 8, 768, 128, TENSOR_CORES),
]
ENCODER_LEN = {"flan-t5-xxl": 512, "whisper-base": 1500}
SMOKE_ENCODER_LEN = 24  # encoder positions of the smoke configs card vs CPU
# where bf16 routing flips between the full prefill and the split path,
# prefill->decode consistency is also gated in float32, at the published
# widths and the depth and batch that fit the card in float32: (layers,
# requests, prompt tokens). mixtral: 8 layers (47.4 GB), 2 prompts past
# its window; kimi-k2: its 1 layer is 77.8 GB in float32, so 2 x 256.
FLOAT32_CHECK = {"mixtral-8x7b": (8, 2, 4160), "kimi-k2-1t-a32b": (1, 2, 256)}
# the largest probability margin a bf16 routing flip may cross: in bf16 an
# MoE block's input differs between two computation orders by up to ~4% of
# its largest entry (jamba's smoke model against JAX's), which moves a
# float32 probability by up to ~1%; a rule that picked other experts would
# cross margins of 0.1 and more (tests/test_torch_serve.py holds the port's
# bf16 routing to JAX's by this bound)
NEAR_TIE = 0.02


@contextlib.contextmanager
def moe_routing(forced=None):
    """Record the top-k experts every MoE block of the port picks, in call
    order, with its float32 probabilities ((topi, probs) a call). With
    ``forced`` (one [T, k] choice a call) each block takes those experts
    instead, weighted by its own probabilities of them, renormalised."""
    import torch
    from repro_torch.models import moe
    real, own = moe.route, []

    def route(cfg, router, x_flat):
        topw, topi = real(cfg, router, x_flat)
        probs = torch.softmax(x_flat.float() @ router.float(), dim=-1)
        own.append((topi, probs))
        if forced is not None:
            topi = forced[len(own) - 1]
            topw = probs.gather(-1, topi)
            topw = topw / topw.sum(dim=-1, keepdim=True)
        return topw, topi

    moe.route = route
    try:
        yield own
    finally:
        moe.route = real


def routing_flips(own, forced) -> tuple:
    """(choices of ``own`` not in ``forced``, the largest probability
    margin among them: own choice's probability minus the forced one's)."""
    import torch
    n_diff, margin = 0, 0.0
    for (topi, probs), want in zip(own, forced, strict=True):
        mine = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, topi, True)
        theirs = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, want, True)
        rows = (mine != theirs).any(-1)
        n_diff += int((mine & ~theirs).sum())
        if rows.any():
            gap = (torch.where(mine & ~theirs, probs, 0.0).max(-1).values
                   - torch.where(theirs & ~mine, probs, 1.0).min(-1).values)
            margin = max(margin, float(gap[rows].max()))
    return n_diff, margin


def extra_inputs(cfg, B: int, enc_len: int, rng, dev) -> dict:
    """The model's inputs beside its tokens, seeded standard normals in
    bf16 on ``dev`` (the JAX launcher's draw): ``enc_embeds`` [B, enc_len,
    D] of an encoder-decoder model, ``image_embeds`` [B, Ni, D] of a vision
    stub; else none (nothing drawn)."""
    import torch
    if cfg.is_encoder_decoder:
        shape = (B, enc_len, cfg.d_model)
    elif cfg.frontend == "vision_stub":
        shape = (B, cfg.num_image_embeds, cfg.d_model)
    else:
        return {}
    name = "enc_embeds" if cfg.is_encoder_decoder else "image_embeds"
    return {name: torch.as_tensor(rng.standard_normal(shape, dtype="float32"),
                                  device=dev).to(torch.bfloat16)}


def prefix_len(extra) -> int:
    """Decoder positions before the prompt: the image embeddings, if any."""
    return extra["image_embeds"].shape[1] if "image_embeds" in extra else 0


def routed_gap(eng, toks, extra=None) -> tuple:
    """Prefill->decode consistency through MoE blocks: the full prefill of
    ``toks`` (its routing recorded) against a prefill of all but the last
    token plus one decode step of it (:func:`split_path`; ``extra`` the
    model's other inputs). Where the split path's own expert choices
    differ from the full prefill's (a discrete top-k flips at near ties,
    and a flip moves a token by a whole expert's share), the split path
    runs again taking
    the full prefill's choices (:func:`moe_routing`). Returns (the gap
    gated: the split path's own when no choice differs, else the one with
    the full prefill's choices; the split path's own gap; its choices that
    differ; those of the run with the full prefill's choices, and their
    largest probability margin). Without MoE blocks the first two are
    :func:`prefill_decode_gap`'s and the rest 0."""
    import torch
    B, S = toks.shape
    extra = extra or {}
    with moe_routing() as full_routing:
        full, _ = eng.prefill(eng.params, {"tokens": toks, **extra})
    choices = [topi.view(B, S, -1) for topi, _ in full_routing]
    forced = ([c[:, :-1].reshape(B * (S - 1), -1) for c in choices]
              + [c[:, -1] for c in choices])

    def split(take=None):
        with moe_routing(take) as routing:
            dec = split_path(eng, toks, extra)
        a, b = full[:, -1], dec[:, -1]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits")
        return rel_gap(a, b), routing_flips(routing, forced)

    rel_own, (flips_own, _) = split()
    if not flips_own:
        return rel_own, rel_own, 0, 0, 0.0
    rel, (flips, margin) = split(forced)
    return rel, rel_own, flips_own, flips, margin


def wall_ms(fn, reps: int = 3):
    """(last result, mean milliseconds of ``fn()`` on the host's clock,
    synchronized before and after): for steps that read to the host."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps * 1e3


def moe_block_split(eng, cfg, T: int, rng, dev) -> dict:
    """One MoE block (layer 0's experts) on T random bf16 rows of unit RMS,
    timed step by step: routing, sort/dispatch (with the group-size read to
    the host), the row gather, the per-expert GEMMs, the combine, and the
    whole ``moe_apply``; the GEMMs against their bound (the FLOPs of the
    routed rows at the bf16 peak, the weights of the experts that got rows
    at the HBM rate)."""
    from repro_torch.models import moe
    blk = next(b for b in eng.params["decoder"].values() if "moe" in b)
    p = {k: v[0] for k, v in blk["moe"].items()}
    x = randn(rng, (T, cfg.d_model), "bfloat16", dev)
    (topw, topi), route_ms = wall_ms(lambda: moe.route(cfg, p["router"], x))
    (sel, sizes), dispatch_ms = wall_ms(lambda: moe.dispatch(cfg, topi))
    xs, gather_ms = wall_ms(lambda: x[sel // cfg.moe_top_k])
    rows, gemm_ms = wall_ms(lambda: moe.expert_ffn(cfg, p, xs, sizes))
    _, combine_ms = wall_ms(lambda: moe.combine(rows, sel, topw, topi))
    _, whole_ms = wall_ms(lambda: moe.moe_apply(cfg, p, x[None]))
    D, F_ = cfg.d_model, cfg.moe_d_ff
    flops = 2 * 3 * len(sel) * D * F_
    nbytes = 3 * D * F_ * 2 * sum(1 for n in sizes if n)
    gemm_bound, by = bound_ms(flops, nbytes)
    return dict(T=T, rows=len(sel), experts_used=sum(1 for n in sizes if n),
                route_ms=route_ms, dispatch_ms=dispatch_ms, gather_ms=gather_ms,
                gemm_ms=gemm_ms, combine_ms=combine_ms, whole_ms=whole_ms,
                gemm_bound_ms=gemm_bound, gemm_bound_by=by)


def ssd_block_split(eng, cfg, B: int, S: int, rng, dev) -> dict:
    """One Mamba2 block (layer 0) on random bf16 inputs of unit RMS: its
    prefill over [B, S] split into the projections, the three causal
    convolutions, the chunked SSD (:func:`~repro_torch.models.ssm.
    ssd_chunked`) and the gate/norm/out projection, and the whole
    ``ssm_forward``; its decode step of B tokens split into the
    projections, the convolutions and the rest (recurrence and gate/out)."""
    import torch
    from repro_torch.models import ssm
    blk = next(b for b in eng.params["decoder"].values() if "ssm" in b)
    p = {k: v[0] for k, v in blk["ssm"].items()}
    d_in, H, G, N = ssm.ssm_dims(cfg)
    P, Q = cfg.ssm_headdim, min(cfg.ssm_chunk, S)
    if S % Q:
        raise AssertionError(f"the split takes S a multiple of the chunk, not {S}")
    x = randn(rng, (B, S, cfg.d_model), "bfloat16", dev)
    (z, xin, Bm, Cm, dt), proj_ms = wall_ms(lambda: ssm._project(cfg, p, x))
    (xin, Bm, Cm, tails), conv_ms = wall_ms(lambda: ssm._conv_all(cfg, p, xin, Bm, Cm, None))
    A = -torch.exp(p["A_log"].float())
    (Y, state), ssd_ms = wall_ms(lambda: ssm.ssd_chunked(
        xin.reshape(B, S, H, P), dt, A, Bm.reshape(B, S, G, N).float(),
        Cm.reshape(B, S, G, N).float(), p["D_skip"], Q))
    y = Y.reshape(B, S, d_in).to(cfg.activation_dtype)
    _, gate_ms = wall_ms(lambda: ssm._gate_out(cfg, p, y, z))
    _, whole_ms = wall_ms(lambda: ssm.ssm_forward(cfg, p, x))
    x1 = x[:, -1:]
    _, dproj_ms = wall_ms(lambda: ssm._project(cfg, p, x1), reps=10)
    z1, xi1, B1, C1, _ = ssm._project(cfg, p, x1)
    _, dconv_ms = wall_ms(lambda: ssm._conv_all(cfg, p, xi1, B1, C1, tails), reps=10)
    _, dwhole_ms = wall_ms(lambda: ssm.ssm_decode(cfg, p, x1, state, tails), reps=10)
    return dict(B=B, S=S, proj_ms=proj_ms, conv_ms=conv_ms, ssd_ms=ssd_ms,
                gate_ms=gate_ms, whole_ms=whole_ms, decode_proj_ms=dproj_ms,
                decode_conv_ms=dconv_ms, decode_ms=dwhole_ms)


def float32_consistency(arch: str, dev) -> float:
    """Prefill->decode consistency of ``arch`` in float32 at the shape
    :data:`FLOAT32_CHECK` gives (published widths, attention weights at
    contraction fan-in), gated at :data:`SERVE_REL_TOL` on the split path's
    own routing; should a choice flip even in float32, the split path with
    the full prefill's choices is gated and every flip must be a near tie.
    Returns the gap gated. Its prompts come from a generator of their own
    (seed 1), so that the served models' prompts do not depend on it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeEngine

    layers, B, S = FLOAT32_CHECK[arch]
    cfg = get_config(arch).replace(num_layers=layers, dtype=torch.float32)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, S + 1, B, device="cuda")
    condition_attention(cfg, eng.params)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)),
                           device=dev)
    rel, rel_own, flips_own, flips, margin = routed_gap(eng, toks)
    if not rel < SERVE_REL_TOL:
        raise AssertionError(f"{arch} float32: prefill->decode mismatch rel={rel:.3e}")
    if not margin < NEAR_TIE:
        raise AssertionError(f"{arch} float32: a routing choice differs by a margin "
                             f"{margin:.3e} >= {NEAR_TIE}")
    weights_gb = torch.cuda.memory_allocated() / 1e9
    say(f"(i) {arch} float32 ({layers} layers, {B} x {S}-token prompts, weights "
        f"{weights_gb:.2f} GB, attention weights at contraction fan-in): "
        f"prefill->decode rel gap {rel:.3e} < {SERVE_REL_TOL}; the split path's own "
        f"routing differed from the full prefill's in {flips_own} expert choices"
        + ("" if not flips_own else f" (own gap {rel_own:.3e}; {flips} flips with "
           f"the full prefill's choices, margin {margin:.3e})")
        + f"; {time.perf_counter() - t0:.2f} s")
    del eng, toks
    torch.cuda.empty_cache()
    return rel


def serve_full_width(dev) -> dict:
    """(h), (i) and (j): ServeEngine on each :data:`PAPER_SERVE`,
    :data:`MOE_SSM_SERVE` and :data:`ENCODER_SERVE` model at full width:
    init time, weights and init peak memory; one ``generate`` with its
    launches by kernel and variant (attention models: every flash and
    decode launch on the expected variant, the encoder's and the
    cross-attention's counted; mamba2: none) and its prompt and output
    tokens/s; prefill->decode
    consistency with the attention weights at contraction fan-in (the JAX
    init's gap printed, not gated; :func:`serve_consistency`) by
    :func:`routed_gap` (where the split path's own expert choices differ
    from the full prefill's, the gap gated is the split path's with the
    full prefill's choices, each choice it would have made otherwise must
    be a near tie, and the float32 run of :func:`float32_consistency` is
    gated too); prefill s, the median of three prefills, and decode ms a
    step, generate's decode loop timed alone from the last prefill's cache;
    one MoE block's or SSD block's time split; and every served config's
    smoke config (jamba's too) card vs CPU in float32. Returns the
    launches of each arch's ``generate`` by kernel and variant."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models.config import MAMBA

    # each phase draws its prompts and block inputs from a generator of its
    # own (seed 0), in its models' order
    rngs = {p: np.random.default_rng(0) for p in ("(h)", "(i)", "(j)")}
    served = {}
    for entry in PAPER_SERVE + MOE_SSM_SERVE + ENCODER_SERVE:
        arch, layers, B, S, n_out, variants = entry
        phase = ("(h)" if entry in PAPER_SERVE else "(i)" if entry in MOE_SSM_SERVE
                 else "(j)")
        rng = rngs[phase]
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        enc_len = ENCODER_LEN.get(arch, 0)
        n_pre = cfg.num_image_embeds if cfg.frontend == "vision_stub" else 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # the shape's sequence: encoder positions, image, prompt, new tokens
        eng = ServeEngine(cfg, enc_len + n_pre + S + n_out, B, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gb = torch.cuda.memory_allocated() / 1e9
        init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        extra = extra_inputs(cfg, B, enc_len, rng, dev)
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        toks = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        batch = {"tokens": toks, **extra}
        t0 = time.perf_counter()
        full, cache = eng.prefill(eng.params, batch)  # first call
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        del cache, full
        reset_counts()
        t0 = time.perf_counter()
        out = eng.generate(tokens, n_out, extra)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = counts()
        by_variant = {"flash": dict(fa.flash_attention.launches_by_variant),
                      "decode": dict(dec.decode_attention.launches_by_variant)}
        # a flash launch per encoder layer, per decoder attention block and
        # per cross-attention block; a decode launch per decoder attention
        # and cross-attention block and new token
        n_attn = 0 if variants is None else cfg.num_layers
        n_attn += n_attn if cfg.is_encoder_decoder else 0
        want = {"polca_tick": 0, "flash_attention": cfg.num_encoder_layers + n_attn,
                "decode_attention": n_attn * n_out}
        if not (launches == want and (variants is None or all(
                by_variant[kind][v] == launches[f"{kind}_attention"]
                for kind, v in variants.items()))):
            raise AssertionError(f"{arch}: generate launched {launches}, by variant "
                                 f"{by_variant}; want {want} on {variants}")
        if out.shape != (B, n_out) or not ((out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"{arch}: bad generated tokens {out.shape}")
        rel_init, _, flips_init, _, _ = routed_gap(eng, toks, extra)
        condition_attention(cfg, eng.params)
        prefill_runs = []
        for _ in range(3):
            full = cache = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full, cache = eng.prefill(eng.params, batch)
            torch.cuda.synchronize()
            prefill_runs.append(time.perf_counter() - t0)
        prefill_s = sorted(prefill_runs)[1]
        # generate's decode loop, timed alone (none for the prefill alone)
        tok, logits = full[:, -1].argmax(dim=-1, keepdim=True), None
        t0 = time.perf_counter()
        for i in range(n_out):
            logits, cache = eng.decode(eng.params, tok, n_pre + S + i, cache)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / n_out * 1e3 if n_out else None
        del cache, full, tok, logits
        (norms, norm_launches), want_norms = prefill_norms(eng, batch), CELL_NORMS.get(arch)
        if (norms.get("plain") or not norms.get("kernel")
                or want_norms not in (None, norms["kernel"])
                or norm_launches != {"rmsnorm_fwd": norms["kernel"], "rmsnorm_bwd": 0}):
            raise AssertionError(f"{arch}: a prefill's norms took the paths {norms} and "
                                 f"launched {norm_launches}; want every one on the forward "
                                 f"kernel ({want_norms or 'any number'})")
        rel, rel_own, flips_own, flips, margin = routed_gap(eng, toks, extra)
        if not rel < SERVE_REL_TOL:
            raise AssertionError(f"{arch}: prefill->decode mismatch rel={rel:.3e}")
        if not margin < NEAR_TIE:
            raise AssertionError(f"{arch}: a routing choice of the split path differs "
                                 f"from the full prefill's by a margin {margin:.3e} "
                                 f">= {NEAR_TIE}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        served[arch] = {"layers": cfg.num_layers, "encoder_layers": cfg.num_encoder_layers,
                        **launches, "by_variant": by_variant, "norms": norms,
                        "norm_launches": norm_launches}
        routing = ("" if not cfg.moe_num_experts else
                   f"; the split path's own routing differed from the full "
                   f"prefill's in {flips_own} expert choices ({flips_init} with the "
                   f"JAX init)" + (
                       "" if not flips_own else
                       f", its own gap {rel_own:.3e} (not gated); the gap gated is "
                       f"the split path's with the full prefill's choices, where "
                       f"{flips} of its own differ (largest probability margin "
                       f"{margin:.3e} < {NEAR_TIE})"))
        inputs = "".join(f", {name} {list(x.shape)}" for name, x in extra.items())
        decode = (f"decode {decode_ms:.3f} ms/token step ({n_out} steps timed alone)"
                  if n_out else "no decode (the prefill alone)")
        say(f"{phase} serving {arch} (full width, {cfg.num_layers}"
            f"{'' if layers is None else ' of ' + str(get_config(arch).num_layers)} "
            f"layers{f' + {cfg.num_encoder_layers} encoder layers' if cfg.num_encoder_layers else ''}, "
            f"{'no attention' if variants is None else f'hd {cfg.head_dim}'}, "
            f"random weights seed 0, bf16): init {init_s:.2f} s (peak "
            f"{init_peak_gb:.2f} GB), weights {weights_gb:.2f} GB; {B} x {S}-token "
            f"prompts{inputs}, {n_out} new tokens: prefill {prefill_s:.4f} s (median of "
            f"{' / '.join(f'{t:.4f}' for t in prefill_runs)}; first call "
            f"{first_s:.4f} s; {B * S / prefill_s:.0f} prompt tokens/s), {decode}, "
            f"generate {gen_s:.3f} s, {B * n_out / gen_s:.1f} output "
            f"tokens/s; peak memory {peak_gb:.2f} GB; "
            f"launches {launches} (by variant {by_variant}); a prefill's norms {norms}, "
            f"launching {norm_launches}; "
            f"prefill->decode rel "
            f"gap {rel:.3e} < {SERVE_REL_TOL} with attention weights at "
            f"contraction fan-in, {rel_init:.3e} with the JAX init (not "
            f"gated){routing}; sample {out[0, :8].tolist()}")
        if cfg.moe_num_experts:
            for step, T in (("prefill", B * S), ("decode", B)):
                m = moe_block_split(eng, cfg, T, rng, dev)
                share = m["whole_ms"] * cfg.num_layers / (
                    prefill_s * 1e3 if step == "prefill" else decode_ms)
                say(f"{phase} {arch} MoE block at its {step} shape (T {T}, {m['rows']} "
                    f"routed rows on {m['experts_used']} of {cfg.moe_num_experts} "
                    f"experts; host clock, synchronized): routing "
                    f"{m['route_ms']:.4f} ms, sort/dispatch with the group-size read "
                    f"{m['dispatch_ms']:.4f} ms, row gather {m['gather_ms']:.4f} ms, "
                    f"expert GEMMs {m['gemm_ms']:.4f} ms (bound {m['gemm_bound_ms']:.4f} "
                    f"ms by {m['gemm_bound_by']}), combine {m['combine_ms']:.4f} ms; "
                    f"moe_apply {m['whole_ms']:.4f} ms, x {cfg.num_layers} layers = "
                    f"{share:.1%} of the {step}")
                served[arch][f"moe_{step}"] = m
        if MAMBA in cfg.pattern:
            m = ssd_block_split(eng, cfg, B, S, rng, dev)
            say(f"{phase} {arch} SSD block (layer 0, host clock, synchronized): prefill "
                f"[{B}, {S}]: projections {m['proj_ms']:.4f} ms, convolutions "
                f"{m['conv_ms']:.4f} ms, chunked SSD {m['ssd_ms']:.4f} ms, gate/norm/out "
                f"{m['gate_ms']:.4f} ms; ssm_forward {m['whole_ms']:.4f} ms, x "
                f"{cfg.num_layers} layers = {m['whole_ms'] * cfg.num_layers / (prefill_s * 1e3):.1%} "
                f"of the prefill (the SSD alone "
                f"{m['ssd_ms'] * cfg.num_layers / (prefill_s * 1e3):.1%}); decode step "
                f"of {B} tokens: projections {m['decode_proj_ms']:.4f} ms, convolutions "
                f"{m['decode_conv_ms']:.4f} ms, ssm_decode {m['decode_ms']:.4f} ms, x "
                f"{cfg.num_layers} layers = "
                f"{m['decode_ms'] * cfg.num_layers / decode_ms:.1%} of a decode step")
            served[arch]["ssd"] = m
        del eng, toks, batch, extra
        torch.cuda.empty_cache()
        if flips_own:
            served[arch]["float32"] = float32_consistency(arch, dev)
    for arch in ([a for a, *_ in PAPER_SERVE] + list(MOE_SSM_SMOKE)
                 + [a for a, *_ in ENCODER_SERVE]):
        serve_card_vs_cpu(dev, arch)
    return served


def bound_ms(flops: float, nbytes: float) -> tuple:
    """(least milliseconds, what bounds it): the larger of bf16 operations
    at the tensor-core peak and bytes at the HBM rate."""
    ops_ms = flops / H100_BF16_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


_FLEX = {}  # the compiled flex_attention, made on first use


def flex_library(softcap: float, *, window: int = 0, valid_len=None, Sq: int, Skv: int,
                 dev, lse: bool = False):
    """PyTorch's one call for attention with a logit softcap, which
    scaled_dot_product_attention lacks, or with a sliding window that skips
    the blocks outside it: ``flex_attention`` compiled (its documented
    use), with score_mod ``cap * tanh(s / cap)`` when ``softcap`` and a
    block mask of the causal window (prefill, ``valid_len`` None) or of the
    first ``valid_len`` keys (decode, ``Sq`` = 1). Returns ``fn(q, k, v)``
    on ``[B, heads, seq, hd]`` tensors (GQA by ``enable_gqa``); the default
    scale is the kernels' ``hd ** -0.5``. With ``lse`` it returns (out, the
    rows' natural log-sum-exp [B, heads, seq] in float32). A yardstick the
    port never calls."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    if "fn" not in _FLEX:
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)

    def capped(s, b, h, qi, kv):
        return softcap * torch.tanh(s / softcap)

    score_mod = capped if softcap else None

    if valid_len is None:
        def mask_mod(b, h, qi, kv):
            keep = kv <= qi
            return keep & (qi - kv < window) if window else keep
    else:
        def mask_mod(b, h, qi, kv):
            return kv < valid_len
    block_mask = create_block_mask(mask_mod, None, None, Sq, Skv, device=dev)
    if not lse:
        return lambda q, k, v: _FLEX["fn"](q, k, v, score_mod=score_mod,
                                           block_mask=block_mask, enable_gqa=True)
    try:
        from torch.nn.attention.flex_attention import AuxRequest
        aux = {"return_aux": AuxRequest(lse=True)}
    except ImportError:  # a torch before AuxRequest
        aux = {"return_lse": True}

    def with_lse(q, k, v):
        o, extra = _FLEX["fn"](q, k, v, score_mod=score_mod, block_mask=block_mask,
                               enable_gqa=True, **aux)
        return o, getattr(extra, "lse", extra)

    return with_lse


def library_rows(row: dict, softcap: float, sdpa_ms: float, flex_ms, flex_err) -> str:
    """Fill ``row``'s library keys: with a softcap, ``library_ms`` is
    flex_attention's time (the same function) and ``library_no_softcap_ms``
    scaled_dot_product_attention's on the same inputs without the softcap;
    with a sliding window and no softcap (``flex_ms`` given),
    ``library_ms`` is flex_attention's with the window's block mask and
    ``library_sdpa_mask_ms`` scaled_dot_product_attention's with the window
    as a boolean mask; else ``library_ms`` is scaled_dot_product_attention's.
    Returns the text for the printed line."""
    if flex_ms is None:
        row["library_ms"] = sdpa_ms
        return f"scaled_dot_product_attention {sdpa_ms:.5f} ms"
    if not softcap:
        row.update(library_ms=flex_ms, library_sdpa_mask_ms=sdpa_ms,
                   library_max_abs_err=flex_err)
        return (f"flex_attention with the window's block mask {flex_ms:.5f} ms (max abs "
                f"gap to the plain version {flex_err:.3e}), scaled_dot_product_attention "
                f"with it as a boolean mask {sdpa_ms:.5f} ms")
    row.update(library_ms=flex_ms, library_no_softcap_ms=sdpa_ms,
               library_max_abs_err=flex_err)
    return (f"flex_attention with the softcap {flex_ms:.5f} ms (max abs gap to the "
            f"plain version {flex_err:.3e}), scaled_dot_product_attention "
            f"without it {sdpa_ms:.5f} ms")


def time_flash(dev, rng, B: int, S: int, H: int, KV: int, hd: int, *,
               causal: bool = True, Skv: int = 0, window: int = 0,
               softcap: float = 0.0, calls: int = 20) -> dict:
    """The flash kernel at one bf16 prefill shape (S queries over ``Skv``
    keys, S by default; causal, or bidirectional as an encoder's and a
    cross-attention's), held against its plain version: device time, call
    time, the plain version's and the library's device times
    (:func:`library_rows`: flex_attention with a softcap or a window,
    whose block mask skips the blocks outside it;
    scaled_dot_product_attention takes a window as a boolean mask, and no
    mask where nothing is masked), the bound and the error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    Skv = Skv or S
    q = randn(rng, (B, S, H, hd), "bfloat16", dev)
    k = randn(rng, (B, Skv, KV, hd), "bfloat16", dev)
    v = randn(rng, (B, Skv, KV, hd), "bfloat16", dev)
    kw = dict(causal=causal, window=window, softcap=softcap)
    seq = f"S={S}" if Skv == S else f"Sq={S} Skv={Skv}"
    label = (f"flash B={B} {seq} H={H} KV={KV} hd={hd} {'causal' if causal else 'bidirectional'} "
             f"window={window} softcap={softcap}")
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = compare_close(got, want, ATTN_TOL["bfloat16"], label)
    del got
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    flex_ms = flex_err = None
    if softcap or window:
        flex = flex_library(softcap, window=window, Sq=S, Skv=S, dev=dev)
        flex_err = compare_close(flex(qt, kt, vt).transpose(1, 2), want,
                                 ATTN_TOL["bfloat16"], f"flex_attention at {label}")
        flex_ms = device_ms([lambda: flex(qt, kt, vt)], calls=calls)
    del want
    lib_kw = (dict(attn_mask=fa.attention_mask(S, S, causal=True, window=window,
                                               q_offset=0, device=dev))
              if window else dict(is_causal=causal))
    kernel = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    sdpa_ms = device_ms([lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **lib_kw)], calls=calls)
    row = dict(
        ms=device_ms([kernel], calls=calls),
        call_ms=cuda_ms(kernel, reps=calls),
        plain_ms=device_ms([lambda: fa.flash_attention_plain(q, k, v, **kw)],
                           calls=3, replays=2),
        max_abs_err=err)
    lib = library_rows(row, softcap, sdpa_ms, flex_ms, flex_err)
    # attended (query, key) pairs: every one without a mask, else
    # min(i + 1, window) for query i
    pairs = (S * Skv if not causal else S * (S + 1) / 2 if not window or window >= S else
             window * (window + 1) / 2 + (S - window) * window)
    flops = 4 * B * H * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * Skv * KV * hd)  # q, o, k, v in bf16
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    print(f"kernel flash_attention B={B} {seq} H={H} KV={KV} hd={hd} bf16 "
          f"{'causal' if causal else 'bidirectional'} window={window} softcap={softcap} "
          f"({fa.kernel_variant(q.dtype, hd)}): "
          f"device {row['ms']:.4f} ms, call {row['call_ms']:.4f} ms (plain version "
          f"{row['plain_ms']:.4f} ms, {lib}, device times; bound {row['bound_ms']:.4f} "
          f"ms by {row['bound_by']}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
          f"max abs gap {err:.3e} [{CARD}]")
    return row


DECODE_SETS = 4  # cache sets the decode timing cycles through: 100 MB > L2


def time_decode(dev, rng, B: int, T: int, H: int, KV: int, hd: int, vl: int, *,
                softcap: float = 0.0) -> dict:
    """The decode kernel at one bf16 shape, as :func:`time_flash`, the
    timed calls cycling through :data:`DECODE_SETS` caches (SDPA without a
    mask when all ``T`` slots attend, as a cross-attention's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    sets = [tuple(randn(rng, s, "bfloat16", dev)
                  for s in ((B, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
            for _ in range(DECODE_SETS)]
    q, k, v = sets[0]
    label = f"decode B={B} T={T} H={H} KV={KV} hd={hd} valid_len={vl} softcap={softcap}"
    got = dec.decode_attention(q, k, v, vl, softcap=softcap)
    want = dec.decode_attention_plain(q, k, v, vl, softcap=softcap)
    torch.cuda.synchronize()
    err = compare_close(got, want, ATTN_TOL["bfloat16"], label)
    lib_sets = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)) for q, k, v in sets]
    flex_ms = flex_err = None
    if softcap:
        flex = flex_library(softcap, valid_len=vl, Sq=1, Skv=T, dev=dev)
        flex_err = compare_close(flex(*lib_sets[0])[:, :, 0], want,
                                 ATTN_TOL["bfloat16"], f"flex_attention at {label}")
        flex_ms = device_ms([lambda s=s: flex(*s) for s in lib_sets], calls=64)
    mask = None if vl == T else (torch.arange(T, device=dev) < vl)[None, None, None, :]
    sdpa_ms = device_ms([lambda s=s: F.scaled_dot_product_attention(
        *s, attn_mask=mask, enable_gqa=True) for s in lib_sets], calls=64)
    row = dict(
        ms=device_ms([lambda s=s: dec.decode_attention(*s, vl, softcap=softcap)
                      for s in sets], calls=64),
        call_ms=cuda_ms(lambda: dec.decode_attention(q, k, v, vl, softcap=softcap), reps=50),
        plain_ms=device_ms([lambda s=s: dec.decode_attention_plain(*s, vl, softcap=softcap)
                            for s in sets], calls=8),
        max_abs_err=err)
    lib = library_rows(row, softcap, sdpa_ms, flex_ms, flex_err)
    nbytes = 2 * (2 * B * vl * KV * hd + 2 * B * H * hd)  # valid k, v; q, o
    flops = 4 * B * H * hd * vl
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    print(f"kernel decode_attention B={B} T={T} H={H} KV={KV} hd={hd} valid_len={vl} "
          f"softcap={softcap} bf16 ({dec.kernel_variant(q.dtype, hd)}): device "
          f"{row['ms']:.5f} ms, call {row['call_ms']:.5f} ms (plain version "
          f"{row['plain_ms']:.5f} ms, {lib}, device times over {DECODE_SETS} caches; "
          f"bound {row['bound_ms']:.5f} ms by {row['bound_by']}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP); max abs gap {err:.3e} [{CARD}]")
    return row


# the phase (h) and (i) model each kernel is timed and checked at, by key of
# the kernels JSON line: every layer of gpt-neox-20b and opt-30b; gemma2-9b's
# LOCAL layers (windowed prefill, ring decode) and GLOBAL layers; every layer
# of mixtral-8x7b (windowed prefill, ring decode) and of kimi-k2-1t-a32b
SERVED_TIMINGS = {"hd96": "gpt-neox-20b", "opt30b": "opt-30b",
                  "local": "gemma2-9b", "global": "gemma2-9b",
                  "mixtral": "mixtral-8x7b", "kimi": "kimi-k2-1t-a32b"}


def time_encoders(dev, rng, flash: dict, decode: dict) -> None:
    """Both attention kernels at the attention shapes of phase (j), into
    ``flash`` and ``decode`` by key: an encoder-decoder model's encoder
    (bidirectional over its :data:`ENCODER_LEN` positions), its
    cross-attention prefill (the prompt over them) and cross decode step
    (every encoder position); the causal prefill of roberta-large and of
    internvl2-1b (image and prompt, G = 7); the decoder's self-attention
    step halfway through the new tokens. Without a mask, the library is
    scaled_dot_product_attention without one."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import decoder_slots

    for arch, _, B, S, n_out, _ in ENCODER_SERVE:
        c = get_config(arch)
        heads = (c.num_heads, c.num_kv_heads, c.head_dim)
        key = arch.split("-")[0]
        enc = ENCODER_LEN.get(arch, 0)
        n_pre = c.num_image_embeds if c.frontend == "vision_stub" else 0
        if enc:
            flash[f"{key}_encoder"] = time_flash(dev, rng, B, enc, *heads, causal=False)
            flash[f"{key}_cross"] = time_flash(dev, rng, B, S, *heads, causal=False, Skv=enc)
            decode[f"{key}_cross"] = time_decode(dev, rng, B, enc, *heads, enc)
        else:
            flash[key] = time_flash(dev, rng, B, n_pre + S, *heads)
        if n_out:
            decode[key if not enc else f"{key}_self"] = time_decode(
                dev, rng, B, decoder_slots(c, enc + n_pre + S + n_out), *heads,
                n_pre + S + n_out // 2)


def time_attention(dev, rng_seed: int = 7) -> list:
    """Both attention kernels at the serving main-path shapes (llama3.2-1b),
    the flash kernel also at the qwen3-8b / yi-34b head dim of 128, and both
    at every attention shape of phases (h) and (i) (:data:`SERVED_TIMINGS`):
    a prefill of the served prompt, and a decode step halfway through the
    new tokens (a sliding-window layer: its full ring of W slots), and of
    phase (j) (:func:`time_encoders`), each held against its plain
    version."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.config import LOCAL
    from repro_torch.models.model import cache_len

    cfg = get_config(SERVE_ARCH)
    B, S, H, KV, hd = (SERVE_REQUESTS, SERVE_PROMPT, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(rng_seed)
    flash = time_flash(dev, rng, B, S, H, KV, hd)
    flash["hd128"] = time_flash(dev, rng, B, S, 32, 8, 128)
    decode = time_decode(dev, rng, B, cache_len(SERVE_PROMPT + SERVE_OUT), H, KV, hd,
                         SERVE_VALID_LEN)
    shapes = {arch: (B, S, n_out)
              for arch, _, B, S, n_out, _ in PAPER_SERVE + MOE_SSM_SERVE}
    for key, arch in SERVED_TIMINGS.items():
        c = get_config(arch)
        B, S, n_out = shapes[arch]
        heads = (B, S, c.num_heads, c.num_kv_heads, c.head_dim)
        cap = c.attn_logit_softcap
        calls = 20 if S <= 1024 else 4
        if key != "global" and LOCAL in c.pattern:
            W = c.window_size
            flash[key] = time_flash(dev, rng, *heads, window=W, softcap=cap, calls=calls)
            decode[key] = time_decode(dev, rng, B, W, *heads[2:], W, softcap=cap)
        else:
            flash[key] = time_flash(dev, rng, *heads, softcap=cap, calls=calls)
            decode[key] = time_decode(dev, rng, B, cache_len(S + n_out), *heads[2:],
                                      S + n_out // 2, softcap=cap)
    time_encoders(dev, rng, flash, decode)
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


def observe_chaos(sc, plain) -> None:
    """(g) step 3a: ``sc`` (a chaos-* run already made as ``plain``, without
    a recorder) under the port's ``recording()``: every count, fault record
    and alert equals the unrecorded run's (the recorder observes, never
    perturbs); ``write_artifacts`` of its snapshot to a temporary directory,
    all three files read back (events equal, every counter and the
    manifest's keys present, the manifest naming this card); and
    ``reconstruct_incidents`` on the events read back."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.experiments.runner import run_experiment
    from repro_torch.obs import (
        MetricsRecorder, incidents_json, read_events, read_manifest,
        read_prometheus, reconstruct_incidents, recording, run_manifest,
        write_artifacts)

    rec = MetricsRecorder()
    t0 = time.perf_counter()
    with recording(rec):
        o = run_experiment(sc)
    run_s = time.perf_counter() - t0
    f, g = o.fleet, plain.fleet
    if not ((f.n_brakes, f.n_shed_total, f.n_rebalances, f.n_offered, f.n_admitted)
            == (g.n_brakes, g.n_shed_total, g.n_rebalances, g.n_offered, g.n_admitted)
            and f.fault_events == g.fault_events and f.alert_events == g.alert_events
            and np.array_equal(f.row_power_frac, g.row_power_frac)):
        raise AssertionError(f"{sc.name}: the recorder changed the run")
    snap = rec.snapshot()
    manifest = run_manifest(seed=sc.seed, scenario=sc,
                            extra={"phase": "(g) 3a", "run_s": run_s})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        paths = write_artifacts(d, snap, manifest)
        sizes = {k: os.path.getsize(v) for k, v in paths.items()}
        back = read_manifest(d)
        prom = read_prometheus(paths["metrics"])
        events = read_events(paths["events"])
    io_s = time.perf_counter() - t0
    card = torch.cuda.get_device_name(0)
    n_counters = sum(len(v) for v in prom.get("counter", {}).values())
    if not (events == snap.events and n_counters == len(snap.counters)
            and set(back) == set(manifest) and back["device"] == card
            and back["torch"] == torch.__version__):
        raise AssertionError(f"{sc.name}: artifacts do not read back "
                             f"({len(events)} of {len(snap.events)} events, "
                             f"{n_counters} of {len(snap.counters)} counters, "
                             f"device {back.get('device')!r})")
    rep = reconstruct_incidents(events)
    doc = incidents_json(rep)
    if doc["n_incidents"] != rep.n_incidents or rep.n_events != len(events):
        raise AssertionError(f"{sc.name}: incident report inconsistent")
    timeline = "; ".join(
        f"#{inc.iid} {inc.kind} on {inc.target} at {inc.t_sched:g} s: "
        f"detected after {inc.detection_latency_s()} s "
        f"({inc.detection_latency_ticks(doc['tick_s'])} ticks), mitigated after "
        f"{inc.time_to_mitigation_s()} s, cleared {inc.time_to_clear_s()} s "
        f"after restore, {len(inc.alerts)} alerts, {inc.n_brake_edges} brake "
        f"edges" for inc in rep.incidents)
    say(f"(g) {sc.name} under recording(): {run_s:.2f} s, counts, fault "
        f"records and alerts equal the unrecorded run; artifacts "
        f"{sizes} bytes written and read back in {io_s:.3f} s ({len(events)} "
        f"events, {n_counters} counters, manifest device {back['device']!r}); "
        f"{rep.n_incidents} incident(s), {rep.n_false_alarms} unattributed "
        f"engage(s): {timeline}")


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
    unrecorded = {}
    for name in CHAOS_RUNS:
        sc = get_scenario(name).with_(duration_s=CHAOS_S, budget=chaos_budget)
        t0 = time.perf_counter()
        o = run_experiment(sc)
        run_s = time.perf_counter() - t0
        unrecorded[name] = (sc, o)
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

    # (3a) the static chaos run again under the recorder, its artifacts
    # written and read back, its incidents reconstructed from the trace
    observe_chaos(*unrecorded[CHAOS_RUNS[0]])
    check_no_tick_launch("the recorded chaos run")

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


# ---------------------------------------------------------------------------
# (k) training: the flash backward kernel, and the train step on the card
# ---------------------------------------------------------------------------

# The backward kernel's shapes: tests/test_torch_train.py's gradient cases in
# float32 (q_offset = Skv - Sq: the reference's alignment, which leaves the
# first rows of the last float32 case without a key), then every CUDA-core
# instance and the tensor-core instance (bf16, hd 64) with causal, window,
# softcap, q_offset, GQA and cross shapes, and a row without a key.
BWD_CASES = [
    # (B, Sq, Skv, H, KV, hd, dtype, causal, window, softcap, q_offset)
    (2, 24, 24, 4, 2, 16, "float32", True, 0, 0.0, 0),
    (2, 24, 24, 4, 4, 16, "float32", False, 0, 0.0, 0),
    (1, 40, 40, 8, 2, 32, "float32", True, 7, 0.0, 0),
    (2, 24, 24, 4, 2, 16, "float32", True, 0, 20.0, 0),
    (1, 33, 33, 4, 1, 64, "float32", True, 9, 30.0, 0),
    (2, 20, 28, 4, 2, 16, "float32", True, 0, 0.0, 8),
    (2, 12, 28, 4, 2, 16, "float32", False, 0, 0.0, 16),
    (2, 20, 16, 4, 2, 16, "float32", True, 0, 0.0, -4),
    (2, 37, 37, 4, 2, 8, "float32", True, 5, 0.0, 0),
    (1, 100, 77, 4, 2, 96, "float32", False, 0, 0.0, 0),
    (1, 130, 130, 4, 2, 128, "float32", True, 0, 0.0, 0),
    (1, 256, 256, 4, 4, 256, "float32", True, 128, 30.0, 0),
    (2, 37, 53, 4, 2, 16, "bfloat16", False, 0, 0.0, 0),
    (2, 37, 37, 8, 1, 32, "bfloat16", True, 0, 0.0, 0),
    (1, 100, 77, 4, 2, 96, "bfloat16", False, 0, 0.0, 0),
    (1, 200, 200, 16, 2, 128, "bfloat16", True, 0, 30.0, 0),
    (1, 64, 64, 4, 2, 256, "bfloat16", True, 16, 0.0, 200),
    (1, 300, 300, 8, 2, 64, "bfloat16", True, 64, 0.0, 0),
    (1, 64, 64, 4, 2, 64, "bfloat16", True, 0, 0.0, -10),
    (2, 130, 130, 8, 8, 64, "bfloat16", False, 0, 50.0, 0),
    (2, 200, 261, 16, 2, 64, "bfloat16", True, 0, 50.0, 61),
    (2, 77, 150, 4, 4, 64, "bfloat16", False, 0, 0.0, 0),
    # the tensor-core instance's tiles (128-row blocks, 64-row loop tiles, a
    # 4-stage ring): Sq and Skv past 256 and off the 64- and 128-row grids,
    # so that both rings wrap and both ragged edges are met; a causal
    # diagonal inside a 128-key block (q_offset 0, and -70: 70 rows without
    # a key); a window edge on a tile border; G = 8 and G = 1; softcaps
    (1, 300, 333, 8, 1, 64, "bfloat16", False, 0, 0.0, 0),
    (2, 270, 270, 4, 2, 64, "bfloat16", True, 0, 0.0, 0),
    (1, 300, 300, 8, 1, 64, "bfloat16", True, 0, 0.0, -70),
    (1, 384, 384, 4, 2, 64, "bfloat16", True, 128, 0.0, 0),
    (2, 290, 290, 4, 4, 64, "bfloat16", True, 0, 30.0, 0),
    (1, 330, 275, 8, 2, 64, "bfloat16", False, 128, 50.0, 0),
]
# roberta-large's and llama3.2-1b's training shapes (bf16, hd 64)
TRAIN_ATTN = {"roberta": (32, 2048, 2048, 16, 16, 64, "bfloat16", False, 0, 0.0, 0),
              "llama": (8, 1024, 1024, 32, 8, 64, "bfloat16", True, 0, 0.0, 0)}
LSE_TOL = 1e-4  # the row log-sum-exp against the plain version's, absolute
# the full-width runs: (arch, batch, sequence, steps); roberta-large at the
# paper's training shape (benchmarks/fig08_09_training.py)
TRAIN_RUNS = {"roberta-large": (32, 2048, 4), "llama3.2-1b": (8, 1024, 3)}
TRAIN_FAIL_AT = 3  # roberta's injected fault: before the fourth step run
GATE_LAYERS = 2  # of the full-width models in the bf16 gate
GATE_TOL = ATTN_TOL["bfloat16"]
REPLAY_ATOL = 1e-6  # tests/test_checkpoint.py's crash-replay contract
# the float32 card-vs-CPU step: float32 parameter storage within this (gap
# norm over norm, each state leaf); bf16 storage (kimi-k2, jamba) within one
# bf16 rounding unit, its squared moments within two (tests/_torch_train_ref.py)
TRAIN_F32_RTOL = 1e-4
BF16_STORAGE_RTOL = 2.0 ** -7
# the smoke configs whose card-vs-CPU step runs on conditioned attention
# (tests/_torch_train_ref.py::CONDITIONED): on the JAX init flan-t5's
# second moments are 1.7e-4 of a leaf's norm apart between an H100 and the
# CPU, as they are between the port and JAX
TRAIN_CONDITIONED = ("jamba-1.5-large-398b", "flan-t5-xxl", "whisper-base")


def loss_chunks(cfg, B: int, S: int) -> int:
    """The chunks of positions of one ``loss_fn`` at B x S
    (``models/model.py`` LOSS_CHUNK_BYTES of float32 logits a chunk): one
    ``bf16_split3`` launch each in a bf16 step's backward."""
    from repro_torch.models import model as model_mod
    n = S if cfg.is_encoder_only else S - 1
    return -(-n // max(1, model_mod.LOSS_CHUNK_BYTES // (4 * B * cfg.vocab_size)))


def train_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    return {"forward": fa.flash_attention_lse.launches,
            "backward": fa.flash_attention_bwd.launches,
            "serving_flash": fa.flash_attention.launches}


def compare_grad(got, want, scale, tol: float, label: str) -> float:
    """:func:`compare_close` for a gradient [B, S, heads, hd]: |got - want|
    <= tol + tol |want|; in bf16 also <= tol (|want| + ``scale`` + tol x
    the RMS of its head's gradient over the sequence), ``scale`` the root
    sum of squares of the products that add up to each entry
    (:func:`grad_scales`), where the forward holds an output to tol (|want|
    + its row's RMS). An output is a convex sum of values; a gradient entry
    sums terms of both signs (a query row's dS sums to zero over its keys),
    and the bf16 roundings of its terms add in quadrature: an early causal
    row's dq is far smaller than its terms, and a row that attends one key
    has a dq of pure rounding noise (the last summand's floor). A dropped
    tile of 64 of 2048 keys still moves an entry by ~0.18 of its scale. In
    float32 the first bound (2e-5 against gradients of 0.01-1) holds alone.
    Returns (the max gap, the number of entries beyond the forward's
    row-RMS bound, which this bound replaces)."""
    import torch
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{label}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f"{label}: non-finite values")
    gap = (g - w).abs()
    n_bad = int((gap > tol + tol * w.abs()).sum())
    n_bad2 = n_row = 0
    if got.dtype == torch.bfloat16:
        head_rms = w.pow(2).mean(dim=(1, 3), keepdim=True).sqrt()
        n_bad2 = int((gap > tol * (w.abs() + scale + tol * head_rms)).sum())
        n_row = int((gap > tol * (w.abs() + w.pow(2).mean(-1, keepdim=True).sqrt())).sum())
    if n_bad or n_bad2:
        raise AssertionError(f"{label}: {n_bad} elements beyond {tol}, {n_bad2} beyond {tol} "
                             f"x (|want| + its terms' scale) (max gap {float(gap.max()):.3e})")
    return float(gap.max()), n_row


def grad_scales(do, q, k, v, o, lse, *, causal, window, softcap, q_offset):
    """The scales of :func:`compare_grad` for (dq, dk, dv), float32: the
    root sum of squares of each entry's terms in the plain backward's
    formulas, sqrt(dS^2 K^2) hd^-1/2, sqrt(dS^2^T Q^2) hd^-1/2 and
    sqrt(P^2^T dO^2)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    mask = fa.attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                             device=q.device)
    c = fa._scores_plain(q, k, softcap)
    lse_ = lse.reshape(B, KV, G, Sq, 1)
    p = torch.where(mask & torch.isfinite(lse_), torch.exp(c - lse_), 0.0)
    dof = do.float().reshape(B, Sq, KV, G, hd)
    d = (dof * o.float().reshape(B, Sq, KV, G, hd)).sum(-1)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dof, v.float())
    ds2 = (p * (dp - d.permute(0, 2, 3, 1)[..., None])).square()
    if softcap:
        ds2 = ds2 * (1.0 - (c / softcap) ** 2).square()
    scale = hd ** -0.5
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds2, k.float().square()).sqrt() * scale
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds2,
                      q.float().square().reshape(B, Sq, KV, G, hd)).sqrt() * scale
    dv = torch.einsum("bkgqt,bqkgd->btkd", p.square(), dof.square()).sqrt()
    return dq.reshape(B, Sq, H, hd), dk, dv


def _by_batch(fn, do, q, k, v, o, lse, **kw):
    """``fn`` (the plain backward, or :func:`grad_scales`) one batch row at
    a time (its float32 score tensors of the whole batch would not fit at
    the training shapes)."""
    import torch
    parts = [fn(do[i:i + 1], q[i:i + 1], k[i:i + 1], v[i:i + 1], o[i:i + 1], lse[i:i + 1],
                **kw) for i in range(q.shape[0])]
    return [torch.cat([p[j] for p in parts]) for j in range(3)]


def check_backward(dev, case, seed: int) -> dict:
    """One shape: the training forward (its output bit-equal to the serving
    launch's, its lse within LSE_TOL of the plain version's, +inf on the
    same rows), then the backward kernel launched twice (bit-equal) against
    the plain backward on the kernel's own o and lse."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, KV, hd, dt, causal, window, cap, q_off = case
    rng = np.random.default_rng(seed)
    q = randn(rng, (B, Sq, H, hd), dt, dev)
    k = randn(rng, (B, Skv, KV, hd), dt, dev)
    v = randn(rng, (B, Skv, KV, hd), dt, dev)
    do = randn(rng, (B, Sq, H, hd), dt, dev)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_off)
    label = (f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} hd={hd} {dt} causal={causal} "
             f"window={window} softcap={cap} q_offset={q_off}")
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    if not torch.equal(o, fa.flash_attention(q, k, v, **kw)):
        raise AssertionError(f"flash_attention_lse {label}: output differs from the serving launch")
    _, plain_lse = fa.flash_attention_lse_plain(q[:1], k[:1], v[:1], **kw)
    empty = torch.isinf(plain_lse)
    if not torch.equal(torch.isinf(lse[:1]), empty):
        raise AssertionError(f"flash_attention_lse {label}: rows without a key differ")
    lse_gap = float((lse[:1] - plain_lse)[~empty].abs().max()) if (~empty).any() else 0.0
    if not lse_gap <= LSE_TOL:
        raise AssertionError(f"flash_attention_lse {label}: lse gap {lse_gap:.3e}")
    got = fa.flash_attention_bwd(do, q, k, v, o, lse, **kw)
    again = fa.flash_attention_bwd(do, q, k, v, o, lse, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd {label}: two launches differ")
    want = _by_batch(fa.flash_attention_bwd_plain, do, q, k, v, o, lse, **kw)
    scales = (_by_batch(grad_scales, do, q, k, v, o, lse, **kw) if dt == "bfloat16"
              else (None, None, None))
    res = {name: compare_grad(g, w, sc, ATTN_TOL[dt], f"flash_attention_bwd {label} {name}")
           for name, g, w, sc in zip(("dq", "dk", "dv"), got, want, scales)}
    gaps = {name: r[0] for name, r in res.items()}
    n_row = sum(r[1] for r in res.values())
    row_note = (f"; {n_row} of {q.numel() + 2 * k.numel()} entries beyond "
                f"the forward's row-RMS bound" if n_row else "")
    say(f"kernel flash_attention_bwd {label} ({fa.bwd_variant(q.dtype, hd)}): max abs gap "
        f"dq {gaps['dq']:.3e} dk {gaps['dk']:.3e} dv {gaps['dv']:.3e}{row_note}; two "
        f"launches bit-equal; forward lse gap {lse_gap:.3e} ({int(empty.sum())} rows without "
        f"a key, +inf in both), output bit-equal to the serving launch")
    return {"max_abs_err": max(gaps.values()), "lse_err": lse_gap, "row_bound_exceeded": n_row}


def check_backward_cases(dev) -> dict:
    """The backward kernel against its plain version at :data:`BWD_CASES`
    and the training shapes; misaligned bf16 hd-64 views raise before any
    launch. Returns the errors at the training shapes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    for i, case in enumerate(BWD_CASES):
        check_backward(dev, case, 300 + i)
    out = {name: check_backward(dev, case, 400 + i)
           for i, (name, case) in enumerate(TRAIN_ATTN.items())}
    rows = torch.zeros((1, 64, 4, 68), dtype=torch.bfloat16, device=dev)
    view = rows[..., :64]
    lse = torch.zeros((1, 4, 64), dtype=torch.float32, device=dev)
    before = fa.flash_attention_bwd.launches
    try:
        fa.flash_attention_bwd(view, view, view, view, view, lse)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention_bwd took a misaligned hd-64 bf16 view")
    if fa.flash_attention_bwd.launches != before:
        raise AssertionError("flash_attention_bwd launched on a misaligned view")
    say("kernel flash_attention_bwd: a misaligned bf16 hd-64 view raises ValueError, no launch")
    return out


def time_backward(dev, name: str, calls: int = 5) -> dict:
    """The backward kernel at a training shape: device and call time, the
    plain version's, scaled_dot_product_attention's backward on the same
    inputs (the library, timed here and never called by the port), and the
    bound: 10 B H hd flops a attended (query, key) pair (S = Q K^T, dP, dV,
    dK, dQ: the minimum; the kernel's two passes make S and dP twice, 14)
    at the bf16 peak, or q, k, v, o, dO and lse read once and dq, dk, dv
    written once at the HBM rate. Also the training forward (the flash
    kernel's launch with the row log-sum-exp): its device time, SDPA's
    forward on the same inputs, and its bound, 4 B H hd flops a pair, or q,
    k, v read and o, lse written once."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, KV, hd, dt, causal, _, _, _ = TRAIN_ATTN[name]
    rng = np.random.default_rng(7)
    q = randn(rng, (B, Sq, H, hd), dt, dev)
    k = randn(rng, (B, Skv, KV, hd), dt, dev)
    v = randn(rng, (B, Skv, KV, hd), dt, dev)
    do = randn(rng, (B, Sq, H, hd), dt, dev)
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    kernel = lambda: fa.flash_attention_bwd(do, q, k, v, o, lse, causal=causal)  # noqa: E731
    row = {"ms": device_ms([kernel], calls=calls), "call_ms": cuda_ms(kernel, reps=calls),
           "forward_ms": device_ms([lambda: fa.flash_attention_lse(q, k, v, causal=causal)],
                                   calls=calls),
           "split_ms": kernel_split(kernel)}
    plain = lambda: fa.flash_attention_bwd_plain(do, q, k, v, o, lse, causal=causal)  # noqa: E731
    plain()
    row["plain_ms"] = cuda_ms(plain, reps=1)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    g = do.transpose(1, 2)
    library = lambda: torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True)  # noqa: E731
    library()
    row["library_ms"] = cuda_ms(library, reps=calls)
    del out
    with torch.no_grad():
        row["forward_library_ms"] = device_ms(
            [lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                    enable_gqa=True)], calls=calls)
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Skv
    flops = 10 * B * H * hd * pairs
    nbytes = 2 * (3 * B * Sq * H * hd + 2 * B * Skv * KV * hd) + 4 * B * H * Sq \
        + 2 * (B * Sq * H * hd + 2 * B * Skv * KV * hd)
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    fwd_flops = 4 * B * H * hd * pairs
    fwd_bytes = 2 * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd) + 4 * B * H * Sq
    row["forward_bound_ms"], row["forward_bound_by"] = bound_ms(fwd_flops, fwd_bytes)
    say(f"kernel flash_attention_bwd at {name}'s training shape B={B} S={Sq} H={H} KV={KV} "
        f"hd={hd} {dt} {'causal' if causal else 'bidirectional'} "
        f"({fa.bwd_variant(q.dtype, hd)}): device {row['ms']:.4f} ms, call "
        f"{row['call_ms']:.4f} ms (plain version {row['plain_ms']:.3f} ms; "
        f"scaled_dot_product_attention's backward {row['library_ms']:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']}: {flops / 1e12:.3f} TFLOP, "
        f"{nbytes / 1e9:.3f} GB; at the kernel's 14 flops a pair "
        f"{flops * 1.4 / H100_BF16_FLOPS * 1e3:.4f} ms); its kernels (torch.profiler, device "
        f"ms a call): " + (", ".join(f"{n} {t:.4f}" for n, t in row["split_ms"].items())
                           or "not measured (the profiler saw no device event)"))
    say(f"kernel flash_attention_lse (the training forward) at {name}'s training shape: "
        f"device {row['forward_ms']:.4f} ms (scaled_dot_product_attention's forward "
        f"{row['forward_library_ms']:.4f} ms; bound {row['forward_bound_ms']:.4f} ms by "
        f"{row['forward_bound_by']}: {fwd_flops / 1e12:.3f} TFLOP, {fwd_bytes / 1e9:.3f} GB)")
    return row


def _attn_layers(cfg) -> int:
    """Attention calls of one forward: self attention in every non-Mamba
    block, cross attention beside it in an encoder-decoder model, and the
    encoder's layers."""
    from repro_torch.models.config import MAMBA
    n = sum(kind != MAMBA for kind in cfg.pattern) * cfg.num_groups
    return n * (2 if cfg.is_encoder_decoder else 1) + cfg.num_encoder_layers


def _state_gaps(got, want):
    """(worst gap norm over norm, its leaf, worst max-entry gap over the
    leaf's largest entry, its leaf) over two state trees."""
    from repro_torch.optim.optimizers import tree_leaves

    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}/{k}" if prefix else k)]
        return [prefix]

    worst, worst_entry = (0.0, ""), (0.0, "")
    for path, g, w in zip(paths(want), tree_leaves(got), tree_leaves(want), strict=True):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        d = g - w
        r = float(d.norm() / max(float(w.norm()), 1e-30))
        e = float(d.abs().max() / max(float(w.abs().max()), 1e-30))
        worst = max(worst, (r, path))
        worst_entry = max(worst_entry, (e, path))
    return worst, worst_entry


def smoke_train_steps(dev) -> None:
    """One float32 train step of every registry arch's smoke config on the
    card against the same step on the CPU (the kernels' plain versions):
    the loss, the grad norm and every state leaf, with the flash launches
    (the training forward twice an attention call under full remat, the
    backward once). kimi-k2 and jamba store their parameters in bf16; they
    run again with float32 storage, which shows where their gap starts.
    The archs of :data:`TRAIN_CONDITIONED` run on conditioned attention."""
    import torch
    from repro_torch.configs import ALL, smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline, device_put_batch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import init_state
    from repro_torch.optim import make_optimizer

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    for arch in sorted(ALL):
        base = smoke_config(arch).replace(dtype=torch.float32)
        storages = [None] + (["float32"] if base.param_dtype == torch.bfloat16 else [])
        for storage in storages:
            cfg = base if storage is None else base.replace(param_dtype=torch.float32)
            opt = make_optimizer(cfg.optimizer)
            cpu = init_state(cfg, opt, "cpu", seed=0)
            if arch in TRAIN_CONDITIONED:
                condition_attention(cfg, cpu["params"])
            batch = SyntheticTokenPipeline(cfg, DataConfig(2, 32)).batch_at(0)
            step = build_train_step(cfg, None, None, opt)
            reset_counts()
            card, m_card = step(to(cpu, dev), device_put_batch(batch, dev))
            torch.cuda.synchronize()
            n = train_counts()
            want_n = {"forward": 2 * _attn_layers(cfg), "backward": _attn_layers(cfg),
                      "serving_flash": 0}
            if n != want_n:
                raise AssertionError(f"(k) {cfg.name} train step launched {n}, want {want_n}")
            host, m_cpu = step(cpu, batch)
            loss, loss_cpu = float(m_card["loss"]), float(m_cpu["loss"])
            (r, leaf), (e, eleaf) = _state_gaps(card, host)
            bf16 = cfg.param_dtype == torch.bfloat16
            if not abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu):
                raise AssertionError(f"(k) {cfg.name}: loss {loss} on the card, {loss_cpu} on the CPU")
            bound = 2 * BF16_STORAGE_RTOL if bf16 else TRAIN_F32_RTOL
            if not r < bound:
                raise AssertionError(f"(k) {cfg.name}: state leaf {leaf} {r:.3e} apart (bound {bound})")
            cond = ", conditioned attention" if arch in TRAIN_CONDITIONED else ""
            say(f"(k) train step {cfg.name} ({opt.name}, {'bf16' if bf16 else 'float32'} "
                f"parameters{cond}) float32 card vs CPU: loss {loss:.6f} / {loss_cpu:.6f}, grad norm "
                f"{float(m_card['grad_norm']):.5f} / {float(m_cpu['grad_norm']):.5f}; worst "
                f"state leaf {leaf} {r:.2e} (gap norm over norm, bound {bound:g}), largest "
                f"entry gap {e:.2e} of its leaf's largest entry ({eleaf}); flash launches "
                f"{n['forward']} forward, {n['backward']} backward")


@contextlib.contextmanager
def plain_attention():
    """The model's attention as autograd of the plain version (on the card)
    instead of the Function whose backward is the kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    real = attention.ops.flash_attention

    def plain(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0):
        return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        softcap=softcap, q_offset=q_offset)

    attention.ops.flash_attention = plain
    try:
        yield
    finally:
        attention.ops.flash_attention = real


@contextlib.contextmanager
def zeroed_backward():
    """The backward kernel launched as always, the dq, dk and dv it returns
    to autograd replaced by zeros: the negative control of the bf16 gate."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    real = fa.FlashAttention.backward

    def zeroed(ctx, do):
        grads = real(ctx, do)
        return tuple(torch.zeros_like(g) for g in grads[:3]) + tuple(grads[3:])

    fa.FlashAttention.backward = staticmethod(zeroed)
    try:
        yield
    finally:
        fa.FlashAttention.backward = staticmethod(real)


def bf16_gate(dev, arch: str, S: int) -> dict:
    """One bf16 AdamW step of a full-width model cut to GATE_LAYERS layers
    (conditioned attention, B 2), with the attention kernels against the
    same step with autograd of the plain attention: every first-moment leaf
    (0.1 x the clipped gradient) within GATE_TOL (gap norm over norm). With
    the backward kernel's outputs zeroed the gate must fail."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline, device_put_batch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import init_state
    from repro_torch.optim import make_optimizer
    cfg = get_config(arch).replace(num_layers=GATE_LAYERS)
    opt = make_optimizer(cfg.optimizer)
    state = init_state(cfg, opt, dev, seed=0)
    condition_attention(cfg, state["params"])
    batch = device_put_batch(SyntheticTokenPipeline(cfg, DataConfig(2, S)).batch_at(0), dev)
    step = build_train_step(cfg, None, None, opt)
    reset_counts()
    kern, km = step(state, batch)
    n = train_counts()
    with plain_attention():
        plain, pm = step(state, batch)
    with zeroed_backward():
        zero, zm = step(state, batch)
    (r, leaf), (e, eleaf) = _state_gaps(kern["opt"]["mu"], plain["opt"]["mu"])
    attn = _state_gaps(kern["opt"]["mu"]["decoder"]["b0"]["attn"],
                       plain["opt"]["mu"]["decoder"]["b0"]["attn"])[0]
    (rz, zleaf), _ = _state_gaps(zero["opt"]["mu"], plain["opt"]["mu"])
    if not r < GATE_TOL:
        raise AssertionError(f"(k) bf16 gate {arch}: mu/{leaf} {r:.3e} apart")
    if not rz >= GATE_TOL:
        raise AssertionError(f"(k) bf16 gate {arch}: zeroed dq/dk/dv pass ({rz:.3e})")
    say(f"(k) bf16 train step {arch} (full width, {GATE_LAYERS} of "
        f"{get_config(arch).num_layers} layers, B 2 x S {S}, conditioned attention) kernels vs "
        f"autograd of the plain attention: loss {float(km['loss']):.6f} / "
        f"{float(pm['loss']):.6f}, grad norm {float(km['grad_norm']):.6f} / "
        f"{float(pm['grad_norm']):.6f}; first-moment leaves, gap norm over norm: worst "
        f"mu/{leaf} {r:.3e}, worst attention leaf {attn[0]:.3e} ({attn[1]}) (bound "
        f"{GATE_TOL}); largest entry gap {e:.3e} (mu/{eleaf}); with dq, dk, dv zeroed "
        f"mu/{zleaf} {rz:.3e} (fails the bound, as it must); flash {n['forward']} forward, "
        f"{n['backward']} backward")
    return {"layers": GATE_LAYERS, "batch": 2, "seq": S, "worst_leaf": r,
            "worst_attention_leaf": attn[0], "worst_entry": e, "zeroed_backward_worst_leaf": rz}


def traced_split(step, state, batch) -> dict:
    """One ``build_train_step`` call's seconds in its three parts, read
    from the program's own ``train.forward``, ``train.backward`` (which
    recomputes each layer's forward under full remat) and
    ``train.optimizer`` spans: device time between the CUDA events at
    each span's entry and exit, the call run under ``torch.profiler``; and
    its ``model.rmsnorm`` counts (:func:`norm_counts`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import device as obs
    obs.new_session()
    with profile(activities=[ProfilerActivity.CUDA]):
        _, m = step(state, batch)
        m["loss"].item()
    rec = obs.session()
    spans, norms = obs.resolve(rec), norm_counts(rec)
    obs.new_session()
    s = {r.name: (r.device_end_ns - r.device_start_ns) / 1e9 for r in spans}
    return {"forward_s": s["train.forward"], "backward_s": s["train.backward"],
            "optimizer_s": s["train.optimizer"], "norms": norms}


def step_peak_start() -> tuple:
    """Before one train step: (the allocator's peak so far, the bytes
    allocated after a garbage collection, the bytes that collection freed),
    and the peak reset, so that the step's own peak reads as
    ``max_memory_allocated`` after it. Without the collection, unreachable
    tensors of earlier work could be freed during the step, at a moment
    the peak would not show."""
    import gc
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    before = torch.cuda.memory_allocated()
    gc.collect()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return peak, held, before - held


def train_full_width(dev, arch: str, ckpt_root: str) -> dict:
    """The training main path at full width and depth through the
    launcher's ``run`` (its supervisor, pipeline and checkpoints), random
    weights from seed 0. roberta-large: a clean run, then the same run with
    a fault injected before its fourth step run, restored from the step-2
    checkpoint and replayed to the clean run's state within REPLAY_ATOL;
    then one step split into forward, backward and optimizer by its spans
    (:func:`traced_split`). llama3.2-1b:
    the same steps through ``build_train_step`` alone (its train state is
    15 GB a checkpoint)."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline, device_put_batch
    from repro_torch.kernels import bf16_split
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.optimizers import tree_leaves
    B, S, steps = TRAIN_RUNS[arch]
    cfg = get_config(arch)
    args = ["--arch", arch, "--batch", str(B), "--seq", str(S), "--steps", str(steps)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    if arch == "roberta-large":
        clean_dir = os.path.join(ckpt_root, "clean")
        state, sup = train.run(args + ["--ckpt-dir", clean_dir, "--ckpt-interval", str(steps)])
        history = sup.history
        shutil.rmtree(clean_dir)
    else:
        opt = make_optimizer(cfg.optimizer)
        state = train.init_state(cfg, opt, dev, seed=0)
        pipeline = SyntheticTokenPipeline(cfg, DataConfig(B, S))
        step = build_train_step(cfg, None, None, opt)
        history = []
        for i in range(steps):
            batch = device_put_batch(pipeline.batch_at(i), dev)
            if i == steps - 1:  # the last step's own peak, for phase (l)
                run_peak, held, freed = step_peak_start()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            m = {k: float(v) for k, v in m.items()}
            history.append({"step": i, "dt": time.perf_counter() - t1, **m})
        step_peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if arch == "roberta-large":
        run_peak = torch.cuda.max_memory_allocated()
    peak_gb = max(run_peak, torch.cuda.max_memory_allocated()) / 1e9
    n = train_counts()
    per_layer = _attn_layers(cfg)
    if n != {"forward": 2 * per_layer * steps, "backward": per_layer * steps, "serving_flash": 0}:
        raise AssertionError(f"(k) {arch}: {steps} steps launched {n}")
    # the loss head's backward on the tensor cores: one split a chunk a step
    split, chunks = bf16_split.split3.launches, loss_chunks(cfg, B, S)
    if split != chunks * steps:
        raise AssertionError(f"(k) {arch}: {steps} steps launched bf16_split3 {split} times, "
                             f"want {chunks} a step ({chunks * steps})")
    # each block's two norms forward and again in its recompute (full remat),
    # and the final norm; a backward launch for each
    norm_n, L = rmsnorm_counts(), cfg.num_layers
    want_norm = {"rmsnorm_fwd": (4 * L + 1) * steps, "rmsnorm_bwd": (2 * L + 1) * steps}
    if cfg.remat_policy != "full" or norm_n != want_norm:
        raise AssertionError(f"(k) {arch}: {steps} steps launched the norm kernels {norm_n}, "
                             f"want {want_norm} (remat {cfg.remat_policy})")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(k) {arch}: non-finite loss {losses}")
    step_s = sorted(h["dt"] for h in history[1:])[len(history[1:]) // 2]
    out = {"batch": B, "seq": S, "steps": steps, "layers": cfg.num_layers,
           "params": sum(p.numel() for p in tree_leaves(state["params"])),
           "step_s": step_s, "first_step_s": history[0]["dt"], "run_s": run_s,
           "tokens_per_s": B * S / step_s, "peak_gb": peak_gb, "losses": losses,
           "launches_per_step": per_layer, "forward_launches_per_step": 2 * per_layer,
           "launches": n["backward"], "forward_launches": n["forward"],
           "split_launches": split, "split_launches_per_step": chunks,
           "norm_launches": norm_n,
           "norm_launches_per_step": {k: v // steps for k, v in norm_n.items()}}
    extra = ""
    if arch == "roberta-large":
        reset_counts()
        faulty_dir = os.path.join(ckpt_root, "faulty")
        faulty, fsup = train.run(args + ["--ckpt-dir", faulty_dir, "--ckpt-interval", "2",
                                         "--fail-at", str(TRAIN_FAIL_AT)])
        shutil.rmtree(faulty_dir)
        torch.cuda.synchronize()
        gap = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(tree_leaves(state), tree_leaves(faulty)))
        replayed = [h["step"] for h in fsup.history]
        if not (fsup.n_restarts == 1 and gap <= REPLAY_ATOL):
            raise AssertionError(f"(k) {arch} crash replay: {fsup.n_restarts} restarts, "
                                 f"state gap {gap:.3e}")
        clean_loss = {h["step"]: h["loss"] for h in history}
        same_loss = all(h["loss"] == clean_loss[h["step"]] for h in fsup.history)
        out.update(replay_state_gap=gap, replayed_steps=replayed, restarts=fsup.n_restarts,
                   replay_losses_bit_equal=same_loss)
        del faulty
        opt = make_optimizer(cfg.optimizer)
        batch = device_put_batch(SyntheticTokenPipeline(cfg, DataConfig(B, S)).batch_at(0), dev)
        step = build_train_step(cfg, None, None, opt)
        _, held, freed = step_peak_start()
        out["split"] = traced_split(step, state, batch)
        step_peak = torch.cuda.max_memory_allocated()
        sp = out["split"]
        # each block's two norms forward and in its recompute, and the final norm
        if sp["norms"] != {"kernel": 4 * cfg.num_layers + 1}:
            raise AssertionError(f"(k) {arch}: a step's norms took the paths {sp['norms']}; "
                                 f"want {4 * cfg.num_layers + 1} on the kernel")
        extra = (f"; crash before step run {TRAIN_FAIL_AT}: restored the step-2 checkpoint, "
                 f"step runs {replayed}, final state within {gap:.3e} of the clean run's "
                 f"(atol {REPLAY_ATOL}), every step run's loss "
                 f"{'equal to' if same_loss else 'NOT bit-equal to'} the clean run's; one step split: forward {sp['forward_s']:.4f} s, backward "
                 f"{sp['backward_s']:.4f} s, optimizer {sp['optimizer_s']:.4f} s; its norms "
                 f"{sp['norms']}")
    out.update(step_peak_bytes=step_peak, step_held_bytes=held, step_gc_freed_bytes=freed)
    say(f"(k) training {arch} full width ({cfg.num_layers} layers, {out['params'] / 1e6:.1f}M "
        f"params, {cfg.optimizer}, B {B} x S {S}, {steps} steps"
        f"{' under TrainSupervisor' if arch == 'roberta-large' else ''}): median "
        f"{step_s:.4f} s/step (first {history[0]['dt']:.3f} s), {B * S / step_s:.0f} tokens/s, "
        f"peak {peak_gb:.2f} GB, run {run_s:.2f} s; loss "
        f"{' -> '.join(f'{x:.5f}' for x in losses)}; flash {per_layer} backward and "
        f"{2 * per_layer} tensor-core forward launches a step, bf16_split3 {split} launches "
        f"({chunks} a step), the norm kernels {norm_n} ({4 * L + 1} forward and "
        f"{2 * L + 1} backward a step){extra}")
    del state
    torch.cuda.empty_cache()
    return out


def training(dev) -> dict:
    """Phase (k). Returns the kernels-line row of the backward kernel."""
    import tempfile
    t0 = time.perf_counter()
    errs = check_backward_cases(dev)
    timing = {name: time_backward(dev, name) for name in TRAIN_ATTN}
    smoke_train_steps(dev)
    gate = {"roberta-large": bf16_gate(dev, "roberta-large", 2048),
            "llama3.2-1b": bf16_gate(dev, "llama3.2-1b", 1024)}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as ckpt:
        trained = {arch: train_full_width(dev, arch, ckpt) for arch in TRAIN_RUNS}
    say(f"(k) training: phase total {time.perf_counter() - t0:.2f} s")
    r = timing["roberta"]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:64",
            "launches": trained["roberta-large"]["launches"],
            "max_abs_err": errs["roberta"]["max_abs_err"],
            **{k: r[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "forward_ms", "forward_library_ms",
                                 "forward_bound_ms", "forward_bound_by", "split_ms")},
            "llama": {**timing["llama"], "max_abs_err": errs["llama"]["max_abs_err"]},
            "trained": trained, "bf16_train_step_gate": gate}


# (l) the dry run: the cells whose train_4k trace takes longest (tens of
# seconds on a CPU core: kimi-k2's 384 experts, jamba's 9 groups of 8
# blocks) are left to the CLI (``python -m repro_torch.launch.dryrun --arch
# all``), which runs every cell of both layouts
DRYRUN_CLI_ONLY = {("kimi-k2-1t-a32b", "train_4k"), ("jamba-1.5-large-398b", "train_4k")}
DRYRUN_GAP_GATE = 0.10  # trace vs allocator, either way
DRYRUN_FLOPS_RATIO = (0.75, 1.35)  # traced over analytic FLOPs, every traced cell
DRYRUN_OUT = os.path.join("out", "dryrun_l.jsonl")


def dry_run_layout(multi_pod: bool) -> list:
    """``run_cell`` over every assigned arch x shape but DRYRUN_CLI_ONLY on
    one production layout: the records, in order."""
    from repro_torch.configs import assigned_archs
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import SHAPES_BY_NAME
    return [run_cell(arch, name, multi_pod, verbose=False) for arch in assigned_archs()
            for name in SHAPES_BY_NAME if (arch, name) not in DRYRUN_CLI_ONLY]


def dry_run(dev, trained: dict) -> dict:
    """Phase (l). The dry run (``launch/dryrun.py``) of the two training
    steps of phase (k) on the card's own 1 x 1 layout at their batch and
    sequence, traced as every deep cell of the grid is (at 2 and 3 layer
    groups, extrapolated to the model's depth): the predicted bytes beside
    the step's own
    ``max_memory_allocated`` (the peak reset just before it), and the H100
    roofline's bound beside the step's seconds and its achieved MFU. Then
    ``run_cell`` over the production grid of both layouts (every assigned
    arch x shape but :data:`DRYRUN_CLI_ONLY`): each applicable cell traces,
    each skipped one gives the shape table's reason, and the records go to
    :data:`DRYRUN_OUT`. The two layouts run in two processes at once
    (:func:`dry_run_layout`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.config import SHAPES_BY_NAME, ShapeConfig, shape_applicable
    from repro_torch.parallel.roofline import H100

    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(dev).total_memory
    tag = f"[total_memory {total} B]"
    calib = {}
    for arch, t in trained.items():
        B, S = t["batch"], t["seq"]
        rec = run_cell(arch, "", False, verbose=False, mesh=make_local_mesh(1, 1),
                       shape=ShapeConfig(f"train_b{B}_s{S}", S, B, "train"))
        roof = rec["roofline"]
        pred, meas = rec["bytes_per_device"], t["step_peak_bytes"]
        gap = pred / meas - 1.0
        mfu = roof["model_flops_global"] / t["step_s"] / H100.peak_flops
        calib[arch] = {"predicted_bytes": pred, "measured_peak_bytes": meas,
                       "held_before_step_bytes": t["step_held_bytes"],
                       "gc_freed_bytes": t["step_gc_freed_bytes"], "gap": gap,
                       "arg_bytes": rec["arg_bytes"], "temp_bytes": rec["temp_bytes"],
                       "out_bytes": rec["out_bytes"], "t_bound_s": max(
                           roof["t_compute_s"], roof["t_memory_s"], roof["t_collective_s"]),
                       "bottleneck": roof["bottleneck"], "mfu_bound": roof["mfu_bound"],
                       "step_s": t["step_s"], "achieved_mfu": mfu,
                       "traced_over_analytic": rec["traced_over_analytic"],
                       "trace_s": rec["compile_s"] + rec["compile_unrolled_s"],
                       "extrapolated": rec["compile_unrolled_s"] > 0}
        c = calib[arch]
        how = "2 and 3 layer groups traced, extrapolated" if c["extrapolated"] else \
            "every layer traced"
        say(f"(l) dry run {arch} train B {B} x S {S} on a 1 x 1 layout ({how}, "
            f"{c['trace_s']:.1f} s): predicted {pred / 1e9:.3f} GB a device (arguments "
            f"{c['arg_bytes'] / 1e9:.3f}, temp {c['temp_bytes'] / 1e9:.3f}, outputs "
            f"{c['out_bytes'] / 1e9:.3f}) against the step's max_memory_allocated "
            f"{meas / 1e9:.3f} GB ({t['step_held_bytes'] / 1e9:.3f} GB held before it, after a "
            f"garbage collection that freed {t['step_gc_freed_bytes'] / 1e9:.3f} GB): "
            f"gap {gap * 100:+.2f} %; roofline t_bound {c['t_bound_s']:.4f} s "
            f"({c['bottleneck']}), mfu_bound {c['mfu_bound']:.3f}, against "
            f"{t['step_s']:.4f} s a step measured: achieved MFU {mfu:.4f} "
            f"({roof['model_flops_global']:.4e} model FLOPs at {H100.peak_flops:.3e} "
            f"FLOP/s); traced / analytic FLOPs {c['traced_over_analytic']:.4f} {tag}")
        if abs(gap) > DRYRUN_GAP_GATE:
            raise AssertionError(f"(l) {arch}: predicted {pred} B, measured {meas} B")

    os.makedirs(os.path.dirname(DRYRUN_OUT), exist_ok=True)
    grid = {}
    t1 = time.perf_counter()
    # the two layouts' cells in two processes at once (host work on meta
    # tensors; each traces rank 0 in a fake world of its own, no CUDA)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        layouts = [pool.submit(dry_run_layout, multi_pod) for multi_pod in (False, True)]
        records = [r for job in layouts for r in job.result()]
    with open(DRYRUN_OUT, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
            arch, name = rec["arch"], rec["shape"]
            ok, why = shape_applicable(get_config(arch), SHAPES_BY_NAME[name])
            if rec["status"] != ("ok" if ok else "skipped") or (
                    not ok and rec["reason"] != why):
                raise AssertionError(f"(l) {arch} x {name}: {rec}")
            if ok:
                r = rec["traced_over_analytic"]
                if not DRYRUN_FLOPS_RATIO[0] <= r <= DRYRUN_FLOPS_RATIO[1]:
                    raise AssertionError(f"(l) {arch} x {name} [{rec['mesh']}]: "
                                         f"traced / analytic FLOPs {r}")
            grid.setdefault(rec["mesh"], []).append(rec)
    grid_s = time.perf_counter() - t1
    summary = {}
    for mesh, recs in grid.items():
        ran = [r for r in recs if r["status"] == "ok"]
        bottlenecks = {}
        for r in ran:
            b = r["roofline"]["bottleneck"]
            bottlenecks[b] = bottlenecks.get(b, 0) + 1
        summary[mesh] = {"cells": len(ran), "skipped": len(recs) - len(ran),
                         "fit": sum(r["fits_hbm"] is True for r in ran),
                         "bottlenecks": bottlenecks,
                         "not_fitting": [f"{r['arch']} x {r['shape']}" for r in ran
                                         if r["fits_hbm"] is False],
                         "unresolved": [f"{r['arch']} x {r['shape']}" for r in ran
                                        if r["fits_hbm"] is None]}
        m = summary[mesh]
        say(f"(l) dry-run grid {mesh}: {m['cells']} cells traced, {m['skipped']} skipped "
            f"(the shape table's reasons), {m['fit']} fit {H100.hbm_bytes / 1e9:.0f} GB a "
            f"device; bottlenecks {bottlenecks}; not fitting: "
            f"{', '.join(m['not_fitting']) or 'none'}; unresolved (fits_hbm null): "
            f"{len(m['unresolved'])} {m['unresolved'] or ''} {tag}")
    say(f"(l) dry run: grid {grid_s:.2f} s, phase total {time.perf_counter() - t0:.2f} s "
        f"(records in {DRYRUN_OUT}; {sorted(DRYRUN_CLI_ONLY)} by the CLI)")
    return {"calibration": calib, "grid": summary}


# (m) the sharded step on the card: a 1 x 1 DeviceMesh over NCCL. The card
# has one GPU and NCCL puts no two ranks on one device, so the sharded code
# path is proven here to launch the hand kernels, compute what the plain
# step computes, and cost no more; the sharded numbers themselves are held
# to JAX on the CPU (tests/test_torch_sharded.py). (arch, B, S) of the
# training steps, as phase (k) trains them
SHARDED_TRAIN = {"llama3.2-1b": (8, 1024), "roberta-large": (32, 2048)}
SHARDED_TURNS, SHARDED_STEPS = 3, 3  # alternating turns of steps, each way
SHARDED_TRAIN_GATE = 1.10  # the sharded step's median time over the plain one's
# (arch, layers served (None: all), requests, prompt tokens, new tokens);
# kimi-k2 decodes token-routed (its decode rules)
SHARDED_SERVE = [("llama3.2-1b", None, 8, 1024, 128), ("kimi-k2-1t-a32b", 1, 8, 1024, 32)]
SHARDED_DECODE_GATE = 1.20  # the sharded engine's decode ms a step over the plain one's
# the decode timing: SHARDED_TIME_STEPS decode steps each way, the two
# engines' steps alternating one by one (ServeEngine.stream, each step timed
# alone between synchronizations; plain first on even steps, sharded first
# on odd ones; a new stream, after a prefill that is not timed, whenever the
# cache is full); the gate reads the medians
SHARDED_TIME_STEPS = 96
# decode_attention_lse against its plain version: the main-path decode shape
# (B 8, cache_len(1152) = 1536 slots, llama's 32/8 heads, hd 64), no valid
# slot, a slice starting mid-cache (slots 768.. of the same cache, 332 of
# them valid), hd 128 and hd 96: (B, T, H, KV, hd, valid_len, slot offset)
LSE_CASES = [(8, 1536, 32, 8, 64, 1100, 0), (8, 1536, 32, 8, 64, 0, 0),
             (8, 1536, 32, 8, 64, 332, 768), (8, 1536, 32, 8, 128, 1100, 0),
             (4, 1024, 16, 4, 96, 700, 0)]


def check_decode_lse(dev) -> dict:
    """decode_attention_lse against its plain version at LSE_CASES (the
    output within the bf16 attention tolerance, the log-sum-exp within
    LSE_TOL; no valid slot: 0 and -inf on both), the merge of the main-path
    cache's two halves by their log-sum-exps against the whole cache's
    decode kernel, and its timing at the main-path shape beside the plain
    version and decode_attention's."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dec
    rng = np.random.default_rng(11)
    err = 0.0
    for B, T, H, KV, hd, vl, off in LSE_CASES:
        q = randn(rng, (B, H, hd), "bfloat16", dev)
        k, v = (randn(rng, (B, off + T, KV, hd), "bfloat16", dev)[:, off:] for _ in range(2))
        label = f"(m) decode_attention_lse B={B} T={T} H={H} KV={KV} hd={hd} valid_len={vl}"
        (o, lse), (po, plse) = (dec.decode_attention_lse(q, k, v, vl),
                                dec.decode_attention_lse_plain(q, k, v, vl))
        torch.cuda.synchronize()
        if vl == 0:
            if not ((o == 0).all() and torch.isneginf(lse).all() and torch.isneginf(plse).all()):
                raise AssertionError(f"{label}: not 0 and -inf")
            continue
        err = max(err, compare_close(o, po, ATTN_TOL["bfloat16"], label))
        gap = float((lse - plse).abs().max())
        if not gap <= LSE_TOL:
            raise AssertionError(f"{label}: log-sum-exp gap {gap:.3e} > {LSE_TOL}")
    B, T, H, KV, hd, vl, _ = LSE_CASES[0]
    sets = [tuple(randn(rng, s, "bfloat16", dev) for s in ((B, H, hd), (B, T, KV, hd),
                                                            (B, T, KV, hd)))
            for _ in range(DECODE_SETS)]
    q, k, v = sets[0]
    half = T // 2
    parts = [dec.decode_attention_lse(q, k[:, a:a + half], v[:, a:a + half],
                                      min(max(vl - a, 0), half)) for a in (0, half)]
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(lse - m)[..., None] for _, lse in parts]
    merged = (sum(wi * o.float() for wi, (o, _) in zip(w, parts)) / sum(w)).to(q.dtype)
    merge_err = compare_close(merged, dec.decode_attention(q, k, v, vl), ATTN_TOL["bfloat16"],
                              "(m) two cache halves merged by log-sum-exp vs the whole cache")
    # the library call: flex_attention with the valid-length block mask and
    # its log-sum-exp, held against the plain version as the kernel is
    po, plse = dec.decode_attention_lse_plain(q, k, v, vl)
    lib_sets = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)) for q, k, v in sets]
    flex = flex_library(0.0, valid_len=vl, Sq=1, Skv=T, dev=dev, lse=True)
    fo, flse = flex(*lib_sets[0])
    flex_err = compare_close(fo[:, :, 0], po, ATTN_TOL["bfloat16"],
                             "(m) flex_attention with its log-sum-exp at the main-path decode")
    flex_lse_gap = float((flse[:, :, 0].float() - plse).abs().max())
    if not flex_lse_gap <= LSE_TOL:
        raise AssertionError(f"(m) flex_attention's log-sum-exp gap {flex_lse_gap:.3e} > "
                             f"{LSE_TOL}")
    row = dict(
        ms=device_ms([lambda s=s: dec.decode_attention_lse(*s, vl) for s in sets], calls=64),
        decode_ms=device_ms([lambda s=s: dec.decode_attention(*s, vl) for s in sets],
                            calls=64),
        plain_ms=device_ms([lambda s=s: dec.decode_attention_lse_plain(*s, vl)
                            for s in sets], calls=8),
        library_ms=device_ms([lambda s=s: flex(*s) for s in lib_sets], calls=64),
        max_abs_err=err, merge_err=merge_err, library_err=flex_err,
        library_lse_gap=flex_lse_gap)
    nbytes = 2 * (2 * B * vl * KV * hd + 2 * B * H * hd) + 4 * B * H  # + the lse
    row["bound_ms"], row["bound_by"] = bound_ms(4 * B * H * hd * vl, nbytes)
    say(f"(m) kernel decode_attention_lse B={B} T={T} H={H} KV={KV} hd={hd} valid_len={vl} "
        f"bf16: device {row['ms']:.5f} ms (decode_attention {row['decode_ms']:.5f} ms, plain "
        f"version {row['plain_ms']:.5f} ms, flex_attention with its log-sum-exp "
        f"{row['library_ms']:.5f} ms (gap {flex_err:.3e}, lse {flex_lse_gap:.3e}); bound "
        f"{row['bound_ms']:.5f} ms by {row['bound_by']}); {len(LSE_CASES)} shapes against "
        f"the plain version: max abs gap "
        f"{err:.3e}, lse within {LSE_TOL}; two halves merged vs the whole cache "
        f"{merge_err:.3e}")
    return row


def sharded_train(dev, mesh, arch: str, shape=None, turns: int = SHARDED_TURNS,
                  steps: int = SHARDED_STEPS, gate=SHARDED_TRAIN_GATE,
                  tag: str = "(m)") -> dict:
    """One arch's training step at full width, plain and over the 1 x 1
    mesh, from one state (the sharded state wraps the plain state's
    tensors): ``turns`` turns of ``steps`` steps each way, plain first, on
    the same batches, at ``shape`` = (B, S) (SHARDED_TRAIN's by default).
    The first turns' losses, grad norms, new states and kernel launches
    must be equal; the median step time over the turns is gated at
    ``gate`` x the plain step's (None: printed, not gated)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline, device_put_batch
    from repro_torch.launch.inputs import make_rules
    from repro_torch.launch.mesh import layout_of
    from repro_torch.launch.steps import build_train_step, init_state, state_specs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.param import distribute
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.optimizers import tree_leaves, tree_unflatten
    B, S = shape or SHARDED_TRAIN[arch]
    cfg = get_config(arch)
    opt = make_optimizer(cfg.optimizer)
    rules = make_rules(cfg, ShapeConfig("t", S, B, "train"), layout_of(mesh))
    state = init_state(cfg, opt, dev, seed=0)
    specs = state_specs(cfg, mesh, rules, opt)
    wrapped = {k: tree_unflatten(state[k], [distribute(x, sp, mesh) for x, sp in zip(
        tree_leaves(state[k]), tree_leaves(specs[k]))]) for k in state}
    pipeline = SyntheticTokenPipeline(cfg, DataConfig(B, S))
    batches = [pipeline.batch_at(i) for i in range(steps)]
    ways = {"plain": (build_train_step(cfg, None, None, opt), state,
                      [device_put_batch(b, dev) for b in batches]),
            "sharded": (build_train_step(cfg, mesh, rules, opt), wrapped,
                        [device_put_batch(b, dev, mesh, rules) for b in batches])}
    del state, wrapped  # the ways hold the first state until their first step
    times = {way: [] for way in ways}
    first = {}
    for turn in range(turns):
        for way in list(ways):
            step, st, placed = ways[way]
            ways[way] = None  # each old state goes as soon as its step has run
            reset_counts()
            metrics = []
            for b in placed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, m = step(st, b)
                metrics.append({k: float(v) for k, v in m.items()})
                times[way].append(time.perf_counter() - t0)
            ways[way] = (step, st, placed)
            if turn == 0:
                first[way] = (metrics, {**train_counts(), **rmsnorm_counts()})
        if turn == 0:  # both ways took the same steps from the same state
            gap = max(float((a.float() - b.to_local().float()).abs().max()) for a, b in zip(
                tree_leaves(ways["plain"][1]), tree_leaves(ways["sharded"][1])))
            (pm, pc), (sm, sc) = first["plain"], first["sharded"]
            if pm != sm or gap != 0.0:
                raise AssertionError(f"{tag} {arch}: the 1 x 1 sharded steps differ from the "
                                     f"plain steps: {sm} vs {pm}, state gap {gap:.3e}")
            if pc != sc or not sc["rmsnorm_bwd"]:
                raise AssertionError(f"{tag} {arch}: kernel launches {sc} vs the plain "
                                     f"steps' {pc}")
    med = {way: sorted(t)[len(t) // 2] for way, t in times.items()}
    ratio = med["sharded"] / med["plain"]
    say(f"{tag} training {arch} B {B} x S {S} on a 1 x 1 DeviceMesh (NCCL): {steps} "
        f"steps' losses, grad norms and states equal to the plain steps' (loss "
        f"{' -> '.join('%.6f' % x['loss'] for x in sm)}, grad norm "
        f"{' -> '.join('%.6f' % x['grad_norm'] for x in sm)}), kernel launches {sc}; median "
        f"step {med['sharded']:.4f} s vs plain {med['plain']:.4f} s over {turns} "
        f"alternating turns of {steps}: ratio {ratio:.4f}")
    if gate is not None and ratio > gate:
        raise AssertionError(f"{tag} {arch}: sharded step {ratio:.4f} x the plain step's "
                             f"> {gate}")
    del ways, first
    torch.cuda.empty_cache()
    return {"batch": B, "seq": S, "step_s": med["sharded"], "plain_step_s": med["plain"],
            "ratio": ratio, "launches": sc, "loss": sm[0]["loss"],
            "grad_norm": sm[0]["grad_norm"]}


def quartiles(xs) -> str:
    """The lower and upper quartiles of ``xs``, as 'q1-q3'."""
    import statistics
    q = statistics.quantiles(xs, n=4)
    return f"{q[0]:.3f}-{q[2]:.3f}"


def sharded_serve(dev, mesh, arch: str, layers, B: int, S: int, n_out: int) -> dict:
    """The sharded ServeEngine over the 1 x 1 mesh against the plain engine
    on the same weights (drawn once): identical tokens over ``n_out`` new
    tokens, every decode launch through decode_attention_lse (none through
    decode_attention), then the decode ms of SHARDED_TIME_STEPS steps of
    each, alternating step by step, the sharded one's median gated at
    SHARDED_DECODE_GATE x the plain one's."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.launch.steps import to_local
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    sharded = ServeEngine(cfg, S + n_out, B, device=dev, mesh=mesh)
    plain = ServeEngine(cfg, S + n_out, B, device=dev, params=to_local(sharded.params))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    reset_counts()
    want = plain.generate(toks, n_out)
    plain_launches, plain_norms = counts()["decode_attention"], rmsnorm_counts()
    reset_counts()
    got = sharded.generate(toks, n_out)
    lse_launches = dec.decode_attention_lse.launches
    if rmsnorm_counts() != plain_norms or not plain_norms["rmsnorm_fwd"]:
        raise AssertionError(f"(m) {arch}: the sharded engine's norm launches "
                             f"{rmsnorm_counts()}, the plain engine's {plain_norms}")
    if not np.array_equal(got, want):
        raise AssertionError(f"(m) {arch}: the sharded engine's tokens differ from the "
                             f"plain engine's at {int((got != want).sum())} places")
    if counts()["decode_attention"] or lse_launches != plain_launches:
        raise AssertionError(f"(m) {arch}: sharded decode launched decode_attention "
                             f"{counts()['decode_attention']} and decode_attention_lse "
                             f"{lse_launches} times; the plain engine {plain_launches}")

    engines = {"plain": plain, "sharded": sharded}
    ms = {way: [] for way in engines}
    while len(ms["plain"]) < SHARDED_TIME_STEPS:
        n = min(n_out, SHARDED_TIME_STEPS - len(ms["plain"]))
        streams = {way: eng.stream(toks, n) for way, eng in engines.items()}
        for it in streams.values():
            next(it)  # the prefill and its token
        for _ in range(n):  # each next token runs one decode step
            for way in (("plain", "sharded") if len(ms["plain"]) % 2 == 0
                        else ("sharded", "plain")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                next(streams[way], None)
                torch.cuda.synchronize()
                ms[way].append((time.perf_counter() - t0) * 1e3)
        del streams
    med = {way: statistics.median(v) for way, v in ms.items()}
    ratio = med["sharded"] / med["plain"]
    say(f"(m) serving {arch} ({cfg.num_layers} layers) {B} x {S} + {n_out} on a 1 x 1 "
        f"DeviceMesh: tokens identical to the plain engine's, {lse_launches} decode launches "
        f"all through decode_attention_lse; median decode {med['sharded']:.3f} ms a step vs "
        f"plain {med['plain']:.3f} ms over {SHARDED_TIME_STEPS} steps each way, alternating "
        f"step by step (quartiles sharded {quartiles(ms['sharded'])}, plain "
        f"{quartiles(ms['plain'])}): ratio {ratio:.4f}")
    if ratio > SHARDED_DECODE_GATE:
        raise AssertionError(f"(m) {arch}: sharded decode {ratio:.4f} x the plain one's > "
                             f"{SHARDED_DECODE_GATE}")
    del sharded, plain
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "decode_ms": med["sharded"],
            "plain_decode_ms": med["plain"], "ratio": ratio, "lse_launches": lse_launches}


def sharded_step(dev) -> dict:
    """Phase (m): a 1 x 1 DeviceMesh over NCCL (a world of one process),
    decode_attention_lse against its plain version, the sharded training
    steps of SHARDED_TRAIN and the sharded engines of SHARDED_SERVE against
    the plain ones, and the collectives one sharded step issues (none on
    one rank: every group has one member). Returns the kernels-line row of
    decode_attention_lse."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline, device_put_batch
    from repro_torch.launch.inputs import make_rules
    from repro_torch.launch.mesh import layout_of, make_device_mesh
    from repro_torch.launch.steps import build_train_step, init_state
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel.collectives import CollectiveCounter
    t0 = time.perf_counter()
    mesh = make_device_mesh(1, 1, "cuda")
    try:
        row = check_decode_lse(dev)
        trained = {arch: sharded_train(dev, mesh, arch) for arch in SHARDED_TRAIN}
        served = {arch: sharded_serve(dev, mesh, arch, layers, B, S, n)
                  for arch, layers, B, S, n in SHARDED_SERVE}
        cfg = get_config("llama3.2-1b").replace(num_layers=2)
        opt = make_optimizer(cfg.optimizer)
        rules = make_rules(cfg, ShapeConfig("t", 1024, 8, "train"), layout_of(mesh))
        batch = device_put_batch(SyntheticTokenPipeline(cfg, DataConfig(8, 1024)).batch_at(0),
                                 dev, mesh, rules)
        with CollectiveCounter() as counter:
            build_train_step(cfg, mesh, rules, opt)(
                init_state(cfg, opt, dev, mesh=mesh, rules=rules), batch)
        comm = {str(k): v for k, v in counter.get_comm_counts().items()}
        say(f"(m) CommDebugMode of one sharded llama3.2-1b train step (2 layers) on the "
            f"1 x 1 mesh: {comm or 'no collective'} (every group has one rank)")
    finally:
        dist.destroy_process_group()
    say(f"(m) the sharded step on the card: phase total {time.perf_counter() - t0:.2f} s")
    return {"name": "decode_attention_lse", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:28",
            "launches": served["llama3.2-1b"]["lse_launches"],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_err", "library_lse_gap",
                                   "decode_ms", "merge_err")},
            "trained": trained, "served": served, "comm_counts": comm}


# (n) the sharded step's second half on the card, on a 1 x 1 DeviceMesh over
# NCCL as in (m): decode_attention_lse at the ring caches that a sequence
# split hands it, and the sharded engines and train step of the block kinds
# (m) does not run, each against its plain twin. The ring shapes: (B, W, H,
# KV, hd, softcap) of gemma2-9b's LOCAL blocks (the CUDA-core instance at hd
# 256, softcap 50) and mixtral-8x7b's (hd 128); each ring is also cut into
# RING_SLICES slices merged by log-sum-exp, RING_VALID of its slots valid
# (slices of 1024, 1024, 952 and 0 valid slots)
RING_LSE_CASES = {"gemma2": (4, 4096, 16, 8, 256, 50.0), "mixtral": (4, 4096, 32, 8, 128, 0.0)}
RING_SLICES, RING_VALID = 4, 3000
# (arch, layers (None: all), requests, prompt tokens, new tokens): the
# serving table's batch, prompt and depth ((h), (i), (j)), 16 new tokens
SHARDED_SERVE_N = [("gemma2-9b", None, 4, 4160, 16), ("whisper-base", None, 8, 32, 16),
                   ("mamba2-370m", None, 8, 1024, 16)]
SHARDED_TRAIN_N = ("mamba2-370m", 8, 1024)  # (arch, B, S): one step each way


def check_ring_lse(dev) -> dict:
    """decode_attention_lse at RING_LSE_CASES against its plain version
    (every slot valid: the output within the bf16 attention tolerance, the
    log-sum-exp within LSE_TOL), the ring cut into RING_SLICES slices merged
    by their log-sum-exps (merge_partials' formula; one slice with no valid
    slot: 0 and -inf) against the whole ring's decode kernel at RING_VALID,
    and its device time beside the plain version's and flex_attention's
    with its log-sum-exp. Returns a row a case."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dec
    rng = np.random.default_rng(13)
    rows = {}
    for name, (B, W, H, KV, hd, cap) in RING_LSE_CASES.items():
        label = f"(n) decode_attention_lse {name} ring B={B} W={W} H={H} KV={KV} hd={hd} " \
                f"softcap={cap:g}"
        sets = [tuple(randn(rng, s, "bfloat16", dev) for s in ((B, H, hd), (B, W, KV, hd),
                                                                (B, W, KV, hd)))
                for _ in range(DECODE_SETS)]
        q, k, v = sets[0]
        (o, lse), (po, plse) = (dec.decode_attention_lse(q, k, v, W, softcap=cap),
                                dec.decode_attention_lse_plain(q, k, v, W, softcap=cap))
        err = compare_close(o, po, ATTN_TOL["bfloat16"], label)
        gap = float((lse - plse).abs().max())
        if not gap <= LSE_TOL:
            raise AssertionError(f"{label}: log-sum-exp gap {gap:.3e} > {LSE_TOL}")
        n = W // RING_SLICES
        parts = [dec.decode_attention_lse(q, k[:, a:a + n], v[:, a:a + n],
                                          min(max(RING_VALID - a, 0), n), softcap=cap)
                 for a in range(0, W, n)]
        empty = [i for i, a in enumerate(range(0, W, n)) if RING_VALID <= a]
        if not empty or not all((parts[i][0] == 0).all() and torch.isneginf(parts[i][1]).all()
                                for i in empty):
            raise AssertionError(f"{label}: a slice with no valid slot is not 0 and -inf")
        m = torch.stack([lse for _, lse in parts]).amax(dim=0)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        w = [torch.exp(lse - m)[..., None] for _, lse in parts]
        merged = (sum(wi * oi.float() for wi, (oi, _) in zip(w, parts)) / sum(w)).to(q.dtype)
        merge_err = compare_close(merged, dec.decode_attention(q, k, v, RING_VALID, softcap=cap),
                                  ATTN_TOL["bfloat16"],
                                  f"{label}: {RING_SLICES} slices merged vs the whole ring")
        flex = flex_library(cap, valid_len=W, Sq=1, Skv=W, dev=dev, lse=True)
        lib_sets = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)) for q, k, v in sets]
        fo, flse = flex(*lib_sets[0])
        flex_err = compare_close(fo[:, :, 0], po, ATTN_TOL["bfloat16"],
                                 f"{label}: flex_attention with its log-sum-exp")
        row = dict(
            ms=device_ms([lambda s=s: dec.decode_attention_lse(*s, W, softcap=cap)
                          for s in sets], calls=64),
            plain_ms=device_ms([lambda s=s: dec.decode_attention_lse_plain(*s, W, softcap=cap)
                                for s in sets], calls=8),
            library_ms=device_ms([lambda s=s: flex(*s) for s in lib_sets], calls=64),
            max_abs_err=err, lse_gap=gap, merge_err=merge_err, library_err=flex_err,
            variant=dec.kernel_variant(q.dtype, hd))
        nbytes = 2 * (2 * B * W * KV * hd + 2 * B * H * hd) + 4 * B * H  # + the lse
        row["bound_ms"], row["bound_by"] = bound_ms(4 * B * H * hd * W, nbytes)
        rows[name] = row
        say(f"{label} bf16 ({row['variant']}): device {row['ms']:.5f} ms (plain version "
            f"{row['plain_ms']:.5f} ms, flex_attention with its log-sum-exp "
            f"{row['library_ms']:.5f} ms, gap {flex_err:.3e}; bound {row['bound_ms']:.5f} ms "
            f"by {row['bound_by']}); against the plain version max abs gap {err:.3e}, lse gap "
            f"{gap:.3e}; {RING_SLICES} slices of {n} ({RING_VALID} valid) merged vs the whole "
            f"ring {merge_err:.3e}")
        del sets, lib_sets, q, k, v, parts
    torch.cuda.empty_cache()
    return rows


def launch_tally() -> dict:
    """Every attention wrapper's launches by variant, now."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    return {fn.__name__: dict(fn.launches_by_variant)
            for fn in (fa.flash_attention, fa.flash_attention_lse, dec.decode_attention,
                       dec.decode_attention_lse)}


def sharded_serve_pair(dev, mesh, arch: str, layers, B: int, S: int, n_out: int) -> dict:
    """The sharded ServeEngine over the 1 x 1 mesh and the plain engine on
    the same weights, their ServeEngine.streams stepped alternately (the
    prefills, then each decode step timed alone between synchronizations):
    identical tokens, and equal launches by kernel and variant (the flash
    kernel's; the decode kernel's, the sharded engine's self attention
    through decode_attention_lse and its cross attention through
    decode_attention). Prints the decode ms a step each way and their
    ratio, not gated."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.launch.steps import to_local
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    sharded = ServeEngine(cfg, S + n_out, B, device=dev, mesh=mesh)
    plain = ServeEngine(cfg, S + n_out, B, device=dev, params=to_local(sharded.params))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    extra = {}
    if cfg.is_encoder_decoder:
        extra["enc_embeds"] = randn(rng, (B, ENCODER_LEN[arch], cfg.d_model), "bfloat16", dev)
    engines = {"plain": plain, "sharded": sharded}
    streams = {way: eng.stream(toks, n_out, extra) for way, eng in engines.items()}
    tally = {way: {} for way in engines}
    tokens = {way: [] for way in engines}
    ms = {way: [] for way in engines}

    def step(way):
        before = launch_tally()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = next(streams[way], None)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        for fn, by in launch_tally().items():
            for variant, n in by.items():
                key = (fn, variant)
                tally[way][key] = tally[way].get(key, 0) + n - before[fn][variant]
        if tok is not None:
            tokens[way].append(tok.cpu().numpy())
        return dt

    for way in engines:
        step(way)  # the prefill and its token
    for i in range(n_out):  # each next token runs one decode step
        for way in (("plain", "sharded") if i % 2 == 0 else ("sharded", "plain")):
            ms[way].append(step(way))
    got, want = (np.concatenate(tokens[w], axis=1) for w in ("sharded", "plain"))
    if got.shape != (B, n_out) or not np.array_equal(got, want):
        raise AssertionError(f"(n) {arch}: the sharded engine's tokens differ from the plain "
                             f"engine's at {int((got != want).sum())} places")

    def by_kernel(t, name):
        return {var: sum(n for (fn, v), n in t.items() if v == var and fn.startswith(name))
                for var in ("tensor_core", "cuda_core")}

    plain_t, shard_t = tally["plain"], tally["sharded"]
    for name in ("flash_attention", "decode_attention"):
        if by_kernel(shard_t, name) != by_kernel(plain_t, name):
            raise AssertionError(f"(n) {arch}: {name} launches by variant "
                                 f"{by_kernel(shard_t, name)} vs the plain engine's "
                                 f"{by_kernel(plain_t, name)}")
    lse = sum(n for (fn, _), n in shard_t.items() if fn == "decode_attention_lse")
    plain_lse = sum(n for (fn, _), n in plain_t.items() if fn == "decode_attention_lse")
    attends = cfg.num_layers and any(k != "mamba" for k in cfg.pattern)
    if plain_lse or (attends and not lse) or (not attends and any(shard_t.values())):
        raise AssertionError(f"(n) {arch}: launches {shard_t} vs the plain engine's {plain_t}")
    med = {way: statistics.median(v) for way, v in ms.items()}
    ratio = med["sharded"] / med["plain"]
    nonzero = {f"{fn}/{v}": n for (fn, v), n in sorted(shard_t.items()) if n}
    say(f"(n) serving {arch} ({cfg.num_layers} layers) {B} x {S}"
        f"{f' (+ {ENCODER_LEN[arch]} encoder positions)' if extra else ''} + {n_out} on a 1 x 1 "
        f"DeviceMesh: tokens identical to the plain engine's; launches by kernel and variant "
        f"equal ({f'{nonzero}; the sharded self-attention decode through decode_attention_lse' if attends else 'no attention kernel either way'}); "
        f"decode {med['sharded']:.3f} ms a step vs plain "
        f"{med['plain']:.3f} ms (medians of {n_out} steps each way, alternating): ratio "
        f"{ratio:.4f}")
    del sharded, plain, engines, streams
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "decode_ms": med["sharded"],
            "plain_decode_ms": med["plain"], "ratio": ratio, "lse_launches": lse,
            "launches": nonzero}


def sharded_second_half(dev) -> dict:
    """Phase (n): a 1 x 1 DeviceMesh over NCCL (a world of one process),
    decode_attention_lse at the ring shapes (check_ring_lse), the sharded
    engines of SHARDED_SERVE_N against the plain ones, and mamba2-370m's
    sharded train step against the plain one (bit-equal, one step each
    way, not timed against a gate)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    t0 = time.perf_counter()
    mesh = make_device_mesh(1, 1, "cuda")
    try:
        ring = check_ring_lse(dev)
        served = {arch: sharded_serve_pair(dev, mesh, arch, layers, B, S, n)
                  for arch, layers, B, S, n in SHARDED_SERVE_N}
        arch, B, S = SHARDED_TRAIN_N
        trained = sharded_train(dev, mesh, arch, (B, S), turns=1, steps=1, gate=None,
                                tag="(n)")
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    say(f"(n) the sharded step's second half on the card: phase total {seconds:.2f} s")
    return {"ring": ring, "served": served, "trained": {arch: trained}, "seconds": seconds}


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
    loss_head_row = check_loss_head(dev)
    rmsnorm_row = check_rmsnorm(dev)

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

    # 6h-j. the paper's dense decoders and gemma2, the MoE, Mamba2/SSD and
    # hybrid decoders, then the encoders and the vision stub, at full width
    t0 = time.perf_counter()
    served = serve_full_width(dev)
    say(f"(h, i, j) full-width models: phase total {time.perf_counter() - t0:.2f} s")

    # 7. the attention kernels at the serving main-path shapes, and at the
    # shapes of phases (h), (i) and (j)
    attn = time_attention(dev)

    # 8. (k) training: the backward kernel, the train step of every arch card
    # vs CPU, the bf16 gate, roberta-large and llama3.2-1b at full width
    train_row = training(dev)

    # 9. (l) the dry run: the two training steps' predicted bytes and
    # roofline against the card, then the production grid
    dry_run(dev, train_row["trained"])

    # 10. (m) the sharded step on a 1 x 1 DeviceMesh over NCCL
    lse_row = sharded_step(dev)

    # 11. (n) its second half: the ring caches' decode_attention_lse, the SSD,
    # sliding-window and cross-attention engines and mamba2-370m's training
    second = sharded_second_half(dev)
    lse_row["ring"] = second["ring"]
    lse_row["served_second_half"] = second["served"]
    lse_row["trained_second_half"] = second["trained"]

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
                        "served": {arch: {"layers": v["layers"], "launches": v[row["name"]],
                                          "by_variant": v["by_variant"][row["name"].split("_")[0]]}
                                   for arch, v in served.items()},
                        **{k: v for k, v in row.items() if isinstance(v, dict)}})
    kernels.append(train_row)
    kernels.append(lse_row)
    split_run = train_row["trained"]["roberta-large"]
    kernels.append({**loss_head_row, "launches": split_run["split_launches"],
                    "launches_per_step": split_run["split_launches_per_step"],
                    "llama_launches": train_row["trained"]["llama3.2-1b"]["split_launches"]})
    kernels.append({**rmsnorm_row, "norms": {
        "roberta-large train step": split_run["split"]["norms"],
        **{f"{arch} prefill": served[arch]["norms"] for arch in CELL_NORMS}},
        "launches": split_run["norm_launches"],
        "launches_per_step": split_run["norm_launches_per_step"],
        "prefill_launches": {arch: served[arch]["norm_launches"] for arch in CELL_NORMS}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
