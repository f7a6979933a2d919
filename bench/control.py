#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, at a cell's own
size, several seeds in one process (the benchmark's own runs never run
this):

* ``program``: the program's outputs on the sample a run compares (a
  prefill cell's sampled requests through the timed path's entry; a train
  cell's set-up steps), held against the float32 reference;
* ``fp8``: the control, the reference at the precision one step below
  the configurations' bf16 put in the program's place;
* each ``--faults`` entry: the reference with that fault planted, in the
  program's place (``half_batch``, ``unchanged`` for training).

    python3 bench/control.py --workload roberta.train --seeds 11,12,13 \\
        --control-seeds 11,12,13 --faults half_batch --out build/ctl.jsonl

Each reading is one JSON line on standard output and in ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(run, seed: int, mode: str, fault: str = "") -> dict:
    """One seed's readings of the program (``mode`` "program") or of the
    reference at ``mode``'s precision in its place."""
    import torch

    from bench.record import Record
    run.seed, run.record = seed, Record()
    t0 = time.time()
    st = run.driver.setup(run)
    if mode == "program":
        run.driver.outputs(run, st)
    else:
        run.driver.control_outputs(run, st, mode, fault)
    out = run.driver.check(run, st)
    del st
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"workload": run.name, "seed": seed, "mode": mode, "fault": fault,
            "seconds": time.time() - t0, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import run as bench_run
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    run = bench_run.load_run(manifest, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    jobs = [(s, "program", "") for s in seeds] + [(s, "fp8", "") for s in ctl]
    jobs += [(s, "float32", f) for f in args.faults.split(",") if f for s in ctl]
    sink = open(args.out, "a") if args.out else None
    try:
        for seed, mode, fault in jobs:
            line = json.dumps(readings(run, seed, mode, fault))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
