"""A cell of the manifest at smoke width on the CPU, for the benchmark's own
tests: the same files, drivers and reference, every size cut small."""

from __future__ import annotations

import json
import time

from bench import run as bench_run

SMOKE = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             head_dim=16, intermediate_size=128, vocab_size=256)
TRAFFIC = {
    "neox20b.prefill": dict(prompt_lengths=[16, 24, 32], max_len=33, max_requests=400,
                            sample={"requests": 3, "longest": 1, "within": 6}),
    "roberta.train": dict(batch=4, seq=32, reference_micro_batch=2),
}


def manifest() -> dict:
    return json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())


def small_run(name: str, seed: int = 2**31 + 17, dtype: str = "", man: dict = None):
    """The cell ``name`` at smoke width on the CPU (``dtype`` overrides the
    configuration's compute dtype)."""
    run = bench_run.load_run(man or manifest(), name)
    run.cfg.update(SMOKE)
    if "mask_token_id" in run.cfg:
        run.cfg["mask_token_id"] = SMOKE["vocab_size"] - 1
    if dtype:
        run.cfg["torch_dtype"] = dtype
    run.traffic.update(TRAFFIC.get(name, {}))
    run.device, run.seed = "cpu", seed
    return run


def execute(run, seconds: float = 1.0, trace: bool = False) -> dict:
    return bench_run.execute(run, seconds, trace, time.time())
