"""A later change adds a configuration, a traffic mix, a cell and a metric as
new files and new manifest entries, and edits no file the benchmark has:
the harness finds each by its name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from bench import run as bench_run
from bench import testing

ROOT = bench_run.ROOT


def digest(folder):
    return {p.relative_to(folder).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_files_added_by_name_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "bench")
    b = tmp_path / "bench"

    cfg = json.loads((b / "configs" / "gpt-neox-20b.json").read_text())
    cfg.update(testing.SMOKE, name="neox-tiny")
    (b / "configs" / "neox-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "prefill_1k_2k.json").read_text())
    traffic.update(testing.TRAFFIC["neox20b.prefill"], prompt_lengths=[8, 12])
    (b / "traffic" / "prefill_tiny.json").write_text(json.dumps(traffic))
    (b / "cells" / "tiny.prefill.json").write_text(json.dumps(
        {"limits": {"logits_rel": {"limit": 0.05}, "token_excess": {"limit": 0}}}))
    (b / "metrics" / "ttft_max_ms.py").write_text(
        "def read(rec, run):\n"
        "    return max((c.done - c.dispatched) * 1e3 for c in rec.completions)\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "neox-tiny", "source": cfg["source"],
                           "file": "bench/configs/neox-tiny.json", "reduced": cfg["reduced"]})
    man["workloads"].append({"name": "tiny.prefill", "config": "neox-tiny",
                             "traffic": "prefill_tiny", "chips": 1, "why": "a test"})
    man["end_to_end"].append({"name": "ttft_max_ms", "unit": "ms", "better": "lower",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["tiny.prefill"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    code = ("import json, sys, time\n"
            "from bench import run\n"
            "r = run.load_run(json.load(open('BENCHMARK.json')), 'tiny.prefill')\n"
            "r.device, r.seed = 'cpu', 3\n"
            "print(json.dumps(run.execute(r, 0.2, False, time.time())))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT / "src")])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=240, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(result["metrics"]) == {"setup_s", "ttft_max_ms"}
    assert result["correct"] and set(result["checks"]) == {"logits_rel", "token_excess"}
    after = digest(b)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == [
        "cells/tiny.prefill.json", "configs/neox-tiny.json", "metrics/ttft_max_ms.py",
        "traffic/prefill_tiny.json"]
