"""Nothing the harness or its reference loads has the top-level name of JAX
or of the JAX package (``repro``; ``repro_torch`` only begins with it), and
the reference loads nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from bench import run as bench_run

ROOT = bench_run.ROOT


def child(code: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=240, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    got = child(
        "import json, sys\n"
        "from bench import testing\n"
        "for name in ('neox20b.prefill', 'roberta.train'):\n"
        "    testing.execute(testing.small_run(name))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "repro_torch" in got
    assert not set(got) & set(bench_run.BANNED)


def test_the_reference_loads_nothing_of_the_program():
    got = child(
        "import json, sys\n"
        "import bench.reference.dense_transformer, bench.yardstick, bench.weights\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not set(got) & {"repro_torch", *bench_run.BANNED}


def test_no_source_under_bench_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in bench_run.BANNED, (path, n)
                if "reference" in path.parts:
                    assert n.split(".")[0] != "repro_torch", (path, n)


def test_the_check_compares_whole_top_level_names():
    assert bench_run.banned_modules(["repro_torch", "repro_torch.models.model", "numpy"]) == []
    assert bench_run.banned_modules(["repro_torch", "repro.core.policy"]) == ["repro"]
    assert bench_run.banned_modules(["jax._src.api", "jaxlib", "flax"]) == ["flax", "jax",
                                                                            "jaxlib"]


def test_without_a_card_a_run_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return  # the refusal is for machines without the cell's cards
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
                          "neox20b.prefill", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=240, check=False)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
