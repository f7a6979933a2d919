"""The mixture-of-experts cell (``mixtral.prefill``) at smoke width on the
CPU: its plain reference (``bench/reference/moe_transformer.py``) against
the program and against a loop over tokens, its arithmetic
(``bench/moe_yardstick.py``) against hand counts, the readers of its
per-layer metrics on a synthetic timeline, ``correct`` against planted
faults and the fp8 control, and the whole cell run as the harness runs it,
from files found by name."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from bench import control
from bench import moe_yardstick as mys
from bench import run as bench_run
from bench import testing
from bench import yardstick as ys
from bench.drivers import moe_prefill_closed_loop as driver
from bench.moe_weights import make_weights
from bench.reference import moe_transformer as ref
from bench.test_bench_additions import digest
from repro_torch.obs import device as obs
from repro_torch.obs.metrics import MetricsRecorder, SpanRecord

ROOT = bench_run.ROOT
CELL = "mixtral.prefill"
SMOKE = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, intermediate_size=128, num_local_experts=8, num_experts_per_tok=2,
             vocab_size=256)
TRAFFIC = dict(prompt_lengths=[16, 24, 32], max_len=33, max_requests=400,
               sample={"requests": 3, "longest": 1, "within": 6})
TOL = 1e-5  # float32 against float32: only the order of the sums differs


def small_run(seed=2**31 + 17, dtype="", size=SMOKE, traffic=TRAFFIC):
    run = bench_run.load_run(testing.manifest(), CELL)
    run.cfg.update(size)
    if dtype:
        run.cfg["torch_dtype"] = dtype
    run.traffic.update(traffic)
    run.device, run.seed = "cpu", seed
    return run


def rel(a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b))


def test_the_configuration_is_the_published_block_cut_in_depth():
    cfg = json.loads((ROOT / "bench" / "configs" / "mixtral-8x7b.json").read_text())
    assert cfg["reduced"] == ["num_hidden_layers"]
    assert (cfg["num_hidden_layers"], cfg["source_values"]["num_hidden_layers"]) == (16, 32)
    assert (cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"], cfg["intermediate_size"]) == (4096, 32, 8, 128, 14336)
    assert (cfg["num_local_experts"], cfg["num_experts_per_tok"], cfg["vocab_size"]) == (8, 2,
                                                                                        32000)
    assert cfg["rope_theta"] == 1e6 and cfg["sliding_window"] is None
    assert cfg["rms_norm_eps"] == 1e-5 and not cfg["tie_word_embeddings"]
    pc = driver.port_config(cfg)
    assert pc.window_size == 0 and pc.rope_theta == 1e6 and pc.moe_d_ff == 14336


@pytest.mark.parametrize("L", [9, 32])
def test_prefill_matches_the_program_in_float32(L):
    from repro_torch.launch.serve import ServeEngine

    cfg = small_run(dtype="float32").cfg
    w = make_weights(cfg, 5, "cpu", "float32")
    eng = ServeEngine(driver.port_config(cfg), 33, 1, device="cpu", params=w)
    tok = torch.randint(0, cfg["vocab_size"], (1, L), generator=torch.Generator().manual_seed(L))
    with driver.routing() as (choices, dropped):
        logits, cache = eng.prefill(eng.params, {"tokens": tok})
    assert dropped == [0] and len(choices) == cfg["num_hidden_layers"]
    seen, margins = [], []

    def on_layer(l, i, k, v):
        for name, want in (("k", k), ("v", v)):
            got = cache["b0"][name][l, 0]
            seen.append(rel(got[:L], want))
            assert torch.count_nonzero(got[L:]) == 0

    def on_route(l, i, topi, m):
        assert torch.equal(topi, choices[l])
        margins.extend(m.tolist())

    own = []
    (want,) = ref.prefill(cfg, w, [tok[0]], "float32", on_layer,
                          on_route=lambda l, i, topi, m: own.append(topi))
    assert [torch.equal(a, b) for a, b in zip(own, choices)] == [True] * len(own)
    assert max(seen) < TOL and rel(logits[0, -1], want) < TOL
    (again,) = ref.prefill(cfg, w, [tok[0]], "float32", route_as=[choices], on_route=on_route)
    assert margins == [] and torch.equal(again, want)


def test_the_expert_layer_against_a_loop_over_tokens():
    cfg = dict(SMOKE)
    g = torch.Generator().manual_seed(4)
    E, D, Fd, k = 8, 64, 128, 2
    lp = {"router": torch.randn(D, E, generator=g) / 8,
          "wg": torch.randn(E, D, Fd, generator=g) / 8,
          "wu": torch.randn(E, D, Fd, generator=g) / 8,
          "wd_": torch.randn(E, Fd, D, generator=g) / 11}
    x = torch.randn(40, D, generator=g)
    out, topi, margins = ref.moe(cfg, lp, x, ref.MATMULS["float32"])
    assert margins.numel() == 0
    for t in range(x.shape[0]):
        p = torch.softmax(x[t] @ lp["router"], -1)
        best = sorted(range(E), key=lambda e: -float(p[e]))[:k]
        assert set(topi[t].tolist()) == set(best)
        want = torch.zeros(D)
        for e in best:
            h = F.silu(x[t] @ lp["wg"][e]) * (x[t] @ lp["wu"][e])
            want += float(p[e] / sum(p[j] for j in best)) * (h @ lp["wd_"][e])
        assert rel(out[t], want) < TOL
    # another rule's choices: taken, weighted by the reference's own
    # probabilities of them, each with the margin it crossed
    probs = torch.softmax(x @ lp["router"], -1)
    low = torch.topk(probs, k, dim=-1, largest=False).indices
    _, taken, margins = ref.moe(cfg, lp, x, ref.MATMULS["float32"], route=low)
    assert torch.equal(taken, low) and margins.numel() == x.shape[0] * k
    assert float(margins.min()) > 0


def test_crossings_are_the_margins_of_the_choices_that_differ():
    probs = torch.tensor([[0.5, 0.3, 0.15, 0.05], [0.4, 0.35, 0.2, 0.05]])
    own = torch.tensor([[0, 1], [0, 1]])
    used = torch.tensor([[0, 2], [3, 2]])
    m = ref.crossings(probs, own, used)
    assert m.tolist() == pytest.approx([0.3 - 0.15, 0.4 - 0.2, 0.4 - 0.05])


def test_attention_in_blocks_equals_the_whole_matrix():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(37, h, 16, generator=g) for h in (4, 2, 2))
    mm = ref.MATMULS["float32"]
    whole = ref.attend(q, k, v, mm, block=64)
    assert rel(ref.attend(q, k, v, mm, block=8), whole) < TOL
    s = torch.einsum("shd,thd->hst", q, k.repeat_interleave(2, 1)) / 4
    s = s.masked_fill(torch.ones(37, 37, dtype=torch.bool).triu(1), -torch.inf)
    want = torch.einsum("hst,thd->shd", torch.softmax(s, -1), v.repeat_interleave(2, 1))
    assert rel(whole, want) < TOL


def test_the_cell_in_bf16_within_its_limits():
    run = small_run()
    got = control.readings(run, 3, "program")
    assert {k: got[k] <= lim for k, lim in run.limits.items()} == {k: True for k in run.limits}
    assert got["route_excess"] == got["dropped_rows"] == got["rerun_differs"] == 0
    assert got["logits_rel"] > 1e-4  # bf16, not float32


# deep and wide enough that rounding builds up as it does at the cell's size
CONTROL_SIZE = dict(SMOKE, num_hidden_layers=4, hidden_size=256, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=64, intermediate_size=512, vocab_size=1024)
CONTROL_TRAFFIC = dict(TRAFFIC, prompt_lengths=[64, 96, 128], max_len=129)


def test_fp8_control_fails_a_number_the_program_passes():
    run = small_run(size=CONTROL_SIZE, traffic=CONTROL_TRAFFIC)
    for seed in (1, 2):
        program = [k for k, lim in run.limits.items()
                   if not control.readings(run, seed, "program")[k] <= lim]
        fp8 = control.readings(run, seed, "fp8")
        assert program == [] and fp8["dropped_rows"] == 0
        assert [k for k, lim in run.limits.items() if not fp8[k] <= lim], seed


def _lowest_two(moe):
    def route(cfg, router, x_flat):
        probs = torch.softmax(x_flat.float() @ router.float(), dim=-1)
        topw, topi = torch.topk(probs, cfg.moe_top_k, dim=-1, largest=False)
        return topw / topw.sum(dim=-1, keepdim=True), topi
    return "route", route


def _drop_expert_rows(moe):
    real = moe.dispatch

    def dispatch(cfg, topi, *args, **kwargs):
        sel, sizes = real(cfg, topi, *args, **kwargs)
        return sel[sizes[0]:], [0] + sizes[1:]
    return "dispatch", dispatch


def _zero_cache(moe):
    from repro_torch.models import model as model_mod
    real = model_mod.prefill_fn

    def prefill_fn(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        return logits, {b: {k: torch.zeros_like(v) for k, v in e.items()}
                        for b, e in cache.items()}
    return model_mod, "prefill_fn", prefill_fn


@pytest.mark.parametrize("fault,fails", [(_lowest_two, "route_excess"),
                                         (_drop_expert_rows, "dropped_rows"),
                                         (_zero_cache, "kv_rel")])
def test_a_run_with_a_broken_path_is_not_correct(fault, fails, monkeypatch):
    from repro_torch.models import moe
    assert testing.execute(small_run())["correct"]
    planted = fault(moe)
    target = moe if len(planted) == 2 else planted[0]
    monkeypatch.setattr(target, *planted[-2:])
    result = testing.execute(small_run())
    assert not result["correct"]
    assert result["checks"][fails]["value"] > result["checks"][fails]["limit"]


def test_counts_by_hand():
    cfg = small_run().cfg
    attn, router, expert, head = mys.moe_matmul_params(cfg)
    # q, o: 64 x 64 each; k, v: 64 x 32 each
    assert (attn, router, expert, head) == (2 * 4096 + 2 * 2048, 64 * 8, 3 * 64 * 128, 64 * 256)
    pairs = 32 * 33 // 2
    assert ys.attended_pairs(32, 32, True) == pairs
    per_token = 2 * (12288 + 512 + 2 * 24576)
    assert mys.forward_flops(cfg, 32, 1, head_positions=1) == (
        2 * (per_token * 32 + 4 * 64 * pairs) + 2 * 16384)
    # two experts with rows, one without: 6 D F a row; 3 D F bf16 weights an
    # expert used, a row in and out
    flops, nbytes = mys.expert_work([5, 0, 7], 64, 128, 2)
    assert flops == 6 * 64 * 128 * 12
    assert nbytes == 2 * (3 * 64 * 128 * 2 + 2 * 64 * 12)


def test_the_cells_counts():
    cfg = json.loads((ROOT / "bench" / "configs" / "mixtral-8x7b.json").read_text())
    attn, router, expert, head = mys.moe_matmul_params(cfg)
    assert attn == 41_943_040 and expert * 8 == 1_409_286_144
    assert 16 * (attn + 8 * expert) == 23_219_666_944  # the stage's layers, 46.44 GB in bf16
    assert 2 * 2 * expert == 704_643_072  # a token's two experts a layer
    tflop = [mys.forward_flops(cfg, L, 1, head_positions=1) / 1e12 for L in (2048, 4096, 8192)]
    assert [round(t, 1) for t in tflop] == [26.4, 53.9, 112.2]
    # a block of 2048 tokens spread evenly: 512 rows an expert, bound by operations
    flops, nbytes = mys.expert_work([512] * 8, 4096, 14336, 2)
    assert ys.bound_s(flops, nbytes) == pytest.approx(flops / ys.PEAK_BF16_FLOPS)
    assert nbytes == 2 * (8 * 3 * 4096 * 14336 + 2 * 4096 * 4096)


def test_mfu_reads_the_counted_operations():
    from bench.record import Completion, Record
    cfg = json.loads((ROOT / "bench" / "configs" / "mixtral-8x7b.json").read_text())
    rec = Record(window_start=0.0)
    for i, L in enumerate((2048, 8192)):
        rec.completions.append(Completion(i * 0.5, (i + 1) * 0.5, L,
                                          mys.forward_flops(cfg, L, 1, head_positions=1)))
    want = 100 * (mys.forward_flops(cfg, 2048, 1, 1) + mys.forward_flops(cfg, 8192, 1, 1)) / (
        1.0 * ys.PEAK_BF16_FLOPS)
    assert bench_run.load_metric("mfu.serve").read(rec, None) == pytest.approx(want)


MS = 1_000_000  # ns


def _span(rec, name, dev, parent=-1, request=None, counts=None):
    rec.timeline.append(SpanRecord(name, (), dev[0], parent, request, dev[1], counts,
                                   device_start_ns=dev[0], device_end_ns=dev[1]))
    return len(rec.timeline) - 1


def synthetic():
    """Three prefills (device 10, 12, 14 ms), each of two expert layers:
    ``model.moe`` 3 ms and 4 ms with a ``moe.experts`` of 2 ms inside,
    rows [512] * 8 in each."""
    rec = MetricsRecorder()
    rows = {f"moe.rows{{expert={e}}}": 512 for e in range(8)}
    t = 0
    for n, dev_ms in enumerate((10, 12, 14), 1):
        top = _span(rec, "serve.prefill", (t, t + dev_ms * MS), request=str(n))
        for j, moe_ms in enumerate((3, 4)):
            a = t + 5 * j * MS
            m = _span(rec, "model.moe", (a, a + moe_ms * MS), top, str(n),
                      {"moe.rows": 4096, **rows})
            _span(rec, "moe.experts", (a, a + 2 * MS), m, str(n))
        t += 100 * MS
    return rec


def test_the_readers_on_a_synthetic_timeline(monkeypatch):
    run = small_run()
    run.cfg.update(hidden_size=4096, intermediate_size=14336)
    monkeypatch.setattr(obs, "_SESSION", synthetic())
    read = lambda name: bench_run.load_metric(name).read(None, run)  # noqa: E731
    assert read("moe_ms.mixtral") == pytest.approx(7.0)
    assert read("prefill_device_ms.mixtral") == pytest.approx(12.0)
    flops, _ = mys.expert_work([512] * 8, 4096, 14336, 2)
    assert read("expert_roofline.mixtral") == pytest.approx(100 * flops / 989e12 / 2e-3)
    for session in (None, MetricsRecorder()):
        monkeypatch.setattr(obs, "_SESSION", session)
        assert [read(n) for n in ("moe_ms.mixtral", "prefill_device_ms.mixtral",
                                  "expert_roofline.mixtral")] == [None] * 3


def test_the_readers_are_the_cells():
    man = testing.manifest()
    per = bench_run.cell_metrics(man, "per_layer", CELL)
    for name in ("moe_ms.mixtral", "expert_roofline.mixtral", "prefill_device_ms.mixtral",
                 "mfu.serve", "flash_roofline.serve", "idle.serve", "ttft_p50_ms"):
        assert name in per
    assert bench_run.cell_metrics(man, "end_to_end", CELL) == ["tokens_per_s", "ttft_p95_ms",
                                                               "setup_s"]
    # the span readers pinned to neox's cell stay there, and the new ones here
    assert not {n for n in per if n.endswith(".serve") and "ms" in n}
    assert not {n for n in bench_run.cell_metrics(man, "per_layer", "neox20b.prefill")
                if n.endswith(".mixtral")}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys\n"
            "import bench.reference.moe_transformer, bench.moe_yardstick, bench.moe_weights\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=240, check=True)
    assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & {"repro_torch",
                                                                      *bench_run.BANNED}


def test_the_cell_runs_from_files_found_by_name(tmp_path):
    """The cell at smoke width through ``run.load_run`` and ``run.execute``
    in a copy of the benchmark, as the harness runs it: correct, its
    metrics and checks, no banned module loaded, and no file under
    ``bench/`` changed by the run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "bench")
    code = ("import json, sys, time\n"
            "from bench import run\n"
            f"r = run.load_run(json.load(open('BENCHMARK.json')), {CELL!r})\n"
            f"r.cfg.update({SMOKE!r})\n"
            f"r.traffic.update({TRAFFIC!r})\n"
            "r.device, r.seed = 'cpu', 2**31 + 99\n"
            "out = run.execute(r, 0.5, False, time.time())\n"
            "out['loaded'] = sorted({m.split('.')[0] for m in sys.modules})\n"
            "print(json.dumps(out))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT / "src")])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=240, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"tokens_per_s", "ttft_p95_ms", "setup_s"}
    assert set(result["checks"]) == {"logits_rel", "kv_rel", "token_excess", "route_excess",
                                     "dropped_rows"}
    assert result["readings"]["rerun_differs"] == 0
    assert "repro_torch" in result["loaded"]
    assert not set(result["loaded"]) & set(bench_run.BANNED)
    assert digest(tmp_path / "bench") == before
    assert math.isfinite(result["metrics"]["tokens_per_s"]["value"])
