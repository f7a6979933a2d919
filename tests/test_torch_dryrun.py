"""The port's dry run (``launch/dryrun.py``) and roofline
(``parallel/roofline.py``) against the JAX package's, on the CPU.

* ``Roofline`` on TPU v5e's constants (read from ``repro.parallel.roofline``
  here; the port's code holds only the H100's) gives JAX's ``to_dict()``
  for the same inputs; ``model_flops`` equals JAX's; the ring formulas
  reproduce ``parse_collectives``' bytes on ``tests/test_roofline.py``'s HLO
  fixture.
* A record's analytic fields equal JAX's ``build_roofline`` on a compiled
  smoke cell (the kernels' byte accounting, ``use_pallas=True``).
* The trace: the attention kernels' traceable ops count each kernel's
  flops; a smoke prefill's traced temp stays below the plain scores of one
  layer; MoE cells trace; the two-part train trace equals one pass of the
  real train step; 2- and 3-group extrapolation equals the full-depth
  trace; ``fits_hbm`` is unresolved (None) where an upper-bound trace is
  over the card's memory; the traced over analytic FLOPs of the dense smoke train and
  prefill cells lie in [0.8, 1.25].
* The CLI writes one JSONL record for one cell with the reference's keys,
  and ``--arch all``'s loop one a cell.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from _hypothesis_compat import given, settings, st
from jax.sharding import AxisType
from torch.utils.flop_counter import FlopCounterMode

from test_roofline import HLO

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import inputs as jax_inputs
from repro.launch.mesh import set_mesh
from repro.launch.steps import abstract_state as jax_abstract_state
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models.config import SHAPES_BY_NAME as JAX_SHAPES
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.parallel import roofline as jax_roofline
from repro_torch.configs import ALL, get_config, smoke_config
from repro_torch.kernels import ops, traced
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import split_seq
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import abstract_state, build_train_step
from repro_torch.models.config import SHAPES_BY_NAME, ShapeConfig
from repro_torch.optim import Optimizer
from repro_torch.parallel import roofline

REPO = Path(__file__).resolve().parents[1]
V5E = roofline.Chip(name="TPU v5e", peak_flops=jax_roofline.PEAK_FLOPS,
                    hbm_bw=jax_roofline.HBM_BW, hbm_bytes=jax_roofline.HBM_BYTES,
                    link_bw=jax_roofline.ICI_BW)
DENSE = ("llama3.2-1b", "qwen3-8b", "yi-34b", "gemma2-9b", "internvl2-1b", "whisper-base")
REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s",
                  "compile_unrolled_s", "arg_bytes", "temp_bytes", "out_bytes", "alias_bytes",
                  "bytes_per_device", "fits_hbm", "roofline"}


def smoke_cell(arch, kind, mesh=None, **kw):
    return dryrun.run_cell(arch, "", False, verbose=False, cfg=smoke_config(arch),
                           mesh=mesh or make_local_mesh(1, 1),
                           shape=ShapeConfig(f"smoke_{kind}", 64, 8, kind), **kw)


@given(st.floats(1e9, 1e15), st.floats(1e6, 1e13), st.floats(0, 1e12),
       st.sampled_from(["train", "prefill", "decode"]))
@settings(max_examples=50, deadline=None)
def test_roofline_on_v5e_constants_equals_jax(fl, by, co, kind):
    stats = roofline.CollectiveStats()
    stats.add("all-reduce", co, 16)
    jstats = jax_roofline.CollectiveStats(dict(stats.ops), dict(stats.bytes_by_kind),
                                          stats.total_bytes)
    args = dict(flops_per_device=fl, hbm_bytes_per_device=by,
                collective_bytes_per_device=co, model_flops_global=fl * 200,
                n_devices=256, hlo_flops_per_device=fl * 0.9, hlo_bytes_per_device=by * 2,
                kind=kind)
    port = roofline.Roofline(**args, collectives=stats, chip=V5E)
    ref = jax_roofline.Roofline(**args, collectives=jstats)
    assert port.to_dict() == ref.to_dict()


def test_model_flops_equal_jax():
    for arch in sorted(ALL):
        for name, shape in SHAPES_BY_NAME.items():
            assert roofline.model_flops(get_config(arch), shape) == \
                jax_roofline.model_flops(jax_get_config(arch), JAX_SHAPES[name]), (arch, name)


def test_ring_formulas_reproduce_parse_collectives():
    """Each collective of the HLO fixture by (kind, result bytes, group)."""
    fixture = [("all-gather", 64 * 1024 * 2, 16), ("all-reduce", 16 * 4096 * 2048 * 4, 16),
               ("reduce-scatter", 4 * 128 * 2, 4), ("collective-permute", 8 * 4, 2),
               ("all-to-all", 2 * 64 * 2, 4), ("all-reduce", 2 * 16 * 8 * 4, 8),
               ("all-gather", 64 * 2, 2)]
    stats = roofline.CollectiveStats()
    for kind, r, n in fixture:
        stats.add(kind, r, n)
    ref = jax_roofline.parse_collectives(HLO)
    assert stats.ops == ref.ops
    assert stats.bytes_by_kind.keys() == ref.bytes_by_kind.keys()
    for kind, b in ref.bytes_by_kind.items():
        assert stats.bytes_by_kind[kind] == pytest.approx(b, rel=1e-12), kind
    assert stats.total_bytes == pytest.approx(ref.total_bytes, rel=1e-12)
    with pytest.raises(ValueError):
        roofline.ring_bytes("broadcast", 1, 2)


def test_extrapolated_collectives_equal_jax():
    a, b = roofline.CollectiveStats(), roofline.CollectiveStats()
    a.add("all-gather", 100.0, 4)
    b.add("all-gather", 150.0, 4, 2)
    b.add("all-reduce", 10.0, 2)
    got = roofline.extrapolate_collectives(a, b, 5)
    want = jax_roofline.extrapolate_collectives(
        jax_roofline.CollectiveStats(dict(a.ops), dict(a.bytes_by_kind), a.total_bytes),
        jax_roofline.CollectiveStats(dict(b.ops), dict(b.bytes_by_kind), b.total_bytes), 5)
    assert (got.ops, got.bytes_by_kind, got.total_bytes) == (
        want.ops, want.bytes_by_kind, want.total_bytes)


def test_h100_across_nodes():
    assert roofline.H100.for_devices(8) is roofline.H100
    far = roofline.H100.for_devices(256)
    assert far.link_bw == roofline.H100.node_link_bw < roofline.H100.link_bw


def test_record_analytic_fields_equal_jax_build_roofline():
    arch, kind = "llama3.2-1b", "prefill"
    jcfg = jax_smoke_config(arch)
    jshape = JaxShapeConfig(f"smoke_{kind}", 64, 8, kind)
    jm = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = jax_inputs.make_rules(jcfg, jshape, jm)
    step, _ = jax_serve_step(jcfg, jshape, jm, rules)
    with set_mesh(jm):
        compiled = jax.jit(step).lower(jax_abstract_state(jcfg, jm, rules, None)["params"],
                                       jax_inputs.input_specs(jcfg, jshape, jm, rules)).compile()
    enc_S, dec_S = split_seq(smoke_config(arch), 64)
    # the port's kernels never write the scores: JAX's use_pallas accounting
    ref = jax_roofline.build_roofline(compiled, jcfg.replace(use_pallas=True), jshape, 8,
                                      enc_S, dec_S).to_dict()
    rec = smoke_cell(arch, kind, make_local_mesh(2, 4))["roofline"]
    for key in ("flops_per_device", "hbm_bytes_per_device", "model_flops_global",
                "n_devices", "kind", "t_compute_s", "t_memory_s"):
        want = ref[key]
        if key in ("t_compute_s", "t_memory_s"):  # v5e's rates there, the H100's here
            rate = {"t_compute_s": (jax_roofline.PEAK_FLOPS, roofline.H100.peak_flops),
                    "t_memory_s": (jax_roofline.HBM_BW, roofline.H100.hbm_bw)}[key]
            want = want * rate[0] / rate[1]
        assert rec[key] == pytest.approx(want, rel=1e-12), key


def test_traced_ops_count_each_kernel():
    q = torch.empty(2, 96, 8, 64, device="meta", dtype=torch.bfloat16, requires_grad=True)
    k = torch.empty(2, 96, 2, 64, device="meta", dtype=torch.bfloat16, requires_grad=True)
    pairs = 96 * 97 // 2
    with FlopCounterMode(display=False) as fc:
        o = ops.flash_attention(q, k, k, window=32)
        torch.autograd.grad(o.float().sum(), [q, k])
    counts = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
    windowed = sum(min(i + 1, 32) for i in range(96))
    assert counts["repro_torch.flash_attention_lse"] == 4 * 2 * 8 * 64 * windowed
    assert counts["repro_torch.flash_attention_bwd"] == 10 * 2 * 8 * 64 * windowed
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        out = ops.flash_attention(q, k, k)
        dec = ops.decode_attention(q[:, 0], k, k, 40)
    counts = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
    assert counts["repro_torch.flash_attention"] == 4 * 2 * 8 * 64 * pairs
    assert counts["repro_torch.decode_attention"] == 4 * 2 * 8 * 64 * 40
    assert out.shape == q.shape and dec.shape == q[:, 0].shape and out.device.type == "meta"
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="meta tensors only"):
        traced.flash_attention(x, x, x, True, 0, 0.0, 0)


def test_live_bytes_counts_allocations_and_frees():
    with dryrun.LiveBytes() as mem:
        a = torch.empty(100, device="meta")  # 400 B
        b = a.view(10, 10)  # a view allocates nothing
        c = torch.zeros(50, device="meta")  # 200 B
        del a, b
        d = c + 1  # 200 B, after a's 400 B are freed
    assert (mem.peak, mem.live) == (600, 400)
    del c, d


def test_prefill_trace_holds_no_scores():
    """The kernels' traceable ops give outputs only: a 1024-token smoke
    prefill's traced temp stays below the float32 scores the plain version
    makes for one layer."""
    cfg = smoke_config("llama3.2-1b")
    B, S = 8, 1024
    rec = dryrun.run_cell("llama3.2-1b", "", False, verbose=False, cfg=cfg,
                          mesh=make_local_mesh(1, 1), shape=ShapeConfig("p", S, B, "prefill"))
    scores = B * cfg.num_heads * S * S * 4
    assert 0 < rec["temp_bytes"] < scores


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"])
def test_moe_cells_trace(arch):
    for kind in ("train", "prefill", "decode"):
        rec = smoke_cell(arch, kind, make_local_mesh(2, 4))
        assert rec["status"] == "ok" and rec["traced_flops"] > 0
        assert "slots = E" in rec["temp_basis"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b", "whisper-base"])
def test_two_part_train_trace_equals_one_pass(arch):
    cfg = smoke_config(arch)
    shape = ShapeConfig("t", 64, 4, "train")
    opt = Optimizer(cfg.optimizer)
    state = abstract_state(cfg, opt)
    one = make_local_mesh(1, 1)
    _, _, inputs = dryrun.lay_out(cfg, shape, one)
    batch = {k: v.tensor for k, v in inputs.items()}
    step = build_train_step(cfg, None, None, opt)
    whole = dryrun._trace(lambda: step(state, batch), 4)
    parts = dryrun.trace_step(cfg, shape, 4)
    assert (parts.peak, parts.out_new, parts.flops, parts.accessed) == (
        whole.peak, whole.out_new, whole.flops, whole.accessed)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-1.5-large-398b", "gemma2-9b"])
def test_extrapolated_trace_equals_full_depth(arch):
    cfg = dryrun.grouped(smoke_config(arch), 5)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("x", 64, 8, kind)
        whole = dryrun._trace_model(cfg, shape, 4)  # every layer
        full = dryrun._with_update(cfg, shape, whole)
        ex = dryrun.trace_step(cfg, shape, 4)
        assert ex.extrapolated and not full.extrapolated
        assert (ex.peak, ex.out_new, ex.flops, ex.end) == (
            full.peak, full.out_new, full.flops, full.end), kind
        # the model part's own peak: exact, or a lower bound where a point
        # of the backward that grows faster takes it over past 3 groups
        part = dryrun.extrapolate_trace(dryrun._trace_model(dryrun.grouped(cfg, 2), shape, 4),
                                        dryrun._trace_model(dryrun.grouped(cfg, 3), shape, 4), 5)
        assert part.peak <= whole.peak, kind


def test_fits_hbm_unresolved_where_the_trace_is_an_upper_bound():
    """yi-34b trains over 80 GB a device on both layouts. On one device
    the trace is exact and the verdict is False; on the (2, 4) layout the
    rules split the weights the trace holds whole, and it is None."""
    shape = ShapeConfig("t", 64, 8, "train")
    one = dryrun.run_cell("yi-34b", "", False, verbose=False, mesh=make_local_mesh(1, 1),
                          shape=shape)
    split = dryrun.run_cell("yi-34b", "", False, verbose=False, mesh=make_local_mesh(2, 4),
                            shape=shape)
    assert one["bytes_per_device"] > roofline.H100.hbm_bytes and one["fits_hbm"] is False
    assert "upper bound" not in one["temp_basis"]
    assert split["bytes_per_device"] > roofline.H100.hbm_bytes and split["fits_hbm"] is None
    assert "upper bound" in split["temp_basis"]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_traced_flops_near_analytic(arch):
    for kind in ("train", "prefill"):
        rec = smoke_cell(arch, kind)
        assert 0.8 <= rec["traced_over_analytic"] <= 1.25, (kind, rec["traced_over_analytic"])


def test_record_keys_and_skips():
    rec = smoke_cell("llama3.2-1b", "train", make_local_mesh(2, 4))
    assert REFERENCE_KEYS <= rec.keys()
    assert rec["chip"]["peak_flops"] == roofline.H100.peak_flops
    # llama3.2-1b trains under pure FSDP: its batch of 8 over all 8 devices
    assert get_config("llama3.2-1b").train_strategy == "fsdp"
    assert rec["roofline"]["n_devices"] == 8 and rec["trace_batch"] == 1
    assert rec["bytes_per_device"] == (rec["arg_bytes"] + rec["temp_bytes"] + rec["out_bytes"]
                                       - rec["alias_bytes"])
    dec = smoke_cell("llama3.2-1b", "decode", make_local_mesh(2, 4))
    assert dec["alias_bytes"] > 0  # the cache, updated in place
    skip = dryrun.run_cell("roberta-large", "decode_32k", False, verbose=False)
    assert skip == {"arch": "roberta-large", "shape": "decode_32k", "mesh": "16x16",
                    "status": "skipped", "reason": "encoder-only arch has no decode step"}


def test_cli_writes_one_record(tmp_path):
    out = tmp_path / "cell.jsonl"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "REPRO_LOG_LEVEL": "WARNING"}
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                    "llama3.2-1b", "--shape", "decode_32k", "--multi-pod", "--out", str(out),
                    "--set", "num_layers=2"], check=True, env=env, timeout=300)
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert REFERENCE_KEYS <= rec.keys() and {"chip", "temp_basis", "traced_flops"} <= rec.keys()
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["status"]) == (
        "llama3.2-1b", "decode_32k", "2x16x16", "ok")
    assert rec["overrides"] == {"num_layers": 2}
    assert rec["chip"]["link_bw"] == roofline.H100.node_link_bw  # 512 devices: across nodes


def test_run_all_writes_a_record_per_cell(tmp_path, monkeypatch):
    """``--arch all``'s loop (one subprocess a cell) over one arch's four
    shapes: a record each, the skipped one with the shape table's reason."""
    out = tmp_path / "grid.jsonl"
    monkeypatch.setenv("REPRO_LOG_LEVEL", "WARNING")
    assert dryrun.run_all(str(out), False, archs=["llama3.2-1b"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["shape"] for r in recs] == list(SHAPES_BY_NAME)
    assert [r["status"] for r in recs] == ["ok", "ok", "ok", "skipped"]
    assert all(REFERENCE_KEYS <= r.keys() for r in recs[:3])
