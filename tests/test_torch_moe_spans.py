"""The MoE block's spans and counters (``models/moe.py``, ``model.py::
_ffn_apply``; ``repro_torch.obs.device``) on the CPU, on the smoke
mixtral-8x7b served through ``ServeEngine.prefill``:

* under a recorder (an enabled one, or ``torch.profiler``'s session), one
  ``model.moe`` span a block (labelled with its layer, inside the block's
  ``model.block``) around one ``moe.experts`` span;
* a block's counts: ``moe.rows`` over its experts summing to T * k, one
  ``moe.host_reads``, ``moe.dropped_rows`` 0 at the capacity factor 1.25
  on one device and the rows cut at 0.5, in the spans that hold the block
  and in the recorder's counters alike;
* tracing off: every site gets the shared null span and nothing counts;
* ``moe_apply``'s and the prefill's outputs bit-identical with tracing on
  and off.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import smoke_config
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import moe
from repro_torch.obs import device as obs
from repro_torch.obs import metrics

PROMPTS = (8, 12)


@pytest.fixture(autouse=True)
def fresh_session():
    obs.new_session()
    yield
    obs.new_session()


def engine(**kw):
    cfg = smoke_config("mixtral-8x7b").replace(**kw)
    return cfg, ServeEngine(cfg, 16, 1, device="cpu")


def tokens(L):
    return {"tokens": (torch.arange(L, dtype=torch.int64)[None] * 7) % 251}


def prefills(eng):
    return [eng.prefill(eng.params, tokens(L)) for L in PROMPTS]


def rows_of(counts):
    return {k: v for k, v in counts.items() if k.startswith(moe.ROWS + "{")}


@pytest.mark.parametrize("how", ["recorder", "profiler"])
def test_one_moe_and_one_experts_span_a_block(how):
    cfg, eng = engine()
    if how == "recorder":
        with metrics.recording(metrics.MetricsRecorder()) as rec:
            prefills(eng)
        spans = rec.timeline
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            prefills(eng)
        spans = obs.resolve(obs.session())
    names = [r.name for r in spans]
    per_request = 1 + 3 * cfg.num_layers
    assert names == (["serve.prefill"] + ["model.block", "model.moe", "moe.experts"]
                     * cfg.num_layers) * len(PROMPTS)
    for j, r in enumerate(spans):
        if r.name == "model.moe":
            block = spans[r.parent]
            assert block.name == "model.block" and r.labels_dict() == block.labels_dict()
            assert spans[j + 1].name == "moe.experts" and spans[j + 1].parent == j
    assert len(spans) == per_request * len(PROMPTS)


@pytest.mark.parametrize("cf,dropped", [(1.25, False), (0.5, True)])
def test_a_blocks_counts(cf, dropped):
    cfg, eng = engine(moe_capacity_factor=cf)
    k = cfg.moe_top_k
    with metrics.recording(metrics.MetricsRecorder()) as rec:
        prefills(eng)
    moes = [r for r in rec.timeline if r.name == "model.moe"]
    assert len(moes) == cfg.num_layers * len(PROMPTS)
    total_dropped = 0
    for n, r in enumerate(moes):
        T = PROMPTS[n // cfg.num_layers]
        c = r.counts
        rows = rows_of(c)
        assert set(rows) <= {obs.count_key(moe.ROWS, expert=e)
                             for e in range(cfg.moe_num_experts)}
        assert sum(rows.values()) == c[moe.ROWS]
        assert c[moe.ROWS] + c[moe.DROPPED_ROWS] == T * k
        assert c[moe.HOST_READS] == 1
        cap = moe._capacity(T * k, 1, cf)
        assert c[moe.ROWS] == min(T * k, cap)
        total_dropped += c[moe.DROPPED_ROWS]
        # the counts move in every span that holds the block, not inside it
        assert rec.timeline[r.parent].counts == c
        child = rec.timeline[rec.timeline.index(r) + 1]
        assert child.name == "moe.experts" and child.counts is None
    assert (total_dropped > 0) == dropped
    top = [r for r in rec.timeline if r.name == "serve.prefill"]
    assert [r.counts[moe.HOST_READS] for r in top] == [cfg.num_layers] * len(PROMPTS)
    assert [r.counts[moe.ROWS] + r.counts[moe.DROPPED_ROWS] for r in top] == [
        T * k * cfg.num_layers for T in PROMPTS]
    snap = rec.snapshot()
    assert snap.counter_total(moe.HOST_READS) == cfg.num_layers * len(PROMPTS)
    assert snap.counter_total(moe.ROWS) == sum(r.counts[moe.ROWS] for r in moes)
    assert snap.counter_total(moe.DROPPED_ROWS) == total_dropped


def test_tracing_off_counts_nothing(monkeypatch):
    got, site = [], obs.span

    def seen(name, **labels):
        sp = site(name, **labels)
        got.append((name, sp))
        return sp

    def no_count(*args, **kwargs):
        raise AssertionError("a count with tracing off")

    monkeypatch.setattr(obs, "span", seen)
    monkeypatch.setattr(obs, "count", no_count)
    assert metrics.get_recorder() is metrics.NULL_RECORDER
    cfg, eng = engine()
    prefills(eng)
    names = [name for name, _ in got]
    assert names.count("model.moe") == names.count("moe.experts") == cfg.num_layers * len(
        PROMPTS)
    assert all(sp is metrics._NULL_SPAN for _, sp in got)
    assert obs.session() is None


def test_outputs_are_bit_identical_with_tracing_on_and_off():
    cfg, eng = engine()
    p = {k: v[0] for k, v in eng.params["decoder"]["b0"]["moe"].items()}
    x = torch.randn(1, 12, cfg.d_model, generator=torch.Generator().manual_seed(3)).to(
        cfg.activation_dtype)
    off = moe.moe_apply(cfg, p, x)
    with metrics.recording(metrics.MetricsRecorder()):
        rec = moe.moe_apply(cfg, p, x)
    with profile(activities=[ProfilerActivity.CPU]):
        on = moe.moe_apply(cfg, p, x)
    assert torch.equal(off, rec) and torch.equal(off, on)
    off = eng.prefill(eng.params, tokens(12))
    with profile(activities=[ProfilerActivity.CPU]):
        on = eng.prefill(eng.params, tokens(12))
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(off[1][b][k], on[1][b][k]) for b in off[1] for k in off[1][b])
