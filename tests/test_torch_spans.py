"""The port's spans inside its steps (``repro_torch.obs.device``) on the CPU:

* a smoke roberta-large ``build_train_step`` call and smoke gpt-neox-20b
  ``ServeEngine`` prefills under ``torch.profiler``: the span tree
  (``train.step`` around ``train.forward`` around the blocks and
  ``model.loss_head``, ``train.backward`` around the recomputed blocks,
  then ``train.optimizer``; ``serve.prefill`` around one ``model.block`` a
  layer), parents and step or request ids, the plain and the sharded (1 x
  1 gloo mesh) steps alike;
* the spans' clock is the profiler's: kineto's events of the aten ops run
  inside a span lie within its ``time.time_ns()`` bounds;
* an enabled recorder takes the spans in place of the profiler's;
* tracing off: nothing recorded, each site gets the shared null span, no
  CUDA event made and no timestamp taken; outputs bit-identical with
  tracing on and off;
* on a card (marked ``card``, skipped here): every span's device start and
  end set, nested as the spans are, and the allocator's counter read.

Run the card test on the card without this directory's conftest (it
imports JAX): ``python -m pytest -p no:cacheprovider --noconftest -m card
tests/test_torch_spans.py``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import smoke_config
from repro_torch.launch.inputs import make_rules
from repro_torch.launch.mesh import MeshLayout, make_device_mesh
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.steps import build_train_step, init_state
from repro_torch.models.config import ShapeConfig
from repro_torch.data.pipeline import device_put_batch
from repro_torch.obs import device as obs
from repro_torch.obs import metrics
from repro_torch.optim import Optimizer

SITES = {"serve.prefill", "model.block", "train.step", "train.forward", "train.backward",
         "train.optimizer", "model.loss_head"}
B, S = 2, 16
PROMPTS = (8, 12)


@pytest.fixture(autouse=True)
def fresh_session():
    obs.new_session()
    yield
    obs.new_session()


def roberta(device="cpu"):
    cfg = smoke_config("roberta-large")
    opt = Optimizer(cfg.optimizer)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
             .to(device) for k in ("tokens", "targets")}
    return cfg, opt, init_state(cfg, opt, device, seed=0), batch


def neox(device="cpu", mesh=None):
    cfg = smoke_config("gpt-neox-20b")
    return cfg, ServeEngine(cfg, 32, 1, device=device, mesh=mesh)


def prompt(L):
    return np.arange(L, dtype=np.int64)[None] % 97


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def tree(spans):
    """(name, labels, parent's name, request) of each span, in order."""
    return [(r.name, r.labels_dict(), spans[r.parent].name if r.parent >= 0 else None,
             r.request) for r in spans]


def train_tree(n_layers, step):
    fwd = [("model.block", {"layer": str(i)}, "train.forward", step) for i in range(n_layers)]
    bwd = [("model.block", {"layer": str(i)}, "train.backward", step)
           for i in reversed(range(n_layers))]
    return ([("train.step", {"step": step}, None, step), ("train.forward", {}, "train.step", step)]
            + fwd + [("model.loss_head", {}, "train.forward", step),
                     ("train.backward", {}, "train.step", step)]
            + bwd + [("train.optimizer", {}, "train.step", step)])


def prefill_tree(n_layers, first=1):
    out = []
    for n, L in enumerate(PROMPTS, first):
        out.append(("serve.prefill", {"request": str(n), "tokens": str(L)}, None, str(n)))
        out += [("model.block", {"layer": str(i)}, "serve.prefill", str(n))
                for i in range(n_layers)]
    return out


def test_train_step_span_tree():
    cfg, opt, state, batch = roberta()
    step = build_train_step(cfg, None, None, opt)
    step(state, batch)  # step 1, untraced
    profiled(lambda: step(state, batch))
    spans = obs.resolve(obs.session())
    assert tree(spans) == train_tree(cfg.num_layers, "2")
    assert all(r.end_ns >= r.start_ns > 0 for r in spans)
    for r in spans[1:]:  # nested on the host's clock
        p = spans[r.parent]
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    # on the CPU: no device times and no allocator count
    assert all(r.device_start_ns is None and r.counts is None for r in spans)


def test_prefill_span_tree():
    cfg, eng = neox()
    profiled(lambda: [eng.generate(prompt(L), 0) for L in PROMPTS])
    assert tree(obs.resolve(obs.session())) == prefill_tree(cfg.num_layers)


def test_sharded_steps_record_the_plain_steps_spans():
    layout = MeshLayout(("data", "model"), (1, 1))
    mesh = make_device_mesh(1, 1, "cpu")
    try:
        cfg, opt, _, batch = roberta()
        rules = make_rules(cfg, ShapeConfig("t", S, B, "train"), layout)
        state = init_state(cfg, opt, "cpu", mesh=mesh, rules=rules)
        step = build_train_step(cfg, mesh, rules, opt)
        profiled(lambda: step(state, device_put_batch(batch, "cpu", mesh, rules)))
        assert tree(obs.resolve(obs.session())) == train_tree(cfg.num_layers, "1")
        obs.new_session()
        ncfg, eng = neox(mesh=mesh)
        profiled(lambda: [eng.generate(prompt(L), 0) for L in PROMPTS])
        assert tree(obs.resolve(obs.session())) == prefill_tree(ncfg.num_layers)
    finally:
        torch.distributed.destroy_process_group()


def test_kineto_events_lie_inside_their_spans():
    _, eng = neox()
    toks = {"tokens": torch.as_tensor(prompt(12))}
    _, prof = profiled(lambda: eng.prefill(eng.params, toks))
    spans = obs.resolve(obs.session())
    events = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    top, blocks = spans[0], spans[1:]
    assert top.name == "serve.prefill" and events and blocks
    # every op of the call lies inside its span, and each block holds some
    assert all(top.start_ns <= a <= b <= top.end_ns for a, b in events)
    for r in blocks:
        assert any(r.start_ns <= a <= b <= r.end_ns for a, b in events), r


def test_an_enabled_recorder_takes_the_spans():
    cfg, opt, state, batch = roberta()
    rec = metrics.MetricsRecorder()
    with metrics.recording(rec):
        build_train_step(cfg, None, None, opt)(state, batch)
    assert obs.session() is None
    assert tree(rec.timeline) == train_tree(cfg.num_layers, "1")
    assert rec.open_spans == []
    # the aggregates fold the timeline's spans, by name and labels
    counts = {}
    for r in rec.timeline:
        counts[(r.name, r.labels)] = counts.get((r.name, r.labels), 0) + 1
    assert {k: s.count for k, s in rec.spans.items()} == counts
    assert all(s.total_s > 0 for s in rec.spans.values())


class _NoClock:
    def time_ns(self):
        raise AssertionError("a timestamp taken with tracing off")


def test_tracing_off_records_nothing(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event made with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(metrics, "time", _NoClock())
    monkeypatch.setattr(obs, "time", _NoClock())
    got, site = [], obs.span

    def seen(name, **labels):
        sp = site(name, **labels)
        got.append((name, sp))
        return sp

    monkeypatch.setattr(obs, "span", seen)
    assert metrics.get_recorder() is metrics.NULL_RECORDER
    cfg, opt, state, batch = roberta()
    build_train_step(cfg, None, None, opt)(state, batch)
    _, eng = neox()
    eng.generate(prompt(8), 0)
    assert {name for name, _ in got} == SITES
    assert all(sp is metrics._NULL_SPAN for _, sp in got)
    assert obs.session() is None


def test_outputs_are_bit_identical_with_tracing_on_and_off():
    cfg, opt, state, batch = roberta()
    step = build_train_step(cfg, None, None, opt)
    off = step(state, batch)
    on, _ = profiled(lambda: step(state, batch))
    with metrics.recording(metrics.MetricsRecorder()):
        rec = step(state, batch)
    flat = lambda t: [t] if torch.is_tensor(t) else [y for v in t.values() for y in flat(v)]
    for other in (on, rec):
        assert all(torch.equal(a, b) for a, b in zip(flat(off[0]), flat(other[0]), strict=True))
        assert all(torch.equal(off[1][k], other[1][k]) for k in off[1])
    _, eng = neox()
    toks = {"tokens": torch.as_tensor(prompt(12))}
    off = eng.prefill(eng.params, toks)
    on, _ = profiled(lambda: eng.prefill(eng.params, toks))
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(off[1][b][k], on[1][b][k]) for b in off[1] for k in off[1][b])


@pytest.mark.card
def test_device_times_are_set_and_nested():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: device times come from CUDA events")
    cfg, opt, state, batch = roberta("cuda")
    step = build_train_step(cfg, None, None, opt)
    step(state, batch)
    _, eng = neox("cuda")
    eng.generate(prompt(8), 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        step(state, batch)
        [eng.generate(prompt(L), 0) for L in PROMPTS]
    rec = obs.session()
    spans = obs.resolve(rec)
    assert tree(spans) == (train_tree(cfg.num_layers, "2")
                           + prefill_tree(smoke_config("gpt-neox-20b").num_layers, first=2))
    for r in spans:
        assert r.device_start_ns is not None and r.device_start_ns <= r.device_end_ns
        # the device runs a span's work after the host launched it
        assert r.device_start_ns >= r.start_ns
        if r.parent >= 0:
            p = spans[r.parent]
            assert p.device_start_ns <= r.device_start_ns <= r.device_end_ns <= p.device_end_ns
    counted = [r for r in spans if r.counts is not None]
    assert [r.name for r in counted] == ["train.step", "serve.prefill", "serve.prefill"]
    assert all(r.counts[obs.ALLOC_CALLS] >= 0 for r in counted)
    moved = sum(r.counts[obs.ALLOC_CALLS] for r in counted)
    assert rec.snapshot().counter_total(obs.ALLOC_CALLS) == moved
    # the device timer against the host clock, mapped through two anchors
    assert abs(rec.device_clock.drift_ppm) < 1000
