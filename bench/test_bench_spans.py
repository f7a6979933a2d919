"""The readers of the program's spans and counters (``bench/spans.py`` and
the metrics that read it) on a synthetic timeline of the program's
recorder, and None without one."""

import pytest

from bench import run as bench_run
from bench import testing
from repro_torch.obs import device
from repro_torch.obs.metrics import MetricsRecorder, SpanRecord

MS = 1_000_000  # ns
READERS = {
    "prefill_device_ms.serve": 9.0, "prefill_enqueue_ms.serve": 4.0,
    "host_lead_ms.serve": 0.5, "alloc_calls.serve": 3.0,
    "forward_ms.train": 30.0, "backward_ms.train": 60.0, "optimizer_ms.train": 5.0,
    "loss_head_ms.train": 12.0, "alloc_calls.train": 2.0,
}


def span(rec, name, host, dev, parent=-1, counts=None):
    r = SpanRecord(name, (), host[0], parent, None, host[1], counts,
                   device_start_ns=dev[0], device_end_ns=dev[1])
    rec.timeline.append(r)
    return len(rec.timeline) - 1


def synthetic() -> MetricsRecorder:
    """Three prefills (device 8, 9, 10 ms; host 3, 4, 5 ms; one, three and
    five allocator calls; least block leads 0.2, 0.5, 2 ms) and two train
    steps (forward 30 ms with a 12 ms loss head, backward 60 ms, optimizer
    5 ms; two allocator calls each)."""
    rec = MetricsRecorder()
    t = 0
    for dev_ms, host_ms, calls, leads in ((8, 3, 1, (0.2, 1.0)), (9, 4, 3, (0.5, 0.7)),
                                          (10, 5, 5, (2.0, 3.0))):
        top = span(rec, "serve.prefill", (t, t + host_ms * MS), (t + MS, t + (1 + dev_ms) * MS),
                   counts={"alloc.device_calls": calls})
        for k, lead in enumerate(leads):
            h = t + k * MS
            span(rec, "model.block", (h, h + MS // 2), (h + int(lead * MS), h + 2 * MS), top)
        t += 100 * MS
    for _ in range(2):
        step = span(rec, "train.step", (t, t + MS), (t, t + 95 * MS),
                    counts={"alloc.device_calls": 2})
        fwd = span(rec, "train.forward", (t, t + MS), (t, t + 30 * MS), step)
        span(rec, "model.loss_head", (t, t + MS), (t + 18 * MS, t + 30 * MS), fwd)
        span(rec, "train.backward", (t, t + MS), (t + 30 * MS, t + 90 * MS), step)
        span(rec, "train.optimizer", (t, t + MS), (t + 90 * MS, t + 95 * MS), step)
        t += 100 * MS
    return rec


def read(name):
    return bench_run.load_metric(name).read(None, None)


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_on_a_synthetic_timeline(monkeypatch, name):
    monkeypatch.setattr(device, "_SESSION", synthetic())
    assert read(name) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_none_without_a_timeline(monkeypatch, name):
    monkeypatch.setattr(device, "_SESSION", None)
    assert read(name) is None
    monkeypatch.setattr(device, "_SESSION", MetricsRecorder())  # no span recorded
    assert read(name) is None


def test_spans_without_device_times_give_no_device_metric(monkeypatch):
    rec = synthetic()
    for r in rec.timeline:
        r.device_start_ns = r.device_end_ns = None
        r.counts = None
    monkeypatch.setattr(device, "_SESSION", rec)
    assert {n: read(n) for n in READERS} == {
        n: (4.0 if n == "prefill_enqueue_ms.serve" else None) for n in READERS}


def test_every_new_reader_is_in_the_manifest_for_its_cell():
    man = testing.manifest()
    cells = {m["name"]: m["workloads"] for m in man["per_layer"]}
    for name in READERS:
        want = ["neox20b.prefill"] if name.endswith(".serve") else ["roberta.train"]
        assert cells[name] == want
