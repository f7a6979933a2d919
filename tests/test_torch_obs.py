"""The port's observability reporting against the JAX package's, on the CPU.

``repro_torch.obs.{export,incidents,log}`` are copies of the reference's
modules (the manifest records torch, CUDA and the card where the
reference records jax). Each registered ``chaos-*`` scenario runs in both
packages under their recorders, with its fault timeline compressed into the
1500 s horizon of ``tests/test_torch_chaos.py``:

* ``prometheus_text`` equals JAX's byte for byte once the spans (wall-clock
  aggregates) are set aside, and the spans agree by name, labels and count
  (spans come from the ensemble engine: one recorded run is a two-member
  routed ``run_ensemble(engine="numpy")`` of ``chaos-pdu-loss-tree``);
  ``event_lines`` equal JAX's byte for byte;
* the incident report of the trace — ``reconstruct_incidents``,
  ``incidents_json``, ``render_incidents_markdown`` — equals JAX's, on
  that trace and on the hand-built traces of ``tests/test_incidents.py``;
* ``write_artifacts`` writes what ``read_prometheus``, ``read_events`` and
  ``read_manifest`` read back, and the manifest has the reference's keys
  with ``torch``, ``cuda`` and ``device`` in place of ``jax``;
* ``obs`` exports the reference's whole ``__all__``; the shared logger
  takes its level from ``REPRO_LOG_LEVEL`` as the reference's does, writes
  to stderr, and carries ``launch/serve.py``'s lines.
"""

import dataclasses
import io
import json
import logging
import re
import sys

import pytest
import torch

import repro.obs as jax_obs
import repro.provisioning  # noqa: F401
from repro.experiments import runner as jax_runner
from repro.experiments.scenario import CHAOS_SCENARIO_FAMILY as JAX_CHAOS_FAMILY
from repro.obs import export as jax_export
from repro.obs import incidents as jax_incidents
from repro.obs import log as jax_log
from repro.obs.metrics import Event as JaxEvent
from repro.obs.metrics import MetricsRecorder as JaxRecorder
from repro.obs.metrics import label_key as jax_label_key
from repro.obs.metrics import recording as jax_recording
from repro.provisioning.montecarlo import EnsembleSpec as JaxEnsembleSpec
from repro.provisioning.montecarlo import run_ensemble as jax_run_ensemble

import repro_torch.obs as obs
import repro_torch.provisioning  # noqa: F401
from repro_torch.experiments import runner
from repro_torch.launch import serve
from repro_torch.obs import export, incidents
from repro_torch.obs import log as obs_log
from repro_torch.obs.metrics import Event, MetricsRecorder, label_key, recording
from repro_torch.provisioning.montecarlo import EnsembleSpec, run_ensemble

from _torch_parity import assert_same
from test_torch_chaos import _compressed, _port

ENSEMBLE = "ensemble:chaos-pdu-loss-tree"
RUNS = list(JAX_CHAOS_FAMILY) + [ENSEMBLE]
_RUNS = {}


def _recorded(name: str):
    """(port snapshot, JAX snapshot) of the ``name`` run compressed to the
    test horizon, each package under its own recorder; cached per run.
    :data:`ENSEMBLE` is two routed members of chaos-pdu-loss-tree on one
    worker of the event-driven engine (its spans: the run and the shard)."""
    if name not in _RUNS:
        want_rec, got_rec = JaxRecorder(), MetricsRecorder()
        if name == ENSEMBLE:
            sc = _compressed(name.split(":")[1])
            with jax_recording(want_rec):
                jax_run_ensemble(JaxEnsembleSpec(sc, n_seeds=2, n_workers=1))
            with recording(got_rec):
                run_ensemble(EnsembleSpec(_port(sc), n_seeds=2, n_workers=1),
                             engine="numpy")
        else:
            sc = _compressed(name)
            with jax_recording(want_rec):
                jax_runner.run_experiment(sc)
            with recording(got_rec):
                runner.run_experiment(_port(sc))
        _RUNS[name] = (got_rec.snapshot(), want_rec.snapshot())
    return _RUNS[name]


_SPAN_VALUE = re.compile(r"^(\S+_seconds_(?:sum|min|max)(?:\{.*\})?) \S+$")


def _mask_span_values(text: str) -> list:
    """The exposition's lines with the span sums, minima and maxima (wall
    clock) replaced by a placeholder; every other line as it is."""
    return [_SPAN_VALUE.sub(r"\1 <wall-clock>", line) for line in text.splitlines()]


@pytest.mark.parametrize("name", RUNS)
def test_exports_of_recorded_chaos_run_equal_jax(name):
    got, want = _recorded(name)
    assert got.events and len(got.events) == len(want.events)
    assert bool(got.spans) == (name == ENSEMBLE)
    assert export.event_lines(got) == jax_export.event_lines(want)
    # spans hold wall-clock time: same names, labels and counts
    assert {k: s.count for k, s in got.spans.items()} == \
        {k: s.count for k, s in want.spans.items()}
    no_spans = lambda snap: dataclasses.replace(snap, spans={})  # noqa: E731
    assert export.prometheus_text(no_spans(got)) == \
        jax_export.prometheus_text(no_spans(want))
    assert _mask_span_values(export.prometheus_text(got)) == \
        _mask_span_values(jax_export.prometheus_text(want))


@pytest.mark.parametrize("name", RUNS)
def test_incidents_of_recorded_chaos_run_equal_jax(name):
    got, want = _recorded(name)
    rep = incidents.reconstruct_incidents(got.events)
    jrep = jax_incidents.reconstruct_incidents(want.events)
    assert_same(rep, jrep)
    assert incidents.incidents_json(rep) == jax_incidents.incidents_json(jrep)
    assert incidents.render_incidents_markdown(rep) == \
        jax_incidents.render_incidents_markdown(jrep)
    assert (rep.n_incidents > 0) == (name != "chaos-noop")


# the hand-built traces of tests/test_incidents.py: (t, subsystem, kind,
# labels) rows
def _fault(t, fault, target, t_sched=None, phase="fault_apply"):
    return (t, "chaos", phase, dict(fault=fault, target=target,
                                    t_sched=t if t_sched is None else t_sched))


def _engage(t, name, rule, target="", value=1.0):
    return (t, "alert", "alert_engage",
            dict(alert=name, rule=rule, target=target, value=value))


def _release(t, name):
    return (t, "alert", "alert_release", dict(alert=name))


_DERATE = [
    _fault(120.0, "node-derate", "row3", t_sched=100.0),
    _engage(110.0, "cap-proximity:pdu0", "cap-proximity", "pdu0", 0.97),
    (130.0, "row", "brake_engage", dict(row="row3")),
    (140.0, "controller", "rebalance", dict(n_moves=2)),
    (150.0, "row", "brake_release", dict(row="row3")),
    _fault(400.0, "node-derate", "row3", phase="fault_restore"),
    _release(410.0, "cap-proximity:pdu0"),
]
TRACES = {
    "empty": [],
    "single-fault": _DERATE,
    "shuffled": [_DERATE[i] for i in (6, 1, 5, 0, 3, 2, 4)],
    "overlapping": [
        _fault(100.0, "node-derate", "row0"),
        _fault(150.0, "site-demand-response", "site"),
        _engage(160.0, "cap-proximity:pdu0", "cap-proximity", "pdu0"),
        _fault(200.0, "node-derate", "row0", phase="fault_restore"),
        _engage(250.0, "slo-burn", "slo-burn"),
        _fault(300.0, "site-demand-response", "site", phase="fault_restore"),
        _release(310.0, "cap-proximity:pdu0"),
        _release(320.0, "slo-burn"),
    ],
    "never-released": [
        _fault(100.0, "node-derate", "row1"),
        _engage(110.0, "brake-storm", "brake-storm"),
        _fault(200.0, "node-derate", "row1", phase="fault_restore"),
    ],
    "unrestored": [
        _fault(100.0, "row-crash", "row2"),
        _engage(99999.0, "fault-active", "fault-active"),
    ],
    "crash-revive": [
        _fault(100.0, "row-crash", "row2"),
        _fault(500.0, "row-revive", "row2"),
    ],
    "false-alarm": [
        _fault(100.0, "node-derate", "row0"),
        _fault(200.0, "node-derate", "row0", phase="fault_restore"),
        _engage(250.0, "cap-proximity:pdu0", "cap-proximity", "pdu0", 1.01),
    ],
    "ground-truth": [
        _fault(100.0, "node-derate", "row0"),
        _engage(102.0, "fault-active", "fault-active"),
        _engage(130.0, "cap-proximity:pdu0", "cap-proximity", "pdu0"),
        _fault(300.0, "node-derate", "row0", phase="fault_restore"),
    ],
    "clear-floor": [
        _fault(100.0, "node-derate", "row0"),
        _engage(110.0, "slo-burn", "slo-burn"),
        _release(150.0, "slo-burn"),
        _fault(300.0, "node-derate", "row0", phase="fault_restore"),
    ],
}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_incidents_of_hand_built_traces_equal_jax(trace):
    rows = TRACES[trace]
    got = incidents.reconstruct_incidents(
        [Event(float(t), sub, kind, label_key(lab)) for t, sub, kind, lab in rows])
    want = jax_incidents.reconstruct_incidents(
        [JaxEvent(float(t), sub, kind, jax_label_key(lab)) for t, sub, kind, lab in rows])
    assert_same(got, want)
    for tick_s in (2.0, 1.0):
        assert incidents.incidents_json(got, tick_s=tick_s) == \
            jax_incidents.incidents_json(want, tick_s=tick_s)
        assert incidents.render_incidents_markdown(got, tick_s=tick_s) == \
            jax_incidents.render_incidents_markdown(want, tick_s=tick_s)


def test_artifacts_round_trip(tmp_path):
    got, _ = _recorded(ENSEMBLE)
    sc = _port(_compressed("chaos-pdu-loss-tree"))
    manifest = export.run_manifest(seed=3, scenario=sc, argv=["x", "--y"],
                                   extra={"rows": 12})
    paths = export.write_artifacts(str(tmp_path / "a"), got, manifest)
    assert paths == {"manifest": str(tmp_path / "a" / export.MANIFEST_NAME),
                     "metrics": str(tmp_path / "a" / export.METRICS_NAME),
                     "events": str(tmp_path / "a" / export.EVENTS_NAME)}
    assert export.read_events(paths["events"]) == got.events
    with open(paths["events"]) as f:
        assert f.read().splitlines() == export.event_lines(got)
    back = export.read_manifest(str(tmp_path / "a"))
    assert back == json.loads(json.dumps(manifest))
    assert (back["seed"], back["argv"], back["rows"]) == (3, ["x", "--y"], 12)
    assert back["scenario"]["name"] == "chaos-pdu-loss-tree"
    with open(paths["manifest"]) as f:
        assert f.read() == json.dumps(manifest, indent=2, sort_keys=True) + "\n"
    prom = export.read_prometheus(paths["metrics"])
    # the parser reads every sample back, with the reference's parser's result
    assert prom == jax_export.read_prometheus(paths["metrics"])
    counters = {(n, tuple(sorted(lab.items()))): v
                for n, rows in prom["counter"].items() for lab, v in rows}
    assert counters == {(export._sanitize(n), tuple((k, v) for k, v in lab)): v
                        for (n, lab), v in got.counters.items()}
    assert set(prom) == {"counter", "gauge", "histogram", "summary"}
    spans = {(n, tuple(sorted(lab.items()))): v
             for n, rows in prom["summary"].items() for lab, v in rows
             if n.endswith("_seconds_count")}
    assert spans == {(export._sanitize(n) + "_seconds_count", tuple(lab)): s.count
                     for (n, lab), s in got.spans.items()}


def test_manifest_keys_are_the_references_with_torch_cuda_device():
    sc = _compressed("chaos-noop")
    got = export.run_manifest(seed=1, scenario=_port(sc))
    want = jax_export.run_manifest(seed=1, scenario=sc)
    assert set(got) == (set(want) - {"jax"}) | {"torch", "cuda", "device"}
    assert got["torch"] == torch.__version__
    assert got["cuda"] == torch.version.cuda
    assert got["device"] is None  # no card here
    assert got["scenario"] == want["scenario"]
    for k in ("seed", "git_sha", "python", "platform", "numpy"):
        assert got[k] == want[k], k


def test_obs_exports_the_references_whole_all():
    assert obs.__all__ == jax_obs.__all__
    assert all(hasattr(obs, name) for name in obs.__all__)
    assert (obs.EVENTS_NAME, obs.METRICS_NAME, obs.MANIFEST_NAME,
            obs.INCIDENTS_NAME) == (jax_obs.EVENTS_NAME, jax_obs.METRICS_NAME,
                                    jax_obs.MANIFEST_NAME, jax_obs.INCIDENTS_NAME)


# ---------------------------------------------------------------------------
# the shared logger
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_logging():
    """Each package's logger reconfigured from the environment after the
    test (the handler binds the stderr of its setup)."""
    yield
    obs_log.setup_logging(force=True)
    jax_log.setup_logging(force=True)


@pytest.mark.parametrize("level", ["DEBUG", "INFO", "WARNING", "ERROR", "bogus"])
def test_log_level_from_repro_log_level(level, monkeypatch, fresh_logging):
    monkeypatch.setenv("REPRO_LOG_LEVEL", level)
    root = obs_log.setup_logging(force=True)
    want = jax_log.setup_logging(force=True)
    assert obs_log.ENV_VAR == jax_log.ENV_VAR == "REPRO_LOG_LEVEL"
    assert root.name == "repro_torch" and root.level == want.level
    assert root.level == getattr(logging, level, logging.INFO)
    assert not root.propagate and len(root.handlers) == 1
    handler = root.handlers[0]
    assert handler.stream is sys.stderr
    assert handler.formatter._fmt == "%(message)s"
    # idempotent: a second setup (as every get_logger does) changes nothing
    assert obs_log.setup_logging(level="ERROR") is root
    assert root.level == want.level and root.handlers == [handler]


def test_get_logger_nests_names_under_repro_torch(fresh_logging):
    stream = io.StringIO()
    obs_log.setup_logging("INFO", stream=stream, force=True)
    assert obs_log.get_logger("repro_torch.launch.serve").name == \
        "repro_torch.launch.serve"
    assert obs_log.get_logger("tools.report").name == "repro_torch.tools.report"
    obs_log.get_logger("tools.report").info("a %s line", "logged")
    obs_log.get_logger("x").debug("below the level")
    assert stream.getvalue() == "a logged line\n"


def test_serve_launcher_logs_through_the_shared_logger(capsys, fresh_logging):
    assert serve.log is obs_log.get_logger("repro_torch.launch.serve")
    obs_log.setup_logging("INFO", force=True)  # bind the captured stderr
    serve.main(["--arch", "gemma2-9b", "--smoke", "--device", "cpu",
                "--requests", "2", "--prompt", "20", "--out-tokens", "3",
                "--report-power"])
    out, err = capsys.readouterr()
    assert out == ""
    lines = err.splitlines()
    assert lines[0].startswith("served batch=2 prompt=20 out=3 on cpu in ")
    assert lines[1].startswith("sample output tokens: [")
    assert lines[2].startswith("[power, modelled A100 server] gemma2-9b: prompt phase ")
