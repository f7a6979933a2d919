"""The port's event-driven simulator against the JAX package's.

``repro_torch.core.simulator`` is a copy of the reference's plain-Python
event loop (``heapq`` events, per-server state, numpy only), and so are the
trace generator, the replication report, the power hierarchy and the cluster
simulator. The same inputs go through both packages here and every result is
held **exactly** equal: per-request latencies, power series, brake and cap
counts, cluster arrays, recorder events. Short horizons (3600 s) and hot
settings (power_scale 1.15-1.2 on an oversubscribed row) make caps and
brakes fire.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.hierarchy import PowerHierarchy as JaxPowerHierarchy
from repro.core.power_model import A100 as JAX_A100
from repro.core.power_model import ServerPower as JaxServerPower
from repro.core.simulator import RowSimulator as JaxRowSimulator
from repro.core.simulator import SimConfig as JaxSimConfig
from repro.core import traces as jax_traces
from repro.experiments.scenario import POLICY_BUILDERS as JAX_POLICIES
from repro.obs.metrics import MetricsRecorder as JaxRecorder
from repro.obs.metrics import recording as jax_recording

from repro_torch.core.hierarchy import PowerHierarchy
from repro_torch.core.power_model import A100, ServerPower
from repro_torch.core.simulator import RowSimulator, SimConfig
from repro_torch.core import traces
from repro_torch.experiments.scenario import POLICY_BUILDERS
from repro_torch.obs.metrics import MetricsRecorder, recording

import repro.provisioning  # noqa: F401  (registers the JAX generator families)
import repro_torch.provisioning  # noqa: F401  (registers the port's)

DURATION = 3600.0
N_PROVISIONED = 20
# (n_servers, power_scale, occupancy peak): "caps" caps without braking
# under polca; "brakes" fires the powerbrake under every policy
REGIMES = {"caps": (26, 1.15, 0.97), "brakes": (27, 1.2, 0.9)}
POLICIES = ["polca", "polca-predictive", "one-threshold", "no-cap"]


def _setup(port: bool):
    if port:
        server = ServerPower(A100)
        return server, traces, *traces.build_workload_classes("bloom-176b", server)
    server = JaxServerPower(JAX_A100)
    return (server, jax_traces,
            *jax_traces.build_workload_classes("bloom-176b", server))


def _row(port: bool, policy: str, regime: str, *, seed: int = 3,
         recorder=None):
    """One standalone row run in one package; returns (result, requests)."""
    n, ps, occ = REGIMES[regime]
    server, tr, wls, shares = _setup(port)
    reqs = tr.generate_requests(DURATION, n, wls, shares, seed=seed,
                                occ_kwargs={"peak": occ})
    sim_cls, cfg_cls, builders, rec_ctx, rec_cls = (
        (RowSimulator, SimConfig, POLICY_BUILDERS, recording, MetricsRecorder)
        if port else (JaxRowSimulator, JaxSimConfig, JAX_POLICIES,
                      jax_recording, JaxRecorder))
    sim = sim_cls(wls, server, n, N_PROVISIONED, builders[policy](), reqs,
                  shares, cfg_cls(power_scale=ps), duration=DURATION)
    rec = rec_cls() if recorder else None
    with rec_ctx(rec):
        res = sim.run()
    return res, reqs, rec


def _snapshot_without_spans(rec):
    snap = rec.snapshot()
    return (snap.counters,
            {k: (h.bounds, h.counts, h.sum, h.count) for k, h in snap.hists.items()},
            snap.gauges, [dataclasses.astuple(e) for e in snap.events])


def assert_sim_results_equal(got, want):
    """Every field of two SimResults, exactly."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "latency":
            assert a.hp_impacts == b.hp_impacts and a.lp_impacts == b.lp_impacts
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("policy", POLICIES)
def test_row_simulator_run_equals_jax(policy, regime):
    got, got_reqs, _ = _row(True, policy, regime)
    want, want_reqs, _ = _row(False, policy, regime)
    assert [dataclasses.astuple(r) for r in got_reqs] == \
        [dataclasses.astuple(r) for r in want_reqs]
    assert got.latencies == want.latencies
    np.testing.assert_array_equal(got.power_w, want.power_w)
    for name in ("n_brakes", "cap_events", "n_completed", "peak_power_frac",
                 "mean_power_frac"):
        assert getattr(got, name) == getattr(want, name), name
    assert_sim_results_equal(got, want)
    assert got.spike(60.0) == want.spike(60.0)
    if regime == "brakes":
        assert got.n_brakes > 0
    elif policy != "no-cap":
        assert got.cap_events > 0 and got.n_brakes == 0


@pytest.mark.parametrize("policy", ["polca", "no-cap"])
def test_row_recorder_equals_jax(policy):
    """Brake-edge events, their counters and the queue-delay histogram that
    the simulator records are the JAX package's, and recording does not move
    a bit of the result."""
    got, _, got_rec = _row(True, policy, "brakes", recorder=True)
    want, _, want_rec = _row(False, policy, "brakes", recorder=True)
    assert _snapshot_without_spans(got_rec) == _snapshot_without_spans(want_rec)
    assert got_rec.snapshot().counter_total("row_brake_edges_total") > 0
    assert_sim_results_equal(got, _row(True, policy, "brakes")[0])
    assert_sim_results_equal(got, want)


@pytest.mark.parametrize("generator", ["diurnal", "bursty", "nighttime"])
def test_generate_requests_equals_jax(generator):
    """The arrival trace from the built-in diurnal curve and from a
    registered generator's occupancy on the 60 s grid."""
    got_server, _, got_wls, got_shares = _setup(True)
    _, _, want_wls, want_shares = _setup(False)
    t_grid = np.arange(0.0, DURATION, 60.0)
    kw = {}
    if generator != "diurnal":
        kw = dict(t_grid=t_grid, occupancy=traces.get_occupancy_generator(
            generator)(t_grid, seed=5, peak=0.8, n_rows=1, row=0))
        want_occ = jax_traces.get_occupancy_generator(generator)(
            t_grid, seed=5, peak=0.8, n_rows=1, row=0)
        np.testing.assert_array_equal(kw["occupancy"], want_occ)
    got = traces.generate_requests(DURATION, 24, got_wls, got_shares, seed=9,
                                   occ_kwargs={"peak": 0.8}, **kw)
    want = jax_traces.generate_requests(DURATION, 24, want_wls, want_shares,
                                        seed=9, occ_kwargs={"peak": 0.8}, **kw)
    assert len(got) > 100
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert traces.list_occupancy_generators() == \
        jax_traces.list_occupancy_generators()


def test_replication_report_equals_jax():
    """Fig. 16's replication check on a no-cap run: target curve, rolling
    means and MAPE."""
    reports = []
    for port in (True, False):
        server, tr, wls, shares = _setup(port)
        res, _, _ = _row(port, "no-cap", "caps")
        n, _, occ = REGIMES["caps"]
        reports.append(tr.replication_report(
            res.power_t, res.power_w, wls, shares, server, n, N_PROVISIONED,
            occ_peak=occ, smooth_window_s=120.0, duration_s=DURATION))
    got, want = reports
    assert got.mape == want.mape and 0.0 < got.mape < 1.0
    np.testing.assert_array_equal(got.sim_smooth, want.sim_smooth)
    np.testing.assert_array_equal(got.target_smooth, want.target_smooth)
    a = np.linspace(1.0, 2.0, 7)
    assert traces.mape(a, a[::-1]) == jax_traces.mape(a, a[::-1])
    np.testing.assert_array_equal(traces.rolling_mean(a, 3),
                                  jax_traces.rolling_mean(a, 3))


@pytest.mark.parametrize("shape", [None, (2, 3), (2, 2, 2)])
def test_hierarchy_publish_and_conservation_equal_jax(shape):
    """``publish`` pushes the same ancestor fractions into the rows,
    ``fold`` gives the same fractions, and ``conservation_errors`` reports
    the same violations once an interior budget is moved."""
    rng = np.random.default_rng(4)
    n_rows = 6 if shape is None else int(np.prod(shape))
    budgets = rng.uniform(8e4, 1.2e5, n_rows)
    power = rng.uniform(5e4, 1.3e5, (5, n_rows))
    trees = []
    for cls in (PowerHierarchy, JaxPowerHierarchy):
        trees.append(cls.two_level(budgets, rows_per_rack=4) if shape is None
                     else cls.from_shape(shape, budgets,
                                         budget_fracs={"1": 0.8}))
    got, want = trees
    assert [a.tolist() for a in got.ancestors] == \
        [a.tolist() for a in want.ancestors]
    np.testing.assert_array_equal(got.interior, want.interior)
    assert got.root_budget_w == want.root_budget_w
    np.testing.assert_array_equal(got.fold(power), want.fold(power))
    np.testing.assert_array_equal(got.node_cap_w, want.node_cap_w)

    class _Row:
        group_fracs = None

    rows = [[_Row() for _ in range(n_rows)] for _ in trees]
    fracs = [h.publish(r, power[2]) for h, r in zip(trees, rows)]
    np.testing.assert_array_equal(fracs[0], fracs[1])
    assert [r.group_fracs for r in rows[0]] == [r.group_fracs for r in rows[1]]
    assert got.conservation_errors() == want.conservation_errors() == []
    for h in trees:
        h.node_budget_w[h.interior[0]] *= 1.1
    assert got.conservation_errors() == want.conservation_errors() != []
