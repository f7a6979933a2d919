"""Guards of the PyTorch port's boundaries.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
  anything of the JAX package ``repro`` (an AST scan, so imports inside
  functions count too), the port's copies of ``core/hierarchy.py`` and
  ``chaos/faults.py`` included.
* A scenario the JAX package serializes with a hierarchy and a fault
  timeline loads in the port; ``routing``, ``controller`` and ``alerts``
  still raise.
* Entry points run on the CUDA card unless the caller passes
  ``device="cpu"``: without CUDA they raise instead of falling back, on both
  batched engines and on the calibrated ``mc-*`` scenarios;
  ``resolve_devices`` refuses a card that does not exist. The event-driven
  engine (``engine="numpy"``) runs on the host only when asked for by name
  and refuses a device and the batched engines' options.
* The port's scenario registry is the JAX package's without the routed
  fleet, rebalancing, site and chaos families.
* ``ops.polca_tick``, ``ops.flash_attention`` and ``ops.decode_attention``
  take the plain version for CPU tensors without touching the kernels'
  launch counters; the kernel wrappers refuse CPU tensors. Under grad,
  ``ops.flash_attention`` on CPU tensors runs the training forward's and the
  backward's plain versions without touching theirs; their wrappers refuse
  CPU tensors too.
* On ``meta`` tensors the attention wrappers and the training Function
  take the kernels' traceable ops (``kernels/traced.py``) without touching
  the launch counters.
* The training modules (``optim``, ``data``, ``checkpoint``, ``runtime``,
  ``launch/train.py``) and the dry run's (``launch/{dryrun,mesh}.py``,
  ``parallel/roofline.py``, ``kernels/traced.py``) are scanned like the
  rest, and ``launch.train`` raises without a card unless ``--device cpu``
  is given.
* ``chip_smoke.py`` holds the kernels against their plain versions on the
  kernel test shapes of ``tests/test_kernels.py``.
"""

import ast
import importlib.util
from pathlib import Path

import pytest
import torch

import numpy as np

from test_kernels import DECODE_CASES, FLASH_CASES, TICK_CASES, TICK_CONSTS
from _torch_train_ref import BF16_STORAGE_RTOL, CONDITIONED, RTOL

from repro_torch.experiments.scenario import FleetSpec, Scenario, TrafficSpec
from repro_torch.configs import smoke_config
from repro_torch.kernels import decode_attention, flash_attention, ops, tick
from repro_torch.launch import serve, train
from repro_torch.device import resolve_devices
from repro_torch.provisioning import (
    EnsembleSpec,
    plan_capacity,
    plan_scenarios,
    run_ensemble,
    run_ensemble_grid,
)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _small_spec():
    sc = Scenario(name="guard", duration_s=600.0,
                  fleet=FleetSpec(n_provisioned=10, n_rows=2),
                  traffic=TrafficSpec(occ_peak=0.9), budget="nominal")
    return EnsembleSpec(sc, n_seeds=2)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ensemble(_small_spec())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ensemble(_small_spec(), device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan_capacity(_small_spec().base)
    for call in (lambda: run_ensemble(_small_spec(), engine="torch"),
                 lambda: run_ensemble(_small_spec(), engine="torch",
                                      devices=["cuda:0"]),
                 lambda: run_ensemble_grid([_small_spec().base], n_seeds=2),
                 lambda: plan_scenarios([_small_spec().base],
                                        engine="torch")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    res = run_ensemble(_small_spec(), device="cpu")
    assert res.n_members == 2
    res = run_ensemble(_small_spec(), engine="torch", device="cpu")
    assert res.n_members == 2
    cfg = smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.ServeEngine(cfg, 32, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "llama3.2-1b", "--smoke"])
    assert serve.ServeEngine(cfg, 32, 2, device="cpu").device.type == "cpu"
    serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                "--requests", "2", "--prompt", "8", "--out-tokens", "2",
                "--report-power"])
    # a sharded run needs its ranks (torchrun; tests/test_torch_sharded.py
    # serves every arch on 8), and is never served unsharded instead
    for arch in ("llama3.2-1b", "mamba2-370m"):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--model-par", "2"])


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine='cuda'"):
        run_ensemble(_small_spec(), engine="pallas", device="cpu")


def test_cpu_tensors_take_plain_version_without_launching():
    c = tick.TickConsts(**TICK_CONSTS)
    args = (torch.full((3, 8, 2), 0.9, dtype=torch.float64),
            torch.ones((8, 2), dtype=torch.float64),
            torch.full((2,), 10_000.0, dtype=torch.float64))
    kw = dict(oob_ticks=5, brake_ticks=2, ring_depth=6, esc=4)
    tick.polca_tick_loop.launches = 0
    got = ops.polca_tick(*args, consts=c, **kw)
    assert tick.polca_tick_loop.launches == 0
    want = tick.polca_tick_plain(*args, c, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="CUDA kernel"):
        tick.polca_tick_loop(*args, c, **kw)
    assert tick.polca_tick_loop.launches == 0


def test_cpu_attention_takes_plain_versions_without_launching():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 40, 4, 16), generator=g, dtype=torch.bfloat16)
    k = torch.randn((2, 40, 2, 16), generator=g, dtype=torch.bfloat16)
    v = torch.randn((2, 40, 2, 16), generator=g, dtype=torch.bfloat16)
    flash_attention.flash_attention.launches = 0
    decode_attention.decode_attention.launches = 0
    got = ops.flash_attention(q, k, v, causal=True, window=8, q_offset=3)
    assert torch.equal(got, flash_attention.flash_attention_plain(
        q, k, v, causal=True, window=8, q_offset=3))
    got = ops.decode_attention(q[:, 0], k, v, 17, softcap=20.0)
    assert torch.equal(got, decode_attention.decode_attention_plain(
        q[:, 0], k, v, 17, softcap=20.0))
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_attention.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA kernel"):
        decode_attention.decode_attention(q[:, 0], k, v, 17)
    assert flash_attention.flash_attention.launches == 0
    assert decode_attention.decode_attention.launches == 0


def test_cpu_training_attention_takes_plain_versions_without_launching():
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 24, 4, 16), generator=g, requires_grad=True)
    k = torch.randn((2, 24, 2, 16), generator=g, requires_grad=True)
    v = torch.randn((2, 24, 2, 16), generator=g, requires_grad=True)
    fa = flash_attention
    for fn in (fa.flash_attention, fa.flash_attention_lse, fa.flash_attention_bwd):
        fn.launches = 0
    o = ops.flash_attention(q, k, v, causal=True)
    o.sum().backward()
    assert torch.equal(o.detach(), fa.flash_attention_plain(q.detach(), k.detach(),
                                                            v.detach(), causal=True))
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    _, lse = fa.flash_attention_lse_plain(q.detach(), k.detach(), v.detach())
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention_lse(q.detach(), k.detach(), v.detach())
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention_bwd(o.detach(), q.detach(), k.detach(), v.detach(), o.detach(), lse)
    assert fa.flash_attention.launches == fa.flash_attention_lse.launches == \
        fa.flash_attention_bwd.launches == 0


def test_meta_attention_takes_traced_ops_without_launching():
    """On ``meta`` tensors (the dry run's trace) the attention wrappers and
    the training Function call the traceable ops of ``kernels/traced.py``:
    outputs of the kernels' shapes, no launch counted, no plain scores."""
    fa = flash_attention
    for fn in (fa.flash_attention, fa.flash_attention_lse, fa.flash_attention_bwd,
               decode_attention.decode_attention):
        fn.launches = 0
    q = torch.empty(2, 16, 4, 8, device="meta", requires_grad=True)
    k = torch.empty(2, 16, 2, 8, device="meta", requires_grad=True)
    o = ops.flash_attention(q, k, k)
    dq, dk = torch.autograd.grad(o.sum(), [q, k])
    with torch.no_grad():
        outs = [ops.flash_attention(q, k, k), ops.decode_attention(q[:, 0], k, k, 9)]
    assert [t.shape for t in (o, dq, dk, *outs)] == [q.shape, q.shape, k.shape, q.shape,
                                                     q[:, 0].shape]
    assert all(t.device.type == "meta" for t in (o, dq, dk, *outs))
    assert fa.flash_attention.launches == fa.flash_attention_lse.launches == \
        fa.flash_attention_bwd.launches == decode_attention.decode_attention.launches == 0


def test_train_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--arch", "llama3.2-1b", "--smoke", "--steps", "2", "--batch", "2", "--seq",
            "16", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(args + ["--device", "cuda"])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        train.main(args + ["--device", "cpu", "--model-par", "2"])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        train.main(["--arch", "mamba2-370m"] + args[2:] + ["--device", "cpu",
                                                          "--model-par", "2"])
    assert not any(tmp_path.iterdir())  # nothing ran
    assert len(train.main(args + ["--device", "cpu"])) == 2


def test_decode_split_covers_the_valid_slots():
    """Splits are whole 64-slot tiles, cover [0, valid_len) and give at least
    two blocks per SM when the valid slots are enough for that."""
    for bkv, vl in ((64, 1100), (1, 1024), (24, 17), (64, 32768), (4, 1), (8, 0)):
        sl, n = decode_attention.split_plan(bkv, vl, 132)
        assert sl % decode_attention.SPLIT_GRAIN == 0 and n * sl >= vl
        assert (n - 1) * sl < max(vl, 1)  # no split starts at or past valid_len
        assert n * bkv >= min(2 * 132, -(-max(vl, 1) // 64) * bkv)
    assert decode_attention.split_plan(64, 1100, 132) == (256, 5)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises with a message naming it (and writes
    nothing); it never substitutes another implementation."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LOADED", {})
    assert _build.sources() == ["decode_attention", "flash_attention", "flash_attention_bwd",
                                "tick"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("tick")
    assert not (tmp_path / "kernels").exists()


def test_chip_smoke_checks_the_kernel_test_shapes():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.TICK_CASES == TICK_CASES
    assert smoke.TICK_CONSTS == TICK_CONSTS
    by_name = lambda cases, i: [(*c[:i], np.dtype(c[i]).name, *c[i + 1:])
                                for c in cases]
    assert smoke.FLASH_CASES == by_name(FLASH_CASES, 6)
    assert smoke.DECODE_CASES == DECODE_CASES
    # the training phase conditions the archs the training tests condition
    # and bounds bf16 parameter storage as they do
    assert smoke.TRAIN_CONDITIONED == CONDITIONED
    assert smoke.BF16_STORAGE_RTOL == BF16_STORAGE_RTOL and smoke.TRAIN_F32_RTOL == RTOL


def test_copied_numpy_modules_are_scanned():
    rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/core/hierarchy.py",
            "src/repro_torch/chaos/faults.py",
            "src/repro_torch/chaos/__init__.py",
            "src/repro_torch/chaos/injector.py",
            "src/repro_torch/fleet/fleet.py",
            "src/repro_torch/fleet/controller.py",
            "src/repro_torch/obs/alerts.py",
            "src/repro_torch/obs/stream.py",
            "src/repro_torch/obs/export.py",
            "src/repro_torch/obs/incidents.py",
            "src/repro_torch/obs/log.py",
            "src/repro_torch/optim/optimizers.py",
            "src/repro_torch/optim/compression.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/checkpoint/checkpointer.py",
            "src/repro_torch/runtime/fault_tolerance.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/parallel/roofline.py",
            "src/repro_torch/parallel/collectives.py",
            "src/repro_torch/models/model.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/kernels/decode_attention.py",
            "src/repro_torch/launch/steps.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/kernels/traced.py"} <= rel


def test_jax_scenario_with_hierarchy_and_faults_loads():
    """A scenario serialized by the JAX package with a HierarchySpec and a
    FaultSpec loads in the port with both fields and serializes back to the
    same dict; so do the routing, controller and alerts fields."""
    from conftest import parity_scenario
    from repro.chaos.faults import FaultEvent as JaxFaultEvent
    from repro.experiments.scenario import HierarchySpec as JaxHierarchySpec
    from repro_torch.chaos import FaultEvent, FaultSpec
    from repro_torch.experiments.scenario import HierarchySpec

    jax_sc = parity_scenario(n_rows=6, duration_s=1800.0, hierarchy=JaxHierarchySpec(
        shape=(2, 3), level_names=("site", "rack"), budget_fracs={"1": 0.9}),
        faults=[JaxFaultEvent("row-crash", t=60.0, row=2),
                JaxFaultEvent("node-derate", t=90.0, node="rack1",
                              factor=0.5, until=400.0, ramp_s=30.0)])
    sc = Scenario.from_dict(jax_sc.to_dict())
    assert sc.to_dict() == jax_sc.to_dict()
    assert isinstance(sc.hierarchy, HierarchySpec) and sc.hierarchy.n_rows == 6
    assert isinstance(sc.faults, FaultSpec)
    assert sc.faults.events[1] == FaultEvent("node-derate", t=90.0,
                                             node="rack1", factor=0.5,
                                             until=400.0, ramp_s=30.0)
    again = sc.with_hierarchy((3, 2)).with_faults(None)
    assert again.fleet.n_rows == 6 and again.faults is None
    for field, value in (("routing", {"router": "jsq"}),
                         ("controller", {"kind": "static"}), ("alerts", [])):
        d = jax_sc.to_dict()
        d[field] = value
        got = Scenario.from_dict(d)
        assert got.to_json() == type(jax_sc).from_dict(d).to_json()
        assert Scenario.from_json(got.to_json()) == got
    with pytest.raises(ValueError, match="unknown kind"):
        FaultSpec(({"kind": "meteor", "t": 1.0},))


def test_resolve_devices(monkeypatch):
    """resolve_devices resolves each entry like resolve_device, names a bare
    'cuda' by the current card, and raises for a card that does not exist,
    an empty sequence, or a single device passed as a sequence."""
    assert resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_devices(["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_devices(["cuda", "cuda:0"]) == [
        torch.device("cuda", 1), torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="does not exist"):
        resolve_devices(["cuda:0", "cuda:2"])
    with pytest.raises(ValueError, match="empty"):
        resolve_devices([])
    with pytest.raises(TypeError, match="sequence"):
        resolve_devices("cpu")


def test_registry_equals_jax():
    """The port registers every scenario of the JAX package's registry, the
    fleet, rebalancing, site and chaos families included, each with the
    same fields and the same JSON text."""
    import repro.provisioning  # noqa: F401  (registers the JAX mc-* scenarios)
    import repro_torch.provisioning  # noqa: F401
    from repro.experiments import scenario as jax_scenario
    from repro_torch.experiments import scenario
    from repro_torch.experiments.scenario import get_scenario, list_scenarios

    want = jax_scenario.list_scenarios()
    assert list_scenarios() == want
    assert not hasattr(scenario, "UNPORTED_FIELDS")
    assert {"mc-diurnal", "fig14-plus30", "table2-baseline", "fleet-cap-aware",
            "fleet-rebalance-predictive", "site-tree-predictive",
            "chaos-row-crash"} <= set(want)
    for family in ("FLEET_SCENARIO_FAMILY", "SITE_SCENARIO_FAMILY",
                   "CHAOS_SCENARIO_FAMILY"):
        assert getattr(scenario, family) == getattr(jax_scenario, family)
    for name in want:
        assert get_scenario(name).to_dict() == \
            jax_scenario.get_scenario(name).to_dict(), name
        assert get_scenario(name).to_json() == \
            jax_scenario.get_scenario(name).to_json(), name


@pytest.mark.parametrize("opts", [
    pytest.param(dict(device="cuda"), id="device-cuda"),
    pytest.param(dict(device="cpu"), id="device-cpu"),
    pytest.param(dict(member_chunk=4), id="member_chunk"),
    pytest.param(dict(devices=["cpu"]), id="devices"),
    pytest.param(dict(keep_series=False), id="keep_series"),
])
def test_event_driven_engine_refuses_batched_options(opts):
    """engine="numpy" runs on the host: a device or a batched-engine option
    raises (as JAX's engine="numpy" refuses the batched options), on
    run_ensemble, run_ensemble_grid and plan_capacity."""
    spec = _small_spec()
    with pytest.raises(ValueError, match="engine='numpy'"):
        run_ensemble(spec, engine="numpy", **opts)
    with pytest.raises(ValueError, match="engine='numpy'"):
        run_ensemble_grid([spec.base], n_seeds=2, engine="numpy", **opts)
    with pytest.raises(ValueError, match="engine='numpy'"):
        plan_capacity(spec.base, n_seeds=2, engine="numpy", **opts)


def test_cuda_engine_still_raises_without_a_card_on_calibrated_scenarios(
        monkeypatch):
    """The event-driven engine is no CPU fallback: without a card the default
    engine="cuda" raises on the calibrated mc-* family as on any scenario,
    and only engine="numpy", asked for by name, runs on the host."""
    import repro_torch.provisioning  # noqa: F401
    from repro_torch.experiments.scenario import get_scenario

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = get_scenario("mc-diurnal").with_(duration_s=600.0)
    spec = EnsembleSpec(base, n_seeds=1)
    for call in (lambda: run_ensemble(spec),
                 lambda: run_ensemble(spec, engine="cuda"),
                 lambda: run_ensemble_grid([base], n_seeds=1, engine="cuda"),
                 lambda: plan_capacity(base, n_seeds=1),
                 lambda: plan_scenarios([base], n_seeds=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    res = run_ensemble(EnsembleSpec(base, n_seeds=1, n_workers=1),
                       engine="numpy")
    assert res.n_members == 1 and res.budget_w > 0
