"""The port's checkpointing and training runtime, on the CPU.

* ``checkpointer``: round trip with float32, int32 and bf16 leaves (bf16
  restored bit for bit through its uint16 view), the ``keep`` GC, the
  torn-write fallback, the atomic write (no temp file left), and the file's
  keys equal to the JAX package's ``_flatten`` keys of the same config's
  train state.
* ``TrainSupervisor``: faults injected at steps 6 and 9 of a 12-step run of
  the port's train step replay to the fault-free run's state within atol
  1e-6 (``tests/test_checkpoint.py``'s contract); ``FaultInjector.reset``;
  the power-event drain; ``StragglerMonitor`` flags.
* ``BrakeSentinel`` on the port's ``fig14-plus30`` run at a 14 kW budget
  fires at the times JAX's fires on JAX's run, and drains the supervisor.
* ``elastic_reshard`` re-places a host state onto a device with the
  template's dtypes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jax_checkpointer
from repro.configs import smoke_config as jax_smoke_config
from repro.experiments import get_scenario as jax_get_scenario
from repro.experiments import run_experiment as jax_run_experiment
from repro.models import model as jax_model
from repro.models.param import init_params as jax_init_params
from repro.optim import make_optimizer as jax_make_optimizer
from repro.runtime.fault_tolerance import BrakeSentinel as JaxBrakeSentinel
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.experiments import get_scenario, run_experiment
from repro_torch.launch.steps import abstract_state, build_train_step
from repro_torch.launch.train import init_state
from repro_torch.optim import make_optimizer
from repro_torch.runtime.fault_tolerance import (BrakeSentinel, FaultInjector,
                                                 StragglerMonitor, TrainSupervisor,
                                                 elastic_reshard)


def _tiny_state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.tensor([1.0, -2.5, 3.25]).to(torch.bfloat16),
                       "e": torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
                       .to(torch.bfloat16)},
            "opt": {"mu": {"w": torch.zeros((2, 3)), "b": torch.zeros(3)},
                    "count": torch.tensor(4, dtype=torch.int32)}}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def test_roundtrip_keeps_dtypes_and_bf16_bits(tmp_path):
    st = _tiny_state()
    path = checkpointer.save(str(tmp_path), 7, st)
    assert os.listdir(tmp_path) == ["step_7.npz"]  # the temp file was renamed
    step, st2 = checkpointer.restore_latest(str(tmp_path), st)
    assert step == 7
    for (k, a), (_, b) in zip(_leaves(st), _leaves(st2), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k
    with np.load(path) as data:
        assert data["params/e@bfloat16"].dtype == np.uint16
        assert int(data["__step__"]) == 7


def test_gc_keeps_latest(tmp_path):
    st = _tiny_state()
    for s in range(6):
        checkpointer.save(str(tmp_path), s, st, keep=3)
    assert checkpointer.list_steps(str(tmp_path)) == [3, 4, 5]


def test_torn_write_fallback(tmp_path):
    st = _tiny_state()
    checkpointer.save(str(tmp_path), 1, st)
    checkpointer.save(str(tmp_path), 2, st)
    with open(os.path.join(tmp_path, "step_3.npz"), "wb") as f:
        f.write(b"not a zip")
    step, _ = checkpointer.restore_latest(str(tmp_path), st)
    assert step == 2
    assert checkpointer.restore_latest(str(tmp_path / "none"), st) == (None, st)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b", "whisper-base"])
def test_keys_are_the_reference_flatten_keys(tmp_path, arch):
    """The file's keys (bf16 tags stripped) are the reference's ``_flatten``
    paths of the same config's train state (kimi-k2: bf16 parameters)."""
    cfg = smoke_config(arch)
    opt = make_optimizer(cfg.optimizer)
    path = checkpointer.save(str(tmp_path), 1, init_state(cfg, opt, "cpu"))
    jcfg = jax_smoke_config(arch)
    jopt = jax_make_optimizer(jcfg.optimizer)
    pspecs = jax_model.model_specs(jcfg, 1)
    jstate = {"params": jax_init_params(pspecs, jax.random.key(0)),
              "opt": jax_init_params(jopt.init_specs(pspecs), jax.random.key(1))}
    want = jax_checkpointer._flatten(jstate)
    with np.load(path) as data:
        got = {k.removesuffix(checkpointer.BF16_TAG): data[k] for k in data.files}
    assert sorted(got) == sorted(list(want) + ["__step__"])
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert got[k].dtype == (np.uint16 if str(v.dtype) == "bfloat16" else v.dtype), k


def test_supervisor_crash_restart_replays_exactly(tmp_path):
    """Faults at steps 6 and 9 of 12: the supervisor restores the newest
    checkpoint and replays; the final state equals the fault-free run's."""
    cfg = smoke_config("llama3.2-1b")
    opt = make_optimizer(cfg.optimizer)
    state0 = init_state(cfg, opt, "cpu")
    pipeline = SyntheticTokenPipeline(cfg, DataConfig(2, 32))
    clean_step = build_train_step(cfg, None, None, opt)
    sup_clean = TrainSupervisor(clean_step, pipeline, str(tmp_path / "clean"), ckpt_interval=4)
    final_clean, _ = sup_clean.run(state0, 12)

    inj = FaultInjector(fail_at=[6, 9])

    def faulty_step(state, batch):
        inj.maybe_fail(len(sup_faulty.history))
        return clean_step(state, batch)

    sup_faulty = TrainSupervisor(faulty_step, pipeline, str(tmp_path / "faulty"),
                                 ckpt_interval=4)
    final_faulty, last = sup_faulty.run(state0, 12)
    assert sup_faulty.n_restarts == 2 and last == 12
    for (k, a), (_, b) in zip(_leaves(final_clean), _leaves(final_faulty), strict=True):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-6, err_msg=k)
    clean_loss = {h["step"]: h["loss"] for h in sup_clean.history}
    assert len(sup_faulty.history) > 12  # replayed steps are recorded again
    for h in sup_faulty.history:  # every replay of a step repeats its loss exactly
        assert h["loss"] == clean_loss[h["step"]], h


def test_fault_injector_reset_reinjects():
    inj = FaultInjector(fail_at=[2])
    with pytest.raises(RuntimeError):
        inj.maybe_fail(2)
    inj.maybe_fail(2)  # already seen: silent
    inj.reset()
    with pytest.raises(RuntimeError):
        inj.maybe_fail(2)


class _CountingPipeline:
    def batch_at(self, step):
        return {"step": step}


def test_supervisor_power_event_checkpoints_and_drains(tmp_path):
    seen = []

    def step_fn(state, batch):
        if int(state["x"]) == 3:
            sup.power_event("sustained-brake")
        return {"x": state["x"] + 1.0}, {"loss": 0.0}

    sup = TrainSupervisor(step_fn, _CountingPipeline(), str(tmp_path),
                          ckpt_interval=100, on_power_event=seen.append)
    sup.power_event("brake-cleared")  # informational: no drain
    state, step = sup.run({"x": torch.tensor(0.0)}, 10)
    assert step == 4 and float(state["x"]) == 4.0
    assert sup.power_events == ["brake-cleared", "sustained-brake"] == seen
    assert checkpointer.list_steps(str(tmp_path))[-1] == 4
    state, step = sup.run(state, 10, start_step=step)  # the drain is one-shot
    assert step == 10 and float(state["x"]) == 10.0


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0)
    for i in range(10):
        mon.observe(i, 0.1)
    assert mon.observe(10, 0.5)
    assert mon.flagged_steps == [10]
    assert not mon.observe(11, 0.12)


def test_brake_sentinel_fires_on_sustained_runs_only():
    s = BrakeSentinel(sustain_ticks=3)
    pattern = [False, True, True, False, True, True, True, True]
    fired = [s.observe(float(i), b) for i, b in enumerate(pattern)]
    assert fired == [None] * 6 + ["sustained-brake", None]
    assert s.events == [6.0]


def test_brake_sentinel_on_the_port_run_matches_jax(tmp_path):
    """The port's fig14-plus30 row at a 14 kW budget brakes at the same
    ticks as JAX's, the sentinel fires at the same times, and its event
    drains the supervisor before the first step."""
    kw = dict(duration_s=900.0, budget=14_000.0, compare_to_reference=False)
    res = run_experiment(get_scenario("fig14-plus30").with_(**kw)).result
    jres = jax_run_experiment(jax_get_scenario("fig14-plus30").with_(**kw)).result
    np.testing.assert_array_equal(res.braked_series, jres.braked_series)

    def step_fn(state, batch):
        return {"x": state["x"] + 1.0}, {"loss": 0.0}

    sup = TrainSupervisor(step_fn, _CountingPipeline(), str(tmp_path))
    fired = BrakeSentinel(sustain_ticks=3).scan(res, supervisor=sup)
    assert fired and fired == JaxBrakeSentinel(sustain_ticks=3).scan(jres)
    assert "sustained-brake" in sup.power_events
    _, step = sup.run({"x": torch.tensor(0.0)}, 5)
    assert step == 0 and checkpointer.list_steps(str(tmp_path)) == [0]


def test_elastic_reshard_replaces_a_host_state():
    cfg = smoke_config("kimi-k2-1t-a32b")
    opt = make_optimizer(cfg.optimizer)
    host = init_state(cfg, opt, "cpu", seed=3)
    host_np = {k: {n: v for n, v in _numpy_tree(t).items()} for k, t in host.items()}
    out = elastic_reshard(lambda dev: abstract_state(cfg, opt), host_np, "cpu")
    for (k, a), (_, b) in zip(_leaves(host), _leaves(out), strict=True):
        assert b.device.type == "cpu" and b.dtype == a.dtype and torch.equal(a, b), k


def _numpy_tree(tree):
    """float32 numpy copies of a state's leaves (bf16 values are exact in
    float32), as a host-side restore holds them."""
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.float().numpy()
                if v.is_floating_point() else v.numpy()) for k, v in tree.items()}
