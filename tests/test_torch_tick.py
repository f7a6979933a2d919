"""The port's tick loop (``repro_torch.kernels``) against the JAX reference.

Same inputs, made with numpy from the seeds of ``tests/test_kernels.py``, go
through ``repro.kernels.ref.polca_tick_reference`` (run in float64 under
``jax.enable_x64``, as the JAX package's own tests run it) and through the
port's plain version: ``ops.polca_tick`` on CPU tensors, which the engine
calls and which the port's ``ref.polca_tick_reference`` names. Contract: the
brake, frequency and count planes are bit-identical; row watts agree to
1e-6 relative (measured ~3e-16: the two frameworks' ``pow`` may differ in
the last bit). The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_kernels import TICK_CASES, TICK_CONSTS

from repro.kernels import ref as jax_ref
from repro.kernels.tick import TickConsts as JaxTickConsts
from repro_torch.kernels import ops, tick

ROW_W_RTOL = 1e-6


def _inputs(case):
    N, T, R, _, oob, brake, esc, ps = case
    consts = {**TICK_CONSTS, "power_scale": ps}
    rng = np.random.default_rng(N * 1000 + T)
    occ = rng.uniform(0.3, 1.0, (N, T, R))
    bscale = rng.uniform(0.9, 1.0, (T, R))
    row_budget = (consts["n_servers"]
                  * (consts["p0_srv_w"] + 0.8 * consts["k_lp_w"]) * np.ones(R))
    kw = dict(oob_ticks=oob, brake_ticks=brake,
              ring_depth=max(oob, brake) + 1, esc=esc)
    return consts, (occ, bscale, row_budget), kw


def _jax_reference(consts, arrays, kw):
    with jax.enable_x64(True):
        out = jax_ref.polca_tick_reference(
            *(jnp.asarray(a) for a in arrays), JaxTickConsts(**consts), **kw)
        return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("case", TICK_CASES,
                         ids=lambda c: f"n{c[0]}t{c[1]}r{c[2]}ps{c[7]}")
def test_tick_matches_jax_reference(case):
    consts, arrays, kw = _inputs(case)
    want = _jax_reference(consts, arrays, kw)
    occ, bscale, row_budget = (torch.from_numpy(a) for a in arrays)
    out = ops.polca_tick(occ, bscale, row_budget,
                         consts=tick.TickConsts(**consts), **kw)
    got = {k: v.numpy() for k, v in out.items()}
    for k in ("fire", "f_lp", "f_hp", "n_brakes"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["row_w"], want["row_w"], rtol=ROW_W_RTOL,
                               atol=0.0)


def test_tick_brakes_actually_fire():
    """The hot case exercises the brake path on the port too (otherwise the
    parity above proves nothing about rings and latches)."""
    c = tick.TickConsts(**{**TICK_CONSTS, "power_scale": 1.30})
    out = ops.polca_tick(torch.full((4, 64, 2), 0.98, dtype=torch.float64),
                         torch.ones((64, 2), dtype=torch.float64),
                         torch.full((2,), c.n_servers * 250.0,
                                    dtype=torch.float64),
                         consts=c, oob_ticks=20, brake_ticks=3,
                         ring_depth=21, esc=25)
    assert int(out["n_brakes"].sum()) > 0
    # every firing lands on the brake frequency brake_ticks later
    fire = out["fire"].numpy()
    f_lp = out["f_lp"].numpy()
    m, k, r = np.argwhere(fire)[0]
    assert f_lp[m, k + 3, r] == c.brake_freq


def test_power_planes_match_jax():
    """``row_power_w`` and ``lp_power_w`` (the predictive step's LP share)
    against the JAX functions on the same random state."""
    from repro.kernels import tick as jax_tick

    rng = np.random.default_rng(3)
    occ, f_lp, f_hp = (rng.uniform(0.2, 1.0, (7, 3)) for _ in range(3))
    jc = JaxTickConsts(**TICK_CONSTS)
    c = tick.TickConsts(**TICK_CONSTS)
    t = [torch.from_numpy(a) for a in (occ, f_lp, f_hp)]
    with jax.enable_x64(True):
        want_row = np.asarray(jax_tick.row_power_w(jc, occ, f_lp, f_hp))
        want_lp = np.asarray(jax_tick.lp_power_w(jc, occ, f_lp))
    np.testing.assert_allclose(tick.row_power_w(c, *t).numpy(), want_row,
                               rtol=ROW_W_RTOL, atol=0.0)
    np.testing.assert_allclose(tick.lp_power_w(c, t[0], t[1]).numpy(),
                               want_lp, rtol=ROW_W_RTOL, atol=0.0)


def test_latch_step_predictive_informed_escalation():
    """The predictive branch of ``polca_latch_step`` (ported with the
    non-predictive one) skips the escalation wait when LP power cannot
    bring the row below T2, exactly as ``PredictivePolcaPolicy`` does."""
    c = tick.TickConsts(**TICK_CONSTS)
    t = torch.tensor([True])
    f = torch.tensor([False])
    lat = tick.PolcaLatches(t1c=t, t2c=t, hpc=f, brk=f,
                            t2s=torch.zeros(1, dtype=torch.int32))
    p = torch.tensor([0.99], dtype=torch.float64)
    args = (lat, p, p, torch.tensor([0.01], dtype=torch.float64), c)
    lat_p, _, _, hp_p = tick.polca_latch_step(*args, esc=25, predictive=True)
    lat_n, _, _, hp_n = tick.polca_latch_step(*args, esc=25, predictive=False)
    assert bool(lat_p.hpc) and float(hp_p) == c.hp_t2
    assert not bool(lat_n.hpc) and torch.isnan(hp_n).all()
    assert int(lat_n.t2s) == 1


def _frequency_values(out) -> set:
    return set(np.unique(out["f_lp"].numpy())) | set(
        np.unique(out["f_hp"].numpy()))


@pytest.mark.parametrize("case", TICK_CASES,
                         ids=lambda c: f"n{c[0]}t{c[1]}r{c[2]}ps{c[7]}")
def test_freq_table_holds_every_frequency(case):
    """The kernel's ring carries codes into ``freq_table`` in place of
    frequencies: every value the plain version's f_lp/f_hp planes hold is in
    the table (hot and cool cases, rings of 6 and 21 slots)."""
    consts, arrays, kw = _inputs(case)
    c = tick.TickConsts(**consts)
    out = tick.polca_tick_plain(*(torch.from_numpy(a) for a in arrays), c,
                                **kw)
    table = tick.freq_table(c)
    assert len(table) == 5 and table[0] == 1.0
    assert _frequency_values(out) <= set(table)


def test_plain_planes_are_time_major_views():
    """The plain version writes the kernel's layout: [N, T, R]-shaped views
    of [T, N, R] storage, whatever the layout of occ."""
    consts, arrays, kw = _inputs(TICK_CASES[2])
    occ, bscale, row_budget = (torch.from_numpy(a) for a in arrays)
    c = tick.TickConsts(**consts)
    want = tick.polca_tick_plain(occ, bscale, row_budget, c, **kw)
    got = tick.polca_tick_plain(occ.permute(1, 0, 2).contiguous()
                                .permute(1, 0, 2), bscale, row_budget, c, **kw)
    for k in ("row_w", "fire", "f_lp", "f_hp"):
        assert tuple(got[k].shape) == tuple(occ.shape), k
        assert got[k].permute(1, 0, 2).is_contiguous(), k
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["n_brakes"], want["n_brakes"])


@pytest.mark.parametrize("depth,match", [
    (tick.MAX_RING_DEPTH + 1, "exceeds"),
    (20, "must exceed"),  # not deeper than oob_ticks
])
def test_kernel_ring_depth_limit_raises(depth, match):
    """The kernel's ring lives in shared memory: a depth past
    MAX_RING_DEPTH (or one that cannot hold the delays) raises before any
    launch, on any device."""
    consts, arrays, _ = _inputs(TICK_CASES[0])
    tick.polca_tick_loop.launches = 0
    with pytest.raises(ValueError, match=match):
        tick.polca_tick_loop(*(torch.from_numpy(a) for a in arrays),
                             tick.TickConsts(**consts), oob_ticks=20,
                             brake_ticks=3, ring_depth=depth, esc=25)
    assert tick.polca_tick_loop.launches == 0
