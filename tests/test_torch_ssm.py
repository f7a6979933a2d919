"""The port's Mamba2 / SSD blocks (``repro_torch.models.ssm``) against the
JAX package's and against the sequential oracle, on the CPU, in float32.

Weights come from JAX's ``init_params`` of the mamba2 smoke config's
``ssm_specs`` (widths as ``tests/test_ssm.py`` sets them), activations from
a seeded numpy generator; both go to both sides as numpy arrays.

* the chunked core :func:`ssd_chunked` against the port's sequential
  ``ref.ssd_reference``, and that oracle against JAX's;
* the whole ``ssm_forward`` (S not a chunk multiple, so padded with dt = 0)
  against the same block with its SSD taken by the sequential oracle, and
  against JAX's ``ssm_forward`` (output, final state and conv tails);
* a prefill continued from ``init_state`` / ``conv_tails`` against the
  whole prefill and against JAX's continuation;
* ``ssm_decode`` against JAX's over several steps, state and tails carried;
* the ``ssm_a`` / ``ssm_dt`` inits of ``init_param`` in their ranges.

Tolerances: 1e-5 relative to the largest magnitude between the two
packages (the same float32 einsums in the same order, summed by another
library); 1e-4 against the sequential oracle (a different order of the
same sums over up to 128 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro.models.param import init_params as jax_init_params
from repro_torch.configs import smoke_config
from repro_torch.kernels import ref
from repro_torch.models import ssm
from repro_torch.models.param import ParamSpec, init_param

PKG_TOL = 1e-5
ORACLE_TOL = 1e-4


def _configs(chunk=16):
    kw = dict(ssm_chunk=chunk, ssm_d_state=16, ssm_headdim=16, d_model=64)
    jcfg = jax_smoke_config("mamba2-370m").replace(dtype="float32", **kw)
    return jcfg, smoke_config("mamba2-370m").replace(dtype=torch.float32, **kw)


def _params(jcfg, seed=0):
    """numpy weights (JAX's init), and the same as torch tensors."""
    p = jax.tree.map(np.asarray, jax_init_params(jssm.ssm_specs(jcfg), jax.random.key(seed)))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(shape, seed):
    return 0.5 * np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-12))


def _tails_np(tails):
    return {k: np.asarray(v) for k, v in tails.items()}


@pytest.mark.parametrize("S,Q,G", [(64, 16, 1), (128, 32, 1), (48, 16, 2), (16, 16, 1)])
def test_ssd_chunked_matches_the_sequential_oracle(S, Q, G):
    B, H, P, N = 2, 4, 16, 16
    rng = np.random.default_rng(S + Q + G)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32)))
    A = -np.exp(0.3 * rng.standard_normal(H, dtype=np.float32))
    Bm = 0.3 * rng.standard_normal((B, S, G, N), dtype=np.float32)
    Cm = 0.3 * rng.standard_normal((B, S, G, N), dtype=np.float32)
    D = rng.standard_normal(H, dtype=np.float32)
    s0 = 0.1 * rng.standard_normal((B, H, N, P), dtype=np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D, s0)]
    y, final = ssm.ssd_chunked(*t[:6], Q, init_state=t[6])
    y_ref, final_ref = ref.ssd_reference(*t)
    assert final.dtype == final_ref.dtype == torch.float32
    assert _rel(y_ref, y) < ORACLE_TOL and _rel(final_ref, final) < ORACLE_TOL
    jy, jfinal = jref.ssd_reference(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D, s0)))
    assert _rel(jy, y_ref) < PKG_TOL and _rel(jfinal, final_ref) < PKG_TOL


@pytest.mark.parametrize("S", [40, 7, 64])
def test_ssm_forward_matches_oracle_and_jax(S):
    """S = 40 and 7 are not multiples of the 16-step chunk (Q = min(16, S))."""
    jcfg, cfg = _configs()
    p, pt = _params(jcfg)
    x = _x((2, S, cfg.d_model), S)
    got, (state, tails) = ssm.ssm_forward(cfg, pt, torch.from_numpy(x), return_state=True)
    # the same block with its SSD taken by the sequential oracle
    d_in, H, G, N = ssm.ssm_dims(cfg)
    z, xin, Bm, Cm, dt = ssm._project(cfg, pt, torch.from_numpy(x))
    xin, Bm, Cm, _ = ssm._conv_all(cfg, pt, xin, Bm, Cm, None)
    y, final = ref.ssd_reference(xin.reshape(2, S, H, -1), dt, -torch.exp(pt["A_log"]),
                                 Bm.reshape(2, S, G, N), Cm.reshape(2, S, G, N),
                                 pt["D_skip"])
    assert _rel(ssm._gate_out(cfg, pt, y.reshape(2, S, d_in), z), got) < ORACLE_TOL
    assert _rel(final, state) < ORACLE_TOL
    want, (jstate, jtails) = jssm.ssm_forward(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x), return_state=True)
    assert _rel(want, got) < PKG_TOL and _rel(jstate, state) < PKG_TOL
    for k, v in _tails_np(jtails).items():
        assert _rel(v, tails[k]) < PKG_TOL, k


def test_prefill_continuation_with_init_state_and_conv_tails():
    jcfg, cfg = _configs()
    p, pt = _params(jcfg, seed=1)
    x = _x((2, 45, cfg.d_model), 5)
    whole = ssm.ssm_forward(cfg, pt, torch.from_numpy(x))
    a, (state, tails) = ssm.ssm_forward(cfg, pt, torch.from_numpy(x[:, :21]),
                                         return_state=True)
    b, (state2, tails2) = ssm.ssm_forward(cfg, pt, torch.from_numpy(x[:, 21:]),
                                          init_state=state, conv_tails=tails,
                                          return_state=True)
    assert _rel(whole, torch.cat([a, b], dim=1)) < ORACLE_TOL
    jp = jax.tree.map(jnp.asarray, p)
    _, (js, jt) = jssm.ssm_forward(jcfg, jp, jnp.asarray(x[:, :21]), return_state=True)
    jb, (js2, jt2) = jssm.ssm_forward(jcfg, jp, jnp.asarray(x[:, 21:]), init_state=js,
                                      conv_tails=jt, return_state=True)
    assert _rel(jb, b) < PKG_TOL and _rel(js2, state2) < PKG_TOL
    for k, v in _tails_np(jt2).items():
        assert _rel(v, tails2[k]) < PKG_TOL, k


def test_ssm_decode_matches_jax_over_steps():
    """Prefill 9 tokens, then 12 decode steps on both sides, the state and
    conv tails carried; every step's output and the final state within
    1e-5 of JAX's, and the decode outputs within 1e-4 of the whole
    prefill's."""
    jcfg, cfg = _configs()
    p, pt = _params(jcfg, seed=2)
    jp = jax.tree.map(jnp.asarray, p)
    x = _x((2, 21, cfg.d_model), 9)
    _, (state, tails) = ssm.ssm_forward(cfg, pt, torch.from_numpy(x[:, :9]), return_state=True)
    _, (js, jt) = jssm.ssm_forward(jcfg, jp, jnp.asarray(x[:, :9]), return_state=True)
    whole = ssm.ssm_forward(cfg, pt, torch.from_numpy(x))
    for t in range(9, 21):
        y, (state, tails) = ssm.ssm_decode(cfg, pt, torch.from_numpy(x[:, t:t + 1]),
                                           state, tails)
        jy, (js, jt) = jssm.ssm_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), js, jt)
        assert _rel(jy, y) < PKG_TOL, t
        assert _rel(whole[:, t:t + 1], y) < ORACLE_TOL, t
    assert _rel(js, state) < PKG_TOL
    for k, v in _tails_np(jt).items():
        assert _rel(v, tails[k]) < PKG_TOL, k


@pytest.mark.parametrize("device_seed", [0, 1])
def test_ssm_inits_in_range(device_seed):
    """A_log = log U(1, 16) and dt_bias = softplus^-1 U(1e-3, 1e-1), drawn
    in float32 from the generator and cast to the spec dtype; seeded."""
    gen = torch.Generator().manual_seed(device_seed)
    a = init_param(ParamSpec((4096,), ("ssm_heads",), init="ssm_a"), gen)
    dt = init_param(ParamSpec((4096,), ("ssm_heads",), init="ssm_dt"), gen)
    assert a.dtype == dt.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < np.log(16.0) + 1e-6
    u = torch.nn.functional.softplus(dt)
    assert float(u.min()) >= 1e-3 * (1 - 1e-5) and float(u.max()) <= 1e-1 * (1 + 1e-5)
    assert float(a.std()) > 0.5 and float(u.std()) > 0.02  # spread, not constant
    b = init_param(ParamSpec((4096,), ("ssm_heads",), init="ssm_a", dtype=torch.bfloat16),
                   torch.Generator().manual_seed(device_seed))
    assert b.dtype == torch.bfloat16 and torch.equal(b, a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unknown init"):
        init_param(ParamSpec((4,), ("x",), init="xavier"), gen)


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """A strong decay (dt ~ 20, A = -10: cs falls 200 a step) puts
    cs[q] - cs[k] above float32's exp range above the chunk's diagonal, as
    full-width mamba2-370m does at initialisation. The forward equals JAX's
    (the masked entries are 0 on both sides); the port masks the exponent
    before the exp, so its gradient stays finite, where the reference's
    ``where`` of the exp's output gives 0 * inf = NaN (ROADMAP "Deliberate
    divergences")."""
    jcfg, cfg = _configs()
    p, pt = _params(jcfg)
    p["dt_bias"] = np.full_like(p["dt_bias"], 20.0)
    p["A_log"] = np.full_like(p["A_log"], np.log(10.0))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = _x((2, 32, cfg.d_model), 3)
    leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
    got = ssm.ssm_forward(cfg, leaves, torch.from_numpy(x))
    got.square().sum().backward()
    assert all(torch.isfinite(v.grad).all() for v in leaves.values())
    want = jssm.ssm_forward(jcfg, p, jnp.asarray(x))
    assert _rel(want, got.detach()) < PKG_TOL
    jgrad = jax.grad(lambda q: jnp.sum(jnp.square(jssm.ssm_forward(jcfg, q, jnp.asarray(x)))))(
        jax.tree.map(jnp.asarray, p))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(jgrad))
