"""The port's mixture of experts (``repro_torch.models.moe``) against the
JAX package's, on the CPU.

The same numpy inputs (weights from JAX's ``init_params``, activations from
a seeded numpy generator) go to both sides; JAX's ``moe_apply`` runs in its
``shard_map`` on the Auto-axis reference mesh of one device, the port's
on one device (``slots = E``):

* ``moe_apply`` within 1e-5 relative in float32 and within 2e-2 in bf16
  (identical float32 routing; the bf16 gap is the rounding of three
  products and the combine in bf16, a few units of bf16's 2^-8), for the
  mixtral smoke config and kimi-k2's (top-8, bf16 weights);
* a capacity factor of 0.5: the port keeps the rows JAX keeps, drops
  the same, and gives JAX's outputs;
* ``moe_layout``, ``_capacity``, ``moe_specs`` and ``moe_aux_loss`` equal
  to JAX's;
* ``moe_apply`` against a dense numpy reference that runs every expert on
  every token (``tests/test_moe.py``'s), with no drops;
* the combine: the same bits on every run, and the reference's order (the
  sorted rows added into zeros one after another, in bf16).

Routing ties: ``torch.topk`` does not promise ``lax.top_k``'s order among
equal probabilities (lowest index first). The float32 probabilities of
these normal activations have no ties, so both pick the same experts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from test_moe import dense_moe_reference

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.mesh import set_mesh
from repro.models import moe as jmoe
from repro.models.param import init_params as jax_init_params
from repro_torch.configs import smoke_config
from repro_torch.models import moe

B, S = 2, 24
F32_RTOL = 1e-5
BF16_RTOL = 2e-2


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _configs(arch, dtype, **kw):
    jcfg = jax_smoke_config(arch).replace(dtype=dtype, **kw)
    return jcfg, smoke_config(arch).replace(dtype=getattr(torch, dtype), **kw)


def _case(arch, dtype, seed=0, **kw):
    """(JAX config, port config, numpy weights, numpy activations [B, S, D])."""
    jcfg, cfg = _configs(arch, dtype, **kw)
    p = jax.tree.map(np.asarray, jax_init_params(jmoe.moe_specs(jcfg, 1),
                                                 jax.random.key(seed)))
    x = np.random.default_rng(seed).standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    return jcfg, cfg, p, x


def _jax_moe(jcfg, p, x, mesh):
    with set_mesh(mesh):
        out = jax.jit(lambda pp, xx: jmoe.moe_apply(
            jcfg, pp, xx, mesh=mesh, batch_spec=None, gather_axes=()))(
                jax.tree.map(jnp.asarray, p), jnp.asarray(x, jcfg.activation_dtype))
    return np.asarray(out, np.float32)


def _port_params(cfg, p):
    """The numpy weights as tensors of their spec dtypes (router float32)."""
    specs = moe.moe_specs(cfg, 1)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(specs[k].dtype)
            for k, v in p.items()}


def _rel(a, b):
    a, b = np.float32(a), np.float32(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-6))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_RTOL), ("bfloat16", BF16_RTOL)])
def test_moe_apply_matches_jax(arch, dtype, tol, mesh):
    jcfg, cfg, p, x = _case(arch, dtype)
    want = _jax_moe(jcfg, p, x, mesh)
    got = moe.moe_apply(cfg, _port_params(cfg, p),
                        torch.from_numpy(x).to(cfg.activation_dtype))
    assert got.shape == (B, S, cfg.d_model) and got.dtype == cfg.activation_dtype
    assert np.isfinite(got.float().numpy()).all()
    assert _rel(want, got.float().numpy()) < tol


def test_capacity_drops_the_rows_jax_drops(mesh):
    """cf = 0.5 keeps C = _capacity(T k, 1, 0.5) of the T k rows: the
    first C of the stable sort by expert id, the rest dropped."""
    jcfg, cfg, p, x = _case("mixtral-8x7b", "float32", seed=1, moe_capacity_factor=0.5)
    T, k = B * S, cfg.moe_top_k
    params = _port_params(cfg, p)
    xt = torch.from_numpy(x).reshape(T, -1)
    _, topi = moe.route(cfg, params["router"], xt)
    sel, sizes = moe.dispatch(cfg, topi)
    C = moe._capacity(T * k, 1, 0.5)
    assert C < T * k and len(sel) == C == sum(sizes)
    order = np.argsort(topi.reshape(-1).numpy(), kind="stable")
    np.testing.assert_array_equal(sel.numpy(), order[:C])
    assert sizes == np.bincount(topi.reshape(-1).numpy()[order[:C]],
                                minlength=cfg.moe_num_experts).tolist()
    want = _jax_moe(jcfg, p, x, mesh)
    got = moe.moe_apply(cfg, params, torch.from_numpy(x)).numpy()
    assert _rel(want, got) < F32_RTOL
    # tokens with every choice dropped give zeros on both sides
    kept = np.zeros(T * k, bool)
    kept[order[:C]] = True
    none_kept = ~kept.reshape(T, k).any(-1)
    assert none_kept.any()
    assert not want.reshape(T, -1)[none_kept].any() and not got.reshape(T, -1)[none_kept].any()


@pytest.mark.parametrize("E,n", [(8, 1), (384, 1), (4, 1), (8, 16), (384, 16), (16, 16), (6, 4)])
def test_layout_capacity_and_specs_equal_jax(E, n):
    jcfg, cfg = _configs("mixtral-8x7b", "bfloat16", moe_num_experts=E, moe_d_ff=128)
    assert moe.moe_layout(cfg, n) == jmoe.moe_layout(jcfg, n)
    for rows in (1, 4, 7, 8, 92, 100, 65536):
        for cf in (0.5, 1.0, 1.25, 8.0):
            assert moe._capacity(rows, moe.moe_layout(cfg, n)[0], cf) == \
                jmoe._capacity(rows, jmoe.moe_layout(jcfg, n)[0], cf)
    if n == 1:
        js, ps = jmoe.moe_specs(jcfg, 1), moe.moe_specs(cfg, 1)
        assert sorted(js) == sorted(ps)
        for key in js:
            assert (js[key].shape, js[key].logical, js[key].init, js[key].scale) == \
                (ps[key].shape, ps[key].logical, ps[key].init, ps[key].scale), key
            assert np.dtype(js[key].dtype).name == str(ps[key].dtype)[6:], key


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_aux_loss_equals_jax(arch):
    jcfg, cfg, p, x = _case(arch, "float32", seed=2)
    want = float(jmoe.moe_aux_loss(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = float(moe.moe_aux_loss(cfg, _port_params(cfg, p), torch.from_numpy(x)))
    assert abs(got - want) <= 1e-6 * abs(want)
    zero = dict(p, router=np.zeros_like(p["router"]))  # a uniform router: ~1
    assert abs(float(moe.moe_aux_loss(cfg, _port_params(cfg, zero),
                                      torch.from_numpy(x))) - 1.0) < 0.05


@pytest.mark.parametrize("E", [2, 4, 8])
def test_moe_matches_dense_reference(E):
    """Every expert on every token, combined by top-k weight (numpy); no
    drops (cf = 8); the JAX test's tolerance."""
    jcfg, cfg, p, x = _case("mixtral-8x7b", "float32", seed=E, moe_num_experts=E,
                            moe_capacity_factor=8.0)
    x = 0.5 * x[:, :8]
    got = moe.moe_apply(cfg, _port_params(cfg, p), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, dense_moe_reference(jcfg, p, x), atol=2e-4, rtol=2e-3)


def test_combine_is_deterministic_in_the_reference_order():
    """bf16, top-8: two runs give the same bits, equal to adding the sorted
    rows into zeros one after another, rounding each sum to bf16 (the
    reference's ``.at[sel_tok].add``), with dropped rows (cf = 0.5)."""
    _, cfg, p, x = _case("kimi-k2-1t-a32b", "bfloat16", seed=3, moe_capacity_factor=0.5)
    params = _port_params(cfg, p)
    T = B * S
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(T, -1)
    topw, topi = moe.route(cfg, params["router"], xt)
    sel, sizes = moe.dispatch(cfg, topi)
    k = cfg.moe_top_k
    rows = moe.expert_ffn(cfg, params, xt[sel // k], sizes)
    a = moe.combine(rows, sel, topw, topi)
    b = moe.combine(rows.clone(), sel.clone(), topw.clone(), topi.clone())
    assert torch.equal(a, b)
    weighted = rows * topw.reshape(-1)[sel].to(rows.dtype)[:, None]
    want = torch.zeros_like(a)
    for r in range(len(sel)):
        t = int(sel[r]) // k
        want[t] = want[t] + weighted[r]
    assert torch.equal(a, want)
    assert torch.equal(moe.moe_apply(cfg, params, xt.reshape(B, S, -1)).reshape(T, -1), a)
