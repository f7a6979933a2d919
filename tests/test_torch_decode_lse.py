"""The decode kernel's log-sum-exp variant (``decode_attention_lse``), the
statistic that merges the outputs of a cache split by sequence.

* Its plain version's output equals ``repro.kernels.ref.
  decode_attention_reference`` (JAX) on the whole cache at every
  ``DECODE_CASES`` entry of ``tests/test_kernels.py`` in float32, and its
  log-sum-exp equals the scores' log-sum-exp over the valid slots.
* The cache cut into slices (one starting mid-cache, one past
  ``valid_len``, so with no valid slot: output 0, log-sum-exp -inf), each
  slice attended at its own valid length, merges by the log-sum-exps into
  the whole cache's output (the merge of ``models.attention.
  merge_partials``, done here on the host).
* ``ops.decode_attention_lse`` takes the plain version for CPU tensors
  without touching the kernel's launch counters; the kernel's wrapper
  refuses CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_kernels import DECODE_CASES
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ops

TOL = 2e-5  # float32


def _inputs(case, seed=0):
    B, T, H, KV, hd, vl, softcap, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    return q, k, v, vl, softcap


def _scores_lse(q, k, vl, softcap):
    """The log-sum-exp of each row's scores over slots < vl, in float64."""
    B, H, hd = q.shape
    G = H // k.shape[2]
    kk = np.repeat(k.astype(np.float64), G, axis=2)  # [B, T, H, hd]
    s = np.einsum("bhd,bthd->bht", q.astype(np.float64), kk) * hd ** -0.5
    if softcap:
        s = np.tanh(s / softcap) * softcap
    s = s[..., :vl]
    m = s.max(-1)
    return m + np.log(np.exp(s - m[..., None]).sum(-1))


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"T{c[1]}h{c[2]}kv{c[3]}vl{c[5]}")
def test_plain_lse_matches_the_jax_reference(case):
    q, k, v, vl, softcap = _inputs(case)
    o, lse = ops.decode_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), vl, softcap=softcap)
    want = np.asarray(jref.decode_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v), vl, softcap=softcap))
    np.testing.assert_allclose(o.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), _scores_lse(q, k, vl, softcap), rtol=TOL, atol=TOL)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]


def _merged(parts):
    """The host merge of (o, lse) slices: weights exp(lse - max lse)."""
    lse = np.stack([p[1] for p in parts])  # [n, B, H]
    o = np.stack([p[0] for p in parts])
    m = lse.max(0)
    w = np.exp(lse - m)[..., None]
    return (w * o).sum(0) / w.sum(0)


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"T{c[1]}h{c[2]}kv{c[3]}vl{c[5]}")
def test_slices_merge_into_the_whole_cache(case):
    q, k, v, vl, softcap = _inputs(case, seed=1)
    T = k.shape[1]
    cuts = sorted({0, max(1, vl // 3), vl, T})  # [vl, T) holds no valid slot
    qt = torch.from_numpy(q)
    parts = []
    for a, b in zip(cuts, cuts[1:]):
        o, lse = ops.decode_attention_lse(qt, torch.from_numpy(k[:, a:b]),
                                          torch.from_numpy(v[:, a:b]),
                                          min(max(vl - a, 0), b - a), softcap=softcap)
        if a >= vl:  # an empty slice: zero output, zero weight
            assert (o == 0).all() and torch.isneginf(lse).all()
        parts.append((o.numpy().astype(np.float64), lse.numpy().astype(np.float64)))
    whole = ops.decode_attention(qt, torch.from_numpy(k), torch.from_numpy(v), vl,
                                 softcap=softcap)
    np.testing.assert_allclose(_merged(parts), whole.numpy(), rtol=TOL, atol=TOL)


def test_no_valid_slot_gives_zero_and_minus_infinity():
    q, k, v, _, _ = _inputs(DECODE_CASES[0])
    o, lse = ops.decode_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), 0)
    assert (o == 0).all() and torch.isneginf(lse).all()


def test_cpu_tensors_take_the_plain_version_and_the_wrapper_refuses_them():
    q, k, v, vl, _ = _inputs(DECODE_CASES[0])
    before = (dec.decode_attention_lse.launches, dict(dec.decode_attention_lse.launches_by_variant))
    ops.decode_attention_lse(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), vl)
    assert (dec.decode_attention_lse.launches,
            dict(dec.decode_attention_lse.launches_by_variant)) == before
    with pytest.raises((ValueError, RuntimeError)):
        dec.decode_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), vl)
