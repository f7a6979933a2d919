"""The port's attention kernels' plain versions against the JAX package.

The same numpy inputs (from a seed) go to both sides:

* the plain flash and decode versions against JAX's Pallas kernels in
  interpret mode (``ops.flash_attention`` / ``ops.decode_attention``) and
  against JAX's naive ``ref.mha_reference`` / ``ref.decode_attention_
  reference``, at every ``FLASH_CASES`` / ``DECODE_CASES`` entry of
  ``tests/test_kernels.py`` with its tolerances (3e-2 bf16, 2e-5 fp32);
* the port's ``ref`` oracles against JAX's;
* ragged shapes (which the Pallas wrapper refuses) against
  ``ref.mha_reference``;
* a tile whose every query is past its window: zeros, as the Pallas
  kernel gives, never NaN.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_kernels import DECODE_CASES, FLASH_CASES

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain


def _inputs(seed, shapes, dtype):
    """numpy standard normals, as (jax arrays, torch tensors) of ``dtype``."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    name = np.dtype(dtype).name
    return ([jnp.asarray(x, dtype) for x in xs],
            [torch.from_numpy(x).to(getattr(torch, name)) for x in xs])


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.float32(got)
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.float32(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: f"{c[1]}x{c[2]}h{c[3]}kv{c[4]}d{c[5]}{np.dtype(c[6]).name}c{int(c[7])}w{c[8]}s{c[9]}")
def test_flash_plain_vs_pallas_and_ref(case):
    B, Sq, Skv, H, KV, hd, dtype, causal, window, softcap, bq, bk = case
    (jq, jk, jv), (q, k, v) = _inputs(
        hash(case[:6]) % 1000, [(B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)], dtype)
    tol = 3e-2 if dtype == jnp.bfloat16 else 2e-5
    got = flash_attention_plain(q, k, v, causal=causal, window=window,
                                softcap=softcap, q_offset=Skv - Sq)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  softcap=softcap, q_offset=Skv - Sq,
                                  block_q=bq, block_k=bk, interpret=True)
    jax_ref = jref.mha_reference(jq, jk, jv, causal=causal, window=window, softcap=softcap)
    _close(got, pallas, tol)
    _close(got, jax_ref, tol)
    _close(ref.mha_reference(q, k, v, causal=causal, window=window, softcap=softcap),
           jax_ref, tol)


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"T{c[1]}h{c[2]}kv{c[3]}vl{c[5]}")
def test_decode_plain_vs_pallas_and_ref(case):
    B, T, H, KV, hd, vl, softcap, bk = case
    (jq, jk, jv), (q, k, v) = _inputs(
        T + B + H, [(B, H, hd), (B, T, KV, hd), (B, T, KV, hd)], jnp.bfloat16)
    got = decode_attention_plain(q, k, v, vl, softcap=softcap)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jops.decode_attention(jq, jk, jv, vl, softcap=softcap, block_k=bk,
                                   interpret=True)
    jax_ref = jref.decode_attention_reference(jq, jk, jv, vl, softcap=softcap)
    _close(got, pallas, 3e-2)
    _close(got, jax_ref, 3e-2)
    _close(ref.decode_attention_reference(q, k, v, vl, softcap=softcap), jax_ref, 3e-2)


@pytest.mark.parametrize("dtype,tol", [(jnp.bfloat16, 3e-2), (jnp.float32, 2e-5)])
@pytest.mark.parametrize("Sq,Skv,window", [(200, 200, 0), (77, 333, 100)])
def test_flash_plain_ragged_vs_ref(Sq, Skv, window, dtype, tol):
    """Sequences that no 64/128 tile divides (a served prompt may have any
    length); q_offset = Skv - Sq, the alignment ``mha_reference`` implies."""
    (jq, jk, jv), (q, k, v) = _inputs(
        Sq + Skv, [(2, Sq, 8, 64), (2, Skv, 2, 64), (2, Skv, 2, 64)], dtype)
    got = flash_attention_plain(q, k, v, causal=True, window=window, q_offset=Skv - Sq)
    _close(got, jref.mha_reference(jq, jk, jv, causal=True, window=window), tol)


def test_flash_plain_fully_masked_rows_give_zero():
    """Every query of the tile sits past its window (positions 200..263 with
    window 16 over keys 0..63): the Pallas kernel skips every KV block and
    its ``l == 0`` guard gives 0; the plain version gives the same, not NaN.
    """
    (jq, jk, jv), (q, k, v) = _inputs(
        5, [(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)], jnp.float32)
    kw = dict(causal=True, window=16, q_offset=200)
    got = flash_attention_plain(q, k, v, **kw)
    pallas = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                  interpret=True, **kw)
    assert not torch.isnan(got).any()
    _close(got, pallas, 2e-5)
    assert torch.equal(got, torch.zeros_like(got))
    # a decode step with no valid slot is the same case
    out = decode_attention_plain(q[:, 0], k, v, 0)
    assert torch.equal(out, torch.zeros_like(out))
