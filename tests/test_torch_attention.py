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
  kernel gives, never NaN;
* every head dim the kernels take (``HEAD_DIMS``, gpt-neox-20b's 96
  included), windowed and softcapped, in bf16 and float32;
* the identity the tensor-core kernel's hd-96 route rests on: heads
  zero-padded from 96 to 128 columns, at scale 96^-1/2, give the unpadded
  output in their first 96 columns and zeros after them;
* the launch planning the kernels depend on: the (dtype, hd) -> kernel
  variant choice, the decode split plan, the TMA alignment check.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_kernels import DECODE_CASES, FLASH_CASES

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import decode_attention
from repro_torch.kernels.decode_attention import (
    SPLIT_GRAIN, decode_attention_plain, split_plan)
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, bwd_variant, check_aligned, flash_attention_plain, kernel_variant)


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


# ---------------------------------------------------------------------------
# the pure-Python launch planning the CUDA kernels depend on (no card needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(jnp.bfloat16, 3e-2), (jnp.float32, 2e-5)])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_attention_at_every_head_dim(hd, dtype, tol):
    """Both plain versions at each head dim the kernels take (96 is
    gpt-neox-20b's), against the Pallas kernels in interpret mode and the
    JAX references: a causal, windowed, softcapped prefill with G = 2, and
    a softcapped decode over part of its cache."""
    (jq, jk, jv), (q, k, v) = _inputs(
        hd, [(2, 64, 4, hd), (2, 64, 2, hd), (2, 64, 2, hd)], dtype)
    kw = dict(causal=True, window=24, softcap=20.0)
    got = flash_attention_plain(q, k, v, **kw)
    _close(got, jops.flash_attention(jq, jk, jv, block_q=32, block_k=32,
                                     interpret=True, **kw), tol)
    _close(got, jref.mha_reference(jq, jk, jv, **kw), tol)
    got = decode_attention_plain(q[:, 0], k, v, 41, softcap=20.0)
    _close(got, jops.decode_attention(jq[:, 0], jk, jv, 41, softcap=20.0,
                                      block_k=32, interpret=True), tol)
    _close(got, jref.decode_attention_reference(jq[:, 0], jk, jv, 41, softcap=20.0),
           tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_variant_choice(dtype, hd):
    """bf16 prefill at hd 64 / 96 / 128 / 256 (llama3.2-1b, gpt-neox-20b,
    qwen3-8b, yi-34b, opt-30b, gemma2-9b) runs the tensor-core flash
    kernel; float32 (TF32 would break its 2e-5 contract) and bf16 at the
    test-only head dims 8 / 16 / 32 the CUDA-core kernel."""
    want = ("tensor_core" if dtype == torch.bfloat16 and hd in (64, 96, 128, 256)
            else "cuda_core")
    assert kernel_variant(dtype, hd) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_decode_kernel_variant_choice(dtype, hd):
    """Decode keeps its own choice: the tensor-core decode kernel for bf16
    at hd 64 / 128 only; gpt-neox-20b's 96 and gemma2-9b's 256 decode on
    the CUDA cores."""
    want = ("tensor_core" if dtype == torch.bfloat16 and hd in (64, 128)
            else "cuda_core")
    assert decode_attention.kernel_variant(dtype, hd) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_bwd_kernel_variant_choice(dtype, hd):
    """The backward keeps its own choice: the tensor-core backward (wgmma
    fed by TMA) for bf16 at hd 64 only, the head dim of the trained models
    (roberta-large, llama3.2-1b); float32 (TF32 would break its 2e-5
    contract) and bf16 at every other head dim on the CUDA cores."""
    want = "tensor_core" if dtype == torch.bfloat16 and hd == 64 else "cuda_core"
    assert bwd_variant(dtype, hd) == want


@pytest.mark.parametrize("dtype,tol", [(jnp.bfloat16, 3e-2), (jnp.float32, 2e-5)])
@pytest.mark.parametrize("causal,window,softcap,q_offset", [
    (True, 0, 0.0, 0), (True, 24, 0.0, 0), (True, 0, 30.0, 0),
    (True, 40, 50.0, 17), (False, 0, 0.0, 0)])
def test_hd96_zero_padded_to_128_columns(causal, window, softcap, q_offset, dtype, tol):
    """The tensor-core kernel runs hd 96 in a 128-column tile: TMA fills
    columns 96-127 of Q, K and V with zeros, the kernel scales by 96^-1/2
    and writes the first 96 output columns. Zero columns add exactly 0 to
    Q K^T and make PV's extra columns 0, so the padded heads at scale
    96^-1/2 give the unpadded output (and zeros after it), which is JAX's
    reference at hd 96. The plain version scales 128-column heads by
    128^-1/2, so Q goes in multiplied by (128 / 96)^1/2 (in float32: a
    bf16 rounding of the product would move the scores)."""
    (jq, jk, jv), (q, k, v) = _inputs(
        96 + window, [(2, 80, 4, 96), (2, 80 + q_offset, 2, 96), (2, 80 + q_offset, 2, 96)],
        dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    pad = lambda t: F.pad(t, (0, 32))  # noqa: E731
    got = flash_attention_plain(pad(q).float() * (128 / 96) ** 0.5, pad(k), pad(v),
                                q_offset=q_offset, **kw).to(q.dtype)
    assert got.shape == (2, 80, 4, 128)
    assert torch.equal(got[..., 96:], torch.zeros_like(got[..., 96:]))
    _close(got[..., :96], flash_attention_plain(q, k, v, q_offset=q_offset, **kw), tol)
    _close(got[..., :96], jref.mha_reference(jq, jk, jv, **kw), tol)


_MAIN_T = 1536  # the served cache length (cache_len(1024 + 128))


@pytest.mark.parametrize("rows", [1, 3 * 8, 8 * 8, 4096])
@pytest.mark.parametrize("valid_len", sorted({c[5] for c in DECODE_CASES} | {0, 1, _MAIN_T}))
def test_decode_split_plan_covers_valid_slots(valid_len, rows):
    """Chunks [i * split_len, min((i + 1) * split_len, valid_len)) cover
    [0, valid_len) exactly once, none starts at or past valid_len, and a
    valid length of at most one grain is one chunk. With no valid slot the
    plan is one empty chunk (its block writes the zero output)."""
    sl, n = split_plan(rows, valid_len, 132)
    assert sl > 0 and sl % SPLIT_GRAIN == 0 and n >= 1
    chunks = [(i * sl, min((i + 1) * sl, valid_len)) for i in range(n)]
    if valid_len == 0:
        assert chunks == [(0, 0)]
        return
    assert all(start < valid_len for start, _ in chunks)
    covered = [t for start, end in chunks for t in range(start, end)]
    assert covered == list(range(valid_len))
    if valid_len <= SPLIT_GRAIN:
        assert n == 1


@pytest.mark.parametrize("shape", [(2, 8, 4, 64), (1, 77, 8, 128), (3, 5, 2, 8),
                                   (1, 77, 8, 96), (2, 33, 4, 256)])
def test_copy_alignment_accepts_contiguous(shape):
    t = torch.zeros(shape, dtype=torch.bfloat16)
    check_aligned("flash_attention", "q", "TMA", t.stride(), t.element_size(), 256)


@pytest.mark.parametrize("strides,data_ptr", [
    ((8 * 4 * 72, 4 * 72, 72 + 4, 1), 0),   # head stride of 76 bf16 = 152 bytes
    ((8 * 36, 36, 4, 1), 0),                # seq stride of 36 bf16 = 72 bytes
    ((2048, 256, 64, 1), 8),                # base 8 bytes off
    ((8 * 4 * 100, 4 * 100, 100, 1), 0),    # hd 96 in rows of 100 bf16: head stride 200 bytes
    ((8 * 4 * 96, 4 * 96, 96, 1), 2),       # hd 96 contiguous, base 2 bytes off
    ((8 * 4 * 260, 4 * 260, 260, 1), 0),    # hd 256 in rows of 260 bf16: head stride 520 bytes
    ((8 * 4 * 256 + 4, 4 * 256, 256, 1), 0),  # hd 256, batch stride 8 bytes past a multiple
])
def test_copy_alignment_rejects_misaligned(strides, data_ptr):
    """A stride or base that is not a multiple of 16 bytes cannot be copied
    by TMA or cp.async: the wrapper raises before any launch."""
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        check_aligned("flash_attention", "k", "the tensor-core kernel's TMA load",
                      strides, 2, data_ptr)
