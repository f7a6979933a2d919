"""The port's training path against the JAX package, on the CPU.

* Attention's gradient: ``flash_attention_bwd_plain`` and the
  ``FlashAttention`` Function (its CPU path: the plain forward with the row
  log-sum-exp, the plain backward) against ``jax.grad`` of
  ``repro.kernels.ref.mha_reference`` in float32, within 1e-5 of the
  largest entry: causal, bidirectional, GQA, window, softcap, ``q_offset``
  (the reference's Skv - Sq alignment), Sq != Skv, and rows with no key
  (the port gives them zero gradients where the reference attends every
  key uniformly: their dO is zero in the comparison, and a second call with
  it nonzero must give finite gradients and exact zeros on those rows).
* ``model.loss_fn`` and its gradient for all 15 registry archs at B 2 x S
  16 in float32 with float32 parameter storage, from the JAX parameters:
  loss within 1e-5 relative, each gradient leaf within 1e-4 (gap norm over
  norm); kimi-k2 and jamba also with their own bf16 storage, within one
  bf16 rounding unit (``tests/_torch_train_ref.py`` says why).
* The three remat policies give the same loss and gradients, so does the
  loss made a chunk of positions at a time, and ``ops.flash_attention``
  under grad goes through the Function.
* ``SyntheticTokenPipeline.batch_at`` equals JAX's bit for bit for every
  frontend (bf16 compared through bit views).
* ``launch.train.main`` on a smoke model on the CPU: the loss falls, the
  history is written, the checkpoints are there; ``--fail-at`` replays to
  the clean run's state.
* ``core.workload.train_profile`` equals the reference's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import (ARCHS, BF16_PARAM_ARCHS, BF16_STORAGE_RTOL, RTOL, configs,
                              jax_batch, jax_loss_and_grads, leaves, port_batch,
                              reference_mesh, rel, shared_params)
from repro.core.workload import train_profile as jax_train_profile
from repro.core.power_model import A100 as JAX_A100, ServerPower as JaxServerPower
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokenPipeline as JaxPipeline
from repro.configs import get_config as jax_get_config
from repro.kernels.ref import mha_reference
from repro_torch.configs import get_config
from repro_torch.core.power_model import A100, ServerPower
from repro_torch.core.workload import train_profile
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline, device_put_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import model

ATTN_RTOL = 1e-5

# (B, Sq, Skv, H, KV, hd, causal, window, softcap[, q_offset]); q_offset
# defaults to Skv - Sq, the reference's alignment; Sq > Skv with causal
# leaves the first Sq - Skv query rows without a key. Another q_offset X <
# Skv - Sq runs the reference with Skv - Sq - X query rows appended (their
# dO zero, so they add nothing to dK and dV): its row i then sits at X + i.
GRAD_CASES = [
    (2, 24, 24, 4, 2, 16, True, 0, 0.0),      # causal GQA
    (2, 24, 24, 4, 4, 16, False, 0, 0.0),     # bidirectional (the encoder)
    (1, 40, 40, 8, 2, 32, True, 7, 0.0),      # sliding window
    (2, 24, 24, 4, 2, 16, True, 0, 20.0),     # softcap
    (1, 33, 33, 4, 1, 64, True, 9, 30.0),     # window + softcap, G = 4
    (2, 20, 28, 4, 2, 16, True, 0, 0.0),      # q_offset 8 (Sq < Skv)
    (2, 12, 28, 4, 2, 16, False, 0, 0.0),     # cross attention, Sq != Skv
    (2, 20, 16, 4, 2, 16, True, 0, 0.0),      # 4 rows with no key
    # the geometry of the tensor-core backward's tiles (128-row blocks,
    # 64-row loop tiles) at hd 64: sizes off the 64- and 128-row grids, a
    # causal diagonal off the reference's alignment, G = 8, window 128
    (1, 200, 200, 8, 1, 64, True, 0, 0.0, -70),     # diagonal at -70: 70 rows with no key
    (1, 130, 261, 4, 2, 64, True, 0, 0.0, 0),       # diagonal at 0 with Skv > Sq
    (1, 300, 300, 4, 2, 64, True, 128, 0.0),        # window 128 on a tile border
    (1, 257, 190, 8, 1, 64, False, 0, 0.0),         # bidirectional, G = 8, ragged
    (1, 150, 270, 8, 1, 64, True, 128, 30.0, 60),   # G = 8, window, softcap, q_offset 60
]


def _grad_inputs(B, Sq, Skv, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), np.float32),
            rng.standard_normal((B, Skv, KV, hd), np.float32),
            rng.standard_normal((B, Skv, KV, hd), np.float32),
            rng.standard_normal((B, Sq, H, hd), np.float32))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_gradient_matches_jax_grad(case):
    B, Sq, Skv, H, KV, hd, causal, window, softcap = case[:9]
    q_offset = case[9] if len(case) > 9 else Skv - Sq
    q, k, v, do = _grad_inputs(B, Sq, Skv, H, KV, hd)
    empty = min(Sq, max(0, -q_offset)) if causal else 0  # rows with no key
    do[:, :empty] = 0.0
    pad = Skv - Sq - q_offset  # query rows appended for the reference
    assert pad >= 0

    def reference(q, k, v):
        qp = jnp.concatenate([q, jnp.zeros((B, pad, H, hd), q.dtype)], axis=1)
        return mha_reference(qp, k, v, causal=causal, window=window, softcap=softcap)[:, :Sq]

    want = jax.grad(lambda q, k, v: jnp.sum(reference(q, k, v) * do), argnums=(0, 1, 2))(q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, **kw)  # grad enabled: the Function
    (o * torch.from_numpy(do)).sum().backward()
    _, lse = fa.flash_attention_lse_plain(tq.detach(), tk.detach(), tv.detach(), **kw)
    plain = fa.flash_attention_bwd_plain(torch.from_numpy(do), tq.detach(), tk.detach(),
                                         tv.detach(), o.detach(), lse, **kw)
    for name, w, g, p in zip("qkv", want, (tq.grad, tk.grad, tv.grad), plain):
        assert _max_rel(g, w) < ATTN_RTOL, name
        assert torch.equal(g, p), name  # the Function's backward is the plain one
    if empty:
        do_full = torch.from_numpy(_grad_inputs(B, Sq, Skv, H, KV, hd)[3])
        dq, dk, dv = fa.flash_attention_bwd_plain(do_full, tq.detach(), tk.detach(),
                                                  tv.detach(), o.detach(), lse, **kw)
        assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
        assert torch.equal(dq[:, :empty], torch.zeros_like(dq[:, :empty]))
        assert torch.isinf(lse[:, :, :empty]).all() and torch.isfinite(lse[:, :, empty:]).all()
        assert torch.equal(o[:, :empty], torch.zeros_like(o[:, :empty]))


def test_train_forward_is_the_serving_function():
    """The Function's output is the plain forward's, and its lse is the
    log-sum-exp of the masked scores."""
    q, k, v, _ = _grad_inputs(2, 24, 24, 4, 2, 16, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(causal=True, window=5, softcap=10.0, q_offset=0)
    o, lse = fa.flash_attention_lse_plain(tq, tk, tv, **kw)
    assert torch.equal(o, fa.flash_attention_plain(tq, tk, tv, **kw))
    s = torch.einsum("bqkgd,btkd->bkgqt", tq.reshape(2, 24, 2, 2, 16), tk) * 16 ** -0.5
    s = torch.tanh(s / 10.0) * 10.0
    mask = fa.attention_mask(24, 24, causal=True, window=5, q_offset=0, device="cpu")
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), -1).reshape(2, 4, 24)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def mesh():
    return reference_mesh()


def _loss_and_gradient_gap(arch, mesh, param_storage):
    """(loss, JAX's loss, worst (gap, leaf) of the gradient)."""
    jcfg, cfg = configs(arch, param_storage=param_storage)
    np_params = shared_params(jcfg)
    jb = jax_batch(jcfg)
    jloss, jgrads = jax_loss_and_grads(jcfg, np_params, jb, mesh)
    params = model.load_jax_params(cfg, np_params, "cpu")
    tracked = [p.requires_grad_() for _, p in leaves(params)]
    loss = model.loss_fn(cfg, params, port_batch(jb))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    for (path, j), g, p in zip(leaves(jgrads), grads, tracked, strict=True):
        assert g is not None and g.dtype == p.dtype, path
    worst = max((rel(g, j), path) for (path, j), g in zip(leaves(jgrads), grads))
    return float(loss.detach()), jloss, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, mesh):
    """Float32 with float32 parameter storage: loss within 1e-5, each
    gradient leaf within 1e-4."""
    loss, jloss, worst = _loss_and_gradient_gap(arch, mesh, "float32")
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert worst[0] < RTOL, worst


@pytest.mark.parametrize("arch", BF16_PARAM_ARCHS)
def test_bf16_parameter_gradients_match_jax(arch, mesh):
    """The config's own bf16 parameter storage: bf16 gradients, each leaf
    within one bf16 rounding unit of JAX's (``BF16_STORAGE_RTOL``)."""
    loss, jloss, worst = _loss_and_gradient_gap(arch, mesh, None)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert worst[0] < BF16_STORAGE_RTOL, worst


def test_remat_policies_agree():
    """none, dots and full compute the same loss and gradients (the same
    operations; a checkpoint recomputes them in the backward pass)."""
    jcfg, cfg = configs("llama3.2-1b")
    np_params = shared_params(jcfg)
    batch = port_batch(jax_batch(jcfg))
    out = []
    for policy in ("none", "dots", "full"):
        c = cfg.replace(remat_policy=policy)
        params = model.load_jax_params(c, np_params, "cpu")
        tracked = [p.requires_grad_() for _, p in leaves(params)]
        loss = model.loss_fn(c, params, batch)
        out.append((loss, torch.autograd.grad(loss, tracked)))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for g, g0 in zip(grads, out[0][1]):
            torch.testing.assert_close(g, g0, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "roberta-large", "internvl2-1b"])
def test_loss_chunks_agree(arch, monkeypatch):
    """The loss made five positions at a time (each chunk recomputed in the
    backward pass) equals the loss made at once, and so do its gradients."""
    jcfg, cfg = configs(arch)
    np_params = shared_params(jcfg)
    batch = port_batch(jax_batch(jcfg))
    out = []
    for chunk_bytes in (model.LOSS_CHUNK_BYTES, 4 * 2 * cfg.vocab_size * 5):
        monkeypatch.setattr(model, "LOSS_CHUNK_BYTES", chunk_bytes)
        params = model.load_jax_params(cfg, np_params, "cpu")
        tracked = [p.requires_grad_() for _, p in leaves(params)]
        loss = model.loss_fn(cfg, params, batch)
        out.append((loss, torch.autograd.grad(loss, tracked)))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=0)
    for g, g0 in zip(out[1][1], out[0][1]):  # sums over chunks: another order
        assert rel(g, g0) < 1e-6


def test_attention_goes_through_the_function_only_under_grad():
    q = torch.randn(1, 8, 2, 8, requires_grad=True)
    k = torch.randn(1, 8, 2, 8)
    o = ops.flash_attention(q, k, k)
    assert o.grad_fn is not None and type(o.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).grad_fn is None
    assert fa.flash_attention_lse.launches == fa.flash_attention_bwd.launches == 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "flan-t5-xxl", "internvl2-1b",
                                  "roberta-large", "whisper-base"])
def test_pipeline_batches_are_jax_bit_for_bit(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    seq = 300  # past internvl2's 256 image positions
    mine = SyntheticTokenPipeline(cfg, DataConfig(3, seq, seed=7))
    ref = JaxPipeline(jcfg, JaxDataConfig(3, seq, seed=7))
    for step in (0, 5):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want)
        for name in want:
            g, w = got[name], want[name]
            assert tuple(g.shape) == w.shape, name
            if str(w.dtype) == "bfloat16":
                assert g.dtype == torch.bfloat16, name
                np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
            else:
                assert g.dtype == torch.int32, name
                np.testing.assert_array_equal(g.numpy(), w)
    assert not torch.equal(mine.batch_at(0)["tokens"], mine.batch_at(1)["tokens"])
    placed = device_put_batch(mine.batch_at(2), "cpu")
    assert all(torch.equal(placed[k], v) for k, v in mine.batch_at(2).items())


def test_launcher_trains_a_smoke_model_on_the_cpu(tmp_path):
    hist_path = tmp_path / "history.json"
    history = train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "6", "--batch", "2",
                          "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt"),
                          "--ckpt-interval", "3", "--history", str(hist_path),
                          "--device", "cpu"])
    assert len(history) == 6 and history[-1]["loss"] < history[0]["loss"]
    assert json.loads(hist_path.read_text()) == history
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_3.npz",
                                                                      "step_6.npz"]


def test_launcher_fail_at_replays_to_the_clean_state(tmp_path):
    """``--fail-at 4``: the supervisor restores the step-3 checkpoint and
    replays; the final state equals the clean run's bit for bit (the CPU
    plain versions are deterministic)."""
    args = ["--arch", "roberta-large", "--smoke", "--steps", "6", "--batch", "2", "--seq", "32",
            "--ckpt-interval", "3", "--device", "cpu"]
    clean, sup = train.run(args + ["--ckpt-dir", str(tmp_path / "clean")])
    faulty, fsup = train.run(args + ["--ckpt-dir", str(tmp_path / "faulty"), "--fail-at", "4"])
    assert sup.n_restarts == 0 and fsup.n_restarts == 1
    assert [h["step"] for h in fsup.history] == [0, 1, 2, 3, 3, 4, 5]
    for (path, a), (_, b) in zip(leaves(clean), leaves(faulty), strict=True):
        assert torch.equal(a, b), path


def test_train_profile_matches_jax():
    for arch in ("roberta-large", "flan-t5-xxl", "llama3.2-1b"):
        got = train_profile(get_config(arch), 32, 2048, ServerPower(A100))
        want = jax_train_profile(jax_get_config(arch), 32, 2048, JaxServerPower(JAX_A100))
        assert got.t_iter == want.t_iter and got.trough_frac == want.trough_frac
        assert got.compute_point.t_seconds == want.compute_point.t_seconds
        assert got.compute_point.u_compute == want.compute_point.u_compute
        assert [d for d, _ in got.phases()] == [d for d, _ in want.phases()]
