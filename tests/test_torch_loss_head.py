"""The logits' matrix products (``models/model.py::logits_product``) and the
exact three-way bf16 split of their float32 cotangent
(``kernels/bf16_split.py``), on the CPU:

* the split is bit-exact for ``2**-110 <= |x|`` (softmax-like rows, signed
  values from 1e-30 to 1e30, zeros) and misses by at most ``2**-134``
  below; its padding columns are zero;
* :class:`~repro_torch.models.model.TensorCoreLogits`, its bf16 products
  run in float32 on the CPU, matches autograd of ``h.float() @
  w.float()``: the logits and the float32 ``dh`` and ``dw`` within float32
  rounding, the returned bf16 gradients within one bf16 rounding;
* ``loss_fn`` run through it (bf16 smoke models) matches the float32 path;
* ``model.logits_products`` counts each forward product once: ``float32``
  on the CPU, ``tensor_core`` where the Function runs; recording changes
  no bit of the loss or the gradients;
* on a card (marked ``card``, skipped here): one roberta-large loss chunk
  on the tensor cores against the float32 path and float64, and the split
  kernel bit for bit against its plain version.

Run the card test on the card without this directory's conftest (it
imports JAX): ``python -m pytest -p no:cacheprovider --noconftest -m card
tests/test_torch_loss_head.py``.
"""

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import bf16_split, ops
from repro_torch.models import model
from repro_torch.models.param import init_params
from repro_torch.obs import device as obs
from repro_torch.obs import metrics

TINY = 2.0 ** -110  # below this the third piece is a bf16 subnormal
TINY_MISS = 2.0 ** -134  # the most the pieces miss by there


def _draw(case, gen, rows=64, cols=251):
    if case == "softmax":  # a loss chunk's cotangent: softmax / n, less 1 / n at the target
        n = rows * 41
        x = torch.softmax(3 * torch.randn(rows, cols, generator=gen), -1) / n
        x[torch.arange(rows), torch.randint(0, cols, (rows,), generator=gen)] -= 1 / n
        return x
    if case == "zeros":
        x = torch.randn(rows, cols, generator=gen)
        return torch.where(torch.rand(rows, cols, generator=gen) < 0.5, 0.0, x)
    if case == "subnormal":  # magnitudes 2^-140 .. 2^-100, either sign
        e = torch.randint(-140, -100, (rows, cols), generator=gen).float()
        sign = torch.where(torch.rand(rows, cols, generator=gen) < 0.5, -1.0, 1.0)
        return sign * torch.rand(rows, cols, generator=gen).add(1.0) * torch.exp2(e)
    return torch.randn(rows, cols, generator=gen) * float(case)  # signed, at a scale


@pytest.mark.parametrize("case", ["softmax", "1e-30", "1e-10", "1", "1e10", "1e30", "zeros",
                                  "subnormal"])
def test_split_is_exact(case):
    x = _draw(case, torch.Generator().manual_seed(31))
    p = bf16_split.split3_plain(x, 256)
    assert p.dtype == torch.bfloat16 and p.shape == (3, 64, 256)
    assert not p[:, :, 251:].any()
    got = p[:, :, :251].double().sum(0)
    big = x.abs() >= TINY
    assert torch.equal(got[big], x.double()[big])
    assert torch.equal((p[0, :, :251].float() + p[1, :, :251].float()
                        + p[2, :, :251].float())[big], x[big])
    assert ((got - x.double()).abs() <= TINY_MISS).all()
    if case == "subnormal":
        assert (~big).any() and big.any()


def test_split_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32"):
        bf16_split.split3_plain(torch.zeros(4, 8, dtype=torch.bfloat16), 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        bf16_split.split3_plain(torch.zeros(4, 7), 10)
    with pytest.raises(ValueError, match="at least"):
        bf16_split.split3_plain(torch.zeros(4, 12), 8)
    # the kernel's wrapper takes CUDA tensors only; ops takes the plain
    # version for CPU tensors
    with pytest.raises(ValueError, match="CUDA tensor"):
        bf16_split.split3(torch.zeros(4, 8), 8)
    x = torch.randn(4, 5)
    assert torch.equal(ops.bf16_split3(x, 8), bf16_split.split3_plain(x, 8))


def _layout(name):
    base = torch.randn(6, 12, generator=torch.Generator().manual_seed(5))
    return {"dense": base, "row_slice": base[:, :9], "one_row": base[2:3, 1:10],
            "row_broadcast": base[:1].expand(6, 12), "transposed": base.T,
            "column_step": base[:, ::2], "column_broadcast": base[:1, :1].expand(6, 1)}[name]


@pytest.mark.parametrize("name,copied", [
    ("dense", False), ("row_slice", False), ("one_row", False), ("row_broadcast", True),
    ("transposed", True), ("column_step", True), ("column_broadcast", True)])
def test_kernel_reads_any_layout(name, copied):
    """What the kernel's wrapper hands the kernel (``dense_rows``): rows of
    contiguous columns at least ``cols`` apart, inside the tensor's
    storage, holding ``x``; a copy only where ``x`` is not so (a row
    broadcast's stride 0 would read past its storage)."""
    x = _layout(name)
    d, stride = bf16_split.dense_rows(x)
    rows, cols = x.shape
    assert (d is not x) == copied and stride >= cols
    assert d.storage_offset() + (rows - 1) * stride + cols <= d.untyped_storage().nbytes() // 4
    assert torch.equal(torch.as_strided(d, (rows, cols), (stride, 1)), x)
    assert torch.equal(ops.bf16_split3(x, 12), bf16_split.split3_plain(x.contiguous(), 12))


def _operands(M, D, V, layout, gen):
    h = torch.randn(M, D, generator=gen).bfloat16()
    if layout == "tied":  # the embedding's transpose, as a tied model's logits take it
        w = (torch.randn(V, D, generator=gen) / D ** 0.5).bfloat16().T
    else:
        w = (torch.randn(D, V, generator=gen) / D ** 0.5).bfloat16()
    return h, w, _draw("softmax", gen, M, V)


def _within_bf16(a, b, terms):
    """Each entry of the bf16 ``a`` within one bf16 rounding of ``b`` (a
    rounding that flipped), or within float32 rounding of the sum of its
    terms' magnitudes (an entry that cancels)."""
    a, b = a.float(), b.float()
    return ((a - b).abs() <= 2.0 ** -7 * b.abs() + 1e-6 * terms).all()


CASES = [(48, 64, 251, "plain"), (40, 32, 264, "plain"), (36, 64, 251, "tied"),
         (24, 16, 8, "tied")]


@pytest.mark.parametrize("M,D,V,layout", CASES)
def test_cotangent_products_are_the_float32_products(M, D, V, layout):
    """The backward's float32 ``dh`` and ``dw`` from the three pieces
    equal the float32 products of the cotangent within float32 rounding."""
    h, w, g = _operands(M, D, V, layout, torch.Generator().manual_seed(M))
    Vp = -(-V // model.VOCAB_PAD) * model.VOCAB_PAD
    wp = torch.nn.functional.pad(w, (0, Vp - V))
    dh, dw = model.cotangent_products(g, h, wp)
    assert dh.dtype == dw.dtype == torch.float32 and dw.shape == (D, V)
    want_h = g.double() @ w.double().T
    want_w = h.double().T @ g.double()
    terms_h = g.double().abs() @ w.double().abs().T
    terms_w = h.double().abs().T @ g.double().abs()
    assert ((dh - want_h).abs() <= 1e-6 * terms_h).all()
    assert ((dw - want_w).abs() <= 1e-6 * terms_w).all()
    assert model.cotangent_products(g, h, wp, True, False)[1] is None
    assert model.cotangent_products(g, h, wp, False, True)[0] is None


@pytest.mark.parametrize("M,D,V,layout", CASES)
def test_function_matches_float32_autograd(M, D, V, layout):
    h, w, g = _operands(M, D, V, layout, torch.Generator().manual_seed(M + 1))
    h.requires_grad_()
    w.requires_grad_()
    out = model.TensorCoreLogits.apply(h, w)
    want = torch.matmul(h.float(), w.float())
    assert out.dtype == torch.float32 and out.shape == (M, V)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    dh, dw = torch.autograd.grad(out, (h, w), g)
    ref_h, ref_w = torch.autograd.grad(want, (h, w), g)
    assert dh.dtype == ref_h.dtype == torch.bfloat16 and dw.dtype == ref_w.dtype
    assert dw.shape == w.shape
    assert _within_bf16(dh, ref_h, g.abs() @ w.float().abs().T)
    assert _within_bf16(dw, ref_w, h.float().abs().T @ g.abs())
    # only the operands that need it get a gradient
    w2 = w.detach()
    (dh2,) = torch.autograd.grad(model.TensorCoreLogits.apply(h, w2), (h,), g)
    assert torch.equal(dh2, dh)


def _bf16_model(arch, B=2, S=16):
    cfg = smoke_config(arch)
    params = init_params(model.model_specs(cfg), torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen, dtype=torch.int32)
             for k in ("tokens", "targets")}
    return cfg, params, batch


def _loss_and_grads(cfg, params, batch):
    tracked = [p.requires_grad_() for p in _leaves(params)]
    loss = model.loss_fn(cfg, params, batch)
    return loss, torch.autograd.grad(loss, tracked)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _emulate_tensor_cores(monkeypatch):
    """bf16 operands on the CPU take :class:`TensorCoreLogits` (its products
    run in float32 there)."""
    monkeypatch.setattr(model, "tensor_core_operands",
                        lambda h, w: h.dtype == w.dtype == torch.bfloat16)


@pytest.mark.parametrize("arch", ["roberta-large", "gemma2-9b", "gpt-neox-20b", "llama3.2-1b"])
def test_loss_fn_through_the_function_matches_the_float32_path(arch, monkeypatch):
    """bf16 smoke models (mlm_head, a tied softcapped head, an unembedding,
    a tied head), the loss chunked in threes: the loss within float32
    rounding and each gradient leaf within the parity tests' 1e-4 of the
    float32 path's (the bf16 ``dh`` of the two paths differ where a
    rounding flips; 2.6e-6 at most, gpt-neox-20b)."""
    cfg, params, batch = _bf16_model(arch)
    monkeypatch.setattr(model, "LOSS_CHUNK_BYTES", 4 * 2 * cfg.vocab_size * 3)
    loss0, grads0 = _loss_and_grads(cfg, params, batch)
    _emulate_tensor_cores(monkeypatch)
    loss, grads = _loss_and_grads(cfg, params, batch)
    assert abs(loss.item() - loss0.item()) <= 1e-6 * abs(loss0.item())
    for g, g0 in zip(grads, grads0, strict=True):
        assert g.dtype == g0.dtype and _rel(g, g0) < 1e-4


def _counts(rec):
    return {dict(labels)["path"]: v for (name, labels), v in rec.counters.items()
            if name == model.LOGITS_PRODUCTS}


@pytest.mark.parametrize("chunks,path", [(1, "float32"), (4, "float32"), (4, "tensor_core")])
def test_logits_products_are_counted(chunks, path, monkeypatch):
    """One count a forward product: a chunk's forward and, where the loss is
    chunked (checkpointed), its recompute in the backward. Recording
    changes nothing: the loss and every gradient leaf equal, bit for bit,
    those of the same step without a recorder, which counts nothing."""
    cfg, params, batch = _bf16_model("roberta-large")
    if chunks > 1:
        monkeypatch.setattr(model, "LOSS_CHUNK_BYTES", 4 * 2 * cfg.vocab_size * (16 // chunks))
    if path == "tensor_core":
        _emulate_tensor_cores(monkeypatch)
    loss0, grads0 = _loss_and_grads(cfg, params, batch)
    assert metrics.get_recorder().enabled is False and obs.active() is None
    with metrics.recording(metrics.MetricsRecorder()) as rec:
        loss, grads = _loss_and_grads(cfg, params, batch)
    per_chunk = 2 if chunks > 1 else 1
    assert _counts(rec) == {path: float(per_chunk * chunks)}
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads, grads0, strict=True):
        assert torch.equal(g, g0)
    with metrics.recording(metrics.MetricsRecorder()) as rec, torch.no_grad():
        model.loss_fn(cfg, params, batch)
    assert _counts(rec) == {path: float(chunks)}


@pytest.mark.card
def test_roberta_loss_chunk_on_the_tensor_cores():
    """One roberta-large loss chunk (5248 rows, d 1024, vocab 50265, the
    cotangent of a mean cross-entropy) on the card. The split kernel equals
    its plain version bit for bit. The tensor-core logits, ``dh`` and
    ``dw`` each lie within the card's float32 accumulation bound of the
    float64 products: the products are exact, and an H100's tensor cores
    add them with truncation, at most one float32 unit of the sum of the
    terms' magnitudes for every 16 products (``2**-27 K``, K the
    contraction length). The returned bf16 gradients equal the float32
    path's in 97 % of entries or more, and each lies within one bf16
    rounding of it or within that bound.

    What these checks tell apart, at this chunk on an H100 (PERF.md §6):
    they refuse a bf16-rounded cotangent (one piece: ``dh`` and ``dw``
    4.1e-4 and 4.5e-4 of their norms from float64, entries outside the
    bound, 88 % and 64 % of the bf16 gradients equal). They pass a path
    that drops the third piece (each cotangent entry then misses by at most
    2**-17 of itself: 5.94e-5 and 1.20e-5 from float64, against 5.96e-5
    and 1.22e-5 with it), because the truncating accumulation's own error
    is larger; the bit-exact split is held by the CPU tests and the kernel
    against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the tensor-core products run only there")
    dev = "cuda"
    M, D, V = 5248, 1024, 50265
    Vp = -(-V // model.VOCAB_PAD) * model.VOCAB_PAD
    gen = torch.Generator(device=dev).manual_seed(31)
    h = torch.randn(M, D, device=dev, generator=gen).bfloat16()
    w = (torch.randn(D, V, device=dev, generator=gen) / D ** 0.5).bfloat16()
    n = M * 41
    g = torch.softmax(3 * torch.randn(M, V, device=dev, generator=gen), -1) / n
    g[torch.arange(M, device=dev), torch.randint(0, V, (M,), device=dev, generator=gen)] -= 1 / n
    assert model.tensor_core_operands(h, w)

    pieces = bf16_split.split3(g, Vp)
    assert torch.equal(pieces, bf16_split.split3_plain(g, Vp))
    assert torch.equal(pieces[:, :, :V].double().sum(0)[g.abs() >= TINY],
                       g.double()[g.abs() >= TINY])
    del pieces

    hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
    out = model.TensorCoreLogits.apply(hg, wg)
    dh, dw = torch.autograd.grad(out, (hg, wg), g)
    hf, wf = h.clone().requires_grad_(), w.clone().requires_grad_()
    ref = torch.matmul(hf.float(), wf.float())
    ref_h, ref_w = torch.autograd.grad(ref, (hf, wf), g)
    dh32, dw32 = model.cotangent_products(g, h, torch.nn.functional.pad(w, (0, Vp - V)))

    def bound(K, terms):
        return 2.0 ** -27 * K * terms

    hd, wd, gd = h.double(), w.double(), g.double()
    terms = hd.abs() @ wd.abs()
    assert ((out.double() - hd @ wd).abs() <= bound(D, terms)).all()
    assert ((ref.double() - hd @ wd).abs() <= bound(D, terms)).all()
    del out, ref, terms
    for got, ref32, want, terms, K in (
            (dh, ref_h, gd @ wd.T, gd.abs() @ wd.abs().T, Vp),
            (dw, ref_w, hd.T @ gd, hd.abs().T @ gd.abs(), 3 * M)):
        f32 = dh32 if got is dh else dw32
        assert ((f32.double() - want).abs() <= bound(K, terms)).all()
        assert float((got == ref32).float().mean()) >= 0.97
        assert ((got.double() - ref32.double()).abs()
                <= 2.0 ** -7 * ref32.double().abs() + bound(K, terms)).all()
