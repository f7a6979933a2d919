"""The RMS norm's dispatch (``models/layers.py::rmsnorm``) and the fused
kernels' wrapper (``kernels/rmsnorm.py``), on the CPU:

* on CPU tensors the dispatch keeps the float32 chain bit for bit, in the
  value and in the gradients of ``x`` and ``w``, for [B, S, D] and
  qk-norm's [B, S, H, hd] inputs, ``x`` and ``w`` each bf16 or float32;
  the ``group`` path (the mean square all-reduced) is untouched;
* ``model.rmsnorm`` counts one ``plain`` a call where a span would record,
  and one more for each recompute under ``checkpoint``; a smoke model's
  train step counts each block's two norms twice and the final norm once,
  a prefill each once; recording changes no bit;
* the kernels' entry points (``ops.rmsnorm``, :class:`~repro_torch.kernels.
  rmsnorm.RMSNorm` and the wrappers) take CUDA tensors alone, and raise
  ``ValueError`` on the inputs the kernels do not take;
* on a card (marked ``card``, skipped here): the kernels against autograd
  of the plain chain and against float64, and a train step through them
  against the chain's.

Run the card test on the card without this directory's conftest (it
imports JAX): ``python -m pytest -p no:cacheprovider --noconftest -m card
tests/test_torch_rmsnorm.py``.
"""

import pytest
import torch
from torch.utils import checkpoint

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms
from repro_torch.models import layers, model
from repro_torch.models.param import init_params
from repro_torch.obs import metrics
from repro_torch.parallel import collectives as coll

EPS = 1e-5
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def chain(x, w, eps):
    """The norm as ``models/layers.py`` composed it before the kernels."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * w.float()).to(dtype)


def _inputs(shape, xd, wd, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 3).to(DTYPES[xd])
    w = (1 + 0.3 * torch.randn(shape[-1], generator=gen)).to(DTYPES[wd])
    dy = torch.randn(shape, generator=gen).to(x.dtype)
    return x, w, dy


def _value_and_grads(fn, x, w, dy):
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fn(xg, wg, EPS)
    return (y, *torch.autograd.grad(y, (xg, wg), dy))


SHAPES = {"3d": (2, 5, 64), "qk_norm": (2, 5, 4, 16)}
PAIRS = [(s, xd, wd) for s in SHAPES for xd in DTYPES for wd in DTYPES]


@pytest.mark.parametrize("shape,xd,wd", PAIRS)
def test_dispatch_keeps_the_chain_on_the_cpu(shape, xd, wd):
    x, w, dy = _inputs(SHAPES[shape], xd, wd)
    assert not rms.kernel_takes(x, w)
    got = _value_and_grads(layers.rmsnorm, x, w, dy)
    want = _value_and_grads(chain, x, w, dy)
    for g, v in zip(got, want, strict=True):
        assert g.dtype == v.dtype and torch.equal(g, v)
    assert torch.equal(rms.rmsnorm_plain(x, w, EPS), want[0])


def test_group_path_is_untouched(monkeypatch):
    """With a group the sum of squares is all-reduced inside the norm:
    the chain as it was, never the kernels, counted ``plain``. The fake
    all-reduce sums over two ranks holding the same block."""
    group = coll.Group(axes=("tensor",), pg=None, size=2, index=0)
    monkeypatch.setattr(layers.coll, "all_reduce", lambda t, g: t * g.size)
    x, w, dy = _inputs((3, 4, 32), "bf16", "f32")

    def grouped(x, w, eps):
        dtype = x.dtype
        x = x.float()
        var = torch.sum(x * x, dim=-1, keepdim=True) * group.size / (x.shape[-1] * group.size)
        x = x * torch.rsqrt(var + eps)
        return (x * w.float()).to(dtype)

    with metrics.recording(metrics.MetricsRecorder()) as rec:
        got = _value_and_grads(lambda a, b, e: layers.rmsnorm(a, b, e, group), x, w, dy)
    want = _value_and_grads(grouped, x, w, dy)
    for g, v in zip(got, want, strict=True):
        assert torch.equal(g, v)
    assert _counts(rec) == {"plain": 1.0}


def _counts(rec):
    return {dict(labels)["path"]: v for (name, labels), v in rec.counters.items()
            if name == layers.RMSNORM}


@pytest.mark.parametrize("recomputed", [False, True])
def test_rmsnorm_is_counted_once_a_call(recomputed):
    """One ``plain`` a forward call where a span would record (none
    without a recorder), one more for the recompute of a checkpointed
    call; the values and gradients are those of the same calls
    unrecorded."""
    x, w, dy = _inputs((2, 3, 16), "bf16", "f32")

    def twice(a, b, e):
        return layers.rmsnorm(layers.rmsnorm(a, b, e), b, e)

    def call(a, b, e):
        if recomputed:
            return checkpoint.checkpoint(twice, a, b, e, use_reentrant=False)
        return twice(a, b, e)

    assert metrics.get_recorder().enabled is False
    want = _value_and_grads(call, x, w, dy)
    with metrics.recording(metrics.MetricsRecorder()) as rec:
        got = _value_and_grads(call, x, w, dy)
    assert _counts(rec) == {"plain": 4.0 if recomputed else 2.0}
    for g, v in zip(got, want, strict=True):
        assert torch.equal(g, v)


def _smoke(arch, B=2, S=16):
    cfg = smoke_config(arch)
    params = init_params(model.model_specs(cfg), torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen, dtype=torch.int32)
             for k in ("tokens", "targets")}
    return cfg, params, batch


@pytest.mark.parametrize("arch", ["roberta-large", "gpt-neox-20b", "mixtral-8x7b"])
def test_a_step_counts_each_norm(arch):
    """The benchmarked models at smoke size: a train step (full remat)
    counts each block's two norms in the forward and again in its
    recompute, the final norm once, and an MoE model's load-balance norm
    (the first block's ``ln_mlp``) once; a prefill counts each norm once.
    On a card the same counts read ``kernel`` (97 a roberta-large step, 89
    a gpt-neox-20b prefill, 33 a 16-layer mixtral-8x7b one)."""
    cfg, params, batch = _smoke(arch)
    assert cfg.remat_policy == "full"
    L, aux = cfg.num_layers, 1 if cfg.moe_num_experts else 0
    leaves = [p.requires_grad_() for p in _leaves(params)]
    with metrics.recording(metrics.MetricsRecorder()) as rec:
        loss = model.loss_fn(cfg, params, batch)
        torch.autograd.grad(loss, leaves)
    assert _counts(rec) == {"plain": float(4 * L + 1 + aux)}
    with metrics.recording(metrics.MetricsRecorder()) as rec, torch.no_grad():
        model.prefill_fn(cfg, params, batch, batch["tokens"].shape[1])
    assert _counts(rec) == {"plain": float(2 * L + 1)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("shape,xd,wd", PAIRS)
def test_kernel_entry_points_take_cuda_tensors_alone(shape, xd, wd):
    """``ops.rmsnorm`` has no plain branch (``layers.rmsnorm`` picks the
    path): on CPU tensors it and :class:`RMSNorm` raise, with grad or
    without, before any launch."""
    x, w, _ = _inputs(SHAPES[shape], xd, wd, seed=1)
    before = (rms.rmsnorm_fwd.launches, rms.rmsnorm_bwd.launches)
    for needs in ((False, False), (True, False), (False, True)):
        xg, wg = x.clone().requires_grad_(needs[0]), w.clone().requires_grad_(needs[1])
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.rmsnorm(xg, wg, EPS)
        with pytest.raises(ValueError, match="CUDA tensors"):
            rms.RMSNorm.apply(xg, wg, EPS)
    assert (rms.rmsnorm_fwd.launches, rms.rmsnorm_bwd.launches) == before


@pytest.mark.parametrize("x,w,match", [
    (torch.zeros(4, 16, dtype=torch.float64), torch.ones(16), "float32 or bf16"),
    (torch.zeros(4, 16, dtype=torch.float16), torch.ones(16), "float32 or bf16"),
    (torch.zeros(4, 16), torch.ones(16, dtype=torch.float64), "float32 or bf16"),
    (torch.zeros(4, 16), torch.ones(8), r"w \[D\]"),
    (torch.zeros(4, 12), torch.ones(12), "multiple of 8"),
    (torch.zeros(4, 4), torch.ones(4), "multiple of 8"),
    (torch.zeros(2, rms.MAX_COLS + 8), torch.ones(rms.MAX_COLS + 8), "up to 16384"),
    (torch.zeros(4, 16), torch.ones(16), "CUDA tensors"),
    (torch.zeros(4, 16, dtype=torch.bfloat16), torch.ones(16), "CUDA tensors"),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(x, w, match):
    assert not rms.kernel_takes(x, w)
    with pytest.raises(ValueError, match=match):
        rms.rmsnorm_fwd(x, w, EPS)
    with pytest.raises(ValueError, match=match):
        rms.rmsnorm_bwd(x, torch.zeros_like(x), torch.ones(x.shape[:-1]), w)


@pytest.mark.parametrize("dy,r", [
    (torch.zeros(4, 8), torch.ones(4)),
    (torch.zeros(4, 16, dtype=torch.bfloat16), torch.ones(4)),
    (torch.zeros(4, 16), torch.ones(4, dtype=torch.float64)),
    (torch.zeros(4, 16), torch.ones(4, 1)),
    (torch.zeros(4, 16, device="meta"), torch.ones(4)),
    (torch.zeros(4, 16), torch.ones(4, device="meta")),
])
def test_backward_refuses_a_mismatched_dy_or_r(dy, r):
    """``dy`` of ``x``'s shape, dtype and device, ``r`` float32 [rows] on
    the same device: checked before any pointer is passed."""
    with pytest.raises(ValueError, match="float32 r"):
        rms.rmsnorm_bwd(torch.zeros(4, 16), dy, r, torch.ones(16))


def test_meta_tensors_take_the_chain():
    """The dry run's data-less trace follows the chain (``meta``)."""
    x = torch.empty(2, 8, 64, device="meta", dtype=torch.bfloat16)
    w = torch.empty(64, device="meta")
    assert not rms.kernel_takes(x, w)
    y = layers.rmsnorm(x, w, EPS)
    assert y.device.type == "meta" and y.dtype == x.dtype and y.shape == x.shape
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rmsnorm(x, w, EPS)


# the kernels against autograd of the chain on the card (chip_smoke.py's
# limits): dx and dw by the norm of their gap, within REL of the chain's
# norm plus one unit in the last place (UNIT) of its largest entry; y, dx
# and dw each no further from float64 than F64_RATIO x the chain's gap
# (norm against norm) plus a floor of float32 rounding
DX_REL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}
DW_REL = {torch.bfloat16: 4e-3, torch.float32: 1e-4}
UNIT = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}
F64_RATIO = {torch.bfloat16: 1.05, torch.float32: 2.0}
F64_FLOOR = 2.0 ** -22


def _f64(x, w, dy):
    xg, wg = x.double().requires_grad_(), w.double().requires_grad_()
    y = xg * torch.rsqrt((xg * xg).mean(-1, keepdim=True) + EPS) * wg
    return (y.detach(), *torch.autograd.grad(y, (xg, wg), dy.double()))


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.card
def test_kernels_against_the_chain_on_the_card(monkeypatch):
    """The kernels against autograd of the chain on the card, bf16 and
    float32, rows of 8 to 6144 wide: ``y`` within one bf16 unit in the last
    place (float32: 1e-5 relative), ``dx`` and ``dw`` within
    :data:`DX_REL` and :data:`DW_REL` of their norms (plus one unit of the
    largest entry), each of ``y``, ``dx`` and ``dw`` no further from
    float64 than the chain's (:data:`F64_RATIO`), two backward runs
    bit-equal; and a 2-layer roberta-large train step through the kernels:
    in bf16 one backward launch a norm and the loss within 1e-3 of the
    chain's, in float32 the loss within 1e-4 and every gradient leaf within
    1e-3 of the chain's (an H100 reads 6.3e-5 at most). A bf16 step's
    gradients move by ≈ 2e-3 of their norm when only the order of the
    norm's float32 backward changes (4e-3 on the card), so they are held in
    float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernels run only there")
    dev = "cuda"
    for shape in ((3, 8), (77, 64), (256, 1024), (33, 6144), (4, 16, 8, 128)):
        for xd in DTYPES:
            for wd in DTYPES:
                x, w, dy = (t.to(dev) for t in _inputs(shape, xd, wd, seed=2))
                assert rms.kernel_takes(x, w)
                y, r = rms.rmsnorm_fwd(x, w, EPS, save=True)
                dx, dw = rms.rmsnorm_bwd(x, dy, r, w)
                dx2, dw2 = rms.rmsnorm_bwd(x, dy, r, w)
                assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
                yp, dxp, dwp = _value_and_grads(chain, x, w, dy)
                gap = (y.double() - yp.double()).abs()
                if y.dtype == torch.bfloat16:
                    _, e = torch.frexp(yp.double())
                    assert (gap <= torch.ldexp(torch.ones_like(gap), e - 8)).all()
                else:
                    assert (gap <= 1e-5 * yp.double().abs()).all()
                for g, v, rel in ((dx, dxp, DX_REL), (dw, dwp, DW_REL)):
                    v = v.double()
                    lim = rel[g.dtype] * v.norm() + UNIT[g.dtype] * v.abs().max()
                    assert float((g.double() - v).norm()) <= float(lim)
                for g, v, t64 in zip((y, dx, dw), (yp, dxp, dwp), _f64(x, w, dy), strict=True):
                    assert _rel(g, t64) <= F64_RATIO[g.dtype] * _rel(v, t64) + F64_FLOOR

    cfg = smoke_config("roberta-large").replace(
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096, num_layers=2)
    params, batch = _smoke_on(cfg, dev)

    def step(c):
        leaves = [p.detach().clone().requires_grad_() for p in _leaves(params)]
        loss = model.loss_fn(c, _rebuild(params, iter(leaves)), batch)
        return loss, torch.autograd.grad(loss, leaves)

    f32 = cfg.replace(dtype=torch.float32)
    before = rms.rmsnorm_bwd.launches
    loss, _ = step(cfg)
    assert rms.rmsnorm_bwd.launches - before == 2 * cfg.num_layers + 1
    loss32, grads32 = step(f32)
    monkeypatch.setattr(rms, "kernel_takes", lambda x, w: False)
    loss0, _ = step(cfg)
    assert abs(loss.item() - loss0.item()) <= 1e-3 * abs(loss0.item())
    loss320, grads320 = step(f32)
    assert abs(loss32.item() - loss320.item()) <= 1e-4 * abs(loss320.item())
    for g, g0 in zip(grads32, grads320, strict=True):
        assert float((g.double() - g0.double()).norm()) <= 1e-3 * float(g0.double().norm())


def _smoke_on(cfg, dev, B=4, S=128):
    params = init_params(model.model_specs(cfg), torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              dtype=torch.int32).to(dev) for k in ("tokens", "targets")}
    return _to(params, dev), batch


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _rebuild(tree, it):
    """``tree`` with its leaves, in :func:`_leaves`' order, taken from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)
