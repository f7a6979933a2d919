"""The port's serving path against the JAX model, on the CPU.

For the smoke configs of llama3.2-1b, qwen3-8b (qk-norm), yi-34b (padded
query heads), gemma2-9b (alternating sliding-window and global layers,
softcaps, post-norms, GeGLU, tied embeddings), the paper's gpt-neox-20b
and opt-30b (gelu MLPs), mixtral-8x7b (MoE on sliding-window layers),
kimi-k2-1t-a32b (top-8 MoE with a shared expert, bf16 weights),
mamba2-370m (Mamba2/SSD blocks only), jamba-1.5-large-398b (Mamba2 and
attention without RoPE, an FFN after every block, MoE on every other one),
the paper's roberta-large (encoder-only: a causal prefill, as the JAX
``prefill_fn`` runs it, and the MLM head) and flan-t5-xxl, whisper-base
(encoder-decoder: the encoder over seeded ``enc_embeds`` of
:data:`ENC_S` positions, cross-attention, the cross K/V cache) and
internvl2-1b (seeded ``image_embeds`` before the prompt, GQA 2:1 in the
smoke config, 7:1 at full width), one parameter tree from JAX's ``init_params`` goes to both sides as numpy
arrays (``load_jax_params`` on the port's side); leaves that JAX
initialises to zero (yi's padded ``wo``) get small numpy normals so that
every path computes something. The JAX model runs on the Auto-axis
reference mesh (ROADMAP "Open items"); the port on the CPU runs its
kernels' plain versions.

* float32: prefill logits and every cache leaf (K/V, SSM states, conv
  tails, cross K/V) within 1e-4 relative, one decode step's logits and
  updated cache too, and ``ServeEngine.generate`` gives JAX's
  ``ServeEngine``'s greedy tokens over 8 steps (internvl2's: those of a
  JAX loop of decode steps from position Ni + S, where the port starts;
  the JAX engine starts at S, over a cached image position);
* bfloat16 (the configs' default), with MoE routing followed across (see
  that test) and, for jamba, flan-t5-xxl and whisper-base, the
  attention weights conditioned:
  prefill and decode logits within the 0.06 relative bound of
  ``tests/test_system.py``, and prefill->decode consistency below 0.06;
* ``load_jax_params`` copies every leaf exactly, in its spec dtype;
* the port's config registry is the JAX package's, and every full-size
  config's parameter tree is JAX's, leaf for leaf;
* gemma2's LOCAL blocks: the prompt of S = 24 tokens is longer than the
  smoke window of 16, so prefill places the ring (S - W = 8) and decode
  wraps it; :func:`test_local_decode_matches_jax_every_step` decodes more
  than twice around the ring (and once with a window longer than the cache,
  where the block is not a ring) and compares every step's logits.
"""

import contextlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ALL as JAX_ALL
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.inputs import make_rules
from repro.launch.mesh import set_mesh
from repro.launch.serve import ServeEngine as JaxServeEngine
from repro.launch.steps import build_decode_step as jax_decode_step
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.models.param import init_params as jax_init_params
from _torch_train_ref import shared_params as _shared_params
from repro_torch.configs import ALL, get_config, smoke_config
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import model, moe
from repro_torch.models.config import ShapeConfig

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["llama3.2-1b", "qwen3-8b", "yi-34b", "gemma2-9b", "gpt-neox-20b", "opt-30b",
         "mixtral-8x7b", "kimi-k2-1t-a32b", "mamba2-370m", "jamba-1.5-large-398b",
         "roberta-large", "flan-t5-xxl", "whisper-base", "internvl2-1b"]
B, S = 2, 24
ENC_S = 20  # encoder positions of the encoder-decoder archs' enc_embeds
F32_RTOL = 1e-4
BF16_RTOL = 0.06  # tests/test_system.py's bound
# the archs whose bf16 check runs on conditioned attention weights
# (:func:`_shared_params`); every other arch runs on the JAX init
CONDITIONED = ("jamba-1.5-large-398b", "flan-t5-xxl", "whisper-base")


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _configs(arch, dtype):
    """(JAX config, port config) of the smoke model in ``dtype``."""
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    return jcfg, smoke_config(arch).replace(dtype=getattr(torch, dtype))


def _extra(cfg, seed=6):
    """The arch's inputs beside its tokens, as numpy float32: ``enc_embeds``
    [B, ENC_S, D] of an encoder-decoder model, ``image_embeds`` [B, Ni, D]
    of a vision stub; else none."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"enc_embeds": rng.standard_normal((B, ENC_S, cfg.d_model), np.float32)}
    if cfg.frontend == "vision_stub":
        return {"image_embeds": rng.standard_normal((B, cfg.num_image_embeds, cfg.d_model),
                                                    np.float32)}
    return {}


def _prefix(cfg) -> int:
    """Positions before the prompt: a vision stub's image embeddings."""
    return cfg.num_image_embeds if cfg.frontend == "vision_stub" else 0


def _jax_batch(tokens, extra):
    return {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in extra.items()}}


def _batch(tokens, extra):
    return {"tokens": torch.as_tensor(tokens),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}


def _rel(a, b):
    a, b = np.float32(a), np.float32(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-6))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@contextlib.contextmanager
def _jax_routing():
    """Record the top-k experts JAX's model picks in every MoE block, in
    call order ([T, k] each, numpy): the routing of ``moe_apply``'s own
    float32 logits of its input, sent out of the jitted step by an ordered
    debug callback."""
    real, taken = jax_moe.moe_apply, []

    def moe_apply(cfg, p, x, **kw):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        _, topi = jax.lax.top_k(jax.nn.softmax(xf @ p["router"], axis=-1), cfg.moe_top_k)
        jax.debug.callback(lambda t: taken.append(np.asarray(t)), topi, ordered=True)
        return real(cfg, p, x, **kw)

    jax_moe.moe_apply = moe_apply
    try:
        yield taken
    finally:
        jax_moe.moe_apply = real


def _chip_smoke():
    """``chip_smoke.py`` as a module: its MoE routing recorder and near-tie
    check are the ones its consistency gate runs on the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()


def _assert_near_ties(own, forced):
    """Every expert the port would pick and ``forced`` does not (or the
    reverse) is a near tie: the port's probability of its own choice
    exceeds that of the choice it was given by less than ``NEAR_TIE``
    (``chip_smoke.py``'s, its reason there)."""
    _, margin = CHIP_SMOKE.routing_flips(own, forced)
    assert margin < CHIP_SMOKE.NEAR_TIE


def _run_both(arch, dtype, mesh, tokens, follow_jax_routing=False, condition=False):
    """Prefill of ``tokens`` and one decode step of the next token on both
    sides, with :func:`_shared_params` (``condition`` passed on). Returns
    ((jax logits, cache, dec logits, dec cache), (port ...)); with
    ``follow_jax_routing`` every MoE block of the port takes the experts
    JAX's picked (``chip_smoke.moe_routing``), and a third item, (the
    port's own routing, JAX's), is returned."""
    jcfg, cfg = _configs(arch, dtype)
    np_params = _shared_params(jcfg, condition=condition)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = model.load_jax_params(cfg, np_params, "cpu")
    shape = JaxShapeConfig("t", S, B, "prefill")
    rules = make_rules(jcfg, shape, mesh)
    nxt, extra, pos = tokens[:, -1:], _extra(jcfg), _prefix(jcfg) + S - 1
    with set_mesh(mesh), _jax_routing() as taken:
        jpf = jax.jit(jax_prefill_step(jcfg, shape, mesh, rules))
        jdc = jax.jit(jax_decode_step(jcfg, mesh, rules))
        jl, jc = jpf(jparams, _jax_batch(tokens[:, :-1], extra))
        jl, jc = jax.tree.map(np.asarray, (jl, jc))
        jdl, jdc_ = jdc(jparams, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32),
                        jax.tree.map(jnp.asarray, jc))
        jdl, jdc_ = jax.tree.map(np.asarray, (jdl, jdc_))
        jax.effects_barrier()
    pf = build_prefill_step(cfg, ShapeConfig("t", S, B, "prefill"))
    dc = build_decode_step(cfg)
    forced = [torch.from_numpy(np.array(t)).long() for t in taken]
    with CHIP_SMOKE.moe_routing(forced if follow_jax_routing else None) as own:
        pl, pc = pf(params, _batch(tokens[:, :-1], extra))
        pc_prefill = jax.tree.map(lambda t: t.clone(), pc)
        pdl, pdc = dc(params, torch.as_tensor(nxt), pos, pc)
    out = (jl, jc, jdl, jdc_), (pl, pc_prefill, pdl, pdc)
    return out + ((own, forced),) if follow_jax_routing else out


def _tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_prefill_and_decode_match_jax(arch, mesh):
    jcfg, _ = _configs(arch, "float32")
    (jl, jc, jdl, jdc), (pl, pc, pdl, pdc) = _run_both(arch, "float32", mesh, _tokens(jcfg))
    assert pl.shape == jl.shape == (B, 1, jcfg.vocab_size) and pl.dtype == torch.float32
    assert _rel(jl, _np(pl)) < F32_RTOL
    assert _rel(jdl, _np(pdl)) < F32_RTOL
    for (jpath, j), (ppath, p) in zip(_leaves(jc), _leaves(pc), strict=True):
        assert jpath == ppath and j.shape == tuple(p.shape)
        assert _rel(j, _np(p)) < F32_RTOL, jpath
    for (jpath, j), (ppath, p) in zip(_leaves(jdc), _leaves(pdc), strict=True):
        assert jpath == ppath
        assert _rel(j, _np(p)) < F32_RTOL, jpath


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_logits_and_prefill_decode_consistency(arch, mesh):
    """bf16 logits within 0.06 of JAX's, and the port's full prefill
    within 0.06 of a prefill of all but the last token plus one decode
    step, on the JAX init, or for :data:`CONDITIONED` archs with the
    attention weights conditioned (:func:`_shared_params`). An MoE block
    routes each token by a discrete top-k, and bf16 rounding flips a
    choice where two experts' probabilities nearly tie (a flip moves a
    token's block output by a whole expert's share). So the port
    follows the other side's choices (JAX's; the full prefill's) and each
    of its own choices that differ must be a near tie
    (:func:`_assert_near_ties`); the float32 tests hold the choices
    themselves exactly."""
    jcfg, cfg = _configs(arch, "bfloat16")
    tokens = _tokens(jcfg, seed=4)
    (jl, _, jdl, _), (pl, _, pdl, _), (own, taken) = _run_both(
        arch, "bfloat16", mesh, tokens, follow_jax_routing=True,
        condition=arch in CONDITIONED)
    assert _rel(jl, _np(pl)) < BF16_RTOL
    assert _rel(jdl, _np(pdl)) < BF16_RTOL
    _assert_near_ties(own, taken)
    # the port alone: full prefill against prefill of all but the last token
    # plus one decode step of it
    params = model.load_jax_params(
        cfg, _shared_params(jcfg, condition=arch in CONDITIONED), "cpu")
    extra = _extra(jcfg)
    with CHIP_SMOKE.moe_routing() as full_routing:
        full, _ = build_prefill_step(cfg, ShapeConfig("t", S, B, "prefill"))(
            params, _batch(tokens, extra))
    full_choices = [topi.reshape(B, S, -1) for topi, _ in full_routing]
    forced = ([c[:, :-1].reshape(B * (S - 1), -1) for c in full_choices]
              + [c[:, -1] for c in full_choices])
    with CHIP_SMOKE.moe_routing(forced) as split_routing:
        _, cache = build_prefill_step(cfg, ShapeConfig("t", S, B, "prefill"))(
            params, _batch(tokens[:, :-1], extra))
        dec, _ = build_decode_step(cfg)(params, torch.as_tensor(tokens[:, -1:]),
                                        _prefix(cfg) + S - 1, cache)
    _assert_near_ties(split_routing, forced)
    assert np.isfinite(_np(full)).all() and np.isfinite(_np(dec)).all()
    assert _rel(_np(full[:, -1]), _np(dec[:, -1])) < BF16_RTOL


def _jax_greedy(jeng, mesh, tokens, n, extra, pos):
    """JAX's greedy loop of ``jeng``'s jitted prefill and decode steps, its
    first decode step at position ``pos``."""
    with set_mesh(mesh):
        logits, cache = jeng.prefill(jeng.params, _jax_batch(tokens, extra))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        outs = []
        for i in range(n):
            outs.append(np.asarray(tok)[:, 0])
            logits, cache = jeng.decode(jeng.params, tok, jnp.asarray(pos + i, jnp.int32),
                                        cache)
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return np.stack(outs, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_generate_matches_jax_serve_engine(arch, mesh):
    """The port's greedy tokens are JAX's ``ServeEngine``'s; a vision
    stub's are those of JAX's own steps decoding from position Ni + S,
    after the image and the prompt, where the port starts (the JAX engine
    starts at S, over a cached image position)."""
    jcfg, cfg = _configs(arch, "float32")
    np_params = _shared_params(jcfg)
    jeng = JaxServeEngine(jcfg, mesh, max_len=S + 8, batch=B)
    jeng.params = jax.tree.map(jnp.asarray, np_params)
    eng = ServeEngine(cfg, S + 8, B, device="cpu")
    eng.params = model.load_jax_params(cfg, np_params, "cpu")
    tokens = _tokens(jcfg, seed=5)[:, :16]
    extra = _extra(jcfg)
    if _prefix(jcfg):
        want = _jax_greedy(jeng, mesh, tokens, 8, extra, _prefix(jcfg) + tokens.shape[1])
    else:
        want = jeng.generate(tokens, 8, {k: jnp.asarray(v) for k, v in extra.items()})
    got = eng.generate(tokens, 8, extra)
    assert got.shape == (B, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(tokens, 8, extra), got)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_jax_params_copies_every_leaf(arch):
    jcfg, cfg = _configs(arch, "bfloat16")
    np_params = _shared_params(jcfg)
    params = model.load_jax_params(cfg, np_params, "cpu")
    got, want = list(_leaves(params)), list(_leaves(np_params))
    specs = list(_leaves(model.model_specs(cfg)))
    assert [p for p, _ in got] == [p for p, _ in want] == [p for p, _ in specs]
    for (path, p), (_, x), (_, spec) in zip(got, want, specs):
        # float32 leaves, or bf16 ones (kimi-k2's and jamba's weights)
        assert str(p.dtype)[6:] == np.dtype(x.dtype).name, path
        assert p.dtype == spec.dtype and tuple(p.shape) == x.shape, path
        assert np.array_equal(p.float().numpy(), x.astype(np.float32)), path
    bad = dict(np_params, embed=np_params["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        model.load_jax_params(cfg, bad)
    with pytest.raises(ValueError, match="keys"):
        model.load_jax_params(cfg, {k: v for k, v in np_params.items() if k != "embed"})


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_jax(arch):
    """The port's parameter tree and cache layout are JAX's, leaf for leaf;
    a seeded init is deterministic and puts each rule where JAX does."""
    jcfg, cfg = _configs(arch, "bfloat16")
    jspecs = jax_model.model_specs(jcfg, 1)
    specs = model.model_specs(cfg)
    is_spec = lambda x: hasattr(x, "logical")
    jl = jax.tree_util.tree_leaves_with_path(jspecs, is_leaf=is_spec)
    pl = list(_leaves(specs))
    assert len(jl) == len(pl)
    for (jpath, js), (ppath, ps) in zip(jl, pl):
        assert "/" + "/".join(k.key for k in jpath) == ppath
        assert (js.shape, js.logical, js.init) == (ps.shape, ps.logical, ps.init), ppath
    enc_S = ENC_S if cfg.is_encoder_decoder else 0
    jcache = jax_model.cache_specs(jcfg, B, S, enc_S)
    pcache = model.cache_specs(cfg, B, S, enc_S)
    assert [(s.shape, np.dtype(s.dtype).name) for s in jax.tree.leaves(jcache, is_leaf=is_spec)] \
        == [(s.shape, str(s.dtype)[6:]) for _, s in _leaves(pcache)]
    _, cache = build_prefill_step(cfg, ShapeConfig("t", S, B, "prefill"))(
        model.load_jax_params(cfg, _shared_params(jcfg)),
        _batch(_tokens(jcfg), _extra(jcfg)))
    assert [tuple(t.shape) for _, t in _leaves(cache)] == \
        [s.shape for _, s in _leaves(pcache)]
    a = ServeEngine(cfg, S, B, device="cpu", seed=7).params
    b = ServeEngine(cfg, S, B, device="cpu", seed=7).params
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), path
    for blk in a["decoder"].values():
        if "attn" in blk:  # mamba2 has none
            assert bool((blk["attn"]["wo"] == 0).all()) == (cfg.padded_heads != cfg.num_heads)
    # the leaves read in float32 keep their spec dtype (the norm scales, the
    # MoE router, the SSM's A_log, dt_bias, D_skip and gate_norm); every
    # other weight is stored in the activation dtype
    for (path, x), (_, spec) in zip(_leaves(a), _leaves(specs)):
        kept = path.rsplit("/", 1)[1] in model.SPEC_DTYPE_KEYS
        assert x.dtype == (spec.dtype if kept else cfg.activation_dtype), path
    assert a["final_norm"].dtype == torch.float32  # norm scales stay float32
    assert a["embed"].dtype == cfg.activation_dtype


@pytest.mark.parametrize("arch", sorted(JAX_ALL))
def test_registry_and_full_size_specs_match_jax(arch):
    """The port's registry is JAX's, key for key, and each full-size
    config's parameter tree is JAX's: every leaf's path, shape, logical
    axes and init (specs only, nothing allocated)."""
    assert ALL == JAX_ALL
    is_spec = lambda x: hasattr(x, "logical")
    jl = jax.tree_util.tree_leaves_with_path(
        jax_model.model_specs(jax_get_config(arch), 1), is_leaf=is_spec)
    pl = list(_leaves(model.model_specs(get_config(arch))))
    assert ["/" + "/".join(k.key for k in path) for path, _ in jl] == [p for p, _ in pl]
    for (_, js), (path, ps) in zip(jl, pl):
        assert (js.shape, js.logical, js.init) == (ps.shape, ps.logical, ps.init), path


@pytest.mark.parametrize("pos", [0, 5, 31])
def test_windowed_decode_self_attention_matches_jax(pos):
    """A decode step with a window against a plain (not ring) cache shorter
    than the window, as the served model runs a LOCAL block whose cache has
    ``max_len < W`` slots: a 32-slot cache, W = 48, so ``pos < W`` and JAX's
    mask ``t > pos - W`` keeps every slot up to ``pos``; float32."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as attn

    jcfg, cfg = _configs("gemma2-9b", "float32")
    p = _shared_params(jcfg)["decoder"]["b0"]["attn"]
    p = {k: v[0] for k, v in p.items()}  # layer 0
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32)
    cache = rng.standard_normal((2, B, 32, jcfg.num_kv_heads, jcfg.head_dim),
                                dtype=np.float32)
    want, jk, jv = jax_attn.decode_self_attention(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(cache[0]),
        jnp.asarray(cache[1]), jnp.asarray(pos, jnp.int32), window=48)
    ck, cv = torch.from_numpy(cache[0].copy()), torch.from_numpy(cache[1].copy())
    got, ck, cv = attn.decode_self_attention(
        cfg, {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()},
        torch.from_numpy(x), ck, cv, pos, window=48)
    assert _rel(np.asarray(want), _np(got)) < F32_RTOL
    assert _rel(np.asarray(jk), _np(ck)) < F32_RTOL and _rel(np.asarray(jv), _np(cv)) < F32_RTOL


@pytest.mark.parametrize("prompt,steps,window", [
    (24, 40, None),  # ring placed at prefill (S - W = 8), decode wraps twice
    (8, 36, None),  # prompt shorter than the ring: slots fill, then wrap
    (8, 12, 1024),  # window longer than the 512-slot cache: not a ring
])
def test_local_decode_matches_jax_every_step(prompt, steps, window, mesh):
    """gemma2's smoke config in float32: prefill of ``prompt`` tokens, then
    ``steps`` decode steps of seeded tokens (the same on both sides), each
    step's logits within 1e-4 of JAX's and the caches equal at the end. A
    ring decode step is the plain decode attention over the first
    ``min(pos + 1, W)`` slots (``valid_len``), which this holds to JAX's
    mask of each slot's absolute position."""
    jcfg, cfg = _configs("gemma2-9b", "float32")
    if window is not None:
        jcfg, cfg = jcfg.replace(window_size=window), cfg.replace(window_size=window)
    W = cfg.window_size
    assert window is not None or steps >= 2 * W  # twice around the ring
    np_params = _shared_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = model.load_jax_params(cfg, np_params, "cpu")
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, prompt + steps)).astype(np.int32)
    shape = JaxShapeConfig("t", prompt + steps, B, "prefill")
    rules = make_rules(jcfg, shape, mesh)
    jpf = jax.jit(jax_prefill_step(jcfg, shape, mesh, rules))
    jdc = jax.jit(jax_decode_step(jcfg, mesh, rules))
    pf = build_prefill_step(cfg, ShapeConfig("t", prompt + steps, B, "prefill"))
    dc = build_decode_step(cfg)
    with set_mesh(mesh):
        jl, jc = jpf(jparams, {"tokens": jnp.asarray(toks[:, :prompt])})
        pl, pc = pf(params, {"tokens": torch.as_tensor(toks[:, :prompt])})
        assert _rel(np.asarray(jl), _np(pl)) < F32_RTOL
        ring = W if window is None else 512
        assert pc["b0"]["k"].shape[2] == ring and pc["b1"]["k"].shape[2] == 512
        for i in range(steps):
            pos = prompt + i
            nxt = toks[:, pos:pos + 1]
            jl, jc = jdc(jparams, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32), jc)
            pl, pc = dc(params, torch.as_tensor(nxt), pos, pc)
            assert _rel(np.asarray(jl), _np(pl)) < F32_RTOL, pos
        jc = jax.tree.map(np.asarray, jc)
    for (jpath, j), (ppath, p) in zip(_leaves(jc), _leaves(pc), strict=True):
        assert jpath == ppath and j.shape == tuple(p.shape)
        assert _rel(j, _np(p)) < F32_RTOL, jpath
