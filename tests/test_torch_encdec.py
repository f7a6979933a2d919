"""The port's encoders, cross-attention and modality stubs against the JAX
package's, on the CPU.

The same numpy inputs (weights from JAX's ``init_params``, activations from
a seeded numpy generator) go to both sides, in float32. The port runs its
attention kernels' plain versions on the CPU; the JAX model runs its XLA
attention on the Auto-axis reference mesh.

* ``project_cross_kv``, ``cross_attention`` with Sq != Skv (the flash
  path) and for one decode position (the decode path), the encoder's
  bidirectional ``self_attention`` and ``_run_encoder``, each within 1e-5
  relative, for the flan-t5-xxl and whisper-base smoke configs;
* ``load_jax_params`` copies the encoder, ``enc_norm``, ``ln_cross``,
  ``cross`` and ``mlm_head`` leaves exactly, and ``cast_weights`` keeps
  the norm scales among them in float32;
* ``ServeEngine.generate`` refuses, before its prefill, a request whose
  positions (image, prompt and new tokens) exceed the decoder cache's
  slots, and serves one that fills them exactly;
* a vision stub's decode starts after the image and the prompt: the first
  step writes slot Ni + S and leaves every cached position as it was;
* ``n_out = 0`` serves the prefill alone (an encoder-only model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.inputs import make_rules
from repro.launch.mesh import set_mesh
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.models.param import init_params as jax_init_params
from repro_torch.configs import smoke_config
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import attention as attn
from repro_torch.models import model

B, SQ, ENC_S = 2, 6, 20
F32_RTOL = 1e-5
ENC_DEC = ["flan-t5-xxl", "whisper-base"]


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _configs(arch, dtype="float32"):
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    return jcfg, smoke_config(arch).replace(dtype=getattr(torch, dtype))


def _params(jcfg, seed=0):
    """JAX-initialised parameters as a numpy tree."""
    return jax.tree.map(np.asarray, jax_init_params(jax_model.model_specs(jcfg, 1),
                                                    jax.random.key(seed)))


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _rel(a, b):
    a, b = np.float32(a), np.float32(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-6))


def _t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(x):
    return x.float().numpy()


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("arch", ENC_DEC)
def test_project_cross_kv_matches_jax(arch):
    jcfg, cfg = _configs(arch)
    p = _layer0(_params(jcfg)["decoder"]["b0"]["cross"])
    enc = _normal(1, B, ENC_S, jcfg.d_model)
    jk, jv = jax_attn.project_cross_kv(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(enc))
    k, v = attn.project_cross_kv(cfg, _t(p), torch.from_numpy(enc))
    assert tuple(k.shape) == (B, ENC_S, cfg.num_kv_heads, cfg.head_dim)
    assert _rel(jk, _np(k)) < F32_RTOL and _rel(jv, _np(v)) < F32_RTOL


@pytest.mark.parametrize("sq", [SQ, 1])
@pytest.mark.parametrize("arch", ENC_DEC)
def test_cross_attention_matches_jax(arch, sq):
    """Sq = 6 decoder positions over 20 encoder positions (the flash
    kernel's plain version at ``causal=False``, Sq != Skv) and one decode
    position (the decode kernel's plain version at ``valid_len = enc_S``)."""
    jcfg, cfg = _configs(arch)
    p = _layer0(_params(jcfg)["decoder"]["b0"]["cross"])
    x = _normal(2, B, sq, jcfg.d_model)
    kv = (_normal(3, B, ENC_S, jcfg.num_kv_heads, jcfg.head_dim),
          _normal(4, B, ENC_S, jcfg.num_kv_heads, jcfg.head_dim))
    want = jax_attn.cross_attention(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                    tuple(map(jnp.asarray, kv)))
    got = attn.cross_attention(cfg, _t(p), torch.from_numpy(x),
                               tuple(map(torch.from_numpy, kv)))
    assert tuple(got.shape) == (B, sq, cfg.d_model)
    assert _rel(want, _np(got)) < F32_RTOL


@pytest.mark.parametrize("arch", ENC_DEC + ["roberta-large"])
def test_bidirectional_self_attention_matches_jax(arch):
    jcfg, cfg = _configs(arch)
    params = _params(jcfg)
    blocks = params["encoder"] if jcfg.is_encoder_decoder else params["decoder"]["b0"]
    p = _layer0(blocks)["attn"]
    x = _normal(5, B, ENC_S, jcfg.d_model)
    pos = np.arange(ENC_S, dtype=np.int32)
    want = jax_attn.self_attention(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                   positions=jnp.asarray(pos), causal=False)
    got = attn.self_attention(cfg, _t(p), torch.from_numpy(x),
                              positions=torch.from_numpy(pos), causal=False)
    assert _rel(want, _np(got)) < F32_RTOL
    # causal and bidirectional differ: the mask is really off
    causal = attn.self_attention(cfg, _t(p), torch.from_numpy(x),
                                 positions=torch.from_numpy(pos), causal=True)
    assert _rel(want, _np(causal)) > 1e-2


@pytest.mark.parametrize("arch", ENC_DEC)
def test_run_encoder_matches_jax(arch, mesh):
    jcfg, cfg = _configs(arch)
    np_params = _params(jcfg)
    enc = _normal(6, B, ENC_S, jcfg.d_model)
    shape = JaxShapeConfig("t", 2 * ENC_S, B, "prefill")
    with set_mesh(mesh):
        ctx = jax_model.MeshCtx(mesh, make_rules(jcfg, shape, mesh))
        want = jax.jit(lambda p, e: jax_model._run_encoder(jcfg, p, e, ctx))(
            jax.tree.map(jnp.asarray, np_params), jnp.asarray(enc))
    got = model._run_encoder(cfg, model.load_jax_params(cfg, np_params),
                             torch.from_numpy(enc))
    assert tuple(got.shape) == (B, ENC_S, cfg.d_model)
    assert _rel(want, _np(got)) < F32_RTOL


@pytest.mark.parametrize("arch", ["flan-t5-xxl", "whisper-base", "roberta-large"])
def test_load_jax_params_new_leaves(arch):
    """The leaves this slice adds are copied exactly, in their spec dtype,
    and ``cast_weights`` keeps ``ln_cross`` and ``enc_norm`` (rmsnorm
    scales) in float32 where the bf16 model casts the other weights."""
    jcfg, cfg = _configs(arch, "bfloat16")
    np_params = _params(jcfg)
    params = model.load_jax_params(cfg, np_params)
    if cfg.is_encoder_decoder:
        new = {"encoder": params["encoder"], "enc_norm": params["enc_norm"],
               "ln_cross": params["decoder"]["b0"]["ln_cross"],
               "cross": params["decoder"]["b0"]["cross"]}
        want = {"encoder": np_params["encoder"], "enc_norm": np_params["enc_norm"],
                "ln_cross": np_params["decoder"]["b0"]["ln_cross"],
                "cross": np_params["decoder"]["b0"]["cross"]}
        assert set(params["encoder"]) == {"ln_attn", "attn", "ln_mlp", "mlp"}
    else:
        assert "unembed" not in params
        new, want = {"mlm_head": params["mlm_head"]}, {"mlm_head": np_params["mlm_head"]}
    for (path, got), x in zip(jax.tree_util.tree_leaves_with_path(new),
                              jax.tree.leaves(want), strict=True):
        assert np.array_equal(got.float().numpy(), x.astype(np.float32)), path
    cast = model.cast_weights(cfg, model.model_specs(cfg))
    if cfg.is_encoder_decoder:
        assert cast["enc_norm"].dtype == cast["decoder"]["b0"]["ln_cross"].dtype \
            == cast["encoder"]["ln_attn"].dtype == torch.float32
        assert cast["decoder"]["b0"]["cross"]["wq"].dtype == torch.bfloat16
    else:
        assert cast["mlm_head"].dtype == torch.bfloat16


def _image(cfg, seed=7):
    return _normal(seed, B, cfg.num_image_embeds, cfg.d_model)


@pytest.mark.parametrize("arch,extra", [("internvl2-1b", "image"),
                                        ("flan-t5-xxl", "enc")])
def test_generate_refuses_past_the_cache(arch, extra):
    """The decoder cache has 512 slots (``cache_len`` of the decoder's
    share of max_len). Image, prompt and new tokens that fill it exactly
    are served; one position more raises ``ValueError`` before the
    prefill runs (the JAX cache update would clamp silently)."""
    _, cfg = _configs(arch)
    max_len = 64 if extra == "image" else 1000  # flan: 500 decoder positions
    eng = ServeEngine(cfg, max_len, B, device="cpu")
    assert eng.slots == 512
    ni = cfg.num_image_embeds if extra == "image" else 0
    inputs = ({"image_embeds": _image(cfg)} if extra == "image"
              else {"enc_embeds": _normal(8, B, ENC_S, cfg.d_model)})
    S = 512 - ni - 4
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S))
    out = eng.generate(tokens, 4, inputs)
    assert out.shape == (B, 4) and out.dtype == np.int32
    real, calls = eng.prefill, []
    eng.prefill = lambda *a: calls.append(a) or real(*a)
    with pytest.raises(ValueError, match="exceed the decoder cache's 512 slots"):
        eng.generate(tokens, 5, inputs)
    assert not calls


def test_vision_decode_starts_after_the_image():
    """internvl2's prefill caches the Ni image positions and the S prompt
    positions; the first decode step writes slot Ni + S and leaves slots
    0 .. Ni + S - 1 as the prefill wrote them (the JAX engine's first step
    writes slot S, over a cached position)."""
    _, cfg = _configs("internvl2-1b")
    eng = ServeEngine(cfg, 64, B, device="cpu", seed=1)
    S, ni = 12, cfg.num_image_embeds
    toks = torch.as_tensor(np.random.default_rng(10).integers(0, cfg.vocab_size, (B, S)))
    logits, cache = eng.prefill(eng.params, {"tokens": toks,
                                             "image_embeds": torch.from_numpy(_image(cfg))})
    k = cache["b0"]["k"]
    assert bool((k[:, :, :ni + S] != 0).any(-1).any(-1).all()) and not k[:, :, ni + S:].any()
    before = k.clone()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    eng.decode(eng.params, tok, ni + S, cache)
    assert torch.equal(k[:, :, :ni + S], before[:, :, :ni + S])
    assert bool((k[:, :, ni + S] != 0).any(-1).all()) and not k[:, :, ni + S + 1:].any()


def test_encoder_only_serves_the_prefill_alone():
    _, cfg = _configs("roberta-large")
    eng = ServeEngine(cfg, 32, B, device="cpu")
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, 24))
    out = eng.generate(tokens, 0)
    assert out.shape == (B, 0) and out.dtype == np.int32
