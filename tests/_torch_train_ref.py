"""Shared pieces of the training parity tests: the JAX reference on the
Auto-axis mesh and the port on the CPU, fed the same numpy values.

* :func:`shared_params` draws the parameters with the JAX package's
  ``init_params`` (numpy tree), zero leaves filled with small numpy normals
  so that every path computes something (as ``tests/test_torch_serve.py``
  does); the port loads them with ``model.load_jax_params``.
* :func:`jax_batch` is ``tests/conftest.py::make_batch`` (bf16 encoder and
  image embeddings); :func:`port_batch` carries the same values to torch.
* :func:`jax_loss_and_grads` is ``jax.value_and_grad`` of the reference's
  ``loss_fn`` under the train rules of ``make_rules``; :func:`jax_steps`
  runs the reference's ``build_train_step`` n times and returns every
  state.
* :func:`rel` is the gap norm over the reference's norm of one leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

from conftest import make_batch
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.inputs import make_rules
from repro.launch.mesh import set_mesh
from repro.launch.steps import build_train_step as jax_train_step
from repro.models import model as jax_model
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.models.param import init_params as jax_init_params
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.configs import smoke_config

# the 15 registry archs
ARCHS = ["bloom-176b", "flan-t5-xxl", "gemma2-9b", "gpt-neox-20b", "internvl2-1b",
         "jamba-1.5-large-398b", "kimi-k2-1t-a32b", "llama3.2-1b", "mamba2-370m",
         "mixtral-8x7b", "opt-30b", "qwen3-8b", "roberta-large", "whisper-base", "yi-34b"]
B, S = 2, 16  # the probe ROADMAP records

# The bound (gap norm over norm, each leaf) of the port's gradients, new
# parameters and optimizer state against JAX's, in float32 with float32
# parameter storage. kimi-k2 and jamba store their parameters in bf16
# (``param_dtype``), so their gradients are bf16 and each new parameter is
# rounded to bf16: a float32 gap of ~1e-7 flips the rounding of an entry
# near a rounding boundary by one bf16 unit (2^-8 to 2^-7 of the entry).
# With bf16 storage their gradients and new parameters are held within
# BF16_STORAGE_RTOL of JAX's, and the squared-gradient moments of Adafactor
# within twice it (ROADMAP Queue 3).
RTOL = 1e-4
BF16_STORAGE_RTOL = 2.0 ** -7
BF16_PARAM_ARCHS = ("jamba-1.5-large-398b", "kimi-k2-1t-a32b")
# The archs whose three-step comparison runs on conditioned attention
# weights (:func:`shared_params`), the set ``tests/test_torch_serve.py``
# conditions. On the JAX init, flan-t5-xxl's and whisper-base's moments
# after the second step are 2.2e-4 and 2.3e-4 of a leaf's norm apart
# (decoder/b0/cross/wk, encoder/attn/wv), conditioned 1.3e-6 and 1.9e-6.
CONDITIONED = ("jamba-1.5-large-398b", "flan-t5-xxl", "whisper-base")


def reference_mesh():
    """The Auto-axis (1, 1) mesh (``launch/mesh.py``'s Explicit axes fail on
    this jax; ROADMAP "Open items")."""
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def configs(arch, dtype="float32", param_storage="float32"):
    """(JAX smoke config, port smoke config) computing in ``dtype`` with
    parameters stored in ``param_storage`` (None: the config's own)."""
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    cfg = smoke_config(arch).replace(dtype=getattr(torch, dtype))
    if param_storage is not None:
        jcfg = jcfg.replace(param_dtype=param_storage)
        cfg = cfg.replace(param_dtype=getattr(torch, param_storage))
    return jcfg, cfg


def shared_params(jcfg, seed=0, condition=False):
    """JAX-initialised parameters as a numpy tree, zero leaves filled with
    small numpy normals. With ``condition``, the attention weights (the
    decoder's self and cross attention, the encoder's self attention) are
    rescaled from the JAX init's fan-in (the second-to-last dim: the head
    count for ``wq [D, H, hd]``) to a fan-in over each product's
    contraction dims (D for wq/wk/wv, H * hd for wo), as
    ``chip_smoke.py::condition_attention`` does: the JAX init gives
    attention scores of standard deviation ~85, a nearly one-hot softmax
    that turns any two bf16 rounding orders into O(1) differences after a
    few layers (the smoke models' prefill logits, JAX jitted against JAX
    eager in bf16: jamba 0.073, flan-t5-xxl 0.056, whisper-base 0.051;
    conditioned 0.012 and 0.007 for the last two), and whose gradient is a
    difference of nearly equal terms. ``tests/test_torch_serve.py`` shares
    it."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_init_params(jax_model.model_specs(jcfg, 1),
                                                    jax.random.key(seed)))
    tree = jax.tree.map(
        lambda x: x if x.any() else (0.05 * rng.standard_normal(x.shape)).astype(x.dtype),
        tree)
    if condition:
        H, KV, D = jcfg.padded_heads, jcfg.num_kv_heads, jcfg.d_model
        blocks = list(tree["decoder"].values()) + ([tree["encoder"]] if "encoder" in tree else [])
        for a in (blk[k] for blk in blocks for k in ("attn", "cross") if k in blk):
            for name, f in (("wq", (H / D) ** 0.5), ("wk", (KV / D) ** 0.5),
                            ("wv", (KV / D) ** 0.5), ("wo", H ** -0.5)):
                a[name] = (a[name].astype(np.float32) * np.float32(f)).astype(a[name].dtype)
    return tree


def jax_batch(jcfg, seed=0):
    return make_batch(jcfg, B, S, seed)


def port_batch(jb, device="cpu"):
    """The JAX batch's values as torch tensors: int32 tokens/targets, bf16
    embeddings (bf16 -> float32 -> bf16 is exact)."""
    out = {}
    for k, v in jb.items():
        a = np.asarray(v)
        out[k] = (torch.from_numpy(a.copy()) if a.dtype == np.int32 else
                  torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16))
    return {k: v.to(device) for k, v in out.items()}


def _ctx(jcfg, mesh):
    return make_rules(jcfg, JaxShapeConfig("t", S, B, "train"), mesh)


def jax_loss_and_grads(jcfg, np_params, jb, mesh):
    rules = _ctx(jcfg, mesh)
    ctx = jax_model.MeshCtx(mesh, rules)
    with set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jax_model.loss_fn(jcfg, p, jb, ctx)))(jax.tree.map(jnp.asarray, np_params))
    return float(loss), jax.tree.map(np.asarray, grads)


def jax_steps(jcfg, np_params, batches, mesh):
    """(the initial state, [(state, metrics) after each step]): the
    reference's train steps over ``batches`` from ``np_params`` and its
    zero optimizer state, states as numpy trees ``{"params", "opt"}``."""
    rules = _ctx(jcfg, mesh)
    opt = jax_make_optimizer(jcfg.optimizer)
    pspecs = jax_model.model_specs(jcfg, 1)
    state = {"params": jax.tree.map(jnp.asarray, np_params),
             "opt": jax_init_params(opt.init_specs(pspecs), jax.random.key(1))}
    out, first = [], jax.tree.map(np.asarray, state)
    with set_mesh(mesh):
        step = jax.jit(jax_train_step(jcfg, mesh, rules, opt))
        for jb in batches:
            state, metrics = step(state, jb)
            out.append((jax.tree.map(np.asarray, state),
                        {k: float(v) for k, v in metrics.items()}))
    return first, out


def leaves(tree, prefix=""):
    """(path, leaf) in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def rel(got, want) -> float:
    got, want = as_np(got), as_np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
