"""The model: parameter specs, the training loss, prefill and decode
(PyTorch port of ``repro.models.model``).

Plain functions over a parameter dict, as in the JAX package. The tree has
the JAX layout, with each block's parameters stacked over ``num_groups`` on
a leading layer axis; the forward passes walk that axis in a Python loop
where the JAX package scans it. The cache is stacked the same way, one
entry a block of the pattern, and decode updates it in place.

The config's ``pattern`` gives each group's block kinds:

* global (ATTN) and sliding-window (LOCAL) self attention, cached as
  ``{"k": [L, B, Tc, KV, hd], "v": ...}``. A LOCAL block of window ``W``
  keeps ``min(T, W)`` slots, as the JAX model does; a cache of exactly
  ``W`` slots is a ring (position ``p`` in slot ``p mod W``);
* Mamba2 (MAMBA) blocks (:mod:`repro_torch.models.ssm`), cached as their
  float32 SSM state ``[L, B, H, N, P]`` and the tails of their three
  causal convolutions ``conv_x/conv_B/conv_C [L, B, W - 1, .]``.

An attention block carries an FFN sublayer, and a Mamba block does too when
``ffn_every_block`` (jamba). The FFN is a dense MLP, or on every
``moe_layer_period``-th block a mixture of experts
(:mod:`repro_torch.models.moe`) plus the shared expert of
``moe_shared_expert_ff``.

An encoder-decoder model (``num_encoder_layers > 0``: flan-t5, whisper)
runs its encoder over ``batch["enc_embeds"]`` [B, enc_S, D] (whisper's
audio frontend is that input itself): ``num_encoder_layers`` blocks of
bidirectional self attention and FFN, then ``enc_norm``. Each decoder
attention block then attends the encoder output through its ``cross``
weights after its self attention, and caches the cross K/V as ``cross_k``
and ``cross_v`` [L, B, enc_S, KV, hd]. An encoder-only model (roberta)
takes its logits from ``mlm_head``; its prefill is causal, as the JAX
model's ``prefill_fn`` is. A vision-stub model (internvl2) prepends
``batch["image_embeds"]`` [B, Ni, D] to the token embeddings, so the
prompt's positions are ``0 .. Ni + S - 1``.

Training (:func:`loss_fn`) runs the whole sequence through the stack at
once: causal for decoders, bidirectional for an encoder-only model, each
layer's body recomputed in the backward pass per ``cfg.remat_policy``
(:func:`_remat`), with the flash kernel's gradient kernel
(``ops.flash_attention`` under grad) as every attention's backward. The
logits' products of bf16 operands on a card run on the tensor cores
(:class:`TensorCoreLogits`), forward and backward.

**Sharded steps.** Given a :class:`MeshCtx` (a ``DeviceMesh`` and the
rules), :func:`loss_fn`, :func:`prefill_fn` and :func:`decode_fn` run on
each rank's local blocks, as the reference's ``shard_map``s run on theirs,
with the exchanges the layout implies (``parallel.collectives``):

* a weight stored split on its d_model dim (``embed``, ``expert_embed``:
  FSDP, the MoE ZeRO split) is all-gathered where its layer runs, inside the
  layer's recompute region (:meth:`MeshCtx.gather`);
* the batch is split over the rules' batch axes; the query heads, the MLP
  hidden dim, the vocab and the expert slots over ``model`` as the weights
  are, so each rank's kernels run on its own heads, and the products whose
  contraction dim is split (``wo``, ``w_down``, the MoE combine, a
  vocab-split lookup) are all-reduced;
* KV heads that the model axis does not divide are replicated (the GQA
  fallback of ``resolve_spec``); each rank attends the KV heads its query
  heads read;
* a vocab-split loss takes its log-sum-exp and gold logit by all-reduces
  over the vocab shards, a chunk of positions at a time, and never gathers
  the ``[B, S, V]`` logits;
* decode over a cache split by sequence (``kv_seq``), a global block's or
  a LOCAL block's ring, writes the new K/V on the rank whose slice holds
  their slot, runs the decode kernel over each rank's slice with its own
  valid length, and merges the partial outputs by their log-sum-exps
  (``ops.decode_attention_lse``); the prefill keeps each rank's slice of
  the slots;
* an SSD block runs on the rank's heads and inner channels, its gate
  norm's mean square and ``w_out`` all-reduced (``models.ssm``); its cache
  keeps the rank's heads and channels;
* the encoder runs on the rank's heads as the decoder does, its output
  replicated over ``model``; cross attention reads the encoder K/V of the
  rank's KV heads, which its cache keeps;
* experts split into FFN chunks where the expert-parallel domain outnumbers
  the expert groups (``moe.moe_layout``'s ``f_shards``); the chunks'
  partial outputs are summed with the groups'.

Every exchange over a group of one rank is skipped, so on a 1 x 1 mesh the
sharded step computes what the one-device step computes. Every arch of
the registry runs sharded.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property, partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ATTN, LOCAL, MAMBA, ModelConfig
from repro_torch.models.layers import mlp, mlp_specs, rmsnorm, rmsnorm_spec, softcap
from repro_torch.models.param import (ParamSpec, Rules, axis_sizes, entry_axes, mesh_coords,
                                      resolve_spec, tree_map_specs)
from repro_torch.obs import device as obs
from repro_torch.parallel import collectives as coll


# ---------------------------------------------------------------------------
# mesh context
# ---------------------------------------------------------------------------

# the logical dims a weight is stored split on and gathered where it is used
STORAGE_AXES = ("embed", "expert_embed")


@dataclasses.dataclass(frozen=True, eq=False)
class MeshCtx:
    """A sharded step's ``DeviceMesh`` and rules (the reference's
    ``MeshCtx``): the groups of ranks its collectives run over, and this
    rank's place in them."""

    mesh: Any
    rules: Rules

    def shard(self, x, *logical):
        """``x``, a rank's block laid out as ``logical`` says: the local
        tensors already are (the reference constrains a global array)."""
        return x

    @cached_property
    def sizes(self) -> Dict[str, int]:
        return axis_sizes(self.mesh)

    @cached_property
    def coords(self) -> Dict[str, int]:
        return mesh_coords(self.mesh)

    @cached_property
    def world(self) -> int:
        return math.prod(self.sizes.values())

    @property
    def n_model(self) -> int:
        return self.sizes["model"]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return entry_axes(self.rules.get("batch"))

    @property
    def expert_gather_axes(self) -> Tuple[str, ...]:
        return entry_axes(self.rules.get("expert_embed"))

    def memo(self, key, make):
        """``make()``, computed once a key: the layout's answers do not
        change, and the step asks them for every layer."""
        memo = self.__dict__.setdefault("_answers", {})
        if key not in memo:
            memo[key] = make()
        return memo[key]

    def memo_cfg(self, tag: str, cfg: ModelConfig, make):
        """:meth:`memo` of an answer about ``cfg``, keyed by the object (a
        config's hash walks all its fields), which the entry keeps alive."""
        return self.memo((tag, id(cfg)), lambda: (cfg, make()))[1]

    def axes_for(self, dim: int, logical: Optional[str]) -> Tuple[str, ...]:
        """The mesh axes a dim of size ``dim`` and logical name ``logical``
        is split over (``resolve_spec``)."""
        return self.memo(("axes", dim, logical), lambda: entry_axes(
            resolve_spec((dim,), (logical,), self.rules, self.sizes)[0]))

    def group(self, axes) -> Optional[coll.Group]:
        """The group of ranks that differ only along ``axes`` (mesh order,
        data outer), or None for a group of one rank."""
        key = ("group", tuple(axes) if isinstance(axes, list) else axes)
        return self.memo(key, lambda: self._make_group(
            tuple(a for a in self.sizes if a in entry_axes(axes))))

    def _make_group(self, axes) -> Optional[coll.Group]:
        size = math.prod(self.sizes[a] for a in axes)
        if size == 1:
            return None
        import torch.distributed as dist
        if len(axes) == 1:
            pg = self.mesh.get_group(axes[0])
        elif len(axes) == len(self.sizes) and size == dist.get_world_size():
            pg = dist.group.WORLD  # the mesh in rank order: data outer
        else:  # some of three axes (the multi-pod layout's batch axes, pod x data)
            pg = self.mesh[axes]._flatten().get_group()
        index = 0
        for a in axes:
            index = index * self.sizes[a] + self.coords[a]
        return coll.Group(axes, pg, size, index)

    @property
    def everyone(self) -> Optional[coll.Group]:
        return self.group(tuple(self.sizes))

    def gather(self, tree, specs, stacked: bool = False):
        """Working weights of a rank's blocks ``tree`` (their ParamSpecs
        ``specs``; ``stacked``: a layer of a stacked tree, the specs' first
        dim dropped): each dim stored split over ``STORAGE_AXES``
        all-gathered, the compute splits (heads, MLP, vocab, expert slots)
        kept. The leaves and dims to gather are found once a ``specs``
        object; the step asks for every layer (a tree no dim of which is
        split so comes back as it is)."""
        plan = self.memo(("gather", id(specs), stacked),
                         lambda: (specs, self._gather_plan(specs, stacked, ())))[1]
        for path, d, group in plan:
            tree = _set_in(tree, path, coll.all_gather(_get_in(tree, path), group, d))
        return tree

    def _gather_plan(self, specs, stacked: bool, path: tuple) -> list:
        """(path, dim, group) of each stored split of ``specs``' leaves."""
        if isinstance(specs, dict):
            return [e for k in specs for e in self._gather_plan(specs[k], stacked, path + (k,))]
        shape, logical = specs.shape[stacked:], specs.logical[stacked:]
        plan = []
        for d, (n, lg) in enumerate(zip(shape, logical)):
            group = self.group(self.axes_for(n, lg)) if lg in STORAGE_AXES else None
            if group is not None:
                plan.append((path, d, group))
        return plan

    def synced(self, tree, specs):
        """``tree`` (a rank's parameter blocks) with each leaf's gradient
        summed over the mesh axes its spec does not split: a replicated
        leaf is used by every rank on its own share of the work."""
        if isinstance(tree, dict):
            return {k: self.synced(tree[k], specs[k]) for k in tree}
        held = {a for e in resolve_spec(specs.shape, specs.logical, self.rules, self.sizes)
                for a in entry_axes(e)}
        return coll.grad_all_reduce(tree, self.group([a for a in self.sizes if a not in held]))


def _get_in(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _set_in(tree, path: tuple, value):
    """``tree`` with the leaf at ``path`` replaced (the dicts on the path
    copied, ``tree`` itself unchanged)."""
    if not path:
        return value
    return {**tree, path[0]: _set_in(tree[path[0]], path[1:], value)}


def mesh_specs(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    """The parameter specs a sharded step lays out: :func:`model_specs` with
    the expert slots of the expert-parallel domain (the model axis, or every
    axis for token-routed decode), as the reference sizes them."""
    token = ctx.rules.get("moe_mode") == "token"
    return ctx.memo_cfg("specs", cfg, lambda: model_specs(cfg, ctx.n_model,
                                                         ctx.world if token else 0))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return kind != MAMBA or cfg.ffn_every_block


def _is_moe_block(cfg: ModelConfig, idx: int, kind: str) -> bool:
    if not cfg.moe_num_experts or not _has_ffn(cfg, kind):
        return False
    if cfg.moe_layer_period == 1:
        return True
    return idx % cfg.moe_layer_period == cfg.moe_layer_period - 1


def block_specs(cfg: ModelConfig, idx: int, kind: str, moe_shards: int = 1, *,
                cross: bool = False) -> dict:
    """Block ``idx`` of the pattern, of kind ``kind``; with ``cross``, an
    attention block also carries the cross-attention weights. An MoE
    block's expert weights have ``moe_layout(cfg, moe_shards)``'s slots."""
    D = cfg.d_model
    p: Dict[str, Any] = {}
    if kind == MAMBA:
        p["ln"] = rmsnorm_spec(D)
        p["ssm"] = ssm_mod.ssm_specs(cfg)
    else:
        p["ln_attn"] = rmsnorm_spec(D)
        p["attn"] = attn_mod.attn_specs(cfg)
        if cfg.use_post_norm:
            p["post_ln_attn"] = rmsnorm_spec(D)
        if cross:
            p["ln_cross"] = rmsnorm_spec(D)
            p["cross"] = attn_mod.attn_specs(cfg, cross=True)
    if _has_ffn(cfg, kind):
        p["ln_mlp"] = rmsnorm_spec(D)
        if _is_moe_block(cfg, idx, kind):
            p["moe"] = moe_mod.moe_specs(cfg, moe_shards)
            if cfg.moe_shared_expert_ff:
                p["shared_mlp"] = mlp_specs(cfg, cfg.moe_shared_expert_ff)
        else:
            p["mlp"] = mlp_specs(cfg)
        if cfg.use_post_norm:
            p["post_ln_mlp"] = rmsnorm_spec(D)
    return p


def _stack_specs(tree, n: int):
    return tree_map_specs(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.logical, s.init,
                            s.scale, s.dtype), tree)


def model_specs(cfg: ModelConfig, n_model: int = 1, moe_shards: int = 0) -> dict:
    """Full abstract parameter tree. ``moe_shards``: size of the expert-
    parallel domain (defaults to the model axis, ``n_model``; the
    token-routed serve path uses data x model). The defaults are one
    device's tree, whose expert weights have ``E`` slots: the tree the port
    serves and trains; a mesh's sizes give the tree the dry run lays out."""
    moe_shards = moe_shards or n_model
    D, V = cfg.d_model, cfg.vocab_size
    wd = cfg.weight_dtype
    specs: Dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), scale=1.0, dtype=wd),
        "final_norm": rmsnorm_spec(D),
    }
    if not cfg.tie_embeddings and not cfg.is_encoder_only:
        specs["unembed"] = ParamSpec((D, V), ("embed", "vocab"), dtype=wd)
    group = {f"b{i}": block_specs(cfg, i, kind, moe_shards, cross=cfg.is_encoder_decoder)
             for i, kind in enumerate(cfg.pattern)}
    specs["decoder"] = _stack_specs(group, cfg.num_groups)
    if cfg.is_encoder_decoder:
        specs["encoder"] = _stack_specs(block_specs(cfg, 0, ATTN, moe_shards),
                                        cfg.num_encoder_layers)
        specs["enc_norm"] = rmsnorm_spec(D)
    if cfg.is_encoder_only:
        specs["mlm_head"] = ParamSpec((D, V), ("embed", "vocab"), dtype=wd)
    return specs


# leaves the model reads in float32 or in their spec dtype, never in the
# activation dtype: the rmsnorm scales (the cross-attention's ln_cross, the
# encoder's enc_norm and the SSM's gate_norm too), the MoE
# router (float32 logits) and the SSM's A_log, dt_bias and D_skip (read
# .float()). Every other weight is cast to the activation dtype where it
# is used.
SPEC_DTYPE_KEYS = frozenset({"ln_attn", "post_ln_attn", "ln_cross", "ln_mlp",
                             "post_ln_mlp", "final_norm", "enc_norm", "q_norm",
                             "k_norm", "ln", "gate_norm", "router", "A_log",
                             "dt_bias", "D_skip"})


def cast_weights(cfg: ModelConfig, specs, name: str = "") -> Any:
    """The parameter specs ``specs`` with every weight except
    :data:`SPEC_DTYPE_KEYS` in the activation dtype. The model casts each
    such weight to that dtype where it uses it, as the JAX model does, so
    weights stored cast compute the same numbers and save a cast of every
    weight on every step; ``init_params`` of these specs casts each leaf as
    it draws it (the same values as a cast after the draw, without a
    float32 copy of the whole model). The others keep their spec dtype, so
    that routing and the SSM's decay are JAX's in bf16 too."""
    if isinstance(specs, dict):
        return {k: cast_weights(cfg, v, k) for k, v in specs.items()}
    if name in SPEC_DTYPE_KEYS:
        return specs
    return dataclasses.replace(specs, dtype=cfg.activation_dtype)


def _load_tree(specs, tree, device, root: str) -> dict:
    """``tree`` (nested dicts of numpy arrays) checked against the
    ParamSpec tree ``specs`` (keys and shapes) and carried to torch tensors
    of each spec's dtype on ``device`` (through float32, exact for the
    values a parameter, a moment or a step count holds)."""
    def load(spec, x, path):
        if isinstance(spec, ParamSpec):
            x = np.asarray(x)
            if tuple(x.shape) != spec.shape:
                raise ValueError(f"{path}: shape {x.shape}, want {spec.shape}")
            return torch.tensor(np.asarray(x, dtype=np.float32), device=device,
                                dtype=spec.dtype)
        if not isinstance(x, dict) or set(x) != set(spec):
            got = sorted(x) if isinstance(x, dict) else type(x).__name__
            raise ValueError(f"{path or root}: keys {got}, want {sorted(spec)}")
        return {k: load(spec[k], x[k], f"{path}/{k}") for k in spec}

    return load(specs, tree, "")


def load_jax_params(cfg: ModelConfig, tree, device="cpu") -> dict:
    """The port's parameters from the JAX package's parameter pytree, given
    as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``;
    layer axis stacked over ``num_groups``): the same tree and values, as
    torch tensors of each spec's dtype on ``device``."""
    return _load_tree(model_specs(cfg), tree, device, "params")


def load_jax_opt_state(cfg: ModelConfig, opt, tree, device="cpu") -> dict:
    """The port's optimizer state from the JAX package's (``opt.init_specs``
    of the same config, as nested dicts of numpy arrays): the moments of
    AdamW (``mu``, ``nu``) or Adafactor (``vr``, ``vc``) and the step
    ``count``, as tensors of each spec's dtype on ``device``. ``opt`` is the
    port's :class:`~repro_torch.optim.Optimizer`."""
    return _load_tree(opt.init_specs(model_specs(cfg)), tree, device, "opt")


def _layer(tree, l: int):
    """Layer ``l`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _mlp(cfg, p, y, ctx, d_ff):
    """The MLP; over a mesh, its hidden dim's split summed."""
    out = mlp(cfg, p, y)
    return out if ctx is None else coll.all_reduce(out, ctx.group(ctx.axes_for(d_ff, "mlp")))


def _ffn_apply(cfg, bp, h, ctx=None, layer=None):
    """The block's FFN after its norm, residual added: an MoE block's a
    ``model.moe`` span labelled ``layer``."""
    y = rmsnorm(h, bp["ln_mlp"], cfg.norm_eps)
    if "moe" in bp:
        with obs.span("model.moe", layer=layer):
            out = moe_mod.moe_apply(cfg, bp["moe"], y, ctx)
        if "shared_mlp" in bp:
            out = out + _mlp(cfg, bp["shared_mlp"], y, ctx, cfg.moe_shared_expert_ff)
    else:
        out = _mlp(cfg, bp["mlp"], y, ctx, cfg.d_ff)
    if cfg.use_post_norm:
        out = rmsnorm(out, bp["post_ln_mlp"], cfg.norm_eps)
    return h + out


def _block_forward(cfg, bp, kind, h, *, positions, causal, enc_out, ctx=None, layer=None):
    """One block of the pattern at full sequence length: a Mamba block, or
    self attention (LOCAL: within the window) and, in an encoder-decoder
    model's decoder, cross attention over ``enc_out``; then the FFN."""
    if kind == MAMBA:
        h = h + ssm_mod.ssm_forward(cfg, bp["ssm"], rmsnorm(h, bp["ln"], cfg.norm_eps),
                                    ctx=ctx)
    else:
        window = cfg.window_size if kind == LOCAL else 0
        a = attn_mod.self_attention(cfg, bp["attn"], rmsnorm(h, bp["ln_attn"], cfg.norm_eps),
                                    positions=positions, causal=causal, window=window, ctx=ctx)
        if cfg.use_post_norm:
            a = rmsnorm(a, bp["post_ln_attn"], cfg.norm_eps)
        h = h + a
        if enc_out is not None:
            enc_kv = attn_mod.project_cross_kv(cfg, bp["cross"], enc_out)
            h = h + attn_mod.cross_attention(
                cfg, bp["cross"], rmsnorm(h, bp["ln_cross"], cfg.norm_eps), enc_kv, ctx)
    if _has_ffn(cfg, kind):
        h = _ffn_apply(cfg, bp, h, ctx, layer)
    return h


def _group_forward(cfg, gp, h, positions, enc_out, index, *, causal, ctx=None, specs=None):
    """Pattern group ``index`` (``gp`` its blocks ``b0 ..``) at full length;
    over a mesh, ``gp`` is the rank's blocks, gathered here (``specs``: the
    stacked group's ParamSpecs). Each block is a ``model.block`` span, so
    a recompute in the backward pass shows as one too."""
    if ctx is not None:
        gp = ctx.gather(gp, specs, stacked=True)
    for i, kind in enumerate(cfg.pattern):
        layer = index * len(cfg.pattern) + i
        with obs.span("model.block", layer=layer):
            h = _block_forward(cfg, gp[f"b{i}"], kind, h, positions=positions, causal=causal,
                               enc_out=enc_out, ctx=ctx, layer=layer)
    return h


# the products whose outputs the "dots" policy keeps: matrix products with
# no batch dimension (every weight product of the model), as JAX's
# dots_with_no_batch_dims_saveable keeps them
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """``fn`` recomputed in the backward pass per ``cfg.remat_policy``:
    ``"full"`` keeps only its inputs (``checkpoint``, non-reentrant),
    ``"dots"`` also keeps the outputs of its weight products (a selective
    checkpoint), ``"none"`` keeps everything autograd keeps. Without grad
    (serving) ``fn`` runs as it is."""
    if cfg.remat_policy == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if cfg.remat_policy == "dots":
            return torch_checkpoint.checkpoint(
                fn, *args, use_reentrant=False,
                context_fn=partial(torch_checkpoint.create_selective_checkpoint_contexts,
                                   _save_dots))
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False)

    return run


def _run_encoder(cfg, params, enc_embeds, ctx=None, specs=None):
    """The encoder over [B, enc_S, D] input embeddings: each layer
    bidirectional self attention (the flash kernel at ``causal=False``)
    and its FFN (recomputed in the backward pass per ``cfg.remat_policy``),
    then ``enc_norm``. Returns [B, enc_S, D]. Over a mesh each layer's
    stored splits are gathered inside its recompute region (``specs``: the
    stacked encoder's ParamSpecs) and its blocks run on the rank's heads;
    the output is replicated over ``model``."""
    h = enc_embeds.to(cfg.activation_dtype)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def layer(h, lp):
        if ctx is not None:
            lp = ctx.gather(lp, specs, stacked=True)
        return _block_forward(cfg, lp, ATTN, h, positions=positions, causal=False,
                              enc_out=None, ctx=ctx)

    layer = _remat(cfg, layer)
    for l in range(cfg.num_encoder_layers):
        h = layer(h, _layer(params["encoder"], l))
    return rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _lookup(cfg, embed, tokens, ctx=None):
    """The embeddings of ``tokens``; over a mesh whose model axis splits
    the vocab, each rank looks up the ids in its rows and the ranks' rows
    are summed (one of them nonzero)."""
    group = None if ctx is None else ctx.group(ctx.axes_for(cfg.vocab_size, "vocab"))
    if group is None:
        return embed[tokens.long()].to(cfg.activation_dtype)
    n = embed.shape[0]
    ids = tokens.long() - group.index * n
    mine = (ids >= 0) & (ids < n)
    h = embed[ids.clamp(0, n - 1)] * mine[..., None].to(embed.dtype)
    return coll.all_reduce(h, group).to(cfg.activation_dtype)


def _embed_inputs(cfg, params, batch, ctx=None, specs=None):
    """(h, enc_out): the token embeddings of ``batch["tokens"]`` [B, S], with
    a vision stub's ``batch["image_embeds"]`` [B, Ni, D] before them ([B,
    Ni + S, D] activations), and an encoder-decoder model's encoder output
    of ``batch["enc_embeds"]`` (else None). Over a mesh every input is the
    rank's batch shard (``specs``: the model's ParamSpecs)."""
    act = cfg.activation_dtype
    enc_out = (_run_encoder(cfg, params, batch["enc_embeds"], ctx,
                            None if ctx is None else specs["encoder"])
               if cfg.is_encoder_decoder else None)
    h = _lookup(cfg, params["embed"], batch["tokens"], ctx)
    if cfg.frontend == "vision_stub":
        h = torch.cat([batch["image_embeds"].to(act), h], dim=1)
    return h, enc_out


# the counter of the logits' forward matrix products (the loss head's, a
# checkpointed chunk's recompute included, and the serving steps'), one a
# product, labelled ``path``: "tensor_core" or "float32"
LOGITS_PRODUCTS = "model.logits_products"
# the tensor-core product pads the vocab dim of its weight and output to a
# multiple of this many columns: a row stride that is not a multiple of 16
# bytes takes cuBLAS off its tensor-core kernels (roberta-large's 50265
# columns: 4.2 ms against 0.93 ms a loss chunk on an H100)
VOCAB_PAD = 8


def tensor_core_operands(h, w) -> bool:
    """Whether ``h @ w`` runs on the tensor cores: bf16 operands on a card.
    A product of two bf16 values is exact in float32, so a bf16 GEMM with
    float32 accumulation forms the reference's products. float32 operands
    keep the float32 product (their values are not bf16), and so do CPU
    and ``meta`` tensors (the CPU has no bf16 GEMM with a float32 output)
    and fp16 operands (fp16's five exponent bits cannot hold the pieces of
    a float32 cotangent)."""
    return h.is_cuda and h.dtype == torch.bfloat16 and w.dtype == torch.bfloat16


def _mm_f32(a, b):
    """``a @ b`` of bf16 matrices accumulated in float32, float32 out: one
    tensor-core GEMM on a card; on the CPU the float32 product of their
    values (the same products, which the tests run in its place)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class TensorCoreLogits(torch.autograd.Function):
    """float32 ``h @ w`` of bf16 ``h`` [M, D] and ``w`` [D, V] on the
    tensor cores, forward and backward. The forward is one GEMM, ``w`` and
    the output padded to :data:`VOCAB_PAD` columns (the result a view of
    the first V). The backward splits the float32 cotangent exactly into
    three bf16 pieces (``ops.bf16_split3``) and forms ``dh`` as the sum of
    the pieces' three products with ``w.T`` and ``dw`` as one product of
    ``h.T`` stacked thrice with the pieces stacked along M; each is
    accumulated in float32 and returned in its operand's dtype, as
    autograd's casts around the float32 product return it.

    Every product of two bf16 values is exact, but an H100's tensor cores
    add them in float32 with truncation: at roberta-large's loss chunk the
    logits lie 1.0e-6 of their norm from float64 and ``dh`` 5.9e-5 (the
    float32 product: 2.5e-7 and 8.8e-7), each entry within one float32 unit
    of its terms' magnitudes per 16 products (PERF.md §6), far inside the
    bf16 rounding that ``dh`` and ``dw`` then take."""

    @staticmethod
    def forward(ctx, h, w):
        V = w.shape[1]
        Vp = -(-V // VOCAB_PAD) * VOCAB_PAD
        wp = w if Vp == V else torch.nn.functional.pad(w, (0, Vp - V))
        ctx.save_for_backward(h, wp)
        return _mm_f32(h, wp)[:, :V]

    @staticmethod
    def backward(ctx, g):
        h, wp = ctx.saved_tensors
        dh, dw = cotangent_products(g, h, wp, *ctx.needs_input_grad)
        return (None if dh is None else dh.to(h.dtype),
                None if dw is None else dw.to(wp.dtype))


def cotangent_products(g, h, wp, need_h=True, need_w=True):
    """float32 (``g @ w.T``, ``h.T @ g``) of a float32 cotangent ``g`` [M, V]
    and bf16 ``h`` [M, D] and ``w`` [D, V], ``wp`` being ``w`` padded to
    Vp >= V columns, each None where not needed (:class:`TensorCoreLogits`'s
    backward): ``g`` split exactly into three bf16 pieces of Vp columns,
    each product a sum over the pieces accumulated in float32."""
    V, Vp = g.shape[1], wp.shape[1]
    pieces = ops.bf16_split3(g, Vp)
    dh = dw = None
    if need_h:
        dh = _mm_f32(pieces[0], wp.T)
        dh += _mm_f32(pieces[1], wp.T)
        dh += _mm_f32(pieces[2], wp.T)
    if need_w:
        dw = _mm_f32(h.repeat(3, 1).T, pieces.view(-1, Vp))[:, :V]
    return dh, dw


def logits_product(h, w):
    """float32 ``h @ w`` of activations ``h`` [..., D] and an unembedding
    ``w`` [D, V]: :class:`TensorCoreLogits` where
    :func:`tensor_core_operands`, else the float32 product of their values.
    Each call (a forward product; its backward's are not counted) counts
    one in :data:`LOGITS_PRODUCTS` where a span would record."""
    tc = tensor_core_operands(h, w)
    rec = obs.active()
    if rec is not None:
        rec.counter(LOGITS_PRODUCTS, path="tensor_core" if tc else "float32")
    if tc:
        return TensorCoreLogits.apply(h.reshape(-1, h.shape[-1]), w).unflatten(
            0, h.shape[:-1])
    return torch.matmul(h.float(), w.float())


def _logits(cfg, params, h):
    """float32 logits of [B, S, D] activations (the JAX einsum's float32
    accumulation of activation-dtype operands; :func:`logits_product`)."""
    act = cfg.activation_dtype
    if cfg.is_encoder_only:
        w = params["mlm_head"].to(act)
    elif cfg.tie_embeddings:
        w = params["embed"].to(act).T
    else:
        w = params["unembed"].to(act)
    logits = logits_product(h, w)
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def _decoder_stack(cfg, params, h, *, positions, causal, enc_out, aux_losses, ctx=None,
                   specs=None):
    """The decoder groups over [B, S, D] activations, then ``final_norm``.
    An MoE model appends its load-balance loss to ``aux_losses``, taken, as
    the reference takes it, from the first group's first MoE block on the
    stack's input: a representative sample of the router distribution.
    Over a mesh ``params["decoder"]`` holds the rank's blocks (``specs``
    their ParamSpecs), gathered a layer at a time."""
    if aux_losses is not None and cfg.moe_num_experts:
        first = _layer(params["decoder"], 0)
        for i in range(len(cfg.pattern)):
            bp = first[f"b{i}"]
            if "moe" in bp:
                y = rmsnorm(h, bp["ln_mlp"], cfg.norm_eps)
                aux_losses.append(moe_mod.moe_aux_loss(cfg, bp["moe"], y, ctx))
                break
    group = _remat(cfg, partial(_group_forward, cfg, causal=causal, ctx=ctx,
                                specs=None if ctx is None else specs["decoder"]))
    for l in range(cfg.num_groups):
        h = group(_layer(params["decoder"], l), h, positions, enc_out, l)
    return rmsnorm(h, params["final_norm"], cfg.norm_eps)


# bytes of float32 logits the loss materialises at once (one chunk of
# positions); a whole batch's would not fit beside the model at the
# training shapes (roberta-large, B 32 x S 2048: 13.2 GB)
LOSS_CHUNK_BYTES = 1 << 30


def _token_losses(cfg, params, h, targets, group=None):
    """logsumexp - gold of each position: h [B, n, D] (the positions that
    predict), targets [B, n]; float32 [B, n]. With ``group`` the vocab is
    split over its ranks: the log-sum-exp and the gold logit are summed
    over them."""
    logits = _logits(cfg, params, h)
    if group is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return logz - gold
    m = coll.all_reduce_max(logits.amax(dim=-1), group)
    logz = torch.log(coll.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), group)) + m
    n = logits.shape[-1]
    ids = targets.long() - group.index * n
    gold = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    gold = coll.all_reduce(gold * ((ids >= 0) & (ids < n)), group)
    return logz - gold


def _gathered_top(cfg, params, ctx, specs):
    """The leaves outside the layer stack (embeddings, heads, final norm)
    as working weights."""
    return {k: v if k in ("decoder", "encoder") else ctx.gather(v, specs[k])
            for k, v in params.items()}


def loss_fn(cfg: ModelConfig, params, batch, ctx: Optional[MeshCtx] = None) -> torch.Tensor:
    """Next-token (or, for an encoder-only model, MLM) cross-entropy, a
    float32 scalar. ``batch``: ``tokens`` [B, S] and the model's other
    inputs (:func:`_embed_inputs`); an encoder-only model's ``targets``
    [B, S]. A causal model predicts token t + 1 at text position t (after
    a vision stub's image positions); the log-sum-exp is taken in float32.
    An MoE model adds ``moe_aux_loss_weight`` times its load-balance loss.
    The logits are made a chunk of positions at a time
    (:data:`LOSS_CHUNK_BYTES`), each chunk recomputed in the backward pass,
    so the float32 logits of the whole batch never exist at once; each
    position's loss is the reference's.

    With ``ctx``, ``params`` and ``batch`` are the rank's blocks and the
    result is the mean over the rank's batch shard (the mean over the
    shards is the reference's loss; ``launch.steps.loss_and_grads``)."""
    specs = None
    if ctx is not None:
        specs = mesh_specs(cfg, ctx)
        params = _gathered_top(cfg, params, ctx, specs)
    h, enc_out = _embed_inputs(cfg, params, batch, ctx, specs)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    aux: Optional[list] = [] if cfg.moe_num_experts else None
    h = _decoder_stack(cfg, params, h, positions=positions,
                       causal=not cfg.is_encoder_only, enc_out=enc_out, aux_losses=aux,
                       ctx=ctx, specs=specs)
    tokens = batch["tokens"]
    n_txt = tokens.shape[1]
    if cfg.is_encoder_only:
        targets = batch["targets"]
    else:  # the text positions that predict a next token
        targets, h = tokens[:, 1:], h[:, -n_txt:, :][:, :-1, :]
    B, n = targets.shape
    vocab = None if ctx is None else ctx.group(ctx.axes_for(cfg.vocab_size, "vocab"))
    chunk = max(1, LOSS_CHUNK_BYTES // (4 * B * cfg.vocab_size // (vocab.size if vocab else 1)))
    run = partial(_token_losses, cfg, params, group=vocab)
    if torch.is_grad_enabled() and n > chunk:
        run = partial(torch_checkpoint.checkpoint, run, use_reentrant=False)
    with obs.span("model.loss_head"):
        losses = torch.cat([run(h[:, i:i + chunk], targets[:, i:i + chunk])
                            for i in range(0, n, chunk)], dim=1)
        ce = torch.mean(losses)
    if aux:
        ce = ce + cfg.moe_aux_loss_weight * sum(aux)
    return ce


# KV caches are padded to a multiple of CACHE_PAD, as in the JAX package
# (there so the sequence dim divides the mesh axes; kept so the caches, and
# the decode kernel's inputs, have the reference's shapes).
CACHE_PAD = 512


def cache_len(T: int) -> int:
    return -(-T // CACHE_PAD) * CACHE_PAD


def _cache_entry(cfg: ModelConfig, kind: str, B: int, Tc: int, enc_S: int) -> dict:
    """Abstract cache entry of one block (no layer axis): ``Tc`` K/V slots
    for attention, and an encoder-decoder model's cross K/V of its
    ``enc_S`` encoder positions; the float32 SSM state and the conv tails
    for MAMBA."""
    act = cfg.activation_dtype
    if kind == MAMBA:
        d_in, H, G, N = ssm_mod.ssm_dims(cfg)
        W = cfg.ssm_conv_width
        return {
            "state": ParamSpec((B, H, N, cfg.ssm_headdim),
                               ("batch", "ssm_heads", None, None), "zeros",
                               dtype=torch.float32),
            "conv_x": ParamSpec((B, W - 1, d_in), ("batch", None, "ssm_inner"),
                                "zeros", dtype=act),
            "conv_B": ParamSpec((B, W - 1, G * N), ("batch", None, None), "zeros",
                                dtype=act),
            "conv_C": ParamSpec((B, W - 1, G * N), ("batch", None, None), "zeros",
                                dtype=act),
        }
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    e = {name: ParamSpec((B, Tc, KV, hd), ("batch", "kv_seq", None, None), "zeros",
                         dtype=act) for name in ("k", "v")}
    if cfg.is_encoder_decoder:
        for name in ("cross_k", "cross_v"):
            e[name] = ParamSpec((B, enc_S, KV, hd), ("batch", None, "kv_heads", None),
                                "zeros", dtype=act)
    return e


def cache_specs(cfg: ModelConfig, B: int, T: int, enc_S: int = 0) -> dict:
    """Abstract cache for B sequences of up to T tokens: ``min(T, W)`` K/V
    slots for a LOCAL block of window W, ``cache_len(T)`` for a global one
    (and the cross K/V of ``enc_S`` encoder positions for an
    encoder-decoder model), the SSM state and conv tails for a MAMBA
    block."""

    def slots(kind):
        return (min(T, cfg.window_size) if kind == LOCAL and cfg.window_size
                else cache_len(T))

    return _stack_specs({f"b{i}": _cache_entry(cfg, kind, B, slots(kind), enc_S)
                         for i, kind in enumerate(cfg.pattern)}, cfg.num_groups)


def _local_entry(cfg: ModelConfig, kind: str, B: int, Tc: int, enc_S: int, ctx) -> dict:
    """:func:`_cache_entry`'s leaves as (shape, dtype) of a rank's blocks:
    ``B`` is already the rank's batch; every other dim is cut as the rules
    cut it (the slots on ``kv_seq``, the cross K/V on ``kv_heads``, the SSM
    state and ``conv_x`` on their heads and channels)."""
    out = {}
    for name, spec in _cache_entry(cfg, kind, B, Tc, enc_S).items():
        shape = spec.shape
        if ctx is not None:
            shape = shape[:1] + tuple(
                n // math.prod(ctx.sizes[a] for a in ctx.axes_for(n, lg))
                for n, lg in zip(shape[1:], spec.logical[1:]))
        out[name] = (shape, spec.dtype)
    return out


def _ring_slots(S: int, W: int, device) -> torch.Tensor:
    """The prompt positions a W-slot ring holds after S >= W tokens, in slot
    order: slot i holds position ``S - W + ((i - (S - W)) mod W)``, the one
    congruent to i mod W among the last W (the JAX prefill's placement)."""
    return S - W + torch.remainder(torch.arange(W, device=device) - (S - W), W)


def prefill_fn(cfg: ModelConfig, params, batch, max_len: int,
               ctx: Optional[MeshCtx] = None):
    """Process the prompt ``batch["tokens"]`` [B, S] (with the model's other
    inputs, :func:`_embed_inputs`); return (last-position float32 logits
    [B, 1, V], cache). S counts a vision stub's image positions. A global
    block's cache has ``max_len`` slots. A LOCAL block of window W attends
    within its window; when ``W <= S`` its cache is a ring of W slots
    holding the last W positions (:func:`_ring_slots`), else it has
    ``min(max_len, W)`` slots. A MAMBA block caches its final SSM state and
    conv tails. A decoder block of an encoder-decoder model also attends
    the encoder output and caches its cross K/V.

    With ``ctx``, ``params`` and ``batch`` are the rank's blocks; the logits
    are the rank's block of the vocab, and the cache is laid out by the
    rules: by ``kv_seq`` a rank keeps the K/V of its slice of a block's
    slots (of the ``max_len`` positions, of a LOCAL block's ring, or of its
    short cache), by ``kv_heads`` its cross K/V heads, by ``ssm_heads`` and
    ``ssm_inner`` its SSM state and ``conv_x`` tail."""
    specs = None
    if ctx is not None:
        specs = mesh_specs(cfg, ctx)
        params = _gathered_top(cfg, params, ctx, specs)
    h, enc_out = _embed_inputs(cfg, params, batch, ctx, specs)
    B, S = h.shape[0], h.shape[1]
    enc_S = 0 if enc_out is None else enc_out.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    blocks, cache = [], {}  # (window, the prompt positions of the rank's slots) a block
    for i, kind in enumerate(cfg.pattern):
        W = cfg.window_size if kind == LOCAL else 0
        Tc = min(max_len, W) if W else max_len  # the block's slots; W when W <= S
        seq = None if ctx is None else ctx.group(ctx.axes_for(Tc, "kv_seq"))
        T = Tc // (seq.size if seq else 1)  # its slots on this rank
        t0 = (seq.index if seq else 0) * T  # the first of them
        ring = _ring_slots(S, W, h.device)[t0:t0 + T] if W and W <= S else None
        blocks.append((W, ring if ring is not None else slice(t0, t0 + T)))
        cache[f"b{i}"] = {
            name: torch.zeros((cfg.num_groups,) + shape, dtype=dtype, device=h.device)
            for name, (shape, dtype) in _local_entry(cfg, kind, B, Tc, enc_S, ctx).items()}
    for l in range(cfg.num_groups):
        gp = _layer(params["decoder"], l)
        if ctx is not None:
            gp = ctx.gather(gp, specs["decoder"], stacked=True)
        for i, (kind, (W, ring)) in enumerate(zip(cfg.pattern, blocks)):
            layer = l * len(cfg.pattern) + i
            with obs.span("model.block", layer=layer):
                bp, bc = gp[f"b{i}"], cache[f"b{i}"]
                if kind == MAMBA:
                    y, (state, tails) = ssm_mod.ssm_forward(
                        cfg, bp["ssm"], rmsnorm(h, bp["ln"], cfg.norm_eps),
                        return_state=True, ctx=ctx)
                    h = h + y
                    bc["state"][l] = state
                    for name in ("x", "B", "C"):
                        bc[f"conv_{name}"][l] = tails[name]
                else:
                    a, (k, v) = attn_mod.self_attention(
                        cfg, bp["attn"], rmsnorm(h, bp["ln_attn"], cfg.norm_eps),
                        positions=positions, causal=True, window=W, return_kv=True, ctx=ctx)
                    if cfg.use_post_norm:
                        a = rmsnorm(a, bp["post_ln_attn"], cfg.norm_eps)
                    h = h + a
                    k, v = k[:, ring], v[:, ring]  # the prompt positions of the rank's slots
                    bc["k"][l, :, :k.shape[1]] = k
                    bc["v"][l, :, :v.shape[1]] = v
                    if enc_out is not None:
                        enc_kv = attn_mod.project_cross_kv(cfg, bp["cross"], enc_out)
                        h = h + attn_mod.cross_attention(
                            cfg, bp["cross"], rmsnorm(h, bp["ln_cross"], cfg.norm_eps), enc_kv,
                            ctx)
                        bc["cross_k"][l], bc["cross_v"][l] = enc_kv
                if _has_ffn(cfg, kind):
                    h = _ffn_apply(cfg, bp, h, ctx, layer)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, h[:, -1:, :]), cache


def decode_fn(cfg: ModelConfig, params, token, pos: int, cache, ctx: Optional[MeshCtx] = None,
              slots: Optional[Dict[str, int]] = None):
    """One decode step. token: [B, 1] int; ``pos`` a host int (the new
    token's position); the cache is updated in place and returned. A LOCAL
    block whose cache has exactly ``window_size`` slots decodes against it
    as a ring (:func:`~repro_torch.models.attention.decode_ring_attention`);
    every other attention block against slots ``0 .. pos``, then, in an
    encoder-decoder model, against the cached cross K/V of every encoder
    position; a MAMBA block takes one step of its recurrence
    (:func:`~repro_torch.models.ssm.ssm_decode`) and writes its new state
    and conv tails into the cache. Returns (float32 logits [B, 1, V],
    cache).

    With ``ctx``, ``params``, ``token`` and ``cache`` are the rank's blocks
    (the cache laid out by the rules, :func:`prefill_fn`) and the logits
    are the rank's block of the vocab; every self attention goes through
    ``ops.decode_attention_lse``. ``slots`` gives each attention block's
    cache slots over the mesh, by block name (``launch.steps`` reads them
    from the DTensor cache)."""
    specs = None
    if ctx is not None:
        if slots is None:
            raise ValueError("decode_fn over a mesh takes each attention cache's slots")
        specs = mesh_specs(cfg, ctx)
        params = _gathered_top(cfg, params, ctx, specs)
    h = _lookup(cfg, params["embed"], token, ctx)
    for l in range(cfg.num_groups):
        gp = _layer(params["decoder"], l)
        if ctx is not None:
            gp = ctx.gather(gp, specs["decoder"], stacked=True)
        for i, kind in enumerate(cfg.pattern):
            bp, bc = gp[f"b{i}"], cache[f"b{i}"]
            if kind == MAMBA:
                y, (state, tails) = ssm_mod.ssm_decode(
                    cfg, bp["ssm"], rmsnorm(h, bp["ln"], cfg.norm_eps), bc["state"][l],
                    {name: bc[f"conv_{name}"][l] for name in ("x", "B", "C")}, ctx)
                h = h + y
                bc["state"][l] = state
                for name in ("x", "B", "C"):
                    bc[f"conv_{name}"][l] = tails[name]
            else:
                x_norm = rmsnorm(h, bp["ln_attn"], cfg.norm_eps)
                W = cfg.window_size if kind == LOCAL else 0
                n = None if ctx is None else slots[f"b{i}"]
                if W and (n or bc["k"].shape[2]) == W:
                    y, _, _ = attn_mod.decode_ring_attention(
                        cfg, bp["attn"], x_norm, bc["k"][l], bc["v"][l], pos, W, ctx=ctx,
                        n_slots=n)
                else:
                    y, _, _ = attn_mod.decode_self_attention(
                        cfg, bp["attn"], x_norm, bc["k"][l], bc["v"][l], pos, window=W,
                        ctx=ctx, n_slots=n)
                if cfg.use_post_norm:
                    y = rmsnorm(y, bp["post_ln_attn"], cfg.norm_eps)
                h = h + y
                if cfg.is_encoder_decoder:
                    h = h + attn_mod.cross_attention(
                        cfg, bp["cross"], rmsnorm(h, bp["ln_cross"], cfg.norm_eps),
                        (bc["cross_k"][l], bc["cross_v"][l]), ctx)
            if _has_ffn(cfg, kind):
                h = _ffn_apply(cfg, bp, h, ctx, l * len(cfg.pattern) + i)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, h), cache
