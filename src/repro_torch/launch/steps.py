"""Train, prefill and decode steps and the abstract state they read
(PyTorch port of ``repro.launch.steps``).

Each ``build_*`` function takes ``(cfg, mesh, rules, ...)`` as the
reference's does and returns a plain callable. With no mesh it runs on
the tensors' device, one card. Given a ``torch.distributed`` ``DeviceMesh``
(``launch.mesh.make_device_mesh``) and rules (``launch.inputs.make_rules``),
its state, inputs, cache and outputs are ``DTensor``s laid out by the
rules, and it runs the model on each rank's local blocks
(``models.model.MeshCtx``); the kernels only ever see plain tensors. Every
arch of the registry runs so.

The abstract state is shapes and dtypes on the ``meta`` device; given a
mesh (a layout or a ``DeviceMesh``) and rules, each leaf also carries its
spec over that mesh, which is what the dry run (``launch.dryrun``) counts
each device's bytes from, and what ``runtime.fault_tolerance.
elastic_reshard`` places a host state by."""

from __future__ import annotations

import itertools
import math
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch import inputs as inputs_mod
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.param import (ParamSpec, Rules, abstract_params, axis_sizes,
                                      entry_axes, init_params, resolve_spec, sharded,
                                      tree_map_specs)
from repro_torch.obs import device as obs
from repro_torch.parallel import collectives as coll
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten


def model_param_specs(cfg: ModelConfig, mesh=None, rules: Optional[Rules] = None) -> Any:
    """The parameter specs a step reads. Over a mesh the MoE slots are
    sized by the expert-parallel domain, as the reference sizes them: the
    model axis, or data x model for token-routed decode (``moe_mode``
    "token"). With no mesh, one device's tree (every expert, ``slots =
    E``), the one the port's steps run."""
    if mesh is None:
        return model_mod.model_specs(cfg)
    return model_mod.model_specs(cfg, axis_sizes(mesh)["model"], moe_shards(mesh, rules))


def moe_shards(mesh, rules: Optional[Rules]) -> int:
    """The ranks of the expert-parallel domain under ``rules``: the model
    axis, or data x model for token-routed decode (``moe_mode`` "token")."""
    sizes = axis_sizes(mesh)
    token = rules is not None and rules.get("moe_mode") == "token"
    return sizes["data"] * sizes["model"] if token else sizes["model"]


def abstract_state(cfg: ModelConfig, opt: Optional[Optimizer], mesh=None,
                   rules: Optional[Rules] = None) -> dict:
    """The train (``opt`` given) or serve state as empty tensors of each
    leaf's shape and dtype on the ``meta`` device: ``{"params": ...}`` and,
    for training, ``"opt"`` (allocates nothing). Given ``mesh`` and
    ``rules``, each leaf is a :class:`~repro_torch.models.param.Sharded`
    (the meta tensor and its ``resolve_spec`` over ``mesh``)."""
    pspecs = model_param_specs(cfg, mesh, rules)
    trees = {"params": pspecs}
    if opt is not None:
        trees["opt"] = opt.init_specs(pspecs)

    if mesh is None:
        return {k: abstract_params(v) for k, v in trees.items()}

    def laid(s: ParamSpec):
        return sharded(s.shape, s.dtype, mesh, resolve_spec(s.shape, s.logical, rules, mesh))

    return {k: tree_map_specs(laid, v) for k, v in trees.items()}


def loss_and_grads(cfg: ModelConfig, params, batch, ctx=None):
    """(loss, gradient tree): :func:`~repro_torch.models.model.loss_fn`
    under autograd, its gradient with respect to every parameter. A
    parameter the loss does not reach gets a zero gradient, as under
    ``jax.grad``. The loss is a detached 0-d tensor.

    Over a mesh (``ctx``) ``params`` and ``batch`` are a rank's blocks. Each
    rank differentiates its loss over the number of ranks, so that the sum
    of the ranks' objectives is the reference's loss and every collective's
    backward is its adjoint; a leaf replicated over some axes has its
    gradient summed over them (``MeshCtx.synced``). The loss returned is the
    reference's, the mean over the batch shards.

    The loss is the ``train.forward`` span, its gradient ``train.backward``
    (:mod:`repro_torch.obs.device`)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        with obs.span("train.forward"):
            tree = tree_unflatten(params, leaves)
            if ctx is not None:
                tree = ctx.synced(tree, model_mod.mesh_specs(cfg, ctx))
            loss = model_mod.loss_fn(cfg, tree, batch, ctx)
            objective = loss if ctx is None or ctx.world == 1 else loss / ctx.world
        with obs.span("train.backward"):
            grads = torch.autograd.grad(objective, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    loss = loss.detach()
    if ctx is not None and ctx.world > 1:
        loss = coll.all_reduce(loss, ctx.everyone) / ctx.world
    return loss, tree_unflatten(params, grads)


def to_local(tree):
    """A tree of DTensors as the rank's local tensors (others as they are)."""
    if isinstance(tree, dict):
        return {k: to_local(v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, DTensor) else tree


def like(local, template):
    """``local`` (a tree of a rank's blocks) as DTensors of ``template``'s
    layout (no communication)."""
    if isinstance(local, dict):
        return {k: like(local[k], template[k]) for k in local}
    return DTensor.from_local(local, template.device_mesh, template.placements,
                              run_check=False, shape=template.shape,
                              stride=template.stride())


def state_specs(cfg: ModelConfig, mesh, rules: Rules, opt: Optional[Optimizer] = None):
    """Each leaf's spec over ``mesh`` of the train (``opt`` given) or serve
    state, as :func:`abstract_state`'s tree of specs."""
    pspecs = model_param_specs(cfg, mesh, rules)
    trees = {"params": pspecs}
    if opt is not None:
        trees["opt"] = opt.init_specs(pspecs)
    return {k: tree_map_specs(lambda s: resolve_spec(s.shape, s.logical, rules, mesh), v)
            for k, v in trees.items()}


def build_train_step(cfg: ModelConfig, mesh, rules: Optional[Rules], opt: Optimizer):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: the
    loss and its gradients (:func:`loss_and_grads`), then ``opt.update``.
    ``state`` is ``{"params", "opt"}``; the new state is a new tree, the old
    one is left as it was. The metrics are 0-d tensors on the state's
    device (reading them waits for the step). With ``mesh`` (a
    ``DeviceMesh``) and ``rules`` the state and the batch are DTensors
    laid out by the rules (``steps.init_state``, ``data.pipeline.
    device_put_batch``), and so is the new state.

    Each call is a ``train.step`` span labelled with the call's count
    (``step``, from 1), which counts the allocator's device calls, around
    ``train.forward`` and ``train.backward`` (:func:`loss_and_grads`) and
    ``train.optimizer`` (:mod:`repro_torch.obs.device`)."""
    calls = itertools.count(1)
    if mesh is None:
        def train_step(state, batch):
            with obs.span("train.step", step=next(calls), alloc=True):
                params = state["params"]
                loss, grads = loss_and_grads(cfg, params, batch)
                with obs.span("train.optimizer"):
                    new_params, new_opt, gnorm = opt.update(grads, state["opt"], params)
            return {"params": new_params, "opt": new_opt}, {"loss": loss, "grad_norm": gnorm}

        return train_step

    ctx = model_mod.MeshCtx(mesh, rules)
    specs = state_specs(cfg, mesh, rules)["params"]

    def sharded_train_step(state, batch):
        with obs.span("train.step", step=next(calls), alloc=True):
            params = to_local(state["params"])
            loss, grads = loss_and_grads(cfg, params, to_local(batch), ctx)
            with obs.span("train.optimizer"):
                new_params, new_opt, gnorm = opt.update(grads, to_local(state["opt"]), params,
                                                        ctx=ctx, specs=specs)
            return ({"params": like(new_params, state["params"]),
                     "opt": like(new_opt, state["opt"])}, {"loss": loss, "grad_norm": gnorm})

    return sharded_train_step


def decoder_slots(cfg: ModelConfig, seq_len: int) -> int:
    """Slots of a global block's cache for sequences of ``seq_len`` tokens:
    ``cache_len`` of the decoder's share (:func:`~repro_torch.launch.inputs.
    split_seq`; an encoder-decoder model gives the encoder its part)."""
    return model_mod.cache_len(inputs_mod.split_seq(cfg, seq_len)[1])


def _placed(x, spec, ctx):
    """A rank's block ``x`` as a DTensor laid out by ``spec``."""
    from repro_torch.models.param import placements

    def layout():
        shape = [n * math.prod(ctx.sizes[a] for a in entry_axes(e))
                 for n, e in zip(x.shape, tuple(spec) + (None,) * (x.dim() - len(spec)))]
        stride = [math.prod(shape[d + 1:]) for d in range(len(shape))]
        return placements(spec, ctx.mesh), torch.Size(shape), tuple(stride)

    place, shape, stride = ctx.memo(("placed", tuple(x.shape), spec), layout)
    return DTensor.from_local(x, ctx.mesh, place, run_check=False, shape=shape, stride=stride)


def _logits_out(cfg, logits, ctx):
    """The rank's logits block [B_l, 1, V_l] as a DTensor laid out as the
    reference's logits (``("batch", "seq", "vocab")``), made contiguous (the
    tensor-core product's logits are a view of its padded output)."""
    spec = (ctx.rules.get("batch"), None, ctx.axes_for(cfg.vocab_size, "vocab") or None)
    return _placed(logits.contiguous(), spec, ctx)


def _cache_out(cfg, cache, ctx, B: int, T: int, enc_S: int):
    """The rank's cache blocks as DTensors laid out by the rules."""
    specs = model_mod.cache_specs(cfg, B, T, enc_S)
    return {blk: {name: _placed(x, resolve_spec(specs[blk][name].shape,
                                                specs[blk][name].logical, ctx.rules, ctx.mesh),
                                ctx)
                  for name, x in entry.items()}
            for blk, entry in cache.items()}


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                       rules: Optional[Rules] = None):
    """``prefill_step(params, batch) -> (logits, cache)`` with a cache of
    :func:`decoder_slots` slots. With ``mesh`` and ``rules``: DTensors in
    and out, the cache laid out by the rules' ``kv_seq`` (the decode
    rules', for a cache that decode reads in place) and the last position's
    logits as the reference lays them out (split by batch and vocab).

    Each call is a ``serve.prefill`` span labelled with the call's count
    (``request``, from 1) and the batch's tokens, which counts the
    allocator's device calls (:mod:`repro_torch.obs.device`)."""
    max_len = decoder_slots(cfg, shape.seq_len)
    calls = itertools.count(1)
    if mesh is None:
        def prefill_step(params, batch):
            with obs.span("serve.prefill", request=next(calls),
                          tokens=batch["tokens"].numel(), alloc=True):
                return model_mod.prefill_fn(cfg, params, batch, max_len=max_len)

        return prefill_step

    ctx = model_mod.MeshCtx(mesh, rules)

    def sharded_prefill_step(params, batch):
        with obs.span("serve.prefill", request=next(calls), tokens=batch["tokens"].numel(),
                      alloc=True):
            logits, cache = model_mod.prefill_fn(cfg, to_local(params), to_local(batch),
                                                 max_len, ctx)
            B = batch["tokens"].shape[0]  # the global batch
            enc_S = batch["enc_embeds"].shape[1] if "enc_embeds" in batch else 0
            return _logits_out(cfg, logits, ctx), _cache_out(cfg, cache, ctx, B, max_len, enc_S)

    return sharded_prefill_step


def build_decode_step(cfg: ModelConfig, mesh=None, rules: Optional[Rules] = None):
    """``decode_step(params, token, pos, cache) -> (logits, cache)``; the
    cache is updated in place. With ``mesh`` and ``rules``: DTensors in and
    out (the cache's local blocks are written in place)."""
    if mesh is None:
        def decode_step(params, token, pos, cache):
            return model_mod.decode_fn(cfg, params, token, pos, cache)

        return decode_step

    ctx = model_mod.MeshCtx(mesh, rules)

    def sharded_decode_step(params, token, pos, cache):
        slots = {blk: e["k"].shape[2] for blk, e in cache.items() if "k" in e}
        logits, _ = model_mod.decode_fn(cfg, to_local(params), to_local(token), pos,
                                        to_local(cache), ctx, slots)
        return _logits_out(cfg, logits, ctx), cache

    return sharded_decode_step


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                     rules: Optional[Rules] = None):
    """The step a shape cell runs: (train_step, its optimizer) for train
    shapes, (prefill step, None) for prefill, (one-token decode step,
    None) for decode."""
    if shape.kind == "train":
        opt = Optimizer(cfg.optimizer)
        return build_train_step(cfg, mesh, rules, opt), opt
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, rules), None
    return build_decode_step(cfg, mesh, rules), None


def init_state(cfg: ModelConfig, opt: Optional[Optimizer], device, seed: int = 0,
               mesh=None, rules: Optional[Rules] = None) -> dict:
    """``{"params"}`` and, with ``opt``, ``"opt"``: parameters of the spec
    dtypes drawn from ``seed`` on ``device``, and the optimizer's zero
    state. On a ``DeviceMesh`` with ``rules`` every leaf is drawn whole, as
    without one, and held as a DTensor of the rank's block."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pspecs = model_param_specs(cfg, mesh, rules)
    state = {"params": init_params(pspecs, gen, mesh, rules)}
    if opt is not None:
        state["opt"] = init_params(opt.init_specs(pspecs), gen, mesh, rules)
    return state
