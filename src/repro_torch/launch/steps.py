"""Train, prefill and decode steps and the abstract state they read
(PyTorch port of ``repro.launch.steps``).

Each ``build_*`` function returns a plain callable that runs on the
tensors' device: the port's steps run on one card (a step sharded over a
``torch.distributed`` mesh is ROADMAP Queue 1 item 4c). The abstract state
is shapes and dtypes on the ``meta`` device; given a mesh layout and rules
(``launch.mesh``, ``launch.inputs.make_rules``), each leaf also carries its
spec over that layout, which is what the dry run (``launch.dryrun``) counts
each device's bytes from."""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.launch import inputs as inputs_mod
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.param import (ParamSpec, Rules, abstract_params, resolve_spec, sharded,
                                      tree_map_specs)
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
    moe_shards = 0
    if rules is not None and rules.get("moe_mode") == "token":
        moe_shards = mesh.shape["data"] * mesh.shape["model"]
    return model_mod.model_specs(cfg, mesh.shape["model"], moe_shards)


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


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, gradient tree): :func:`~repro_torch.models.model.loss_fn`
    under autograd, its gradient with respect to every parameter. A
    parameter the loss does not reach gets a zero gradient, as under
    ``jax.grad``. The loss is a detached 0-d tensor."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = model_mod.loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def build_train_step(cfg: ModelConfig, opt: Optimizer):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: the
    loss and its gradients (:func:`loss_and_grads`), then ``opt.update``.
    ``state`` is ``{"params", "opt"}``; the new state is a new tree, the old
    one is left as it was. The metrics are 0-d tensors on the state's
    device (reading them waits for the step)."""

    def train_step(state, batch):
        params = state["params"]
        loss, grads = loss_and_grads(cfg, params, batch)
        new_params, new_opt, gnorm = opt.update(grads, state["opt"], params)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, "grad_norm": gnorm}

    return train_step


def decoder_slots(cfg: ModelConfig, seq_len: int) -> int:
    """Slots of a global block's cache for sequences of ``seq_len`` tokens:
    ``cache_len`` of the decoder's share (:func:`~repro_torch.launch.inputs.
    split_seq`; an encoder-decoder model gives the encoder its part)."""
    return model_mod.cache_len(inputs_mod.split_seq(cfg, seq_len)[1])


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig):
    """``prefill_step(params, batch) -> (logits, cache)`` with a cache of
    :func:`decoder_slots` slots."""
    max_len = decoder_slots(cfg, shape.seq_len)

    def prefill_step(params, batch):
        return model_mod.prefill_fn(cfg, params, batch, max_len=max_len)

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    """``decode_step(params, token, pos, cache) -> (logits, cache)``."""

    def decode_step(params, token, pos, cache):
        return model_mod.decode_fn(cfg, params, token, pos, cache)

    return decode_step


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig):
    """The step a shape cell runs: (train_step, its optimizer) for train
    shapes, (prefill step, None) for prefill, (one-token decode step,
    None) for decode."""
    if shape.kind == "train":
        opt = Optimizer(cfg.optimizer)
        return build_train_step(cfg, opt), opt
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape), None
    return build_decode_step(cfg), None
