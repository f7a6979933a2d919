"""Optimizers: AdamW and factored Adafactor, as functions over parameter
trees (PyTorch port of ``repro.optim.optimizers``).

A tree is a nested dict of tensors, the layout of the model's parameters.
The state tree is built from ``ParamSpec``s (:meth:`Optimizer.init_specs`),
so ``init_params`` materialises it and ``launch.steps.abstract_state``
lists it on the meta device. Each update reads the gradients, state and
parameters and returns new trees: float32 arithmetic, each new parameter
cast back to its leaf's dtype, as the JAX package computes it. The step
count is an int32 scalar tensor; the bias corrections and Adafactor's decay
take its float32 value, as JAX does (``b1 ** count`` in float32).

Over a mesh (``ctx``, a ``models.model.MeshCtx``, and ``specs``, each
leaf's spec) every tree holds a rank's blocks and the update equals the
unsharded one: the global norm sums each leaf's squares over the ranks
that hold distinct blocks of it, and Adafactor's row and column means and
its update's RMS are taken over the whole leaf (an all-reduce over the
axes that split the reduced dims). AdamW is elementwise.

Error-feedback int8 compression of the gradients lives in
:mod:`repro_torch.optim.compression`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.param import ParamSpec, entry_axes, tree_map_specs
from repro_torch.parallel import collectives as coll

OptState = Dict[str, Any]


def tree_leaves(tree):
    """The tensors of a nested dict, in sorted key order (JAX's pytree
    order for dicts)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s layout holding ``leaves`` (in :func:`tree_leaves`'
    order)."""
    return _unflatten(like, iter(leaves))


def _unflatten(like, it):
    # a module function, not a closure that calls itself: such a closure
    # is a reference cycle, and its cell would keep ``leaves`` (a step's
    # gradients, say) alive until Python's cycle collector ran
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    return next(it)


def global_norm(tree, ctx=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32. Over a mesh
    (``ctx`` and each leaf's spec ``specs``) a leaf replicated over some
    axes adds its square sum once, and the sum is taken over the ranks."""
    if ctx is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))
    total = 0
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs), strict=True):
        sq = torch.sum(torch.square(x.float()))
        copies = ctx.world // math.prod(ctx.sizes[a] for e in spec for a in entry_axes(e))
        total = total + (sq / copies if copies > 1 else sq)
    return torch.sqrt(coll.all_reduce(total, ctx.everyone))


def _mean(x, dim, group):
    """torch.mean over ``dim`` (None: every element) of a block whose dim
    is split over ``group``'s ranks."""
    if group is None:
        return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
    n = (x.numel() if dim is None else x.shape[dim]) * group.size
    s = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
    return coll.all_reduce(s, group) / n


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adamw_init_specs(param_specs) -> OptState:
    def mom(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.logical, init="zeros", dtype=torch.float32)

    return {"mu": tree_map_specs(mom, param_specs), "nu": tree_map_specs(mom, param_specs)}


def _adamw_update(grads, state, params, *, lr, b1, b2, eps, wd):
    c = state["count"] + 1
    cf = c.float()
    bc1 = 1 - _f32(b1, cf) ** cf
    bc2 = 1 - _f32(b2, cf) ** cf

    def upd(g, mu, nu, p):
        g = g.float()
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p.float()
        return (p.float() - lr * step).to(p.dtype), mu, nu

    out = [upd(g, m, n, p) for g, m, n, p in zip(
        tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"]),
        tree_leaves(params),
        strict=True)]
    new_p = tree_unflatten(params, [o[0] for o in out])
    return new_p, {"mu": tree_unflatten(params, [o[1] for o in out]),
                   "nu": tree_unflatten(params, [o[2] for o in out]), "count": c}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------

def _adafactor_init_specs(param_specs) -> OptState:
    def row(s: ParamSpec):
        if len(s.shape) < 2:
            return ParamSpec(s.shape, s.logical, init="zeros", dtype=torch.float32)
        return ParamSpec(s.shape[:-1], s.logical[:-1], init="zeros", dtype=torch.float32)

    def col(s: ParamSpec):
        if len(s.shape) < 2:
            return ParamSpec((1,), (None,), init="zeros", dtype=torch.float32)
        return ParamSpec(s.shape[:-2] + s.shape[-1:], s.logical[:-2] + s.logical[-1:],
                         init="zeros", dtype=torch.float32)

    return {"vr": tree_map_specs(row, param_specs), "vc": tree_map_specs(col, param_specs)}


def _adafactor_update(grads, state, params, *, lr, b2, eps, wd, ctx=None, specs=None):
    c = state["count"] + 1
    cf = c.float()
    decay = 1.0 - cf ** -0.8  # the t^-0.8 schedule of the Adafactor paper

    def upd(g, vr, vc, p, spec):
        def split(*dims):  # the group splitting dims of the leaf
            if ctx is None:
                return None
            return ctx.group([a for d in dims for a in entry_axes(spec[d])])

        g = g.float()
        g2 = torch.square(g) + eps
        if g.dim() < 2:
            vr_n = decay * vr + (1 - decay) * g2
            update = g * torch.rsqrt(vr_n)
            vc_n = vc
        else:
            vr_n = decay * vr + (1 - decay) * _mean(g2, -1, split(-1))
            vc_n = decay * vc + (1 - decay) * _mean(g2, -2, split(-2))
            r = vr_n / _mean(vr_n, -1, split(-2)).unsqueeze(-1)
            update = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc_n)[..., None, :])
        # clip the update's RMS to 1 (Adafactor's d = 1)
        rms = torch.sqrt(_mean(torch.square(update), None, split(*range(g.dim()))) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        newp = p.float() * (1 - lr * wd) - lr * update
        return newp.to(p.dtype), vr_n, vc_n

    leaf_specs = tree_leaves(specs) if specs is not None else [None] * len(tree_leaves(params))
    out = [upd(g, r_, c_, p, sp) for g, r_, c_, p, sp in zip(
        tree_leaves(grads), tree_leaves(state["vr"]), tree_leaves(state["vc"]),
        tree_leaves(params), leaf_specs,
        strict=True)]
    new_p = tree_unflatten(params, [o[0] for o in out])
    return new_p, {"vr": tree_unflatten(params, [o[1] for o in out]),
                   "vc": tree_unflatten(params, [o[2] for o in out]), "count": c}


# ---------------------------------------------------------------------------
# public factory
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Optimizer:
    name: str
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init_specs(self, param_specs) -> OptState:
        if self.name == "adafactor":
            st = _adafactor_init_specs(param_specs)
        else:
            st = _adamw_init_specs(param_specs)
        st["count"] = ParamSpec((), (), init="zeros", dtype=torch.int32)
        return st

    def update(self, grads, state, params, ctx=None,
               specs=None) -> Tuple[Any, OptState, torch.Tensor]:
        """(new params, new state, the gradients' global norm before the
        clip). Gradients are scaled by min(1, grad_clip / (norm + 1e-9))
        in their own dtype, as the JAX package scales them. Over a mesh
        (``ctx``; ``specs`` the tree of each leaf's spec) the trees are a
        rank's blocks."""
        gnorm = global_norm(grads, ctx, specs)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        grads = tree_unflatten(grads, [g * scale.to(g.dtype) for g in tree_leaves(grads)])
        if self.name == "adafactor":
            p, s = _adafactor_update(grads, state, params, lr=self.lr, b2=self.b2,
                                     eps=self.eps, wd=self.weight_decay, ctx=ctx, specs=specs)
        else:
            p, s = _adamw_update(grads, state, params, lr=self.lr, b1=self.b1,
                                 b2=self.b2, eps=self.eps, wd=self.weight_decay)
        return p, s, gnorm


def make_optimizer(name: str, **kw) -> Optimizer:
    return Optimizer(name=name, **kw)


def opt_init_specs(opt: Optimizer, param_specs) -> OptState:
    return opt.init_specs(param_specs)
