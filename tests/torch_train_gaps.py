"""Print the training parity gaps that ROADMAP Queue 3 records: the port
against the JAX package on the CPU, in float32, at the tests' smoke size (B
2 x S 16), with the helpers of ``tests/_torch_train_ref.py``.

    PYTHONPATH=src:tests python tests/torch_train_gaps.py [--jax-self]

For each arch: the loss gap and the worst gradient leaf (gap norm over
norm) with float32 parameter storage and, for kimi-k2 and jamba, with
their own bf16 storage; the worst state leaf after the first and third
train step with each storage; for flan-t5-xxl and whisper-base the
three-step gaps on the JAX init and on conditioned attention. With
``--jax-self``, also the gap of JAX's jitted gradient to its eager one for
kimi-k2 and jamba (bf16 storage; about two minutes).
"""

import sys

import jax
import numpy as np
import torch

from _torch_train_ref import (ARCHS, BF16_PARAM_ARCHS, configs, jax_batch, jax_loss_and_grads,
                              jax_steps, leaves, port_batch, reference_mesh, rel, shared_params)
from repro.launch.mesh import set_mesh
from repro.models import model as jax_model
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model
from repro_torch.optim import make_optimizer


def grad_gap(arch, mesh, storage):
    jcfg, cfg = configs(arch, param_storage=storage)
    np_params = shared_params(jcfg)
    jb = jax_batch(jcfg)
    jloss, jgrads = jax_loss_and_grads(jcfg, np_params, jb, mesh)
    params = model.load_jax_params(cfg, np_params, "cpu")
    tracked = [p.requires_grad_() for _, p in leaves(params)]
    loss = model.loss_fn(cfg, params, port_batch(jb))
    grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    worst = max((rel(g, j), path) for (path, j), g in zip(leaves(jgrads), grads))
    return abs(float(loss.detach()) - jloss) / abs(jloss), worst


def step_gaps(arch, mesh, storage, condition=False):
    jcfg, cfg = configs(arch, param_storage=storage)
    jbatches = [jax_batch(jcfg, seed) for seed in range(3)]
    first, want = jax_steps(jcfg, shared_params(jcfg, condition=condition), jbatches, mesh)
    opt = make_optimizer(cfg.optimizer)
    state = {"params": model.load_jax_params(cfg, first["params"]),
             "opt": model.load_jax_opt_state(cfg, opt, first["opt"])}
    step = build_train_step(cfg, None, None, opt)
    out = []
    for i, jb in enumerate(jbatches):
        state, metrics = step(state, port_batch(jb))
        jstate, jmetrics = want[i]
        worst = max((rel(g, j), path) for (path, j), (_, g) in zip(leaves(jstate), leaves(state)))
        loss_gap = abs(float(metrics["loss"]) - jmetrics["loss"]) / abs(jmetrics["loss"])
        out.append((worst, loss_gap))
    return out


def jax_self_gap(arch, mesh):
    jcfg, _ = configs(arch, param_storage=None)
    p = jax.tree.map(jax.numpy.asarray, shared_params(jcfg))
    from repro.launch.inputs import make_rules
    from repro.models.config import ShapeConfig
    rules = make_rules(jcfg, ShapeConfig("t", 16, 2, "train"), mesh)
    ctx = jax_model.MeshCtx(mesh, rules)
    jb = jax_batch(jcfg)
    f = jax.value_and_grad(lambda q: jax_model.loss_fn(jcfg, q, jb, ctx))
    with set_mesh(mesh):
        _, g1 = jax.jit(f)(p)
        with jax.disable_jit():
            _, g2 = f(p)
    g1, g2 = jax.tree.map(np.asarray, g1), jax.tree.map(np.asarray, g2)
    return max((rel(b, a), path) for (path, a), (_, b) in zip(leaves(g1), leaves(g2)))


def main():
    mesh = reference_mesh()
    for arch in ARCHS:
        for storage in ["float32"] + ([None] if arch in BF16_PARAM_ARCHS else []):
            label = "bf16 storage" if storage is None else "float32 storage"
            lg, (g, leaf) = grad_gap(arch, mesh, storage)
            steps = step_gaps(arch, mesh, storage)
            print(f"{arch} ({label}): loss {lg:.2e}, worst gradient leaf {g:.2e} ({leaf}); "
                  f"step 1 worst state leaf {steps[0][0][0]:.2e} ({steps[0][0][1]}), step 3 "
                  f"{steps[2][0][0]:.2e} ({steps[2][0][1]}), step 3 loss {steps[2][1]:.2e}",
                  flush=True)
        if arch in ("flan-t5-xxl", "whisper-base"):
            steps = step_gaps(arch, mesh, "float32", condition=True)
            print(f"{arch} (float32 storage, conditioned attention): step 1 worst state leaf "
                  f"{steps[0][0][0]:.2e}, step 3 {steps[2][0][0]:.2e} ({steps[2][0][1]})",
                  flush=True)
    if "--jax-self" in sys.argv:
        for arch in BF16_PARAM_ARCHS:
            g, leaf = jax_self_gap(arch, mesh)
            print(f"{arch}: JAX jitted against eager gradient, bf16 storage, worst leaf "
                  f"{g:.2e} ({leaf})", flush=True)


if __name__ == "__main__":
    main()
