"""Training traffic: one train step after another on batches of ``batch``
x ``seq`` tokens, each made from the seed on the host and put on the
device as a loader would (MLM: ``mask_rate`` of the positions replaced by
the mask token, the targets every position's original token). A step is
the program's ``launch/steps.py::build_train_step`` on the state
``init_state``'s layout holds (the benchmark's weights, the optimizer's
zero state); it completes when its loss is read on the host.

Set-up drives that one state through its first ``steps_in_setup`` steps,
through the window's own call and feed, and hands it on to the window.
``correct`` holds those steps against the float32 reference, which follows
them from the same weights and batches: each step's loss, each leaf's
first gradient as the optimizer got it (its first moment after one step
over 1 - b1) and each leaf's change after the steps.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from bench import yardstick
from bench.drivers import port
from bench.record import Completion, now
from bench.weights import leaves, make_weights


def batch_at(cfg: dict, traffic: dict, seed: int, step: int, device):
    """The batch of ``step`` on ``device``: masked ``tokens`` and their
    ``targets``, int32 [batch, seq]."""
    rng = np.random.default_rng([seed, 3, step])
    shape = (traffic["batch"], traffic["seq"])
    targets = rng.integers(0, cfg["vocab_size"], shape, dtype=np.int32)
    masked = rng.random(shape) < traffic["mask_rate"]
    tokens = np.where(masked, np.int32(cfg["mask_token_id"]), targets)
    return {"tokens": torch.from_numpy(tokens).to(device),
            "targets": torch.from_numpy(targets).to(device)}


def _norms(tree) -> list:
    return [float(torch.linalg.vector_norm(x.float())) for _, x in leaves(tree)]


def setup(run) -> dict:
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import model as model_mod
    from repro_torch.models.param import init_params
    from repro_torch.optim import Optimizer

    cfg, traffic, dev = run.cfg, run.traffic, run.device
    pc = port.port_config(cfg)
    opt = Optimizer(**cfg["optimizer"])
    specs = model_mod.model_specs(pc)
    weights = make_weights(cfg, run.seed, dev, cfg["param_dtype"])
    port.check_layout(weights, specs)
    run.log("weights made")
    gen = torch.Generator(device=dev)
    state = {"params": weights, "opt": init_params(opt.init_specs(specs), gen)}
    p0 = {p: x.clone() for p, x in leaves(weights)}
    step_fn = build_train_step(pc, None, None, opt)
    losses, first_grad = [], None
    for step in range(1, traffic["steps_in_setup"] + 1):
        state, m = step_fn(state, batch_at(cfg, traffic, run.seed, step, dev))
        losses.append(m["loss"].item())
        run.log(f"set-up step {step}")
        if step == 1:  # the gradient as the optimizer got it: mu = (1 - b1) g
            first_grad = [n / (1 - opt.b1) for n in _norms(state["opt"]["mu"])]
    change = [float(torch.linalg.vector_norm(x.float() - p0[p]))
              for p, x in leaves(state["params"])]
    return {"state": state, "step_fn": step_fn, "next": traffic["steps_in_setup"] + 1,
            "p0": p0, "losses": losses, "first_grad": first_grad, "change": change}


def window(run, st: dict, seconds: float) -> None:
    rec, cfg, traffic = run.record, run.cfg, run.traffic
    tokens = traffic["batch"] * traffic["seq"]
    flops = yardstick.train_step_flops(cfg, traffic["seq"], traffic["batch"])
    step_fn = st["step_fn"]
    rec.window_start = t0 = now()
    while now() < t0 + seconds:
        t_d = now()
        with rec.span("batch to device"):
            batch = batch_at(cfg, traffic, run.seed, st["next"], run.device)
        with rec.span("train step launch"):
            st["state"], m = step_fn(st["state"], batch)
        with rec.span("loss read"):
            loss = m["loss"].item()
        t_done = now()
        rec.attempted += 1
        st["next"] += 1
        if np.isfinite(loss):
            rec.completions.append(Completion(t_d, t_done, tokens, flops))
        else:
            rec.failed += 1


def outputs(run, st: dict) -> None:
    """Set-up's steps are the program's answers: nothing more to run."""


def _reference_steps(run, st: dict, precision: str, rows=None):
    """The reference's (losses, first gradient norms, change norms) over
    set-up's steps from the same weights and batches; ``rows`` keeps a
    slice of each batch's rows (a planted fault)."""
    cfg, traffic = run.cfg, run.traffic
    params = {}
    for p, x in st["p0"].items():  # the tree of the weights, float32
        node = params
        *parents, leaf = p.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = x.float()
    state, losses, first_grad = None, [], None
    for step in range(1, traffic["steps_in_setup"] + 1):
        b = batch_at(cfg, traffic, run.seed, step, run.device)
        tok, tgt = b["tokens"], b["targets"]
        if rows is not None:
            tok, tgt = tok[rows], tgt[rows]
        loss, grads = run.reference.loss_and_grads(cfg, params, tok, tgt,
                                                   traffic["reference_micro_batch"], precision)
        params, state, clipped = run.reference.adamw(params, grads, state, cfg["optimizer"])
        del grads
        losses.append(loss)
        if step == 1:
            first_grad = _norms(clipped)
        del clipped
    change = [float(torch.linalg.vector_norm(x - st["p0"][p])) for p, x in leaves(params)]
    return losses, first_grad, change


def _free_program(st: dict) -> None:
    st.pop("state", None)
    st.pop("step_fn", None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def control_outputs(run, st: dict, precision: str, fault: str = "") -> None:
    """The reference in the program's place: at ``precision``, or with a
    planted ``fault``: "half_batch" (the first half of each batch's rows,
    the mean over them), "unchanged" (a step that returns its state)."""
    _free_program(st)
    if fault == "unchanged":  # the moments and the weights never move
        st["change"] = [0.0] * len(st["change"])
        st["first_grad"] = [0.0] * len(st["first_grad"])
        return
    rows = slice(0, run.traffic["batch"] // 2) if fault == "half_batch" else None
    if fault not in ("", "half_batch"):
        raise ValueError(f"no fault {fault!r} for training")
    st["losses"], st["first_grad"], st["change"] = _reference_steps(run, st, precision, rows)


def check(run, st: dict) -> dict:
    """Each compared number: ``loss_rel`` the widest relative gap of a
    step's loss; ``grad_rel`` the widest gap of a leaf's first-gradient
    norm; ``change_rel`` the widest gap of a leaf's change after the steps,
    over the leaves whose reference gradient is at least a thousandth of
    the median leaf's; each gap against the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    _free_program(st)
    losses, grad, change = _reference_steps(run, st, "float32")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(st["losses"], losses, strict=True))
    med_g = statistics.median(grad)
    grad_rel = max(abs(a - b) / max(b, med_g)
                   for a, b in zip(st["first_grad"], grad, strict=True))
    keep = [i for i, g in enumerate(grad) if g >= 1e-3 * med_g]
    med_c = statistics.median(change[i] for i in keep)
    change_rel = max(abs(st["change"][i] - change[i]) / max(change[i], med_c) for i in keep)
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "change_rel": change_rel,
            "leaves_left_out": float(len(grad) - len(keep)), "loss_step1": losses[0]}
