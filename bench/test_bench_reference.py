"""The plain reference against the program at smoke width in float32 on the
CPU: a prefill's last-position logits and every layer's K and V cache, and
one train step's loss, gradients and AdamW update."""

import torch

from bench import testing
from bench.drivers import port
from bench.drivers import train_steps
from bench.reference import dense_transformer as ref
from bench.weights import leaves, make_weights

TOL = 2e-5  # float32 against float32: only the order of the sums differs


def rel(a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b))


def test_prefill_matches_the_program_in_float32():
    from repro_torch.launch.serve import ServeEngine

    run = testing.small_run("neox20b.prefill", dtype="float32")
    cfg = run.cfg
    pc = port.port_config(cfg)
    w = make_weights(cfg, 5, "cpu", "float32")
    eng = ServeEngine(pc, 33, 1, device="cpu", params=w)
    for L in (9, 32):
        tok = torch.randint(0, cfg["vocab_size"], (1, L), generator=torch.Generator().manual_seed(L))
        logits, cache = eng.prefill(eng.params, {"tokens": tok})
        seen = []

        def on_layer(l, i, k, v):
            for name, want in (("k", k), ("v", v)):
                got = cache["b0"][name][l, 0]
                seen.append(rel(got[:L], want))
                assert torch.count_nonzero(got[L:]) == 0

        (want,) = ref.prefill(cfg, w, [tok[0]], "float32", on_layer)
        assert len(seen) == 2 * cfg["num_hidden_layers"]
        assert max(seen) < TOL
        assert rel(logits[0, -1], want) < TOL


def test_train_step_matches_the_program_in_float32():
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import model as model_mod
    from repro_torch.models.param import init_params
    from repro_torch.optim import Optimizer

    run = testing.small_run("roberta.train", dtype="float32")
    cfg, traffic = run.cfg, run.traffic
    pc = port.port_config(cfg)
    opt = Optimizer(**cfg["optimizer"])
    w = make_weights(cfg, 6, "cpu", "float32")
    specs = model_mod.model_specs(pc)
    state = {"params": w, "opt": init_params(opt.init_specs(specs), torch.Generator())}
    batch = train_steps.batch_at(cfg, traffic, 6, 1, "cpu")
    new, m = build_train_step(pc, None, None, opt)(state, batch)

    loss, grads = ref.loss_and_grads(cfg, w, batch["tokens"], batch["targets"], 2, "float32")
    params, _, clipped = ref.adamw(w, grads, None, cfg["optimizer"])
    assert abs(float(m["loss"]) - loss) / loss < TOL
    mu = dict(leaves(new["opt"]["mu"]))
    for path, g in leaves(clipped):
        assert rel(mu[path] / (1 - opt.b1), g) < 1e-4, path
    # Adam's first step is lr * sign(g) where |g| >> eps: a gradient entry
    # within round-off of zero may take the other sign, so the update is
    # held elementwise loosely and by its norm, as the cell compares it, tightly
    start, after = dict(leaves(w)), dict(leaves(params))
    for path, p in leaves(new["params"]):
        got, want = p - start[path], after[path] - start[path]
        assert rel(got, want) < 5e-3, path
        n_got, n_want = torch.linalg.vector_norm(got), torch.linalg.vector_norm(want)
        assert abs(float(n_got - n_want)) / float(n_want) < 1e-4, path
