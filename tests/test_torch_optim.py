"""The port's optimizers and train step against the JAX package, on the CPU.

* AdamW and Adafactor on seeded random trees (2-D, 3-D and 1-D leaves, bf16
  parameters among them) against the JAX optimizers over four updates: new
  parameters and every state leaf within 1e-6 relative, the step count
  equal; with gradients large enough that the global clip and Adafactor's
  update-RMS clip both act, and small enough that neither does.
* Error-feedback int8 compression: the same quantized gradients and
  residuals as JAX's (the int8 codes exactly), and the port versions of
  ``tests/test_data_optim.py``'s convergence and error-feedback tests.
* ``launch.steps.build_train_step``, one and three steps, for all 15
  registry archs with each arch's own optimizer (Adafactor for kimi-k2 and
  jamba), in float32 with float32 parameter storage, from the JAX
  parameters and optimizer state (carried across with
  ``load_jax_opt_state``): the loss of each step within 1e-5, the new
  parameters and every optimizer-state leaf within 1e-4 (gap norm over
  norm; on conditioned attention weights for the archs of
  ``CONDITIONED``, as the bf16 serve test); and the last two steps again
  from JAX's state after the first.
* Where the Adafactor drift starts: kimi-k2 and jamba, the two Adafactor
  archs, are also the two that store parameters in bf16. With float32
  storage they meet 1e-4 over three steps (above); with their own bf16
  storage the first step's new parameters are within one bf16 rounding
  unit of JAX's (``BF16_STORAGE_RTOL``) and Adafactor's squared-gradient
  moments within two: the gap starts in the bf16 roundings of the
  gradients and the new parameters, not in Adafactor's factored moments
  or its update clip.
* ``abstract_state`` lists the state on the meta device with the shapes
  and dtypes of the materialised state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import (ARCHS, BF16_PARAM_ARCHS, BF16_STORAGE_RTOL, CONDITIONED, RTOL,
                              configs,
                              jax_batch, jax_steps, leaves, port_batch, reference_mesh, rel,
                              shared_params)
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim.compression import compress_grads as jax_compress_grads
from repro_torch.configs import smoke_config
from repro_torch.launch.steps import abstract_state, build_serve_step, build_train_step
from repro_torch.models import model
from repro_torch.models.config import ShapeConfig
from repro_torch.models.param import ParamSpec, init_params
from repro_torch.optim import make_optimizer
from repro_torch.optim.compression import compress_grads, init_error_feedback
from repro_torch.optim.optimizers import tree_leaves

OPT_RTOL = 1e-6


def _random_tree(rng, scale):
    """Parameters and gradients of several ranks and dtypes, numpy float32
    (the bf16 leaf is rounded to bf16 values)."""
    shapes = {"a": (6, 5), "b": {"c": (3, 4, 7), "d": (9,)}, "e": (4, 8)}
    params, grads = {}, {}

    def fill(shape_tree, p_out, g_out):
        for k, v in shape_tree.items():
            if isinstance(v, dict):
                p_out[k], g_out[k] = {}, {}
                fill(v, p_out[k], g_out[k])
            else:
                p_out[k] = rng.standard_normal(v).astype(np.float32)
                g_out[k] = (scale * rng.standard_normal(v)).astype(np.float32)

    fill(shapes, params, grads)
    params["e"] = np.asarray(torch.from_numpy(params["e"]).bfloat16().float())
    return params, grads


def _port(tree, bf16_leaf="e"):
    return {k: (_port(v) if isinstance(v, dict) else
                torch.from_numpy(v).to(torch.bfloat16 if k == bf16_leaf else torch.float32))
            for k, v in tree.items()}


def _jax(tree, bf16_leaf="e"):
    return {k: (_jax(v) if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if k == bf16_leaf else jnp.float32))
            for k, v in tree.items()}


def _specs(tree):
    return {k: (_specs(v) if isinstance(v, dict) else
                ParamSpec(v.shape, (None,) * v.ndim,
                          dtype=torch.bfloat16 if k == "e" else torch.float32))
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("grad_scale", [30.0, 1e-3])  # both clips act / neither does
def test_optimizer_updates_match_jax(name, grad_scale):
    rng = np.random.default_rng(4)
    params, _ = _random_tree(rng, grad_scale)
    opt, jopt = make_optimizer(name), jax_make_optimizer(name)
    p, jp = _port(params), _jax(params)
    state = init_params(opt.init_specs(_specs(params)), torch.Generator())
    jstate = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.int32 if x.ndim == 0 else x.dtype),
                          jax.tree.map(np.asarray, {k: (v if k == "count" else v)
                                                    for k, v in _np_state(state).items()}))
    for _ in range(4):
        _, grads = _random_tree(rng, grad_scale)
        p, state, gnorm = opt.update(_port(grads, None), state, p)
        jp, jstate, jnorm = jopt.update(_jax(grads, None), jstate, jp)
        assert abs(float(gnorm) - float(jnorm)) <= OPT_RTOL * float(jnorm)
    for (path, j), g in zip(leaves(jax.tree.map(np.asarray, jp)), tree_leaves(p), strict=True):
        assert rel(g, j) < OPT_RTOL, path
    assert p["e"].dtype == torch.bfloat16
    jst = jax.tree.map(np.asarray, jstate)
    for (path, j), (_, g) in zip(leaves(jst), leaves(state), strict=True):
        assert rel(g, j) < OPT_RTOL, path
    assert int(state["count"]) == int(jst["count"]) == 4
    if name == "adafactor":  # 1-D leaves keep an unfactored row moment, vc (1,)
        assert state["vr"]["b"]["d"].shape == (9,) and state["vc"]["b"]["d"].shape == (1,)
        assert state["vr"]["b"]["c"].shape == (3, 4) and state["vc"]["b"]["c"].shape == (3, 7)


def _np_state(state):
    return {k: (_np_state(v) if isinstance(v, dict) else v.numpy()) for k, v in state.items()}


def test_compression_matches_jax():
    rng = np.random.default_rng(5)
    g = {"w": rng.standard_normal((32, 16)).astype(np.float32),
         "b": (1e-3 * rng.standard_normal(7)).astype(np.float32)}
    ef = init_error_feedback(_port(g))
    jef = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), g)
    for i in range(3):
        gi = {k: v * (1 + 0.5 * i) for k, v in g.items()}
        got, ef = compress_grads(_port(gi, None), ef)
        want, jef = jax_compress_grads(_jax(gi, None), jef)
        for (path, w), (_, h) in zip(leaves(jax.tree.map(np.asarray, want)), leaves(got)):
            np.testing.assert_array_equal(h.numpy(), w, err_msg=path)
        for (path, w), (_, h) in zip(leaves(jax.tree.map(np.asarray, jef)), leaves(ef)):
            np.testing.assert_array_equal(h.numpy(), w, err_msg=path)


def _quadratic_losses(opt_name, steps=120):
    opt = make_optimizer(opt_name, lr=0.05, weight_decay=0.0)
    target = torch.tensor([[1.0, -2.0], [0.5, 3.0]])
    params = {"w": torch.zeros((2, 2))}
    state = init_params(opt.init_specs({"w": ParamSpec((2, 2), (None, None))}),
                        torch.Generator())
    losses = []
    for _ in range(steps):
        w = params["w"].clone().requires_grad_()
        loss = torch.sum((w - target) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, state, _ = opt.update({"w": g}, state, params)
        losses.append(float(loss.detach()))
    return losses


def test_adamw_converges():
    ls = _quadratic_losses("adamw")
    assert ls[-1] < 1e-2 * ls[0]


def test_adafactor_converges():
    ls = _quadratic_losses("adafactor")
    assert ls[-1] < 5e-2 * ls[0]


def test_grad_compression_error_feedback():
    """int8 + error feedback: the accumulated compressed sum tracks the true
    sum, and one step is within the int8 quantization error."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.tensor(rng.standard_normal((64, 64)), dtype=torch.float32)}
    ef = init_error_feedback(g_true)
    acc_hat = torch.zeros((64, 64))
    acc_true = torch.zeros((64, 64))
    for i in range(20):
        g = {"w": g_true["w"] * (1 + 0.1 * i)}
        g_hat, ef = compress_grads(g, ef)
        acc_hat += g_hat["w"]
        acc_true += g["w"]
    assert float(torch.linalg.norm(acc_hat - acc_true) / torch.linalg.norm(acc_true)) < 0.01
    g_hat, _ = compress_grads(g_true, init_error_feedback(g_true))
    err = float(torch.max(torch.abs(g_hat["w"] - g_true["w"])))
    assert err <= float(torch.max(torch.abs(g_true["w"]))) / 127.0 + 1e-6


@pytest.fixture(scope="module")
def mesh():
    return reference_mesh()


def _same_dtype(got: torch.Tensor, want: np.ndarray) -> bool:
    return str(got.dtype).removeprefix("torch.") == str(want.dtype)


def _check_state(state, jstate, bound, moment_bound=None, label=""):
    for (path, j), (_, g) in zip(leaves(jstate), leaves(state), strict=True):
        assert _same_dtype(g, j), (label, path, g.dtype, j.dtype)
        b = moment_bound if moment_bound and path.startswith("opt/") else bound
        assert rel(g, j) < b, (label, path, rel(g, j))


def _port_state(cfg, opt, jstate):
    return {"params": model.load_jax_params(cfg, jstate["params"], "cpu"),
            "opt": model.load_jax_opt_state(cfg, opt, jstate["opt"], "cpu")}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, mesh):
    """Three steps over three batches from JAX's initial state, the states
    after the first and the third held to JAX's; then the last two steps
    again from JAX's state after the first."""
    jcfg, cfg = configs(arch)
    jbatches = [jax_batch(jcfg, seed) for seed in range(3)]
    np_params = shared_params(jcfg, condition=arch in CONDITIONED)
    first, want = jax_steps(jcfg, np_params, jbatches, mesh)
    opt = make_optimizer(cfg.optimizer)
    assert opt.name == ("adafactor" if arch in BF16_PARAM_ARCHS else "adamw")
    step = build_train_step(cfg, opt)
    for start in (0, 1):
        state = _port_state(cfg, opt, first if start == 0 else want[0][0])
        for i in range(start, 3):
            state, metrics = step(state, port_batch(jbatches[i]))
            jstate, jmetrics = want[i]
            assert abs(float(metrics["loss"]) - jmetrics["loss"]) <= 1e-5 * abs(jmetrics["loss"])
            assert abs(float(metrics["grad_norm"]) - jmetrics["grad_norm"]) <= \
                1e-4 * jmetrics["grad_norm"]
            if i in (0, 2):
                _check_state(state, jstate, RTOL, label=f"from {start}, step {i}")
        assert int(state["opt"]["count"]) == 3


@pytest.mark.parametrize("arch", BF16_PARAM_ARCHS)
def test_bf16_parameter_storage_step_gap(arch, mesh):
    jcfg, cfg = configs(arch, param_storage=None)
    assert cfg.param_dtype == torch.bfloat16
    jb = jax_batch(jcfg)
    first, ((jstate, jmetrics),) = jax_steps(jcfg, shared_params(jcfg), [jb], mesh)
    opt = make_optimizer(cfg.optimizer)
    state, metrics = build_train_step(cfg, opt)(_port_state(cfg, opt, first), port_batch(jb))
    assert abs(float(metrics["loss"]) - jmetrics["loss"]) <= 1e-5 * abs(jmetrics["loss"])
    _check_state(state, jstate, BF16_STORAGE_RTOL, moment_bound=2 * BF16_STORAGE_RTOL)


def test_abstract_state_lists_the_materialised_state():
    cfg = smoke_config("kimi-k2-1t-a32b")
    opt = make_optimizer(cfg.optimizer)
    meta = abstract_state(cfg, opt)
    real = {"params": init_params(model.model_specs(cfg), torch.Generator()),
            "opt": init_params(opt.init_specs(model.model_specs(cfg)), torch.Generator())}
    got, want = list(leaves(meta)), list(leaves(real))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, m), (_, r) in zip(got, want):
        assert m.device.type == "meta" and m.shape == r.shape and m.dtype == r.dtype, path
    assert set(abstract_state(cfg, None)) == {"params"}
    train_step, train_opt = build_serve_step(cfg, ShapeConfig("t", 16, 2, "train"))
    assert callable(train_step) and train_opt.name == "adafactor"
    for kind in ("prefill", "decode"):
        fn, none = build_serve_step(cfg, ShapeConfig("t", 16, 2, kind))
        assert callable(fn) and none is None


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b"])  # AdamW, Adafactor
def test_train_step_leaves_no_tensor_in_a_reference_cycle(arch):
    """A train step frees its gradients and temporaries when it returns:
    none waits in a reference cycle for Python's cycle collector (on the
    card such garbage held 8-10 GB between steps)."""
    import gc

    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import train

    cfg = smoke_config(arch)
    opt = make_optimizer(cfg.optimizer)
    state = train.init_state(cfg, opt, "cpu", seed=0)
    pipeline = SyntheticTokenPipeline(cfg, DataConfig(2, 16))
    step = build_train_step(cfg, opt)
    batch = {k: torch.as_tensor(v) for k, v in pipeline.batch_at(0).items()}
    # the first step imports modules lazily, whose import frames sit in cycles
    state, _ = step(state, batch)
    gc.collect()
    gc.disable()
    try:
        state, _ = step(state, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic, f"{len(cyclic)} tensors in reference cycles after a step"
