"""``correct`` tells the program from its control and from planted faults on
the CPU: at a test size, a number the reference computed in fp8 (one step
below the configurations' bf16) fails is one the program passes, under
the cells' own limits; and a whole run at smoke width with the timed path
broken underneath comes out not correct, once for each fault the cell can
have. The cells' limits were set from readings at their own size on the
card (``control.py``; PERF.md)."""

import pytest
import torch

from bench import control, testing

# deep and wide enough that rounding builds up as it does at the cells' sizes
CONTROL_SIZE = dict(num_hidden_layers=4, hidden_size=256, num_attention_heads=4,
                    num_key_value_heads=4, head_dim=64, intermediate_size=1024,
                    vocab_size=1024)
CONTROL_TRAFFIC = {"neox20b.prefill": dict(prompt_lengths=[64, 96, 128], max_len=129),
                   "roberta.train": dict(batch=8, seq=128, reference_micro_batch=4)}


def fails(readings: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if not readings[k] <= lim]


@pytest.mark.parametrize("cell", ["neox20b.prefill", "roberta.train"])
def test_fp8_control_fails_a_number_the_program_passes(cell, monkeypatch):
    monkeypatch.setattr(testing, "SMOKE", {**testing.SMOKE, **CONTROL_SIZE})
    monkeypatch.setitem(testing.TRAFFIC, cell, {**testing.TRAFFIC[cell],
                                                **CONTROL_TRAFFIC[cell]})
    run = testing.small_run(cell)
    for seed in (1, 2):
        program = fails(control.readings(run, seed, "program"), run.limits)
        caught = set(fails(control.readings(run, seed, "fp8"), run.limits)) - set(program)
        assert caught, (cell, seed)
    if cell == "neox20b.prefill":  # the prefill's numbers hold at this size too
        assert program == []


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_training_faults_in_the_reference_fail(fault):
    run = testing.small_run("roberta.train")
    assert fails(control.readings(run, 3, "float32", fault), run.limits)
    assert fails(control.readings(run, 3, "float32", fault), SMOKE_TRAIN_LIMITS)


def _zero_cache(model_mod):
    orig = model_mod.prefill_fn

    def prefill_fn(*args, **kwargs):
        logits, cache = orig(*args, **kwargs)
        return logits, {b: {k: torch.zeros_like(v) for k, v in e.items()}
                        for b, e in cache.items()}
    return prefill_fn


def _altered_answer(model_mod):
    orig = model_mod.prefill_fn

    def prefill_fn(*args, **kwargs):
        logits, cache = orig(*args, **kwargs)
        return torch.roll(logits, 1, dims=-1), cache
    return prefill_fn


def _half_prompt(model_mod):
    orig = model_mod.prefill_fn

    def prefill_fn(cfg, params, batch, *args, **kwargs):
        S = batch["tokens"].shape[1]
        return orig(cfg, params, {"tokens": batch["tokens"][:, S // 2:]}, *args, **kwargs)
    return prefill_fn


@pytest.mark.parametrize("fault", [_zero_cache, _altered_answer, _half_prompt])
def test_prefill_run_with_a_broken_path_is_not_correct(fault, monkeypatch):
    from repro_torch.models import model as model_mod
    run = testing.small_run("neox20b.prefill")
    assert testing.execute(run)["correct"]
    monkeypatch.setattr(model_mod, "prefill_fn", fault(model_mod))
    assert not testing.execute(testing.small_run("neox20b.prefill"))["correct"]


def _unchanged(monkeypatch):
    from repro_torch.optim import Optimizer
    monkeypatch.setattr(Optimizer, "update",
                        lambda self, grads, state, params, **kw: (params, state,
                                                                  torch.zeros(())))


def _half_batch(monkeypatch):
    from repro_torch.launch import steps
    orig = steps.loss_and_grads

    def loss_and_grads(cfg, params, batch, ctx=None):
        half = batch["tokens"].shape[0] // 2
        return orig(cfg, params, {k: v[:half] for k, v in batch.items()}, ctx)
    monkeypatch.setattr(steps, "loss_and_grads", loss_and_grads)


def _altered_loss(monkeypatch):
    from repro_torch.launch import steps
    orig = steps.loss_and_grads

    def loss_and_grads(*args, **kwargs):
        loss, grads = orig(*args, **kwargs)
        return loss * 1.05, grads
    monkeypatch.setattr(steps, "loss_and_grads", loss_and_grads)


# At smoke width a sound train step reads up to 1e-4 (loss), 1.3e-3 (first
# gradient) and 8e-4 (change): a mean over 128 positions and a 256-word
# vocabulary, not the cell's 65,536 and 50,265. These runs hold it to limits
# of that size; the cell's own are set at its size on the card.
SMOKE_TRAIN_LIMITS = {"loss_rel": 1e-3, "grad_rel": 1e-2, "change_rel": 1e-2}


def small_train_run():
    run = testing.small_run("roberta.train")
    run.limits = dict(SMOKE_TRAIN_LIMITS)
    return run


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_loss])
def test_train_run_with_a_broken_path_is_not_correct(fault, monkeypatch):
    assert testing.execute(small_train_run())["correct"]
    fault(monkeypatch)
    assert not testing.execute(small_train_run())["correct"]
