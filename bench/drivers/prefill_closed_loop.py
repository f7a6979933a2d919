"""Closed-loop prefill traffic: ``clients`` = 1 client sends one request
at a time and sends the next once the last one's first token is on the
host. Prompt lengths come from the traffic file's table, each block of
``block_repeats`` copies of the table shuffled by the seed, so every seed
sends the same sizes in another order; token ids are drawn from the seed
on the device. Each request runs the serving engine's prefill step
(``ServeEngine(..., batch=1, params=...).prefill``), which writes the
request's KV cache; its first token is the argmax of the last position's
logits.

``correct`` compares, for a sample of the window's requests drawn from the
seed (with the longest prompts in it), the last position's logits and every
layer's K and V cache with the float32 reference, and the served token with
the reference's logits.
"""

from __future__ import annotations

import numpy as np
import torch

from bench import yardstick
from bench.drivers import port
from bench.record import Completion, now
from bench.weights import make_weights


def lengths(traffic: dict, seed: int, n: int) -> list:
    rng = np.random.default_rng([seed, 1])
    table = list(traffic["prompt_lengths"]) * traffic["block_repeats"]
    out: list = []
    while len(out) < n:
        out.extend(int(x) for x in rng.permutation(table))
    return out[:n]


def sample(traffic: dict, seed: int, lens: list) -> list:
    """The requests ``correct`` reads, drawn from the seed among the first
    ``within`` of the window: ``longest`` of the longest prompts and the
    rest of any length."""
    s = traffic["sample"]
    rng = np.random.default_rng([seed, 2])
    first = lens[:s["within"]]
    top = max(first)
    longest = [i for i, L in enumerate(first) if L == top]
    pick = list(rng.choice(longest, size=s["longest"], replace=False))
    rest = [i for i in range(len(first)) if i not in pick]
    pick += list(rng.choice(rest, size=s["requests"] - s["longest"], replace=False))
    return sorted(int(i) for i in pick)


def setup(run) -> dict:
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import model as model_mod

    cfg, traffic, dev = run.cfg, run.traffic, run.device
    pc = port.port_config(cfg)
    weights = make_weights(cfg, run.seed, dev, cfg["torch_dtype"])
    port.check_layout(weights, model_mod.cast_weights(pc, model_mod.model_specs(pc)))
    run.log("weights made")
    eng = ServeEngine(pc, traffic["max_len"], traffic["clients"], device=dev, params=weights)
    n = traffic["max_requests"]
    lens = lengths(traffic, run.seed, n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed + 1)
    tokens = torch.randint(0, cfg["vocab_size"], (n, max(lens)), generator=gen, device=dev)
    warm = torch.randint(0, cfg["vocab_size"], (1, max(lens)), generator=gen, device=dev)
    for L in sorted(set(lens)):  # every shape the window sends, twice
        for _ in range(2):
            logits, cache = eng.prefill(eng.params, {"tokens": warm[:, :L]})
            logits[0, -1].argmax().item()
    picked = sample(traffic, run.seed, lens)
    # the sampled requests' caches are copied out into buffers made here, so
    # that keeping them allocates nothing in the window
    copies = {i: {b: {k: torch.empty_like(x) for k, x in e.items()} for b, e in cache.items()}
              for i in picked}
    del logits, cache
    run.log("warmed up")
    return {"eng": eng, "weights": weights, "lengths": lens, "tokens": tokens,
            "sample": picked, "copies": copies, "kept": {}}


def _request(st: dict, i: int):
    L = st["lengths"][i]
    eng = st["eng"]
    logits, cache = eng.prefill(eng.params, {"tokens": st["tokens"][i:i + 1, :L]})
    last = logits[0, -1]
    return last, cache, torch.stack([last.argmax(), torch.isfinite(last).all().long()])


def window(run, st: dict, seconds: float) -> None:
    rec, cfg = run.record, run.cfg
    sampled = set(st["sample"])
    rec.window_start = t0 = now()
    i = 0
    while now() < t0 + seconds:
        if i >= len(st["lengths"]):
            raise RuntimeError("the window outran the traffic's max_requests")
        L = st["lengths"][i]
        t_d = now()
        with rec.span("prefill launch"):
            last, cache, res = _request(st, i)
        with rec.span("token read"):
            tok, finite = res.tolist()
        t_done = now()
        rec.attempted += 1
        if finite:
            rec.completions.append(Completion(t_d, t_done, L, yardstick.forward_flops(
                cfg, L, 1, head_positions=1)))
        else:
            rec.failed += 1
        if i in sampled:
            st["kept"][i] = (last, _copy_out(cache, st["copies"].pop(i)), tok)
        del last, cache, res
        i += 1


def outputs(run, st: dict) -> None:
    """The program's answers to the sampled requests, where no window ran
    (the control's readings of the program)."""
    for i in st["sample"]:
        last, cache, res = _request(st, i)
        st["kept"][i] = (last, _copy_out(cache, st["copies"].pop(i)), int(res[0]))


def _copy_out(cache: dict, into: dict) -> dict:
    for b, e in cache.items():
        for k, x in e.items():
            into[b][k].copy_(x)
    return into


def control_outputs(run, st: dict, precision: str, fault: str = "") -> None:
    """The reference at ``precision`` in the program's place: its logits,
    its served token and its K and V, stored as the program stores them.
    A prefill has no planted fault of this kind (``fault``)."""
    if fault:
        raise ValueError(f"no fault {fault!r} for a prefill")
    cfg = run.cfg
    st.pop("eng", None)
    st.pop("copies", None)
    st["kept"].clear()
    idx = st["sample"]
    T = _slots(run)
    caches = {}
    for i in idx:
        shape = (cfg["num_hidden_layers"], 1, T, cfg["num_key_value_heads"], cfg["head_dim"])
        dt = getattr(torch, cfg["torch_dtype"])
        caches[i] = {"b0": {"k": torch.zeros(shape, dtype=dt, device=run.device),
                            "v": torch.zeros(shape, dtype=dt, device=run.device)}}

    def keep(l, j, k, v):
        c = caches[idx[j]]["b0"]
        c["k"][l, 0, :k.shape[0]] = k
        c["v"][l, 0, :v.shape[0]] = v

    prompts = [st["tokens"][i, :st["lengths"][i]] for i in idx]
    logits = run.reference.prefill(cfg, st["weights"], prompts, precision, keep)
    for i, lg in zip(idx, logits):
        st["kept"][i] = (lg, caches[i], int(lg.argmax()))


def _slots(run) -> int:
    """Cache slots of the program's layout for the traffic's ``max_len``."""
    from repro_torch.launch.steps import decoder_slots
    return decoder_slots(port.port_config(run.cfg), run.traffic["max_len"])


def check(run, st: dict) -> dict:
    """Each compared number over the sampled requests that completed:
    ``logits_rel`` the widest relative L2 gap of the last position's
    logits, ``kv_rel`` the widest relative L2 gap of a layer's K or V cache
    (the slots past the prompt held to zero), ``token_excess`` how many
    served tokens lie below the reference's best by more than twice the
    widest gap of any logit (a greedy pick on logits within that gap of
    the reference's cannot)."""
    cfg = run.cfg
    st.pop("eng", None)
    st.pop("copies", None)
    kept = st["kept"]
    idx = sorted(kept)
    if not idx:
        raise RuntimeError("no sampled request completed in the window")
    kv = []

    def compare(l, j, k, v):
        cache = kept[idx[j]][1]["b0"]
        for name, want in (("k", k), ("v", v)):
            got = cache[name][l, 0].float()
            S = want.shape[0]
            num = torch.sum((got[:S] - want) ** 2) + torch.sum(got[S:] ** 2)
            kv.append(float(torch.sqrt(num) / torch.linalg.vector_norm(want)))

    prompts = [st["tokens"][i, :st["lengths"][i]] for i in idx]
    ref = run.reference.prefill(cfg, st["weights"], prompts, "float32", compare)
    rel, excess = [], 0
    for i, want in zip(idx, ref):
        got, _, tok = kept[i]
        diff = got.float() - want
        rel.append(float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want)))
        gap = float(want.max() - want[tok])
        excess += gap > 2 * float(diff.abs().max()) + 1e-6 * float(want.abs().max())
    return {"logits_rel": max(rel), "kv_rel": max(kv), "token_excess": float(excess),
            "sampled": float(len(idx)), "widest_logit_gap": max(
                float((kept[i][0].float() - w).abs().max()) for i, w in zip(idx, ref))}
