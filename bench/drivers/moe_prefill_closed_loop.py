"""Closed-loop prefill traffic of a mixture-of-experts configuration
(Mixtral's block): the client, the lengths, the token ids and the sample
of ``prefill_closed_loop``, whose functions this driver shares. Each
request runs the serving engine's prefill step (``ServeEngine(...,
batch=1, params=...).prefill`` -> ``prefill_fn`` -> ``moe_apply``), which
writes the request's KV cache; its first token is the argmax of the last
position's logits. A completion's operations are ``bench/moe_yardstick.py``'s:
the two routed experts of each token, not all eight.

``correct`` compares, for the sample of the window's requests, the last
position's logits and every layer's K and V cache with the float32
reference (``bench/reference/moe_transformer.py``), the served token with
the reference's logits, and the program's expert choices with the
reference's: after the window each sampled request is run again with
``repro_torch.models.moe.route`` and ``dispatch`` wrapped, which gives
the choices of every block and the rows it dropped (the rerun's logits are
held to the kept ones bit for bit, a reading), and the reference follows
those choices.
"""

from __future__ import annotations

import contextlib

import torch

from bench import moe_yardstick
from bench.drivers import port
from bench.drivers.prefill_closed_loop import _copy_out, _request, lengths, sample
from bench.drivers.prefill_closed_loop import outputs  # noqa: F401  (control.py's program)
from bench.moe_weights import make_weights
from bench.record import Completion, now
from bench.weights import DTYPES

# the largest probability margin one of the program's expert choices may
# cross against the reference's own top k. The reference follows the
# program's choices, and its float32 activations part from the bf16 ones
# by ~1.5 % at the cell's depth (kv_rel), which moves its probabilities by
# up to ~0.02: the program's widest margin read 0.0177 over 24 runs at the
# cell's size, the fp8 control's least widest 0.136 over 3 seeds, and the
# bound lies above their midpoint (PERF.md section 6). chip_smoke.py's 0.02
# holds two bf16 computations of the program to each other.
NEAR_TIE = 0.08


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of ``cfg["port_arch"]`` with every
    size and setting of the configuration file (full causal attention,
    the published rotary base and norm epsilon, bf16 weights and compute),
    and a check that the program's block is the one the reference
    computes and drops no row on one device. The port's preset keeps the
    JAX package's sliding window and rotary base, which the published
    configuration does not have."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ATTN

    E, k, F = cfg["num_local_experts"], cfg["num_experts_per_tok"], cfg["intermediate_size"]
    dtype = DTYPES[cfg["torch_dtype"]]
    pc = get_config(cfg["port_arch"]).replace(
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"], d_ff=F, moe_d_ff=F, vocab_size=cfg["vocab_size"],
        moe_num_experts=E, moe_top_k=k, pattern=(ATTN,), window_size=0,
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"], dtype=dtype,
        param_dtype=dtype)
    block = dict(pattern=pc.pattern, mlp_type=pc.mlp_type, use_rope=pc.use_rope,
                 qk_norm=pc.qk_norm, use_post_norm=pc.use_post_norm,
                 softcaps=(pc.attn_logit_softcap, pc.final_logit_softcap),
                 window=pc.window_size, experts=(pc.moe_num_experts, pc.moe_top_k, pc.moe_d_ff),
                 shared_expert=pc.moe_shared_expert_ff, moe_every=pc.moe_layer_period,
                 drops_none=pc.moe_capacity_factor >= 1.0,
                 encoder_layers=pc.num_encoder_layers, frontend=pc.frontend,
                 tied=pc.tie_embeddings, padded=pc.padded_heads != pc.num_heads,
                 encoder_only=pc.is_encoder_only)
    want = dict(pattern=("attn",), mlp_type="swiglu", use_rope=True, qk_norm=False,
                use_post_norm=False, softcaps=(0.0, 0.0), window=cfg["sliding_window"] or 0,
                experts=(E, k, F), shared_expert=0, moe_every=1, drops_none=True,
                encoder_layers=0, frontend="none", tied=cfg["tie_word_embeddings"],
                padded=False, encoder_only=False)
    if block != want:
        raise ValueError(f"{cfg['name']}: the program's block {block} is not the reference's "
                         f"{want}")
    return pc


def setup(run) -> dict:
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import model as model_mod

    cfg, traffic, dev = run.cfg, run.traffic, run.device
    pc = port_config(cfg)
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
            rec.completions.append(Completion(t_d, t_done, L, moe_yardstick.forward_flops(
                cfg, L, 1, head_positions=1)))
        else:
            rec.failed += 1
        if i in sampled:
            st["kept"][i] = (last, _copy_out(cache, st["copies"].pop(i)), tok)
        del last, cache, res
        i += 1


@contextlib.contextmanager
def routing():
    """Record the expert choices ([T, k] a block, in call order) of the
    program's ``moe.route`` and the rows its ``moe.dispatch`` kept, by
    wrapping both for the ``with`` body: yields (choices, dropped), the
    list of choices and a one-item list of the rows dropped."""
    from repro_torch.models import moe

    real_route, real_dispatch = moe.route, moe.dispatch
    choices, dropped = [], [0]

    def route(*args, **kwargs):
        topw, topi = real_route(*args, **kwargs)
        choices.append(topi)
        return topw, topi

    def dispatch(cfg, topi, *args, **kwargs):
        sel, sizes = real_dispatch(cfg, topi, *args, **kwargs)
        dropped[0] += topi.numel() - sum(sizes)
        return sel, sizes

    moe.route, moe.dispatch = route, dispatch
    try:
        yield choices, dropped
    finally:
        moe.route, moe.dispatch = real_route, real_dispatch


def _rerun(st: dict) -> None:
    """The program's expert choices and dropped rows for each kept request,
    from a rerun of it (into ``st["routes"]``, ``st["dropped"]``), and how
    many reruns' logits differ from the kept ones in any bit."""
    st["routes"], st["dropped"], st["rerun_differs"] = {}, 0, 0
    for i in sorted(st["kept"]):
        with routing() as (choices, dropped):
            last, _, _ = _request(st, i)
        st["routes"][i] = list(choices)
        st["dropped"] += dropped[0]
        st["rerun_differs"] += not torch.equal(last, st["kept"][i][0])
        del last


def control_outputs(run, st: dict, precision: str, fault: str = "") -> None:
    """The reference at ``precision`` in the program's place: its logits,
    its served token, its K and V, stored as the program stores them, and
    its own expert choices. A prefill has no planted fault of this kind
    (``fault``)."""
    if fault:
        raise ValueError(f"no fault {fault!r} for a prefill")
    cfg = run.cfg
    st.pop("eng", None)
    st.pop("copies", None)
    st["kept"].clear()
    idx = st["sample"]
    T = _slots(run)
    dt = DTYPES[cfg["torch_dtype"]]
    shape = (cfg["num_hidden_layers"], 1, T, cfg["num_key_value_heads"], cfg["head_dim"])
    caches = {i: {"b0": {"k": torch.zeros(shape, dtype=dt, device=run.device),
                         "v": torch.zeros(shape, dtype=dt, device=run.device)}} for i in idx}
    st["routes"] = {i: [] for i in idx}
    st["dropped"] = st["rerun_differs"] = 0

    def keep(l, j, k, v):
        c = caches[idx[j]]["b0"]
        c["k"][l, 0, :k.shape[0]] = k
        c["v"][l, 0, :v.shape[0]] = v

    def keep_route(l, j, topi, margins):
        st["routes"][idx[j]].append(topi)

    prompts = [st["tokens"][i, :st["lengths"][i]] for i in idx]
    logits = run.reference.prefill(cfg, st["weights"], prompts, precision, keep,
                                   on_route=keep_route)
    for i, lg in zip(idx, logits):
        st["kept"][i] = (lg, caches[i], int(lg.argmax()))


def _slots(run) -> int:
    """Cache slots of the program's layout for the traffic's ``max_len``."""
    from repro_torch.launch.steps import decoder_slots
    return decoder_slots(port_config(run.cfg), run.traffic["max_len"])


def check(run, st: dict) -> dict:
    """Each compared number over the sampled requests that completed:
    ``logits_rel``, ``kv_rel`` and ``token_excess`` as
    ``prefill_closed_loop.check`` reads them; ``route_excess`` how many of
    the program's expert choices differ from the reference's own by more
    than :data:`NEAR_TIE` of probability; ``dropped_rows`` the rows the
    program's blocks dropped in the rerun."""
    cfg = run.cfg
    if "eng" in st:
        _rerun(st)
    st.pop("eng", None)
    st.pop("copies", None)
    kept = st["kept"]
    idx = sorted(kept)
    if not idx:
        raise RuntimeError("no sampled request completed in the window")
    kv, margins = [], []

    def compare(l, j, k, v):
        cache = kept[idx[j]][1]["b0"]
        for name, want in (("k", k), ("v", v)):
            got = cache[name][l, 0].float()
            S = want.shape[0]
            num = torch.sum((got[:S] - want) ** 2) + torch.sum(got[S:] ** 2)
            kv.append(float(torch.sqrt(num) / torch.linalg.vector_norm(want)))

    def crossed(l, j, topi, m):
        margins.extend(m.tolist())

    prompts = [st["tokens"][i, :st["lengths"][i]] for i in idx]
    ref = run.reference.prefill(cfg, st["weights"], prompts, "float32", compare,
                                route_as=[st["routes"][i] for i in idx], on_route=crossed)
    rel, excess = [], 0
    for i, want in zip(idx, ref):
        got, _, tok = kept[i]
        diff = got.float() - want
        rel.append(float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want)))
        gap = float(want.max() - want[tok])
        excess += gap > 2 * float(diff.abs().max()) + 1e-6 * float(want.abs().max())
    return {"logits_rel": max(rel), "kv_rel": max(kv), "token_excess": float(excess),
            "route_excess": float(sum(m > NEAR_TIE for m in margins)),
            "dropped_rows": float(st["dropped"]),
            "sampled": float(len(idx)), "widest_logit_gap": max(
                float((kept[i][0].float() - w).abs().max()) for i, w in zip(idx, ref)),
            "route_flips": float(len(margins)), "route_margin": max(margins, default=0.0),
            "rerun_differs": float(st["rerun_differs"])}
