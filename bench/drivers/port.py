"""The benchmark's one door into the program (``repro_torch``): its model
configuration built from a configuration file, and the program's parameter
layout checked against the tree ``bench/weights.py`` makes."""

from __future__ import annotations

from bench.weights import DTYPES, leaves


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of its architecture ``cfg["port_arch"]``
    with every size and setting of the configuration file, and a check that
    the program's block is the one the reference computes."""
    from repro_torch.configs import get_config

    pc = get_config(cfg["port_arch"]).replace(
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        norm_eps=cfg["layer_norm_eps"], rope_theta=float(cfg["rotary_emb_base"]),
        dtype=DTYPES[cfg["torch_dtype"]], param_dtype=DTYPES[cfg.get("param_dtype", "float32")])
    block = dict(pattern=pc.pattern, mlp_type=pc.mlp_type, use_rope=pc.use_rope,
                 qk_norm=pc.qk_norm, use_post_norm=pc.use_post_norm,
                 softcaps=(pc.attn_logit_softcap, pc.final_logit_softcap),
                 window=pc.window_size, experts=pc.moe_num_experts,
                 encoder_layers=pc.num_encoder_layers, frontend=pc.frontend,
                 tied=pc.tie_embeddings, padded=pc.padded_heads != pc.num_heads,
                 encoder_only=pc.is_encoder_only)
    want = dict(pattern=("attn",), mlp_type="gelu", use_rope=True, qk_norm=False,
                use_post_norm=False, softcaps=(0.0, 0.0), window=0, experts=0,
                encoder_layers=0, frontend="none", tied=False, padded=False,
                encoder_only=not cfg["causal"])
    if block != want:
        raise ValueError(f"{cfg['name']}: the program's block {block} is not the reference's "
                         f"{want}")
    return pc


def check_layout(tree: dict, specs) -> None:
    """Raise unless ``tree`` has the program's leaves (``specs``, a tree of
    its ParamSpecs) with the same shapes and dtypes."""
    got = {p: (tuple(x.shape), x.dtype) for p, x in leaves(tree)}
    want = {p: (tuple(s.shape), s.dtype) for p, s in leaves(specs)}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"weights differ from the program's layout: {diff[:6]}")
