"""The bridge from a hybrid model's configuration file to the program:
the registered architecture it names, cut to the file's depth, checked
against the file's sizes."""
from __future__ import annotations

import dataclasses


def program_arch(config: dict):
    """The program's registered architecture the configuration names
    (``program_arch``) at the file's `num_hidden_layers`, its hybrid
    layers those of the file's `layers_block_type`; refused where a
    width differs from the file's, or where the file's layer pattern is
    not the first layers of the program's."""
    from repro_torch.common.config import get_arch
    arch = get_arch(config["program_arch"])
    m = config["model"]
    check(m, arch)
    ids = tuple(i for i, t in enumerate(m["layers_block_type"])
                if t == "hybrid")
    n = m["num_hidden_layers"]
    if (len(m["layers_block_type"]) != n or ids != tuple(m["hybrid_layer_ids"])
            or ids != tuple(i for i in arch.hybrid_layers if i < n)
            or n > arch.n_layers):
        raise ValueError(f"the configuration's {n} layers (hybrid at "
                         f"{list(ids)}) are not the first layers of the "
                         f"program's {arch.name}")
    return dataclasses.replace(arch, n_layers=n, hybrid_layers=ids)


def check(m: dict, arch) -> None:
    att, s = arch.attention, arch.ssm
    mine = (m["hidden_size"], m["intermediate_size"], m["vocab_size"],
            m["num_attention_heads"], m["num_key_value_heads"],
            m["attention_head_dim"], m["attention_hidden_size"],
            m["mamba_d_state"], m["mamba_d_conv"], m["mamba_expand"],
            m["mamba_headdim"], m["n_mamba_heads"], m["mamba_ngroups"],
            m["num_mem_blocks"], m["adapter_rank"],
            m["tie_word_embeddings"], m["add_bias_linear"],
            m["use_mem_rope"], m["use_shared_mlp_adapter"],
            m["use_shared_attention_adapter"])
    theirs = (arch.d_model, arch.d_ff, arch.vocab_size, att.n_heads,
              att.n_kv_heads, att.head_dim, 2 * arch.d_model, s.d_state,
              s.d_conv, s.expand, s.head_dim, s.n_heads(arch.d_model),
              s.n_groups, arch.n_mem_blocks, arch.adapter_rank,
              arch.tie_embeddings, att.qkv_bias, True,
              arch.adapter_rank > 0, False)
    if mine != theirs:
        raise ValueError(f"the program's {arch.name} is {theirs}, the "
                         f"configuration {mine}")
    # the program's published layout: a conv bias, the gelu MLP, scores
    # scaled by (head_dim / 2)^-0.5
    if (m["use_conv_bias"], m["hidden_act"]) != (True, "gelu"):
        raise ValueError(f"{arch.name} takes a conv bias and the gelu MLP")
    if (m["rope_theta"], m["rms_norm_eps"], m["time_step_min"]) != (
            att.rope_theta, arch.norm_eps, s.dt_min):
        raise ValueError(f"{arch.name}: rope_theta, rms_norm_eps or "
                         f"time_step_min differ")
