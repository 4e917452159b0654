"""The bridge from a model configuration file to the program: the
registered architecture it names, checked against the file's sizes."""
from __future__ import annotations


def program_arch(config: dict):
    """The program's registered architecture the configuration names
    (``program_arch``), refused where its sizes differ from the file's."""
    from repro_torch.common.config import get_arch
    arch = get_arch(config["program_arch"])
    check(config["model"], arch)
    return arch


def check(m: dict, arch) -> None:
    att = arch.attention
    mine = (m["num_hidden_layers"], m["hidden_size"], m["intermediate_size"],
            m["vocab_size"], m["num_attention_heads"],
            m["num_key_value_heads"], m["head_dim"], m["tie_word_embeddings"],
            m["qkv_bias"])
    theirs = (arch.n_layers, arch.d_model, arch.d_ff, arch.vocab_size,
              att.n_heads, att.n_kv_heads, att.head_dim, arch.tie_embeddings,
              att.qkv_bias)
    if mine != theirs:
        raise ValueError(f"the program's {arch.name} is {theirs}, the "
                         f"configuration {mine}")
    if (m["rope_theta"], m["rms_norm_eps"]) != (att.rope_theta,
                                                arch.norm_eps):
        raise ValueError(f"{arch.name}: rope_theta / rms_norm_eps differ")
