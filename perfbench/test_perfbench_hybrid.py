"""The hybrid training cell (`runners/train_hybrid.py`) on the CPU at a
small size: whole runs of its runner (a sound program reads `correct`; a
step that returns its state unchanged, or leaves half of the batch out,
does not); the reference (`reference/zamba2.py`) against the program's
published hybrid layout and against `transformers`' Zamba2; the weights
and the bridge.

The small size keeps every structure of the configuration: 8 layers with
shared blocks A, B, A at layers 2, 4 and 7 (two blocks, three adapters),
d 64, 4 attention heads of 32 over the concatenated 128, 8 SSD heads of
16 in 2 B/C groups, a conv bias, the gelu MLP and the tied head."""
import argparse
import dataclasses
import time
from pathlib import Path

import pytest
import torch

from perfbench import faults, harness, model_hybrid
from perfbench.reference import zamba2
from perfbench.traffic import tokens, weights_hybrid

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CELL = "zamba2-7b-instruct.train_4k"
BLOCKS = ["mamba", "mamba", "hybrid", "mamba", "hybrid", "mamba", "mamba",
          "hybrid"]
TINY = {"num_hidden_layers": 8, "layers_block_type": BLOCKS,
        "hybrid_layer_ids": [2, 4, 7], "hidden_size": 64,
        "intermediate_size": 128, "ffn_hidden_size": 128, "vocab_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "attention_head_dim": 32, "attention_hidden_size": 128,
        "head_dim": 32, "n_mamba_heads": 8, "mamba_headdim": 16,
        "mamba_d_state": 16, "adapter_rank": 8}


def tiny_config() -> dict:
    cfg = harness.load_json(HERE / "configs" / "zamba2-7b-instruct.json")
    cfg["model"].update(TINY)
    return cfg


def tiny_arch():
    from repro_torch.common.config import get_arch
    a = get_arch("zamba2-7b-instruct").reduced()
    return dataclasses.replace(a, hybrid_layers=(2, 4, 7))


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(model_hybrid, "program_arch",
                        lambda c: tiny_arch())
    torch.set_num_threads(2)


def cpu_run(seconds: float = 0.5, seed: int = 3_000_000_019, edit=None):
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    w = harness.load_json(HERE / "workloads" / f"{CELL}.json")
    w["traffic"].update(seq_len=32, vocab=256)
    ns = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
    r = harness.Run(ns, time.perf_counter(), bench, {"name": CELL}, w,
                    tiny_config())
    r.device = "cpu"
    runner = harness.load_module(HERE / "runners" / "train_hybrid.py",
                                 "cpu_runner_train_hybrid")
    if edit is not None:
        edit(runner, r)
    return runner.run(r), r


def correct(out) -> bool:
    return all(c.ok for c in out["checks"])


def test_hybrid_run_is_correct(tiny):
    out, r = cpu_run()
    assert correct(out), r.counters["readings"]
    assert out["attempted"] > 0
    assert r.counters["program"]["f_launches"] == 0   # plain on the CPU


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_hybrid_fault_is_caught(kind, tiny):
    out, r = cpu_run(edit=faults.edit(kind))
    assert not correct(out), r.counters["readings"]


# ------------------------------------------------------------ reference
def tiny_weights(seed: int = 7):
    m = tiny_config()["model"]
    return m, weights_hybrid.make(m, seed, "cpu")


def hf_model(m: dict, flat: dict):
    """`transformers`' Zamba2ForCausalLM at the small size, with the
    benchmark's weights carried across."""
    import os
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    tr = pytest.importorskip("transformers")
    cfg = tr.Zamba2Config(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_hidden_layers=m["num_hidden_layers"],
        layers_block_type=m["layers_block_type"],
        num_attention_heads=m["num_attention_heads"],
        n_mamba_heads=m["n_mamba_heads"], mamba_d_state=m["mamba_d_state"],
        mamba_ngroups=m["mamba_ngroups"], mamba_d_conv=m["mamba_d_conv"],
        chunk_size=m["chunk_size"], intermediate_size=m["intermediate_size"],
        num_mem_blocks=m["num_mem_blocks"], use_mem_rope=True,
        use_shared_attention_adapter=False, adapter_rank=m["adapter_rank"],
        hidden_act="gelu", rms_norm_eps=m["rms_norm_eps"],
        rope_theta=m["rope_theta"], time_step_min=m["time_step_min"],
        max_position_embeddings=m["max_position_embeddings"])
    model = tr.Zamba2ForCausalLM(cfg).eval()
    d, nq, dh = m["hidden_size"], m["num_attention_heads"], \
        m["attention_head_dim"]
    sd = {"model.embed_tokens.weight": flat["embed"],
          "lm_head.weight": flat["embed"],
          "model.final_layernorm.weight": flat["final_ln"]}
    rank = {li: j for j, li in enumerate(m["hybrid_layer_ids"])}
    for li in range(m["num_hidden_layers"]):
        pre = f"model.layers.{li}."
        mam = pre + ("mamba_decoder." if li in rank else "")
        lp = zamba2.pick(flat, f"mamba.{li}")
        sd.update({mam + "input_layernorm.weight": lp["ln"],
                   mam + "mamba.in_proj.weight": lp["in_proj"].T,
                   mam + "mamba.conv1d.weight": lp["conv_w"][:, None, :],
                   mam + "mamba.conv1d.bias": lp["conv_b"],
                   mam + "mamba.dt_bias": lp["dt_bias"],
                   mam + "mamba.A_log": lp["A_log"], mam + "mamba.D": lp["D"],
                   mam + "mamba.norm.weight": lp["norm_w"],
                   mam + "mamba.out_proj.weight": lp["out_proj"].T})
        if li not in rank:
            continue
        j = rank[li]
        bp = zamba2.pick(flat, f"shared.{j % m['num_mem_blocks']}")
        ap = zamba2.pick(flat, f"adapter.{j}")
        st = pre + "shared_transformer."
        ff = st + "feed_forward."
        sd.update({
            pre + "linear.weight": flat[f"linear.{j}"].T,
            st + "input_layernorm.weight": bp["attn_ln"],
            st + "pre_ff_layernorm.weight": bp["mlp_ln"],
            **{st + f"self_attn.{n}_proj.weight":
               bp[f"w{n}"].reshape(2 * d, nq * dh).T for n in "qkv"},
            st + "self_attn.o_proj.weight": bp["wo"].reshape(nq * dh, d).T,
            ff + "gate_up_proj.weight":
                torch.cat([bp["w_gate"], bp["w_up"]], 1).T,
            ff + "down_proj.weight": bp["w_down"].T,
            ff + f"gate_up_proj_adapter_list.{j}.0.weight": ap["a"].T,
            ff + f"gate_up_proj_adapter_list.{j}.1.weight":
                torch.cat([ap["b_gate"], ap["b_up"]], 1).T})
    missing, unexpected = model.load_state_dict(
        {k: v.contiguous() for k, v in sd.items()}, strict=False)
    assert not unexpected and not [k for k in missing if "adapter" not in k]
    return model


def test_reference_matches_transformers_zamba2():
    """The reference's logits are `Zamba2ForCausalLM`'s (its plain-torch
    path) on the same weights: chunks of 256 there, the scan here over
    the same 64 tokens."""
    m, flat = tiny_weights()
    toks = torch.randint(0, m["vocab_size"], (64,),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = hf_model(m, flat)(toks[None], use_cache=False).logits[0]
        got = zamba2.logits(flat, toks, m)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_program_matches_reference_loss_and_gradients():
    """The program's published hybrid (`models.hybrid`, plain kernels on
    the CPU) over the benchmark's weights: loss and every leaf's gradient
    the reference's, within float32 rounding."""
    from repro_torch.models.dims import make_dims
    from repro_torch.train.step import make_grad_fn
    m, flat = tiny_weights(11)
    arch = tiny_arch()
    dims = make_dims(arch, compute_dtype=torch.float32,
                     param_dtype=torch.float32)
    tr = {"seq_len": 32, "micro_batch": 2, "accum": 1, "vocab": 256}
    b = tokens.batch(tr, 5, 0, "cpu")
    loss, _, grads = make_grad_fn(arch, dims)(
        weights_hybrid.program_params(flat), b)
    ps = {k: v.detach().requires_grad_() for k, v in flat.items()}
    want = sum(zamba2.loss(ps, t, lab, m) for t, lab in
               zip(b["tokens"], b["labels"])) / 2
    gw = dict(zip(ps, torch.autograd.grad(want, list(ps.values()))))
    want = float(want.detach())
    assert abs(float(loss) - want) <= 1e-6 * abs(want)
    for k, g in weights_hybrid.flat_params(grads).items():
        scale = float(gw[k].abs().max())
        assert float((g - gw[k]).abs().max()) <= 1e-4 * scale + 1e-9, k


def test_program_tree_is_the_programs_own_layout():
    """`program_params` puts every leaf where the program's init does, at
    its shape; `flat_params` inverts it."""
    from repro_torch.common.treeutil import tree_flatten
    from repro_torch.models.api import get_model
    from repro_torch.models.dims import make_dims
    m, flat = tiny_weights()
    arch = tiny_arch()
    dims = make_dims(arch, compute_dtype=torch.float32,
                     param_dtype=torch.float32)
    own = get_model(arch).init(torch.Generator().manual_seed(0), arch, dims,
                               "cpu")
    mine = weights_hybrid.program_params(flat)
    (a, ta), (b, tb) = tree_flatten(own), tree_flatten(mine)
    assert ta == tb and [x.shape for x in a] == [x.shape for x in b]
    back = weights_hybrid.flat_params(mine)
    assert back.keys() == flat.keys()
    assert all(back[k] is flat[k] for k in flat)


def test_weights_are_drawn_again_the_same():
    """The runner draws the first weights again where it needs them: the
    same seed gives the same bits, another seed others; dt lies in
    [time_step_min, time_step_max] and A in [1, 16]."""
    m = tiny_config()["model"]
    a, b = (weights_hybrid.make(m, 2 ** 40 + 3, "cpu") for _ in range(2))
    c = weights_hybrid.make(m, 2 ** 40 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    dt = torch.nn.functional.softplus(torch.stack(
        [v for k, v in a.items() if k.endswith(".dt_bias")]))
    assert float(dt.min()) >= 0.999e-3 and float(dt.max()) <= 0.1001
    A = torch.exp(torch.stack([v for k, v in a.items()
                               if k.endswith(".A_log")]))
    assert float(A.min()) >= 1.0 and float(A.max()) <= 16.0


def test_bridge_cuts_the_program_to_the_files_layers():
    cfg = harness.load_json(HERE / "configs" / "zamba2-7b-instruct.json")
    arch = model_hybrid.program_arch(cfg)
    assert arch.n_layers == 24 and arch.hybrid_layers == (6, 11, 17, 23)
    assert 2.7e9 < arch.param_count() < 2.8e9
    bad = tiny_config()
    with pytest.raises(ValueError):
        model_hybrid.program_arch(bad)          # widths differ
    cut = harness.load_json(HERE / "configs" / "zamba2-7b-instruct.json")
    cut["model"]["layers_block_type"][5] = "hybrid"
    with pytest.raises(ValueError):
        model_hybrid.program_arch(cut)          # not the first layers


def test_config_files_model_group_copies_its_top_level():
    """The file states the model's keys at its top level, as the
    published config does, and again under `model`, where the readers
    the cell shares with `qwen2-0.5b.train_4k` look: the two agree, and
    the top level holds the published layer pattern cut to its depth."""
    cfg = harness.load_json(HERE / "configs" / "zamba2-7b-instruct.json")
    assert {k: cfg[k] for k in cfg["model"]} == cfg["model"]
    n = cfg["num_hidden_layers"]
    assert len(cfg["layers_block_type"]) == n == 24
    assert cfg["hybrid_layer_ids"] == [
        i for i, t in enumerate(cfg["layers_block_type"]) if t == "hybrid"]
    assert set(cfg["reduced"]) <= set(cfg)
