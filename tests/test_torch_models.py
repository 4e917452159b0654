"""The port's transformer family (`repro_torch.models`, dense and MoE)
against the JAX package's (`repro.models`) on the CPU, on every dense and
MoE architecture's `.reduced()` config in float32.

JAX and torch draw different random numbers, so the weights are the
reference's own `init(PRNGKey(0))`, carried across by
`repro_torch.models.convert.params_from_numpy`; the inputs are made with
numpy from a seed and handed to both. On CPU tensors `chunked_attention`
is the reference's online-softmax loop, so what differs is the order in
which the two frameworks sum.

Bars (stated here, used throughout): `F32` atol 1e-5 / rtol 1e-5 on
hidden states, caches, logits and losses, whose values are O(1) to O(10)
at these widths; the measured differences are below 1e-6, the size of a
few float32 roundings of such values summed in another order. Integer
outputs (expert indices, capacity slots) are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced
from repro.common import treeutil as jtree
from repro.common.config import get_arch as jget_arch
from repro.common.config import list_archs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.dims import make_dims as jmake_dims
from repro.models.loss import lm_loss as jlm_loss
from repro_torch.common import treeutil as ttree
from repro_torch.common.config import get_arch as tget_arch
from repro_torch.models import api as tapi
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import array_to_tensor, params_from_numpy
from repro_torch.models.dims import make_dims as tmake_dims
from repro_torch.models.loss import lm_loss as tlm_loss

F32 = dict(atol=1e-5, rtol=1e-5)
#: every dense and MoE architecture of the registry
ARCHS = [a for a in list_archs() if jget_arch(a).family in ("dense", "moe")]
DENSE = [a for a in ARCHS if jget_arch(a).family == "dense"]
B, S = 2, 16


def _t(a, dtype=None):
    """A numpy array as a CPU tensor (a copy)."""
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _close(got, want, what="", **tol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), err_msg=what, **(tol or F32))


def _port(arch):
    cfg = tget_arch(arch).reduced()
    return cfg, tmake_dims(cfg, tp=1, param_dtype=torch.float32,
                           compute_dtype=torch.float32)


def _inputs(cfg, seed=0):
    """Numpy inputs of the forward: tokens, or (embed frontend) embeddings
    and M-RoPE positions whose three streams differ; labels with a masked
    tail; the decode step's token or embedding."""
    rs = np.random.RandomState(seed)
    out = {"labels": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][:, -3:] = -1
    if cfg.frontend == "embed":
        out["embeds"] = (rs.randn(B, S, cfg.d_model) * 0.1).astype(np.float32)
        if cfg.attention.mrope:
            out["positions"] = np.stack(
                [np.broadcast_to(np.arange(S)[None] * m, (B, S))
                 for m in (0, 1, 2)]).astype(np.int32)
        out["step"] = {"embed": (rs.randn(B, cfg.d_model) * 0.1)
                       .astype(np.float32)}
    else:
        out["tokens"] = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
        out["step"] = {"token": rs.randint(0, cfg.vocab_size, (B,))
                       .astype(np.int32)}
    return out


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both packages' outputs for one architecture, from one set of
    weights and inputs: forward (train), train_loss, prefill, and a decode
    step at position S over a state seeded with the prefill caches."""
    arch = request.param
    jcfg, jdims = reduced(arch)
    jparams = JT.init(jax.random.PRNGKey(0), jcfg, jdims)
    x = _inputs(jcfg)
    keys = ("tokens", "embeds", "positions", "labels")
    jbatch = {k: jnp.asarray(x[k]) for k in keys if k in x}
    jstep = {k: jnp.asarray(v) for k, v in x["step"].items()}

    def ref(params, batch, step):
        fwd = {k: batch[k] for k in ("tokens", "embeds", "positions")
               if k in batch}
        h, aux, _ = JT.forward(params, jcfg, jdims, mode="train", **fwd)
        loss, metrics = JT.train_loss(params, batch, jcfg, jdims)
        logits, caches = JT.prefill(params, fwd, jcfg, jdims)
        st = JT.init_decode_state(jcfg, jdims, B, S + 4)
        st = {k: st[k].at[:, :, :S].set(caches[k]) for k in st}
        dlogits, st2 = JT.decode_step(params, st, jcfg, jdims, pos=S, **step)
        return dict(h=h, aux=aux, loss=loss, xent=metrics["xent"],
                    logits=logits, k=caches["k"], v=caches["v"],
                    dlogits=dlogits, dk=st2["k"], dv=st2["v"])

    want = jax.tree.map(np.asarray, jax.jit(ref)(jparams, jbatch, jstep))
    cfg, dims = _port(arch)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(arch=arch, cfg=cfg, dims=dims, params=params, x=x, want=want)


def _fwd_kw(x):
    return {k: _t(x[k]) for k in ("tokens", "embeds", "positions") if k in x}


def test_every_dense_and_moe_arch_is_covered():
    assert len(ARCHS) == 7
    assert {jget_arch(a).family for a in ARCHS} == {"dense", "moe"}
    assert any(jget_arch(a).attention.mrope for a in ARCHS)


def test_forward_matches_reference(pair):
    h, aux, caches = TT.forward(pair["params"], pair["cfg"], pair["dims"],
                                mode="train", **_fwd_kw(pair["x"]))
    assert caches is None
    _close(h, pair["want"]["h"], "hidden states")
    _close(aux, pair["want"]["aux"], "aux loss")


def test_train_loss_value_matches_reference(pair):
    batch = _fwd_kw(pair["x"])
    batch["labels"] = _t(pair["x"]["labels"])
    loss, metrics = TT.train_loss(pair["params"], batch, pair["cfg"],
                                  pair["dims"])
    _close(loss, pair["want"]["loss"], "loss")
    _close(metrics["xent"], pair["want"]["xent"], "xent")
    assert float(metrics["tokens"]) == B * (S - 3)


def test_prefill_matches_reference(pair):
    logits, caches = TT.prefill(pair["params"], _fwd_kw(pair["x"]),
                                pair["cfg"], pair["dims"])
    v = pair["cfg"].vocab_size
    _close(logits[:, :v], pair["want"]["logits"][:, :v], "prefill logits")
    assert torch.isinf(logits[:, v:]).all()
    _close(caches["k"], pair["want"]["k"], "k cache")
    _close(caches["v"], pair["want"]["v"], "v cache")


def test_decode_step_matches_reference(pair):
    cfg, dims, params = pair["cfg"], pair["dims"], pair["params"]
    _, caches = TT.prefill(params, _fwd_kw(pair["x"]), cfg, dims)
    st = TT.init_decode_state(cfg, dims, B, S + 4, device="cpu")
    for k in st:
        st[k][:, :, :S] = caches[k]
    step = {k: _t(v) for k, v in pair["x"]["step"].items()}
    logits, st2 = TT.decode_step(params, st, cfg, dims, pos=S, **step)
    v = cfg.vocab_size
    _close(logits[:, :v], pair["want"]["dlogits"][:, :v], "decode logits")
    _close(st2["k"], pair["want"]["dk"], "decode k state")
    _close(st2["v"], pair["want"]["dv"], "decode v state")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """The port's own check, as the reference's `test_decode_matches_forward`:
    token-by-token decode from an empty state reproduces the full forward's
    logits at every position, with the port's own init. Dense archs only:
    an MoE block's capacity depends on the number of tokens in the call,
    so a forward over 16 tokens may drop what a decode step of 2 keeps."""
    cfg, dims = _port(arch)
    params = TT.init(torch.Generator().manual_seed(3), cfg, dims, "cpu")
    x = _inputs(cfg, seed=3)
    if cfg.frontend == "embed":
        seq = _t(x["embeds"][:, :8])
        h, _, _ = TT.forward(params, cfg, dims, embeds=seq, mode="prefill")
        step = lambda t: {"embed": seq[:, t]}
    else:
        seq = _t(x["tokens"][:, :8])
        h, _, _ = TT.forward(params, cfg, dims, tokens=seq, mode="prefill")
        step = lambda t: {"token": seq[:, t]}
    head = TT._head_matrix(params, dims)
    st = TT.init_decode_state(cfg, dims, B, 8, device="cpu")
    for t in range(8):
        lg, st = TT.decode_step(params, st, cfg, dims, pos=t, **step(t))
        want = torch.einsum("bd,dv->bv", h[:, t], head)
        _close(lg[:, :cfg.vocab_size], want[:, :cfg.vocab_size].numpy(),
               f"position {t}")


# ------------------------------------------------------------ layer level

def test_rmsnorm_matches_reference():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 24).astype(np.float32)
    w = rs.randn(24).astype(np.float32)
    x[..., 20:] = 0.0                        # padded channels
    for n in (None, 20):
        _close(TL.rmsnorm(_t(x), _t(w), 1e-6, n=n),
               JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6, n=n))


@pytest.mark.parametrize("sections", [None, (2, 3, 3), (4, 2, 2)])
def test_rope_matches_reference(sections):
    rs = np.random.RandomState(2)
    d, s = 16, 9
    if sections is None:
        pos = rs.randint(0, 4096, (2, s)).astype(np.int32)
    else:
        pos = rs.randint(0, 4096, (3, 2, s)).astype(np.int32)
    sin, cos = TL.rope_angles(_t(pos), d, 1e6, sections)
    jsin, jcos = JL.rope_angles(jnp.asarray(pos), d, 1e6, sections)
    _close(sin, jsin, "sin")
    _close(cos, jcos, "cos")
    x = rs.randn(2, s, 3, d).astype(np.float32)
    _close(TL.apply_rope(_t(x), sin, cos),
           JL.apply_rope(jnp.asarray(x), jsin, jcos))


def test_mrope_with_equal_streams_is_1d_rope():
    pos = np.broadcast_to(np.arange(8)[None], (1, 8)).astype(np.int32)
    sin3, _ = TL.rope_angles(_t(np.stack([pos] * 3)), 16, 1e4, (2, 3, 3))
    sin1, _ = TL.rope_angles(_t(pos), 16, 1e4)
    torch.testing.assert_close(sin3, sin1, atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "sq,skv,hq,hkv,causal,q_off,qb,kb",
    [(16, 16, 4, 4, True, 0, 1024, 1024),
     (16, 16, 4, 1, False, 0, 4, 8),          # GQA group 4, several blocks
     (8, 24, 6, 2, True, 16, 4, 8),            # Sq != Skv, q_offset
     (24, 8, 4, 2, False, 0, 8, 4),
     (12, 12, 2, 2, True, 0, 4, 6)])
def test_chunked_attention_matches_reference(sq, skv, hq, hkv, causal, q_off,
                                             qb, kb):
    rs = np.random.RandomState(sq + skv)
    q = rs.randn(2, sq, hq, 8).astype(np.float32)
    k, v = (rs.randn(2, skv, hkv, 8).astype(np.float32) for _ in range(2))
    got = TL.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                               q_block=qb, kv_block=kb, q_offset=q_off)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, q_block=qb,
                                kv_block=kb, q_offset=q_off)
    _close(got, want)


@pytest.mark.parametrize("s,causal", [(300, True), (64, True), (256, False),
                                      (128, True)])
def test_card_attention_layout_and_padding(s, causal):
    """What `chunked_attention` does on the card around kernel E — the
    [B·Hq, S, D] layout, GQA expansion, and the end padding of a causal
    self-attention to a multiple of 128 rows — run here with E's plain
    version (the wrapper's path for CPU tensors): it equals the plain
    loop."""
    rs = np.random.RandomState(s)
    q = _t(rs.randn(2, s, 4, 16).astype(np.float32))
    k, v = (_t(rs.randn(2, s, 2, 16).astype(np.float32)) for _ in range(2))
    got = TL._flash_on_card(q, k, v, causal=causal, q_offset=0)
    torch.testing.assert_close(
        got, TL.chunked_attention(q, k, v, causal=causal), atol=2e-5,
        rtol=2e-5)


@pytest.mark.parametrize("sq,skv,causal,q_off,what", [
    (300, 300, False, 0, "non-causal"),
    (300, 200, True, 0, "Sq != Skv"),
    (128, 128, True, 4, "q_offset")])
def test_card_attention_raises_where_kernel_e_cannot_compute(sq, skv, causal,
                                                             q_off, what):
    q = torch.zeros((1, sq, 2, 16))
    k = torch.zeros((1, skv, 2, 16))
    with pytest.raises(ValueError, match=what):
        TL._flash_on_card(q, k, k, causal=causal, q_offset=q_off)


def test_decode_attention_matches_reference():
    rs = np.random.RandomState(3)
    q = rs.randn(2, 1, 6, 8).astype(np.float32)
    kc, vc = (rs.randn(2, 10, 2, 8).astype(np.float32) for _ in range(2))
    _close(TL.decode_attention(_t(q), _t(kc), _t(vc), 7, 3),
           JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(7), 3))


def test_gated_mlp_matches_reference():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 3, 8).astype(np.float32)
    wi, wg = (rs.randn(8, 12).astype(np.float32) for _ in range(2))
    wd = rs.randn(12, 8).astype(np.float32)
    _close(TL.gated_mlp(*map(_t, (x, wi, wg, wd))),
           JL.gated_mlp(*map(jnp.asarray, (x, wi, wg, wd))))


@pytest.mark.parametrize("top_k,capacity", [(2, 8), (1, 8), (2, 3)])
def test_moe_route_and_dispatch_match_reference(top_k, capacity):
    """Router indices and capacity slots exactly; weights, probs, the
    expert outputs (with drops past a capacity of 3) and the aux loss
    within the bar."""
    rs = np.random.RandomState(5 + top_k + capacity)
    t, d, e, f = 24, 8, 4, 16
    x = rs.randn(t, d).astype(np.float32)
    wr = rs.randn(d, e).astype(np.float32)
    we_i, we_g = (rs.randn(e, d, f).astype(np.float32) * 0.1 for _ in "ig")
    we_o = rs.randn(e, f, d).astype(np.float32) * 0.1
    idx, w, probs = TL.moe_route(_t(x), _t(wr), top_k)
    jidx, jw, jprobs = JL.moe_route(jnp.asarray(x), jnp.asarray(wr), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw)
    _close(probs, jprobs)
    slot = TL.moe_positions(idx, e, capacity)
    jslot = JL.moe_positions(jidx, e, capacity)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    for off in (0, 2):                        # two halves of the experts
        got = TL.moe_apply_local(_t(x), idx, w, slot, _t(we_i[off:off + 2]),
                                 _t(we_g[off:off + 2]), _t(we_o[off:off + 2]),
                                 capacity=capacity, expert_offset=off)
        want = JL.moe_apply_local(
            jnp.asarray(x), jidx, jw, jslot, jnp.asarray(we_i[off:off + 2]),
            jnp.asarray(we_g[off:off + 2]), jnp.asarray(we_o[off:off + 2]),
            capacity=capacity, expert_offset=off)
        _close(got, want)
    _close(TL.moe_aux_loss(probs, idx, e), JL.moe_aux_loss(jprobs, jidx, e))


def test_dims_padding_rules():
    """As the reference's `test_dims_padding_rules`."""
    for arch, tp, want in [("llama4-maverick-400b-a17b", 16, 48),
                           ("qwen2.5-14b", 16, 48),
                           ("qwen2-0.5b", 16, 16),
                           ("qwen2-vl-72b", 16, 64)]:
        cfg = tget_arch(arch)
        dims = tmake_dims(cfg, tp=tp)
        assert dims.n_q == want, (arch, dims.n_q)
        assert dims.n_q % cfg.attention.n_kv_heads == 0
        assert dims.compute_dtype == torch.bfloat16
    assert tget_arch("mamba2-130m").padded_vocab == 50304
    assert tget_arch("seamless-m4t-large-v2").padded_vocab % 128 == 0
    assert tmake_dims(tget_arch("mamba2-130m"), tp=16).ssm_heads == 32
    for arch in list_archs():
        for tp in (1, 8, 16):
            j, t = jmake_dims(jget_arch(arch), tp=tp), tmake_dims(
                tget_arch(arch), tp=tp)
            assert ((t.n_q, t.n_kv, t.kv_sharded, t.vocab, t.ssm_heads,
                     t.d_inner) == (j.n_q, j.n_kv, j.kv_sharded, j.vocab,
                                    j.ssm_heads, j.d_inner)), (arch, tp)


def test_head_padding_is_inert():
    """Padded q heads (tp=8: 4 -> 8) do not change the attention output,
    as the reference's `test_head_padding_is_inert` states it."""
    cfg = tget_arch("qwen2-0.5b").reduced()
    att = cfg.attention
    dims1 = tmake_dims(cfg, tp=1, param_dtype=torch.float32,
                       compute_dtype=torch.float32)
    dims8 = tmake_dims(cfg, tp=8, param_dtype=torch.float32,
                       compute_dtype=torch.float32)
    assert dims8.n_q > dims1.n_q
    p1 = TB.init_attn(torch.Generator().manual_seed(0), dims1, "cpu",
                      out_scale=0.02)
    p8 = TB.init_attn(torch.Generator().manual_seed(0), dims8, "cpu",
                      out_scale=0.02)
    # the padded heads are zero at init, in wq and wo
    assert not p8["wq"][:, att.n_heads:].any()
    assert not p8["wo"][att.n_heads:].any()
    for k in ("wq", "wo", "bq"):
        pad = torch.zeros_like(p8[k])
        if k == "wq":
            pad[:, :dims1.n_q] = p1[k]
        else:
            pad[:dims1.n_q] = p1[k]
        p8[k] = pad
    for k in ("ln", "wk", "wv", "bk", "bv"):
        p8[k] = p1[k]
    rs = np.random.RandomState(0)
    h = _t(rs.randn(2, 16, cfg.d_model).astype(np.float32))
    pos = torch.arange(16)[None].expand(2, 16)
    sin, cos = TL.rope_angles(pos, att.head_dim, att.rope_theta)
    y1, _ = TB.apply_attn(p1, h, dims1, sin=sin, cos=cos, causal=True)
    y8, _ = TB.apply_attn(p8, h, dims8, sin=sin, cos=cos, causal=True)
    torch.testing.assert_close(y1, y8, atol=1e-5, rtol=1e-5)


def test_lm_loss_matches_reference():
    rs = np.random.RandomState(6)
    h = rs.randn(2, 8, 16).astype(np.float32)
    head = rs.randn(16, 32).astype(np.float32)
    labels = rs.randint(0, 27, (2, 8)).astype(np.int32)
    labels[:, -1] = -1
    for block, z in ((4, 0.0), (8, 1e-4)):
        loss, m = tlm_loss(_t(h), _t(head), _t(labels), logical_vocab=27,
                           block=block, z_loss=z)
        jloss, jm = jlm_loss(jnp.asarray(h), jnp.asarray(head),
                             jnp.asarray(labels), logical_vocab=27,
                             block=block, z_loss=z)
        _close(loss, jloss)
        _close(m["xent"], jm["xent"])
        assert float(m["tokens"]) == float(jm["tokens"]) == 14


def test_params_from_numpy_keeps_keys_layouts_and_bf16():
    """A bf16 JAX leaf comes out of `np.asarray` as ml_dtypes.bfloat16,
    which `torch.from_numpy` refuses: the conversion goes through a
    uint16 view, bit for bit."""
    cfg, dims = reduced("qwen3-moe-235b-a22b")
    dims = jmake_dims(cfg, tp=1)                          # bf16 params
    jp = JT.init(jax.random.PRNGKey(1), cfg, dims)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert ttree.flat_paths(tp) == jtree.flat_paths(jp)
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            ttree.tree_leaves(tp)):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, path
        if j.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)
    assert tp["layers"]["attn"]["wq"].shape[0] == cfg.n_layers
    f32 = array_to_tensor(np.asarray(jp["embed"]), "cpu", torch.float32)
    np.testing.assert_array_equal(f32.numpy(),
                                  np.asarray(jp["embed"], np.float32))


def test_treeutil_matches_reference():
    cfg, dims = reduced("llama4-maverick-400b-a17b")
    jp = JT.init(jax.random.PRNGKey(2), cfg, dims)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert ttree.tree_param_count(tp) == jtree.tree_param_count(jp)
    assert ttree.tree_bytes(tp) == jtree.tree_bytes(jp)
    assert ttree.flat_paths(tp) == jtree.flat_paths(jp)
    assert bool(ttree.tree_allfinite(tp))
    tp["final_ln"][0] = float("nan")
    assert not bool(ttree.tree_allfinite(tp))
    z = ttree.tree_zeros_like(tp)
    assert ttree.flat_paths(z) == ttree.flat_paths(tp)
    assert not any(x.any() for x in ttree.tree_leaves(z))


@pytest.mark.parametrize("arch", list_archs())
def test_config_copy_equals_reference(arch):
    j, t = jget_arch(arch), tget_arch(arch)
    assert repr(t) == repr(j)
    assert repr(t.reduced()) == repr(j.reduced())
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("family_arch", ["mamba2-130m", "zamba2-7b",
                                         "seamless-m4t-large-v2"])
def test_families_still_to_port_raise(family_arch):
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        tapi.get_model(tget_arch(family_arch))


def test_init_shapes_and_masks():
    """The port's own init: shapes of the reference's params, padded q
    heads zero, tied embeddings without an lm_head, draws from the
    generator (another seed, other weights)."""
    cfg, dims = _port("qwen2-0.5b")
    a = TT.init(torch.Generator().manual_seed(0), cfg, dims, "cpu")
    b = TT.init(torch.Generator().manual_seed(1), cfg, dims, "cpu")
    jcfg, jdims = reduced("qwen2-0.5b")
    shapes = jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0), jcfg,
                                            jdims))
    assert ttree.flat_paths(a) == jtree.flat_paths(shapes)
    for t, j in zip(ttree.tree_leaves(a), jax.tree.leaves(shapes)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    assert "lm_head" not in a
    assert not torch.equal(a["embed"], b["embed"])
    torch.testing.assert_close(a["embed"].std(), torch.tensor(0.02),
                               atol=2e-3, rtol=0)
