"""The port's mamba, hybrid and encoder-decoder families
(`repro_torch.models.mamba`, `.hybrid`, `.encdec`) against the JAX
package's on the CPU, at mamba2-130m's, zamba2-7b's and
seamless-m4t-large-v2's `.reduced()` configs in float32 (and a hybrid
with a Mamba tail: 14 layers, `attn_every` 6, 2 groups and 2 tail
layers); their new layers one by one; and what the card routes do around
kernels E and F, run here with the kernels' plain versions.

JAX and torch draw different random numbers, so the weights are the
reference's own `init(PRNGKey(0))`, carried across by
`repro_torch.models.convert.params_from_numpy`; the inputs are made with
numpy from a seed and handed to both. On CPU tensors the SSD is the
reference's chunked loop and the attention its online-softmax loop, so
what differs is the order in which the two frameworks sum.

Bars (stated here, used throughout): `F32` atol 1e-5 / rtol 1e-5 on
hidden states, states, logits and losses, whose values are O(1) to O(10)
at these widths; the measured differences are below 1e-6, a few float32
roundings of such values summed in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_arch as jget_arch
from repro.models import api as japi
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models.dims import make_dims as jmake_dims
from repro_torch.common import treeutil as ttree
from repro_torch.common.config import get_arch as tget_arch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.models import api as tapi
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.dims import make_dims as tmake_dims

F32 = dict(atol=1e-5, rtol=1e-5)
B, S, T = 2, 32, 20                    # batch, tokens, encoder frames
#: the three families' reduced configs, and a hybrid with a Mamba tail
CASES = ("mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2", "zamba2-tail")


def _cfg(case, get_arch):
    if case == "zamba2-tail":
        return dataclasses.replace(get_arch("zamba2-7b").reduced(),
                                   n_layers=14)
    return get_arch(case).reduced()


def _jax_side(case):
    cfg = _cfg(case, jget_arch)
    return cfg, jmake_dims(cfg, tp=1, param_dtype=jnp.float32,
                           compute_dtype=jnp.float32)


def _port(case):
    cfg = _cfg(case, tget_arch)
    return cfg, tmake_dims(cfg, tp=1, param_dtype=torch.float32,
                           compute_dtype=torch.float32)


def _t(a, dtype=None):
    """A numpy array as a CPU tensor (a copy)."""
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, what="", **tol):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                               **(tol or F32))


def _close_trees(got, want, what):
    """Every leaf of the port's state tree against the reference's, the
    leaves named alike (a `None` subtree has no leaves in either)."""
    jpaths = ["/".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(want)[0]]
    assert ttree.flat_paths(got) == jpaths, what
    for path, g, w in zip(jpaths, ttree.tree_leaves(got),
                          jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape, (what, path)
        _close(g, w, f"{what} {path}")


def _inputs(cfg, seed=0):
    rs = np.random.RandomState(seed)
    x = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "token": rs.randint(0, cfg.vocab_size, (B,)).astype(np.int32)}
    x["labels"][:, -3:] = -1
    if cfg.family == "encdec":
        x["enc_embeds"] = rs.randn(B, T, cfg.d_model).astype(np.float32)
    return x


def _seed_state(mod, cfg, dims, pre, kv_len, zeros_like):
    """A decode state of `kv_len` positions holding a prefill's state:
    the K/V caches' first rows, the Mamba and cross states whole.
    `zeros_like` is the family's `init_decode_state` (either package)."""
    fam = cfg.family
    if fam == "ssm":
        return pre
    st = zeros_like()
    if fam == "hybrid":
        st["groups_mamba"], st["tail_mamba"] = (pre["groups_mamba"],
                                                pre["tail_mamba"])
    else:
        st["ck"], st["cv"] = pre["ck"], pre["cv"]
    n = pre["k"].shape[2]
    for key in ("k", "v"):
        if isinstance(st[key], torch.Tensor):
            st[key][:, :, :n] = pre[key]
        else:
            st[key] = st[key].at[:, :, :n].set(pre[key])
    return st


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    """Both packages' outputs for one config, from one set of weights and
    inputs: the forward's hidden states (encdec: the encoder's and the
    decoder stack's), train_loss, prefill, and a decode step from a
    state seeded with the prefill's."""
    case = request.param
    jcfg, jdims = _jax_side(case)
    jm = japi.get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0), jcfg, jdims)
    x = _inputs(jcfg)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    enc = jcfg.family == "encdec"

    def ref(params, j):
        out = {}
        if enc:
            enc_h = jm.encode(params, jcfg, jdims, j["enc_embeds"])
            out["enc_h"] = enc_h
            out["h"], _ = jm._decode_stack(params, jcfg, jdims, j["tokens"],
                                           enc_h, "train")
            batch = {"enc_embeds": j["enc_embeds"]}
            kv_len = 4
            make = lambda: jm.init_decode_state(jcfg, jdims, B, kv_len,
                                                enc_len=T)
            pos = 1
        else:
            out["h"], _ = jm.forward(params, jcfg, jdims, tokens=j["tokens"])
            batch = {"tokens": j["tokens"]}
            kv_len = S + 4
            make = lambda: jm.init_decode_state(jcfg, jdims, B, kv_len)
            pos = S
        out["loss"], m = jm.train_loss(
            params, {**batch, "tokens": j["tokens"], "labels": j["labels"]},
            jcfg, jdims)
        out["xent"] = m["xent"]
        out["logits"], out["state"] = jm.prefill(params, batch, jcfg, jdims)
        st = _seed_state(jm, jcfg, jdims, out["state"], kv_len, make)
        out["dlogits"], out["dstate"] = jm.decode_step(
            params, st, jcfg, jdims, token=j["token"], pos=pos)
        return out

    want = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                        jax.jit(ref)(jparams, j))
    cfg, dims = _port(case)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(case=case, cfg=cfg, dims=dims, params=params, x=x,
                want=want, mod=tapi.get_model(cfg))


def _batch(pair, *keys):
    return {k: _t(pair["x"][k]) for k in keys if k in pair["x"]}


def test_get_model_returns_a_module_for_every_family():
    fams = {}
    for name in ("qwen2-0.5b", "qwen3-moe-235b-a22b", "mamba2-130m",
                 "zamba2-7b", "seamless-m4t-large-v2"):
        cfg = tget_arch(name)
        fams[cfg.family] = tapi.get_model(cfg).__name__
    assert fams == {"dense": "repro_torch.models.transformer",
                    "moe": "repro_torch.models.transformer",
                    "ssm": "repro_torch.models.mamba",
                    "hybrid": "repro_torch.models.hybrid",
                    "encdec": "repro_torch.models.encdec"}


def test_hybrid_split_and_tail():
    """zamba2-7b: 13 groups of 5 Mamba layers and the shared block, then a
    3-layer tail; the reduced config has no tail, the 14-layer one 2."""
    from repro.models import hybrid as JH
    from repro_torch.models import hybrid as TH
    for cfg in (tget_arch("zamba2-7b"), tget_arch("zamba2-7b").reduced(),
                _cfg("zamba2-tail", tget_arch)):
        assert TH._split(cfg) == JH._split(cfg)
    assert TH._split(tget_arch("zamba2-7b")) == (13, 5, 3)
    assert TH._split(_cfg("zamba2-tail", tget_arch)) == (2, 5, 2)


def test_forward_matches_reference(pair):
    M, cfg, dims, params = pair["mod"], pair["cfg"], pair["dims"], \
        pair["params"]
    if cfg.family == "encdec":
        enc_h = M.encode(params, cfg, dims, _t(pair["x"]["enc_embeds"]))
        _close(enc_h, pair["want"]["enc_h"], "encoder output")
        h, ys = M._decode_stack(params, cfg, dims, _t(pair["x"]["tokens"]),
                                enc_h, "train")
    else:
        h, ys = M.forward(params, cfg, dims, tokens=_t(pair["x"]["tokens"]))
    assert ys is None
    _close(h, pair["want"]["h"], "hidden states")


def test_train_loss_value_matches_reference(pair):
    M, cfg, dims = pair["mod"], pair["cfg"], pair["dims"]
    loss, metrics = M.train_loss(
        pair["params"], _batch(pair, "tokens", "labels", "enc_embeds"), cfg,
        dims)
    _close(loss, pair["want"]["loss"], "loss")
    _close(metrics["xent"], pair["want"]["xent"], "xent")
    assert float(metrics["tokens"]) == B * (S - 3)


def _prefill(pair):
    keys = ("enc_embeds",) if pair["cfg"].family == "encdec" else ("tokens",)
    return pair["mod"].prefill(pair["params"], _batch(pair, *keys),
                               pair["cfg"], pair["dims"])


def test_prefill_matches_reference(pair):
    """Logits and every leaf of the decode state: each Mamba layer's SSD
    state and conv tails, the shared attention's K/V of each group, the
    encoder-decoder's self and cross K/V."""
    logits, state = _prefill(pair)
    v = pair["cfg"].vocab_size
    _close(logits[:, :v], pair["want"]["logits"][:, :v], "prefill logits")
    assert torch.isinf(logits[:, v:]).all()
    _close_trees(state, pair["want"]["state"], "prefill state")


def test_decode_step_matches_reference(pair):
    M, cfg, dims, params = pair["mod"], pair["cfg"], pair["dims"], \
        pair["params"]
    _, pre = _prefill(pair)
    enc = cfg.family == "encdec"
    kv_len = 4 if enc else S + 4
    make = ((lambda: M.init_decode_state(cfg, dims, B, kv_len, enc_len=T,
                                         device="cpu")) if enc else
            (lambda: M.init_decode_state(cfg, dims, B, kv_len,
                                         device="cpu")))
    st = _seed_state(M, cfg, dims, pre, kv_len, make)
    logits, st2 = M.decode_step(params, st, cfg, dims,
                                token=_t(pair["x"]["token"]),
                                pos=1 if enc else S)
    v = cfg.vocab_size
    _close(logits[:, :v], pair["want"]["dlogits"][:, :v], "decode logits")
    _close_trees(st2, pair["want"]["dstate"], "decode state")


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_forward(case):
    """The port's own check, as the reference's
    `tests/test_system.py::test_decode_matches_forward`: token-by-token
    decode reproduces the full forward's logits at every position, with
    the port's own init. The encoder-decoder's prefix is its first token
    (a BOS prefill over the encoded frames), then decode steps."""
    cfg, dims = _port(case)
    M = tapi.get_model(cfg)
    params = M.init(torch.Generator().manual_seed(3), cfg, dims, "cpu")
    x = _inputs(cfg, seed=3)
    n = 8
    toks = _t(x["tokens"][:, :n])
    head = (params["embed"].T if cfg.family == "ssm" else params["lm_head"])
    if cfg.family == "encdec":
        frames = _t(x["enc_embeds"])
        enc_h = M.encode(params, cfg, dims, frames)
        h, _ = M._decode_stack(params, cfg, dims, toks, enc_h, "train")
        lg, pre = M.prefill(params, {"enc_embeds": frames,
                                     "tokens": toks[:, :1]}, cfg, dims)
        st = M.init_decode_state(cfg, dims, B, n, enc_len=T, device="cpu")
        st = _seed_state(M, cfg, dims, pre, n, lambda: st)
        got, first = [lg], 1
    else:
        h, _ = M.forward(params, cfg, dims, tokens=toks)
        st = M.init_decode_state(cfg, dims, B, n, device="cpu")
        got, first = [], 0
    for t in range(first, n):
        lg, st = M.decode_step(params, st, cfg, dims, token=toks[:, t],
                               pos=t)
        got.append(lg)
    v = cfg.vocab_size
    want = torch.einsum("bsd,dv->bsv", h, head)
    for t, lg in enumerate(got):
        _close(lg[:, :v], want[:, t, :v], f"{case} position {t}")


# ------------------------------------------------------------ layer level

def test_causal_depthwise_conv_matches_reference():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 6).astype(np.float32)
    w = rs.randn(6, 4).astype(np.float32)
    _close(TL.causal_depthwise_conv(_t(x), _t(w)),
           JL.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w)))


def test_ssd_decode_step_matches_reference():
    rs = np.random.RandomState(2)
    b, h, p, n = 2, 3, 4, 5
    x = rs.randn(b, h, p).astype(np.float32)
    dt = (np.abs(rs.randn(b, h)) * 0.1 + 0.01).astype(np.float32)
    A = (-np.abs(rs.randn(h)) - 0.1).astype(np.float32)
    Bi, Ci = (rs.randn(b, n).astype(np.float32) for _ in range(2))
    D = rs.randn(h).astype(np.float32)
    st = rs.randn(b, h, p, n).astype(np.float32)
    y, st2 = TL.ssd_decode_step(*map(_t, (x, dt, A, Bi, Ci, D, st)))
    jy, jst2 = JL.ssd_decode_step(*map(jnp.asarray, (x, dt, A, Bi, Ci, D,
                                                     st)))
    _close(y, jy, "y")
    _close(st2, jst2, "state")


@pytest.mark.parametrize("n", [None, 20])
def test_gated_rmsnorm_matches_reference(n):
    rs = np.random.RandomState(3)
    y, z = (rs.randn(2, 5, 24).astype(np.float32) for _ in range(2))
    y[..., 20:] = 0.0                         # padded channels
    w = rs.randn(24).astype(np.float32)
    _close(TL.gated_rmsnorm(_t(y), _t(z), _t(w), 1e-5, n=n),
           JL.gated_rmsnorm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(w),
                            1e-5, n=n))


def _ssd_args(b, s, h, p, n, seed):
    rs = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rs.randn(b, s, h, p), np.abs(rs.randn(b, s, h)) * 0.1 + 0.01,
        -np.abs(rs.randn(h)) - 0.1, rs.randn(b, s, n), rs.randn(b, s, n),
        rs.randn(h), rs.randn(b, h, p, n))]


@pytest.mark.parametrize("chunk,init", [(8, False), (16, True), (32, False)])
def test_ssd_chunked_matches_reference(chunk, init):
    """The plain loop (CPU) with the D residual, and an initial state."""
    *args, st = _ssd_args(2, 32, 3, 4, 6, seed=chunk)
    y, last = TL.ssd_chunked(*map(_t, args), chunk,
                             init_state=_t(st) if init else None)
    jy, jlast = JL.ssd_chunked(*map(jnp.asarray, args), chunk,
                               init_state=jnp.asarray(st) if init else None)
    _close(y, jy, "y")
    _close(last, jlast, "final state")


def _mamba_pair(seed=0):
    jcfg, jdims = _jax_side("mamba2-130m")
    jp = JB.init_mamba(jax.random.PRNGKey(seed), jdims, 0.02)
    cfg, dims = _port("mamba2-130m")
    return jdims, jp, dims, params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu")


@pytest.mark.parametrize("return_state", [False, True])
def test_apply_mamba_matches_reference(return_state):
    jdims, jp, dims, tp = _mamba_pair()
    h = np.random.RandomState(4).randn(2, 32, 64).astype(np.float32)
    out, st = TB.apply_mamba(tp, _t(h), dims, return_state=return_state)
    jout, jst = JB.apply_mamba(jp, jnp.asarray(h), jdims,
                               return_state=return_state)
    _close(out, jout, "h")
    if return_state:
        _close_trees(st, jst, "mamba state")
        assert ttree.flat_paths(st) == ttree.flat_paths(
            TB.mamba_state_shapes(dims, 2, "cpu"))
    else:
        _close(st, jst, "final SSD state")


def test_apply_mamba_decode_matches_reference():
    jdims, jp, dims, tp = _mamba_pair(1)
    rs = np.random.RandomState(5)
    h = rs.randn(2, 1, 64).astype(np.float32)
    shapes = TB.mamba_state_shapes(dims, 2, "cpu")
    st = {k: rs.randn(*v.shape).astype(np.float32) for k, v in
          shapes.items()}
    out, st2 = TB.apply_mamba_decode(tp, _t(h), dims,
                                     {k: _t(v) for k, v in st.items()})
    jout, jst2 = JB.apply_mamba_decode(
        jp, jnp.asarray(h), jdims, {k: jnp.asarray(v) for k, v in st.items()})
    _close(out, jout, "h")
    _close_trees(st2, jst2, "decode state")


@pytest.mark.parametrize("mode,sq", [("train", 5), ("decode", 1)])
def test_cross_kv_and_apply_cross_attn_match_reference(mode, sq):
    jcfg, jdims = _jax_side("seamless-m4t-large-v2")
    jp = JB.init_attn(jax.random.PRNGKey(6), jdims, out_scale=0.02)
    cfg, dims = _port("seamless-m4t-large-v2")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rs = np.random.RandomState(7)
    mem = rs.randn(2, T, 64).astype(np.float32)
    h = rs.randn(2, sq, 64).astype(np.float32)
    kv = TB.cross_kv(tp, _t(mem), dims)
    jkv = JB.cross_kv(jp, jnp.asarray(mem), jdims)
    _close(kv[0], jkv[0], "cross k")
    _close(kv[1], jkv[1], "cross v")
    _close(TB.apply_cross_attn(tp, _t(h), dims, kv=kv, mode=mode),
           JB.apply_cross_attn(jp, jnp.asarray(h), jdims, kv=jkv, mode=mode),
           "cross-attention")


# ------------------------------------------- the card routes, on the CPU

@pytest.mark.parametrize("sq,skv,causal", [
    (1, 300, False), (300, 300, False), (5, 20, False), (300, 20, False),
    (1000, 1000, False), (1, 1, True), (300, 300, True), (129, 129, True),
    (200, 300, True)])
def test_card_attention_takes_ragged_lengths(sq, skv, causal):
    """What `chunked_attention` does on the card around kernel E at the
    lengths the encoder-decoder and the hybrid give it: q padded at the
    end to E's 128-row blocks (`padded_rows`) and sliced back, the keys at
    their own length, causal or not — run here with E's plain version
    (the wrapper's path for CPU tensors): it equals the plain loop, and
    the reference's."""
    rs = np.random.RandomState(sq + skv)
    q = rs.randn(2, sq, 4, 16).astype(np.float32)
    k, v = (rs.randn(2, skv, 2, 16).astype(np.float32) for _ in range(2))
    got = TL._flash_on_card(_t(q), _t(k), _t(v), causal=causal, q_offset=0)
    torch.testing.assert_close(
        got, TL.chunked_attention(_t(q), _t(k), _t(v), causal=causal),
        atol=2e-5, rtol=2e-5)
    if skv <= 1024 and sq <= 1024:
        _close(got, JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal),
               atol=2e-5, rtol=2e-5)


def test_ragged_route_pads_queries_only():
    """`flash_attention_ragged`: rows a call gives the kernel, the contract
    `flash_attention` keeps, and the operations counted for ragged
    lengths."""
    assert [tfa.padded_rows(s) for s in (1, 100, 128, 129, 300, 1000)] == \
        [1, 100, 128, 256, 384, 1024]
    q = torch.randn(3, 300, 8)
    k = torch.randn(3, 20, 8)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        tfa.flash_attention(q, k, k, causal=False)
    out = tfa.flash_attention_ragged(q, k, k, causal=False)
    assert out.shape == (3, 300, 8)
    torch.testing.assert_close(out, tfa.flash_attention_torch(
        q, k, k, causal=False), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        tfa.operations(3, 300, 20, 8, False)
    assert tfa.operations(3, 300, 20, 8, False, ragged=True) == \
        3 * 300 * 20 * 4 * 8
    assert tfa.operations(1, 3, 3, 8, True, ragged=True) == 6 * 4 * 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_ssd_route_adds_the_residual_and_keeps_the_final_state(dtype):
    """What `ssd_chunked` does on the card around kernel F — inputs cast
    to float32, F's y and final state (`mamba2_ssd_with_state`), `D_res x`
    added in float32, y cast back to x's dtype — run here with F's plain
    version: it equals the plain loop, and an initial state raises."""
    *args, st = _ssd_args(2, 64, 3, 8, 16, seed=9)
    x, dt, A, Bi, Ci, D = map(_t, args)
    x = x.to(dtype)
    y, last = TL._ssd_on_card(x, dt, A, Bi, Ci, D, 16, None)
    wy, wlast = TL.ssd_chunked_plain(x, dt, A, Bi, Ci, D, 16)
    assert y.dtype == dtype and last.dtype == torch.float32
    torch.testing.assert_close(y.float(), wy.float(), **(
        F32 if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)))
    torch.testing.assert_close(last, wlast, **F32)
    with pytest.raises(ValueError, match="init_state"):
        TL._ssd_on_card(x, dt, A, Bi, Ci, D, 16, _t(st))


def test_ssd_wrapper_final_state_matches_reference():
    """The plain version of F's new output, `mamba2_ssd_with_state`, is
    the reference's `ssd_chunked` second output (zero residual);
    `mamba2_ssd` keeps the reference's signature, y only."""
    *args, _ = _ssd_args(2, 64, 3, 8, 16, seed=10)
    args = args[:5]
    y, last = tssd.mamba2_ssd_with_state(*map(_t, args), chunk=16)
    jy, jlast = JL.ssd_chunked(*map(jnp.asarray, args),
                               jnp.zeros((3,), jnp.float32), 16)
    _close(y, jy, "y")
    _close(last, jlast, "final state")
    _close(tssd.mamba2_ssd(*map(_t, args), chunk=16), jy, "y alone")
