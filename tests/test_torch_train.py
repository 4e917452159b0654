"""The port's training side (`repro_torch.optim`, the tree helpers, the
card routes' backward, the models' remat and loss, `.data`, the state
conversion, the no-fallback rule) against the JAX package on the CPU.
One train step of every family is `test_torch_train_step.py`.

JAX and torch draw different random numbers, so trees are the
reference's own (or numpy arrays handed to both), carried across by
`repro_torch.models.convert`. On CPU tensors the attention and the SSD
are the plain loops, and the card routes' `torch.autograd.Function`s run
their plain forward with the backward they use on the card.

Bars (`_torch_train_parity.py`):

  * `OPT_REL` = 1e-6 of each leaf's largest magnitude, for the optimizer
    fed the same gradients: params, m, v, the learning rate and the
    gradient norm are the same float32 formulas; they differ by a
    rounding of `pow`, `sqrt` or `cos`, ~1e-7. bf16 moments: equal bits
    or one bf16 step (their float32 values differ as above, and a value
    next to a rounding boundary may round either way).
  * `GRAD_REL` = 1e-5 of each leaf's largest magnitude, for gradients
    through the card routes: the same float32 products summed in another
    order; measured below 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import Prefetcher as JPrefetcher
from repro.data import SyntheticLMData as JData
from repro.models import layers as JL
from repro.optim import OptConfig as JOpt
from repro.optim import apply_updates as japply
from repro.optim import init_opt as jinit
from repro.optim import lr_at as jlr_at
from repro.train import make_state as jmake_state
from repro_torch.common import treeutil as ttree
from repro_torch.data import Prefetcher, SyntheticLMData
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.optim import OptConfig, apply_updates, init_opt, lr_at
from repro_torch.train import Trainer, TrainerConfig, make_state, \
    make_train_step
from repro_torch.train.step import make_grad_fn

from _torch_train_parity import (GRAD_REL, OPT_REL, _batch, _both, _hold,
                                 _jleaves, one_torch_thread)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


# ================================================================ optimizer
def _param_tree(rs):
    """Leaves of every rank the optimizer treats apart: matrices and a
    stacked [L, D, F] (weight decay, factored v), vectors and a stacked
    [L, D] norm (decayed and factored too: ndim >= 2), a bias."""
    return {"w": rs.randn(6, 10).astype(np.float32),
            "layers": {"wi": rs.randn(3, 5, 7).astype(np.float32),
                       "ln": (1 + 0.1 * rs.randn(3, 5)).astype(np.float32)},
            "b": rs.randn(10).astype(np.float32)}


OPT_CASES = {
    "f32": dict(lr=3e-2, warmup_steps=2, total_steps=20),
    "bf16": dict(lr=3e-2, warmup_steps=2, total_steps=20,
                 moment_dtype="bfloat16"),
    "factored": dict(lr=3e-2, warmup_steps=2, total_steps=20,
                     factored_v=True),
    "schedule": dict(lr=3e-2, warmup_steps=3, total_steps=9,
                     min_lr_ratio=0.2, grad_clip=0.5),
}


def _bf16_steps_apart(got, want) -> int:
    """The most bf16 steps between two bf16 tensors' values (same sign)."""
    g = got.view(torch.int16).numpy().astype(np.int64)
    w = np.asarray(want).view(np.int16).astype(np.int64)
    return int(np.abs(g - w).max())


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_apply_updates_matches_reference(case):
    """The same numpy gradients through both optimizers for 12 steps
    (past the schedule's end in `schedule`): params, m, v (or its
    {"row", "col"}), lr and gnorm at `OPT_REL`; bf16 moments equal bits
    or one bf16 step."""
    kw = OPT_CASES[case]
    rs = np.random.RandomState(7)
    p0 = _param_tree(rs)
    jp, jo = p0, jinit(jax.tree.map(jnp.asarray, p0), JOpt(**kw))
    jp = jax.tree.map(jnp.asarray, p0)
    tp = params_from_numpy(p0, "cpu")
    to = init_opt(tp, OptConfig(**kw))
    assert ttree.flat_paths(to) == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jo)[0]]
    for it in range(12):
        g = jax.tree.map(lambda x: (rs.randn(*x.shape) * (0.3 + it)).astype(
            np.float32), p0)
        jp, jo, jm = japply(jp, jax.tree.map(jnp.asarray, g), jo, JOpt(**kw))
        tp, to, tm = apply_updates(tp, params_from_numpy(g, "cpu"), to,
                                   OptConfig(**kw))
        assert int(to["step"]) == int(jo["step"]) == it + 1
        assert to["step"].dtype == torch.int32
        _hold(tm["lr"], jm["lr"], OPT_REL, f"{case} lr step {it}")
        _hold(tm["gnorm"], jm["gnorm"], OPT_REL, f"{case} gnorm step {it}")
        for path, a, b in zip(ttree.flat_paths(tp), ttree.tree_leaves(tp),
                              _jleaves(jp)):
            _hold(a, b, OPT_REL, f"{case} param {path} step {it}")
        for path, a, b in zip(ttree.flat_paths(to), ttree.tree_leaves(to),
                              _jleaves(jo)):
            if a.dtype == torch.bfloat16:
                assert str(np.asarray(b).dtype) == "bfloat16"
                assert _bf16_steps_apart(a, b) <= 1, (case, path, it)
            else:
                _hold(a, b, OPT_REL, f"{case} {path} step {it}")


def test_lr_at_matches_reference_over_the_schedule():
    """Warmup, the cosine and past its end, as float32 tensors."""
    for kw in ({"warmup_steps": 100, "total_steps": 10_000},
               {"warmup_steps": 3, "total_steps": 9, "min_lr_ratio": 0.2},
               {"warmup_steps": 0, "total_steps": 1}):
        for step in (0, 1, 2, 3, 4, 7, 9, 10, 99, 100, 101, 5000, 10_000,
                     20_000):
            got = lr_at(OptConfig(**kw), torch.tensor(step, dtype=torch.int32))
            want = jlr_at(JOpt(**kw), jnp.int32(step))
            assert got.dtype == torch.float32
            _hold(got, want, OPT_REL, f"lr_at {kw} {step}")


def test_adamw_converges_on_quadratic():
    """The reference's `test_adamw_converges_on_quadratic` on the port."""
    ocfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                     weight_decay=0.0, grad_clip=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = init_opt(params, ocfg)
    for _ in range(120):
        g = {"w": 2 * params["w"]}
        params, opt, _ = apply_updates(params, g, opt, ocfg)
    assert float(params["w"].abs().max()) < 0.05
    assert float(lr_at(ocfg, torch.tensor(100, dtype=torch.int32))) <= ocfg.lr


def test_apply_updates_is_functional():
    """New trees out; the params, grads and state handed in unchanged."""
    p = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    g = {"w": torch.full((3, 2), 0.5), "b": torch.ones(2)}
    o = init_opt(p, OptConfig(factored_v=True))
    before = [x.clone() for x in ttree.tree_leaves((p, g, o))]
    apply_updates(p, g, o, OptConfig(factored_v=True))
    for a, b in zip(ttree.tree_leaves((p, g, o)), before):
        assert torch.equal(a, b)


# ============================================================ tree helpers
def test_tree_helpers_follow_jax_flatten_order():
    """`tree_flatten`/`tree_unflatten`/`flatten_up_to` against JAX's on a
    factored optimizer state (a {"row", "col"} subtree at a param's
    leaf), with None as an empty subtree."""
    rs = np.random.RandomState(0)
    p0 = _param_tree(rs)
    jo = jinit(jax.tree.map(jnp.asarray, p0), JOpt(factored_v=True))
    to = state_from_numpy(jax.device_get(jo), "cpu")
    leaves, tdef = ttree.tree_flatten(to)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(jo)):
        assert tuple(a.shape) == tuple(b.shape)
    back = ttree.tree_unflatten(tdef, leaves)
    assert ttree.flat_paths(back) == ttree.flat_paths(to)
    _, pdef = ttree.tree_flatten(params_from_numpy(p0, "cpu"))
    _, jpdef = jax.tree.flatten(p0)
    got = ttree.flatten_up_to(pdef, to["v"])
    want = jpdef.flatten_up_to(jo["v"])
    assert [isinstance(x, dict) for x in got] == \
        [isinstance(x, dict) for x in want]
    for a, b in zip(got, want):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b) == ["col", "row"]
        else:
            assert tuple(a.shape) == tuple(b.shape)
    tree = {"b": [torch.ones(1), None, (torch.zeros(2),)], "a": torch.ones(3)}
    lv, td = ttree.tree_flatten(tree)
    assert ttree.flat_paths(tree) == ["a", "b/0", "b/2/0"]
    assert ttree.tree_unflatten(td, lv)["b"][1] is None
    with pytest.raises(ValueError):
        ttree.tree_unflatten(td, lv[:-1])


def test_tree_unbind_equals_indexing_in_value_and_gradient():
    """`tree_unbind` (one unbind a stacked leaf) gives `tree_index`'s
    values, and the same gradient of the stack."""
    stack = {"w": torch.randn(4, 3, 2, requires_grad=True),
             "v": {"u": torch.randn(4, 5, requires_grad=True)}}
    sl = ttree.tree_unbind(stack, 4)
    ix = [ttree.tree_index(stack, i) for i in range(4)]
    for a, b in zip(sl, ix):
        for x, y in zip(ttree.tree_leaves(a), ttree.tree_leaves(b)):
            assert torch.equal(x, y)
    weights = torch.arange(1.0, 5.0)

    def loss(layers):
        return sum(w * (lp["w"].sin().sum() + lp["v"]["u"].square().sum())
                   for w, lp in zip(weights, layers))
    ga = torch.autograd.grad(loss(sl), ttree.tree_leaves(stack))
    gb = torch.autograd.grad(loss(ix), ttree.tree_leaves(stack))
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


# ======================================================= card routes' grads
def _qkv(rs, b, sq, skv, hq, hkv, d):
    return (torch.from_numpy(rs.randn(b, sq, hq, d).astype(np.float32)),
            torch.from_numpy(rs.randn(b, skv, hkv, d).astype(np.float32)),
            torch.from_numpy(rs.randn(b, skv, hkv, d).astype(np.float32)))


@pytest.mark.parametrize("causal,sq,skv,hq,hkv", [
    (True, 64, 64, 4, 2), (False, 37, 53, 6, 2), (True, 20, 20, 3, 3)])
def test_card_attention_route_backward_is_the_plain_gradient(causal, sq, skv,
                                                             hq, hkv):
    """`_flash_on_card` (the GQA expansion and permutes under autograd
    around `ops.flash_attention_ragged_trainable`, whose forward is E or,
    here on CPU tensors, its plain version) has the gradient of the plain
    online-softmax loop in q, k and v, GQA groups summed."""
    rs = np.random.RandomState(sq + hq)
    q, k, v = _qkv(rs, 2, sq, skv, hq, hkv, 16)
    g = torch.from_numpy(rs.randn(2, sq, hq, 16).astype(np.float32))
    grads = []
    for fn in (lambda *a: TL._flash_on_card(*a, causal=causal, q_offset=0),
               lambda *a: TL.chunked_attention(*a, causal=causal,
                                               q_block=16 if sq % 16 == 0
                                               else sq,
                                               kv_block=16 if skv % 16 == 0
                                               else skv)):
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        kx = TL._expand_kv(ins[1], hq // hkv)
        vx = TL._expand_kv(ins[2], hq // hkv)
        out = fn(ins[0], kx, vx)
        grads.append(torch.autograd.grad(out, ins, g))
    for a, b, name in zip(*grads, "qkv"):
        _hold(a, b, GRAD_REL, f"d{name}")


@pytest.mark.parametrize("use_state", [False, True])
def test_card_ssd_route_backward_is_the_plain_gradient(use_state):
    """`_ssd_on_card` (`ops.mamba2_ssd_with_state_trainable` with `D·x`
    outside it) has the gradient of `ssd_chunked_plain` in x, dt, A, B, C
    and D, with and without a gradient on the final state (the hybrid's
    prefill keeps it; `train_loss` drops it)."""
    rs = np.random.RandomState(3)
    b, s, h, p, n = 2, 64, 3, 8, 16
    x = rs.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, s, h))).astype(np.float32) * 0.5
    A = -np.exp(rs.randn(h)).astype(np.float32)
    Bi = rs.randn(b, s, n).astype(np.float32)
    Ci = rs.randn(b, s, n).astype(np.float32)
    D = rs.randn(h).astype(np.float32)
    gy = torch.from_numpy(rs.randn(b, s, h, p).astype(np.float32))
    gs = torch.from_numpy(rs.randn(b, h, p, n).astype(np.float32))
    grads = []
    for fn in (TL._ssd_on_card, TL.ssd_chunked_plain):
        ins = [torch.from_numpy(a.copy()).requires_grad_()
               for a in (x, dt, A, Bi, Ci, D)]
        y, last = fn(*ins, 16, None)
        outs, gouts = ([y, last], [gy, gs]) if use_state else ([y], [gy])
        grads.append(torch.autograd.grad(outs, ins, gouts))
    for a, b_, name in zip(*grads, ("x", "dt", "A", "B", "C", "D")):
        _hold(a, b_, GRAD_REL, f"d{name}")


def _ssd_recurrence_f64(x, dt, A, Bi, Ci):
    """The SSD as its token-by-token recurrence in float64: h <- h·exp(dt·A)
    + dt·x ⊗ B, y = h·C (no chunks, no exp of a difference)."""
    b, s, h, p = x.shape
    st = torch.zeros((b, h, p, Bi.shape[-1]), dtype=torch.float64)
    ys = []
    for i in range(s):
        st = (st * torch.exp(dt[:, i] * A)[:, :, None, None]
              + (dt[:, i, :, None] * x[:, i])[..., None]
              * Bi[:, i, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", st, Ci[:, i]))
    return torch.stack(ys, 1)


def test_ssd_gradient_is_nan_where_the_decay_overflows_as_in_reference():
    """Where |dt·A| summed within a chunk passes ~88, the reference's
    chunked SSD takes exp(cum_i - cum_j) over the whole chunk before it
    masks j > i: above the diagonal that overflows, and its gradient is
    0·inf = NaN in dt, A, B and C (not in x). The port masks the exponent
    before the exp (a departure, `ROADMAP.md`): its forward stays the
    reference's, and its gradients through the card route are finite and
    hold against the float64 recurrence everywhere, and against the
    reference's where those are finite. mamba2-130m's init (A down to
    -16, dt up to 0.1, chunk 128) reaches it."""
    rs = np.random.RandomState(0)
    b, s, h, p, n, chunk = 1, 256, 4, 8, 16, 128
    x = rs.randn(b, s, h, p).astype(np.float32)
    A = -np.array([1.0, 4.0, 10.0, 16.0], np.float32)
    dt = np.full((b, s, h), 0.05, np.float32)
    Bi, Ci = (rs.randn(b, s, n).astype(np.float32) for _ in range(2))
    D = np.ones(h, np.float32)

    def jloss(*a):
        return jnp.sum(JL.ssd_chunked(*a, jnp.asarray(D), chunk)[0])
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, dt, A, Bi, Ci)))
    jy = JL.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bi, Ci, D)), chunk)[0]
    ins = [torch.from_numpy(a.copy()).requires_grad_()
           for a in (x, dt, A, Bi, Ci)]
    y, _ = TL._ssd_on_card(*ins, torch.from_numpy(D), chunk, None)
    _hold(y.detach(), np.asarray(jy), GRAD_REL, "y")
    got = torch.autograd.grad(y.sum(), ins)
    ins64 = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
             for a in (x, dt, A, Bi, Ci)]
    y64 = _ssd_recurrence_f64(*ins64) + ins64[0]    # D = 1
    exact = torch.autograd.grad(y64.sum(), ins64)
    for name, g, w, e in zip(("x", "dt", "A", "B", "C"), got, want, exact):
        w = np.asarray(w)
        assert np.isnan(w).any() == (name != "x"), name
        _hold(g, e.numpy(), GRAD_REL, f"d{name} against float64")
        fin = np.isfinite(w)
        _hold(g.numpy()[fin], w[fin], GRAD_REL, f"d{name} where finite")


def test_card_ssd_route_takes_a_state_gradient_alone():
    """Only the final state read: no gradient for C (the state does not
    depend on it), the others autograd's."""
    rs = np.random.RandomState(4)
    ins = [torch.from_numpy(a).requires_grad_() for a in (
        rs.randn(1, 32, 2, 4).astype(np.float32),
        np.full((1, 32, 2), 0.1, np.float32), np.array([-1.0, -0.5],
                                                       np.float32),
        rs.randn(1, 32, 8).astype(np.float32),
        rs.randn(1, 32, 8).astype(np.float32))]
    D = torch.zeros(2)
    _, last = TL._ssd_on_card(*ins, D, 16, None)
    got = torch.autograd.grad(last.sum(), ins, allow_unused=True)
    _, wlast = TL.ssd_chunked_plain(*ins, D, 16)
    want = torch.autograd.grad(wlast.sum(), ins, allow_unused=True)
    assert got[4] is None and want[4] is None
    for a, b_ in zip(got[:4], want[:4]):
        _hold(a, b_, GRAD_REL, "state gradient")


# =============================================================== train step
def test_remat_changes_no_value():
    """`transformer.remat` in train mode (`torch.utils.checkpoint`) gives
    the same loss and gradients as the plain call, bit for bit on the
    CPU, for every family's layer walk."""
    from unittest import mock
    from repro_torch.models import encdec, hybrid, mamba, transformer
    for arch in ("qwen2-0.5b", "zamba2-tail", "seamless-m4t-large-v2"):
        _, _, tc, td = _both(arch)
        state = make_state(torch.Generator().manual_seed(1), tc, td,
                           OptConfig(), device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in _batch(tc).items()}
        fn = make_grad_fn(tc, td)
        loss, _, grads = fn(state["params"], batch)

        def direct(f, mode, *args):
            return f(*args)
        with contextlib_patch(mock, (transformer, mamba, hybrid, encdec),
                              "remat", direct):
            loss2, _, grads2 = fn(state["params"], batch)
        assert torch.equal(loss, loss2), arch
        for a, b in zip(ttree.tree_leaves(grads), ttree.tree_leaves(grads2)):
            assert torch.equal(a, b), arch


def contextlib_patch(mock, modules, name, value):
    import contextlib
    stack = contextlib.ExitStack()
    for m in modules:
        stack.enter_context(mock.patch.object(m, name, value))
    return stack


def test_train_loss_stops_the_gradient_at_the_logsumexp_shift():
    """`lm_loss`'s max shift is detached, as the reference's
    `stop_gradient`: the gradient of the head equals the analytic
    softmax-minus-onehot form."""
    from repro_torch.models.loss import lm_loss
    rs = np.random.RandomState(0)
    h = torch.from_numpy(rs.randn(2, 8, 6).astype(np.float32))
    head = torch.from_numpy(rs.randn(6, 10).astype(np.float32))
    head.requires_grad_()
    labels = torch.from_numpy(rs.randint(0, 7, (2, 8)))
    loss, _ = lm_loss(h, head, labels, logical_vocab=7, z_loss=0.0)
    (g,) = torch.autograd.grad(loss, head)
    logits = torch.einsum("bsd,dv->bsv", h, head.detach())[..., :7]
    p = torch.softmax(logits, -1)
    p = p - torch.nn.functional.one_hot(labels.long(), 7).float()
    want = torch.einsum("bsd,bsv->dv", h, p) / 16
    torch.testing.assert_close(g[:, :7], want, atol=1e-6, rtol=1e-5)
    assert float(g[:, 7:].abs().max()) == 0.0


# ===================================================================== data
@pytest.mark.parametrize("kind", ["tokens", "embeds", "encdec"])
def test_synthetic_data_equals_reference(kind):
    """`batch_at` gives the reference's arrays, for every kind, host
    shard and a few steps; the prefetcher yields them in order."""
    for host, n_hosts in ((0, 1), (1, 2)):
        a = SyntheticLMData(100, batch=8, seq=16, seed=3, host_id=host,
                            n_hosts=n_hosts, embed_dim=12, kind=kind)
        b = JData(100, batch=8, seq=16, seed=3, host_id=host,
                  n_hosts=n_hosts, embed_dim=12, kind=kind)
        for step in (0, 1, 7):
            x, y = a.batch_at(step), b.batch_at(step)
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
    pf, jpf = Prefetcher(iter(a)), JPrefetcher(iter(b))
    for _ in range(3):
        x, y = next(pf), next(jpf)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    pf.close()
    jpf.close()


def test_data_determinism_and_sharding():
    """The reference's `test_data_determinism_and_sharding` on the port."""
    d1 = SyntheticLMData(100, batch=8, seq=16, seed=3)
    d2 = SyntheticLMData(100, batch=8, seq=16, seed=3)
    b1, b2 = d1.batch_at(7), d2.batch_at(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert (d1.batch_at(8)["tokens"] != b1["tokens"]).any()
    h0 = SyntheticLMData(100, batch=8, seq=16, seed=3, host_id=0, n_hosts=2)
    h1 = SyntheticLMData(100, batch=8, seq=16, seed=3, host_id=1, n_hosts=2)
    assert h0.batch_at(0)["tokens"].shape == (4, 16)
    assert (h0.batch_at(0)["tokens"] != h1.batch_at(0)["tokens"]).any()
    assert (b1["labels"][:, -1] == -1).all()


# ============================================================ conversions
def test_state_from_numpy_keeps_dtypes_and_bits():
    """The reference's whole train state with bf16 moments and a
    factored v: same paths, dtypes and bits (bf16 through a 16-bit
    view), the step an int32 scalar."""
    jc, jd, _, _ = _both("qwen2-0.5b")
    js = jmake_state(jax.random.PRNGKey(0), jc, jd,
                     JOpt(moment_dtype="bfloat16", factored_v=True))
    js["opt"]["m"] = jax.tree.map(lambda x: x + jnp.asarray(0.3, x.dtype),
                                  js["opt"]["m"])
    host = jax.device_get(js)
    ts = state_from_numpy(host, "cpu")
    assert ttree.flat_paths(ts) == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(host)[0]]
    for a, b in zip(ttree.tree_leaves(ts), jax.tree_util.tree_leaves(host)):
        b = np.asarray(b)
        if str(b.dtype) == "bfloat16":
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16))
        else:
            assert str(a.dtype).endswith(str(b.dtype))
            np.testing.assert_array_equal(a.numpy(), b)
    assert ts["opt"]["step"].shape == () and \
        ts["opt"]["step"].dtype == torch.int32


# ============================================================ no fallback
@pytest.mark.parametrize("entry", ["make_state", "step", "trainer",
                                   "launch"])
def test_cuda_defaults_raise_without_a_card(entry):
    """With no card the entry points raise on their `cuda` defaults:
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda defaults run there")
    _, _, tc, td = _both("qwen2-0.5b")
    ocfg = OptConfig()
    with pytest.raises((RuntimeError, ValueError)):
        if entry == "make_state":
            make_state(torch.Generator().manual_seed(0), tc, td, ocfg)
        state = make_state(torch.Generator().manual_seed(0), tc, td, ocfg,
                           device="cpu")
        if entry == "step":
            make_train_step(tc, td, ocfg)(state, _batch(tc))
        elif entry == "trainer":
            Trainer(TrainerConfig(total_steps=1), make_train_step(
                tc, td, ocfg, device="cpu"), state, iter([]))
        elif entry == "launch":
            from repro_torch.launch import train as LT
            LT.main(["--reduced", "--steps", "1"])


def test_a_state_on_another_device_raises():
    _, _, tc, td = _both("qwen2-0.5b")
    state = make_state(torch.Generator().manual_seed(0), tc, td, OptConfig(),
                       device="cpu")
    step = make_train_step(tc, td, OptConfig(), device="meta")
    with pytest.raises(ValueError, match="lies on cpu"):
        step(state, _batch(tc))
