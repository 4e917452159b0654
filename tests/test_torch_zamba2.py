"""The port's published Zamba2 layout (`zamba2-7b-instruct`, the hybrid
family with `hybrid_layers`) and what it needs of the kernels' plain
versions, on the CPU: B/C groups in the chunked SSD, the wide-head plan
of kernel E's backward, the arch's registration and its training step.

The JAX package has no counterpart of this layout, so the model is held
against the benchmark's plain reference (`perfbench/test_perfbench_hybrid.py`)
and the SSD against its float64 recurrence."""
import dataclasses
import math

import pytest
import torch

from repro_torch.common.config import get_arch, list_archs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models.api import get_model
from repro_torch.models.dims import make_dims
from repro_torch.optim import OptConfig
from repro_torch.train import make_state, make_train_step


def _ssd_inputs(b, s, h, p, n, g, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)
    return (rnd(b, s, h, p), torch.rand((b, s, h), generator=gen) * 0.1
            + 1e-3, -(1 + 15 * torch.rand((h,), generator=gen)),
            rnd(b, s, g, n), rnd(b, s, g, n))


def _recurrence_f64(x, dt, A, Bh, Ch):
    """y and the final state by the token-by-token recurrence in float64,
    B/C given per head [B,S,H,N]."""
    x, dt, A, Bh, Ch = (t.double() for t in (x, dt, A, Bh, Ch))
    b, s, h, p = x.shape
    st = torch.zeros((b, h, p, Bh.shape[-1]), dtype=torch.float64)
    ys = []
    for i in range(s):
        st = (st * torch.exp(dt[:, i] * A)[..., None, None]
              + (dt[:, i, :, None] * x[:, i])[..., None] * Bh[:, i, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch[:, i]))
    return torch.stack(ys, 1), st


@pytest.mark.parametrize("g,chunk", [(2, 16), (3, 32), (1, 64)])
def test_grouped_plain_ssd_is_the_per_head_expanded_scan(g, chunk):
    """B/C [B,S,G,N]: head h reads group h // (H/G). The grouped plain SSD
    equals the scan with B and C expanded to one group a head, bit for
    bit, and the float64 recurrence within float32 rounding; G = 1
    given as [B,S,N] is the one-group form bit for bit."""
    x, dt, A, Bg, Cg = _ssd_inputs(2, 128, 6, 8, 16, g)
    D = torch.zeros(6)
    y, st = TL.ssd_chunked_plain(x, dt, A, Bg, Cg, D, chunk)
    Bh = Bg.repeat_interleave(6 // g, dim=2)
    Ch = Cg.repeat_interleave(6 // g, dim=2)
    ye, ste = TL.ssd_chunked_plain(x, dt, A, Bh, Ch, D, chunk)
    assert torch.equal(y, ye) and torch.equal(st, ste)
    y64, st64 = _recurrence_f64(x, dt, A, Bh, Ch)
    torch.testing.assert_close(y.double(), y64, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st.double(), st64, atol=1e-4, rtol=1e-4)
    if g == 1:
        y1, st1 = TL.ssd_chunked_plain(x, dt, A, Bg[:, :, 0], Cg[:, :, 0],
                                       D, chunk)
        assert torch.equal(y, y1) and torch.equal(st, st1)


def test_grouped_ssd_routes_take_groups():
    """Kernel F's wrapper (plain on the CPU), the trainable route and its
    gradient take B/C in groups; a group count that does not divide the
    heads is refused; F's operations count C·Bᵀ once a group."""
    x, dt, A, Bg, Cg = _ssd_inputs(1, 64, 4, 8, 16, 2, seed=1)
    y, st = ssd.mamba2_ssd_with_state(x, dt, A, Bg, Cg, chunk=16)
    want = TL.ssd_chunked_plain(x, dt, A, Bg, Cg, torch.zeros(4), 16)
    assert torch.equal(y, want[0]) and torch.equal(st, want[1])
    with pytest.raises(ValueError):
        ssd.mamba2_ssd(x, dt, A, Bg[:, :, :1].expand(1, 64, 3, 16)
                       .contiguous(), Cg[:, :, :1].expand(1, 64, 3, 16)
                       .contiguous(), chunk=16)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bg, Cg)]
    calls = ssd.BWD_CALLS
    got = torch.autograd.grad(
        ops.mamba2_ssd_with_state_trainable(*ins, chunk=16)[0].sum(), ins)
    assert ssd.BWD_CALLS == calls + 1
    ins2 = [t.clone().requires_grad_() for t in (x, dt, A, Bg, Cg)]
    want = torch.autograd.grad(TL.ssd_chunked_plain(
        *ins2, torch.zeros(4), 16)[0].sum(), ins2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    l, pairs = 128, 128 * 129 // 2
    assert (ssd.operations(1, 4096, 112, 64, 64, 128, 2)
            - ssd.operations(1, 4096, 112, 64, 64, 128)
            == 2 * (4096 // l) * pairs * 64)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,d", [(96, 96, 224), (70, 130, 160)])
def test_wide_head_plain_backward_is_the_plain_gradient(sq, skv, d, causal):
    """Past 128 columns kernel E's backward walks blocks of 64 keys and
    query rows (`BWD_ROWS_WIDE`) and its forward tiles of 32 keys
    (`F_KT_WIDE`); their plain versions give the plain attention's
    gradient and log-sum-exp."""
    gen = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn((2, n, d), generator=gen, dtype=torch.float64)
               for n in (sq, skv, skv))
    do = torch.randn((2, sq, d), generator=gen, dtype=torch.float64)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("bqd,bkd->bqk", ins[0], ins[1]) / math.sqrt(d)
    if causal:
        s = s.masked_fill(torch.ones(sq, skv, dtype=torch.bool).triu(1),
                          -math.inf)
    out = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), ins[2])
    want = torch.autograd.grad(out, ins, do)
    lse = fa.flash_attention_lse_torch(q, k, causal=causal)
    got = fa.flash_attention_backward_torch(q, k, v, out.detach(), lse, do,
                                            causal=causal)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).detach(),
                               atol=1e-10, rtol=1e-10)


def test_wide_heads_are_the_float32_kernels_alone():
    assert fa.MAX_D == 128 and fa.MAX_D_F32 == 224
    assert fa.F_KT_WIDE < fa.F_KT and fa.BWD_ROWS_WIDE < fa.BWD_ROWS


def test_instruct_arch_is_registered_beside_the_assigned_ones():
    """Registered, with the published sizes; not among `list_archs`,
    which the suites walking the JAX package's archs take."""
    cfg = get_arch("zamba2-7b-instruct")
    assert "zamba2-7b-instruct" not in list_archs()
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.d_ff) == \
        ("hybrid", 81, 3584, 14336)
    assert cfg.hybrid_layers[:4] == (6, 11, 17, 23) and \
        len(cfg.hybrid_layers) == 13 == cfg.n_attn_applications()
    assert cfg.attention.head_dim == 224 and cfg.ssm.n_groups == 2
    assert cfg.ssm.n_heads(cfg.d_model) == 112 and cfg.tie_embeddings
    assert 7.2e9 < cfg.param_count() < 7.5e9
    cut = dataclasses.replace(cfg, n_layers=24,
                              hybrid_layers=(6, 11, 17, 23))
    assert 2.7e9 < cut.param_count() < 2.8e9
    # the assigned zamba2-7b keeps its layout
    old = get_arch("zamba2-7b")
    assert old.hybrid_layers == () and old.ssm.n_groups == 1


def test_instruct_trains_through_make_train_step():
    """One AdamW step of the reduced layout (8 layers, blocks A, B, A,
    2 groups) on the CPU: a finite loss, every leaf moved, the same
    step twice the same bits; prefill and decode are not ported."""
    cfg = get_arch("zamba2-7b-instruct").reduced()
    dims = make_dims(cfg, compute_dtype=torch.float32,
                     param_dtype=torch.float32)
    opt = OptConfig(warmup_steps=1)
    state = make_state(torch.Generator().manual_seed(0), cfg, dims, opt,
                       device="cpu")
    step = make_train_step(cfg, dims, opt, accum=2, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    new, met = step(state, batch)
    again, _ = step(state, batch)
    assert math.isfinite(float(met["loss"]))
    from repro_torch.common.treeutil import tree_leaves
    for a, b, c in zip(tree_leaves(state["params"]),
                       tree_leaves(new["params"]),
                       tree_leaves(again["params"])):
        assert not torch.equal(a, b) and torch.equal(b, c)
    mod = get_model(cfg)
    with pytest.raises(NotImplementedError):
        mod.prefill(state["params"], batch, cfg, dims)
    with pytest.raises(NotImplementedError):
        mod.init_decode_state(cfg, dims, 1, 8, device="cpu")
