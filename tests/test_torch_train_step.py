"""One `make_train_step` step of every model family's reduced arch
(dense, MoE, Mamba2, a hybrid with a Mamba tail, encoder-decoder; `accum`
1 and 2; qwen2-vl's M-RoPE positions) on the port against the JAX
package's on the CPU, from the reference's own
`make_state(PRNGKey(0))` carried across by `state_from_numpy` (params and
moments; never two independent inits), on the reference's
`SyntheticLMData` batch.

Bars (`_torch_train_parity.py`):

  * `GRAD_REL` = 1e-5 of each leaf's largest magnitude, for the loss,
    the gradient norm, every gradient leaf, m and v after the step:
    both sum the same float32 products in another order through a few
    layers; measured below 1e-6.
  * Params after the step: each element within the difference its
    gradient's bar can make. On the first step AdamW moves an element by
    lr·x/(|x| + eps), x its clipped gradient, so a difference of up to
    d = `GRAD_REL` x the leaf's largest |x| moves it by up to
    lr·min(2, d·eps/(max(|x| - d, 0) + eps)²): nothing where |x| is well
    above d, up to 2·lr where x is at roundoff level (a gradient that is
    zero but for the frameworks' sums); plus `GRAD_REL` of the leaf's
    largest |p| (`_param_bar`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptConfig as JOpt
from repro.train import make_state as jmake_state
from repro.train import make_train_step as jmake_step
from repro_torch.common import treeutil as ttree
from repro_torch.models.convert import state_from_numpy
from repro_torch.optim import OptConfig
from repro_torch.train import make_train_step
from repro_torch.train.step import make_grad_fn

from _torch_train_parity import (EPS, GRAD_REL, OPT_KW, _batch, _both,
                                 _hold, _jleaves, _np, one_torch_thread)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def _param_bar(m_ref, p_ref, lr):
    """The per-element bar on params after a first AdamW step whose
    clipped gradient x = m / (1 - b1) is held at `GRAD_REL`."""
    x = np.abs(np.asarray(m_ref, np.float32)) / 0.1
    d = GRAD_REL * float(x.max())
    move = np.minimum(2.0, d * EPS / (np.maximum(x - d, 0.0) + EPS) ** 2)
    return lr * move + GRAD_REL * float(np.abs(np.asarray(p_ref)).max())



STEP_CASES = [(a, acc) for a in ("qwen2-0.5b", "qwen3-moe-235b-a22b",
                                 "mamba2-130m", "zamba2-tail",
                                 "seamless-m4t-large-v2")
              for acc in (1, 2)] + [("qwen2-vl-72b", 2)]


@pytest.mark.parametrize("arch,accum", STEP_CASES)
def test_train_step_matches_reference(arch, accum):
    """One step of `make_train_step` from the reference's own state: the
    loss, gnorm, lr, every gradient leaf (the port's `make_grad_fn`
    against the reference's, read off its first moment: m = (1 - b1) ·
    scale · g on the first step), m and v at `GRAD_REL`, params at
    `_param_bar`. qwen2-vl takes M-RoPE positions, split on
    their axis 1."""
    jc, jd, tc, td = _both(arch)
    mrope = arch == "qwen2-vl-72b"
    batch = _batch(jc, mrope=mrope)
    jstate = jmake_state(jax.random.PRNGKey(0), jc, jd, JOpt(**OPT_KW))
    jnew, jm = jax.jit(jmake_step(jc, jd, JOpt(**OPT_KW), accum=accum))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = state_from_numpy(jax.device_get(jstate), "cpu")
    new, tm = make_train_step(tc, td, OptConfig(**OPT_KW), accum=accum,
                              device="cpu")(state, batch)
    for key in ("loss", "gnorm", "lr"):
        _hold(tm[key], jm[key], GRAD_REL, f"{arch} {key}")
    if accum == 1:
        assert set(tm) == set(jm), (sorted(tm), sorted(jm))
        for key in jm:
            _hold(tm[key], jm[key], GRAD_REL, f"{arch} metric {key}")
    else:
        assert set(tm) == set(jm) == {"loss", "gnorm", "lr"}
    loss, _, grads = make_grad_fn(tc, td, accum=accum)(
        state["params"], {k: torch.as_tensor(v) for k, v in batch.items()})
    _hold(loss, jm["loss"], GRAD_REL, f"{arch} grad_fn loss")
    scale = min(1.0, 1.0 / max(float(jm["gnorm"]), 1e-12))
    jmom = jax.device_get(jnew["opt"]["m"])
    for path, g, m in zip(ttree.flat_paths(grads), ttree.tree_leaves(grads),
                          jax.tree_util.tree_leaves(jmom)):
        _hold(g, np.asarray(m) / (0.1 * scale), GRAD_REL,
              f"{arch} gradient {path}")
    for path, a, b in zip(ttree.flat_paths(new["opt"]),
                          ttree.tree_leaves(new["opt"]),
                          _jleaves(jnew["opt"])):
        _hold(a, b, GRAD_REL, f"{arch} {path}")
    lr = float(jm["lr"])
    for path, a, b, m in zip(ttree.flat_paths(new["params"]),
                             ttree.tree_leaves(new["params"]),
                             _jleaves(jnew["params"]),
                             jax.tree_util.tree_leaves(jmom)):
        err = np.abs(_np(a) - np.asarray(b, np.float32))
        bar = _param_bar(m, b, lr)
        assert (err <= bar).all(), (arch, path, float((err - bar).max()))
    for a, b in zip(ttree.tree_leaves(state),
                    _jleaves(jstate)):                # state left unchanged
        assert np.array_equal(_np(a), np.asarray(b, np.float32))
