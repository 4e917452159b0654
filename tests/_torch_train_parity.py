"""Helpers shared by the training parity tests (`test_torch_train.py`,
`test_torch_train_step.py`): the bars they hold the port to, the
comparison, and each family's reduced configs and batches on both
packages. Imports JAX: only those two files import it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.common.config import get_arch as jget_arch
from repro.data import SyntheticLMData as JData
from repro.models.dims import make_dims as jmake_dims
from repro_torch.common.config import get_arch as tget_arch
from repro_torch.models.dims import make_dims as tmake_dims

#: the optimizer fed the same gradients (`test_torch_train.py` says why)
OPT_REL = 1e-6
#: loss, gradients and moments after one train step
GRAD_REL = 1e-5
LR = 1e-3
EPS = 1e-8                              # OptConfig's default
OPT_KW = dict(lr=LR, warmup_steps=2, total_steps=100)


def one_torch_thread():
    """One intra-op thread while a module runs (a module-scoped fixture's
    body): the models are tiny, and the suite's workers share the host's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _hold(got, want, rel, what, atol=0.0):
    g, w = _np(got), _np(want)
    assert np.isfinite(g).all(), what
    err = float(np.abs(g - w).max()) if g.size else 0.0
    bar = rel * float(np.abs(w).max() if w.size else 0.0) + atol
    assert err <= bar, f"{what}: max abs difference {err} over {bar}"


def _jleaves(tree):
    return jax.tree_util.tree_leaves(jax.device_get(tree))

def _cfg(arch, get_arch):
    if arch == "zamba2-tail":
        return dataclasses.replace(get_arch("zamba2-7b").reduced(),
                                   n_layers=14)
    return get_arch(arch).reduced()


def _both(arch):
    jc = _cfg(arch, jget_arch)
    tc = _cfg(arch, tget_arch)
    return (jc, jmake_dims(jc, tp=1, param_dtype=jnp.float32,
                           compute_dtype=jnp.float32),
            tc, tmake_dims(tc, tp=1, param_dtype=torch.float32,
                           compute_dtype=torch.float32))


def _batch(cfg, b=4, s=16, mrope=False):
    kind = ("encdec" if cfg.family == "encdec"
            else ("embeds" if cfg.frontend == "embed" else "tokens"))
    batch = JData(cfg.vocab_size, batch=b, seq=s, seed=0,
                  embed_dim=cfg.d_model, kind=kind).batch_at(0)
    if mrope:   # M-RoPE positions [3, B, S]: a distinct stream each
        pos = np.arange(s)[None, None, :] * np.array([1, 2, 3])[:, None, None]
        batch["positions"] = np.broadcast_to(
            pos + np.arange(b)[None, :, None], (3, b, s)).astype(np.int32)
    return batch
