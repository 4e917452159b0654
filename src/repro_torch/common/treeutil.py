"""Small helpers over parameter trees: nested dicts and lists (or tuples)
whose leaves are tensors, mirroring `repro/common/treeutil.py`.

Leaves are visited in the order JAX flattens a pytree: dict keys sorted,
sequences in order, so `flat_paths` names the leaves as the reference
does."""
from __future__ import annotations

import torch


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves_with_paths(x, path + (str(i),))
    elif tree is not None:
        yield path, tree


def tree_leaves(tree) -> list:
    return [x for _, x in _leaves_with_paths(tree)]


def tree_map(fn, tree):
    """`fn` applied to every leaf; dicts, lists and tuples rebuilt."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return None if tree is None else fn(tree)


def tree_param_count(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_allfinite(tree) -> torch.Tensor:
    leaves = [torch.isfinite(x).all() for x in tree_leaves(tree)
              if x.is_floating_point()]
    return torch.stack(leaves).all() if leaves else torch.tensor(True)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def flat_paths(tree) -> list[str]:
    """Stable '/'-joined key paths for every leaf (checkpoint naming)."""
    return ["/".join(p) for p, _ in _leaves_with_paths(tree)]
