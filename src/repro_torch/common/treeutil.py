"""Small helpers over parameter trees: nested dicts and lists (or tuples)
whose leaves are tensors, mirroring `repro/common/treeutil.py`.

Leaves are visited in the order JAX flattens a pytree: dict keys sorted,
sequences in order, `None` an empty subtree, so `flat_paths` names the
leaves as the reference does and `tree_flatten` lists them in the order
the reference's optimizer and checkpoint engine take them."""
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


class _Leaf:
    """The mark of a leaf position in a `tree_flatten` structure."""

    def __repr__(self):
        return "*"


LEAF = _Leaf()


def tree_flatten(tree):
    """(leaves in JAX's order, structure): the structure is `tree` with
    every leaf replaced by `LEAF`, for `tree_unflatten` and
    `flatten_up_to`."""
    return tree_leaves(tree), tree_map(lambda _: LEAF, tree)


def tree_unflatten(treedef, leaves):
    """The tree of structure `treedef` whose leaves, in JAX's order, are
    `leaves`."""
    it = iter(leaves)
    out = _fill(treedef, it)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the structure "
                         "has")
    return out


def _fill(node, it):
    if node is LEAF:
        try:
            return next(it)
        except StopIteration:
            raise ValueError("tree_unflatten: fewer leaves than the "
                             "structure has") from None
    if isinstance(node, dict):
        filled = {k: _fill(node[k], it) for k in sorted(node)}
        return {k: filled[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(x, it) for x in node)
    return None


def flatten_up_to(treedef, tree) -> list:
    """`tree`'s subtrees at `treedef`'s leaf positions, in JAX's order
    (`PyTreeDef.flatten_up_to`): a subtree there stays whole, as the
    factored second moment's {"row", "col"} does for its param."""
    out = []

    def walk(node, sub):
        if node is LEAF:
            out.append(sub)
        elif isinstance(node, dict):
            if not isinstance(sub, dict) or set(sub) != set(node):
                raise ValueError("flatten_up_to: the tree does not have "
                                 "the structure's keys")
            for k in sorted(node):
                walk(node[k], sub[k])
        elif isinstance(node, (list, tuple)):
            if not isinstance(sub, (list, tuple)) or len(sub) != len(node):
                raise ValueError("flatten_up_to: the tree does not have "
                                 "the structure's sequences")
            for a, b in zip(node, sub):
                walk(a, b)
    walk(treedef, tree)
    return out


def tree_map(fn, tree):
    """`fn` applied to every leaf; dicts, lists and tuples rebuilt."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return None if tree is None else fn(tree)


def tree_index(tree, idx):
    """Every leaf indexed by `idx` (an int or a tuple): one layer's params
    or state out of a stack of them."""
    return tree_map(lambda x: x[idx], tree)


def tree_unbind(tree, n: int) -> list:
    """A stacked tree's `n` slices along the leading axis, one
    `torch.unbind` a leaf: the same values as `tree_index(tree, i)` for
    each i, whose gradients a single stack gathers in backward (an index
    a slice would build a zero gradient of the whole stack each)."""
    leaves, treedef = tree_flatten(tree)
    cols = [torch.unbind(x) for x in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols]) for i in range(n)]


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
