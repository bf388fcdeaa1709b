"""Small tree utilities shared across subsystems (twin of
`repro/utils/tree.py`).

A tree is nested dicts, lists and tuples (named tuples too) and
dataclass instances, with tensors, arrays and scalars as leaves; None is
an empty subtree. Leaves are visited in `jax.tree_util`'s order: dict
keys sorted, sequences and dataclass fields by index (a dataclass is a
registered node there, as `train.step.TrainState` is in the reference).
The checkpoint manager keys its leaves by these paths.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) or (
        dataclasses.is_dataclass(x) and not isinstance(x, type))


def _children(node) -> list:
    """[(key, child)] of an inner node in visiting order."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return [(i, getattr(node, f.name))
            for i, f in enumerate(dataclasses.fields(node))]


def _child(node, key):
    """The child of `node` under `key` (a key of `_children`)."""
    if isinstance(node, (dict, list, tuple)):
        return node[key]
    return getattr(node, dataclasses.fields(node)[key].name)


def _rebuild(node, values: list):
    """A node of `node`'s kind holding `values` (in visiting order)."""
    if isinstance(node, dict):
        return dict(zip(sorted(node), values))
    if isinstance(node, list):
        return list(values)
    if isinstance(node, tuple):
        return (type(node)(*values) if hasattr(node, "_fields")
                else tuple(values))
    return type(node)(**{f.name: v for f, v in
                         zip(dataclasses.fields(node), values)})


def leaves_with_paths(tree, prefix=()) -> list:
    """[(path tuple, leaf)] in visiting order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, child in _children(tree):
        out += leaves_with_paths(child, prefix + (k,))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, leaves):
    """The template's structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if not _is_node(t):
            return next(it)
        return _rebuild(t, [build(c) for _, c in _children(t)])

    return build(template)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure); the result has `tree`'s structure."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    return _rebuild(tree, [tree_map(fn, child, *(_child(r, k) for r in rest))
                           for k, child in _children(tree)])


def flatten_up_to(template, tree) -> list:
    """The subtrees of `tree` at the leaf positions of `template`, in
    visiting order (`treedef.flatten_up_to`)."""
    if template is None:
        return []
    if not _is_node(template):
        return [tree]
    out = []
    for k, child in _children(template):
        out += flatten_up_to(child, _child(tree, k))
    return out


def tree_count(tree) -> int:
    """Total number of array elements in a tree."""
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)
                   if hasattr(x, "shape")))


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors or arrays."""
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif hasattr(x, "shape") and hasattr(x, "dtype"):
            total += int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
    return total


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree, dtype):
    """Cast all floating leaves to dtype, leave integer leaves alone."""
    def _cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    return tree_map(_cast, tree)


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm across a tree (float32)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))
