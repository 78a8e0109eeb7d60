"""Parameter trees: nested dicts and lists of tensors (or arrays), walked
as ``jax.tree_util`` flattens them: dicts in sorted key order, lists and
tuples in index order.  So the leaf names (``"attn/wq"``,
``"blocks/10/conv1"``) and their order match the reference's store
layout; ``blocks/10`` comes after ``blocks/9``, unlike a sorted string
key.

A class registered with :func:`register_node` (``quant.QuantLeaf``) is a
node with children (``tree_children()`` / ``tree_rebuild(children)``):
:func:`tree_map` maps each child, while :func:`leaves_with_path` yields
the node as one leaf, under the name the store gives it."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

PyTree = Any

_NODES: set = set()
_SEQUENCES = (list, tuple)


def register_node(cls):
    """Class decorator: instances are tree nodes with children."""
    _NODES.add(cls)
    return cls


def leaves_with_path(tree: PyTree, prefix: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_path(tree[key], prefix + (str(key),))
    elif type(tree) in _SEQUENCES:
        for i, child in enumerate(tree):
            yield from leaves_with_path(child, prefix + (str(i),))
    else:
        yield prefix, tree


def leaves(tree: PyTree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if type(tree) in _SEQUENCES:
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if type(tree) in _NODES:
        kids = zip(tree.tree_children(),
                   *(r.tree_children() for r in rest))
        return tree.tree_rebuild([fn(*k) for k in kids])
    return fn(tree, *rest)


def unflatten(abstract: PyTree, values: Dict[str, Any]) -> PyTree:
    """Rebuild ``abstract``'s structure from ``{"a/b": value}`` leaves.
    (A module-level walk: a recursive closure would hold ``values`` in a
    reference cycle, alive until the garbage collector runs, which kept a
    training step's gradients beside the next step's.)"""
    return _unflatten(abstract, (), values)


def _unflatten(node: PyTree, prefix: Tuple[str, ...],
               values: Dict[str, Any]) -> PyTree:
    if isinstance(node, dict):
        return {k: _unflatten(v, prefix + (str(k),), values)
                for k, v in node.items()}
    if type(node) in _SEQUENCES:
        return type(node)(_unflatten(v, prefix + (str(i),), values)
                          for i, v in enumerate(node))
    return values["/".join(prefix)]
