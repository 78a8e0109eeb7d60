"""Parameter trees: nested dicts of tensors (or arrays), walked in sorted
key order — the order ``jax.tree_util`` flattens dicts in, so the leaf
names (``"attn/wq"``) and their order match the reference's store
layout."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

PyTree = Any


def leaves_with_path(tree: PyTree, prefix: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_path(tree[key], prefix + (str(key),))
    else:
        yield prefix, tree


def leaves(tree: PyTree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(abstract: PyTree, values: Dict[str, Any]) -> PyTree:
    """Rebuild ``abstract``'s structure from ``{"a/b": value}`` leaves."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        return values["/".join(prefix)]
    return build(abstract, ())
