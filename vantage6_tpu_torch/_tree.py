"""Minimal pytree helpers over dicts, lists and tuples of tensors.

The JAX package walks parameter trees with ``jax.tree.map``; the port keeps
the same nested-dict layout (``{"embed", "pos", "layers": [...]}``) and
walks it with these functions instead of a private torch API.

Dict keys are visited in sorted order, as ``jax.tree.leaves`` visits them,
so a flat-packed tree (``fed.collectives.flatten_tree``) has the JAX
package's layout whatever order the dict was built in. Named tuples (an
optimizer's state) keep their type.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list[Any]:
    """Leaves in the same order ``tree_map`` visits them."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten(like: Any, leaves: list[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       path: str = "") -> Any:
    """``tree_map`` of ``fn(path, leaf)``, each path written as
    ``jax.tree_util.keystr`` writes it: ``['key']`` for a dict key,
    ``[i]`` for a list or tuple index, ``.name`` for a named tuple's
    field (``"['layers'][0]['w_up']"``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{path}[{k!r}]")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):
            return type(tree)(*(
                tree_map_with_path(fn, x, f"{path}.{name}")
                for name, x in zip(tree._fields, tree)))
        return type(tree)(tree_map_with_path(fn, x, f"{path}[{i}]")
                          for i, x in enumerate(tree))
    return fn(path, tree)
