"""Nested dicts, lists and tuples flattened in JAX's order, with JAX's key strings.

``torch.utils._pytree`` keeps a dict's insertion order; ``jax.tree_util``
sorts the keys. The wire's bucket plan, the checkpoint manifest's leaf
numbering and ``ckpt.restore``'s zip against a template all follow the
reference's order, so the port flattens as JAX does:

* a dict's children in sorted-key order, keyed ``['name']`` (``repr`` of the key);
* a list's or tuple's children in order, keyed ``[i]``; a namedtuple's ``.field``;
* ``None`` is an empty node (no leaf), as in JAX;
* anything else is a leaf.

A path is the tuple of its entries, each ``("key", k)``, ``("idx", i)`` or
``("attr", name)``; :func:`keystr` joins them into ``jax.tree_util.keystr``'s
form, e.g. ``"['layers']['wq']"``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(node) -> tuple[str, list[tuple[tuple, Any]]] | None:
    """(kind, [(path entry, child)]) of an inner node, None for a leaf."""
    if isinstance(node, dict):
        return "dict", [(("key", k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return "namedtuple", [(("attr", f), getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return type(node).__name__, [(("idx", i), v) for i, v in enumerate(node)]
    if node is None:
        return "none", []
    return None


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path: ``['a'][0].b``."""
    out = []
    for kind, k in path:
        out.append(f"[{k!r}]" if kind == "key" else f"[{k}]" if kind == "idx" else f".{k}")
    return "".join(out)


def _walk(node, path: tuple) -> Iterator[tuple[tuple, Any]]:
    ch = _children(node)
    if ch is None:
        yield path, node
        return
    for entry, child in ch[1]:
        yield from _walk(child, path + (entry,))


def flatten_with_path(tree: Any) -> tuple[list[tuple[tuple, Any]], Any]:
    """-> ([(path, leaf)], treedef), leaves in JAX's order."""
    return list(_walk(tree, ())), tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in _walk(tree, ())]


def leaves_with_keys(tree: Any) -> list[tuple[str, Any]]:
    """[(keystr, leaf)] in JAX's order."""
    return [(keystr(p), leaf) for p, leaf in _walk(tree, ())]


def unflatten(treedef: Any, new_leaves) -> Any:
    """Rebuild ``treedef``'s structure (any tree of that shape) around ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        ch = _children(node)
        if ch is None:
            return next(it)
        kind, kids = ch
        if kind == "dict":
            # the keys in the node's own order: a rebuilt dict iterates as the template
            built = {entry[1]: build(child) for entry, child in kids}
            return {k: built[k] for k in node}
        if kind == "none":
            return None
        vals = [build(child) for _, child in kids]
        if kind == "namedtuple":
            return type(node)(*vals)
        return vals if kind == "list" else type(node)(vals)
    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree structure holds")
    return out


_END = object()


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest`` (same structure)."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree structures differ: {len(flat)} and {len(o)} leaves")
    return unflatten(tree, [fn(*args) for args in zip(flat, *others)])
