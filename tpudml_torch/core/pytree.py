"""Parameter-path helpers (the port of ``tpudml/core/pytree.py``) shared
by every module that classifies parameters by their path (expert-tensor
detection), so path matching cannot diverge between classifiers. The
port's parameter paths are dotted names (``block0.moe.experts.w1``); JAX
key-path entries are read by their key, name or index, as in JAX."""

from __future__ import annotations


def key_name(k) -> str | int:
    """The name of one path entry: a dotted name's component as it is, a
    pytree key entry's ``key`` / ``name`` / ``idx``, or its str as a last
    resort."""
    if isinstance(k, (str, int)):
        return k
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    return str(k)


def path_names(path) -> tuple:
    """The names along ``path``: a dotted name's components, or each key
    entry's :func:`key_name`."""
    if isinstance(path, str):
        return tuple(path.split("."))
    return tuple(key_name(k) for k in path)


def jax_sort_key(name) -> tuple:
    """Sort key that puts dotted names in the order JAX flattens the
    nested dicts they name (keys sorted at every level): the tuple of
    their components."""
    return tuple(str(name).split("."))


def keystr(name: str) -> str:
    """JAX's ``keystr`` of the nested-dict path a dotted name stands for:
    ``block0.attn.q.kernel`` -> ``['block0']['attn']['q']['kernel']``."""
    return "".join(f"[{c!r}]" for c in name.split("."))
