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
