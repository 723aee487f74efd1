"""The port's state trees: flatten, unflatten and host leaves.

The reference flattens checkpoint state with ``jax.tree_util`` and
pickles the treedef into its manifest.  The port flattens its own
structures in a fixed order and describes them in JSON:

* ``dict`` — children in sorted key order (ints before strings), as
  ``jax.tree_util`` orders a dict, so a tree of dicts, lists and arrays
  flattens to the same leaf order in both packages;
* ``list`` / ``tuple`` — children in order;
* ``None`` — no leaf (as in ``jax.tree_util``);
* leaves: a torch tensor, a numpy array or numpy scalar, a Python bool,
  int, float or str.

Leaves travel as numpy arrays (:func:`to_host`): a tensor's bytes as they
are, except bfloat16, which numpy has no dtype for without ``ml_dtypes``:
it travels as its raw 16-bit words with the dtype name ``"bfloat16"``
beside it (:func:`dtype_name`), and :func:`from_host` turns the words
back into a bfloat16 tensor.

Pickles of host leaves are read back through :func:`safe_loads`, which
admits only builtin containers and scalars, numpy arrays and numpy
dtypes: loading a shard or snapshot never runs other code.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = ["flatten", "unflatten", "leaves_of", "to_host", "from_host",
           "dtype_name", "leaf_sig", "dumps", "loads", "safe_loads", "conform"]

_SCALARS = {bool: "bool", int: "int", float: "float", str: "str"}


def _key_order(k):
    return (0, k, "") if isinstance(k, int) else (1, 0, str(k))


def flatten(tree: Any) -> Tuple[List[Any], dict]:
    """``(leaves, spec)``: the leaves in the fixed order and the JSON
    spec of the structure.  Raises ``TypeError`` for a value that is
    neither a container nor a leaf."""
    leaves: List[Any] = []

    def walk(x):
        if isinstance(x, dict):
            keys = sorted(x, key=_key_order)
            return {"t": "dict", "k": keys, "c": [walk(x[k]) for k in keys]}
        if isinstance(x, (list, tuple)):
            return {"t": type(x).__name__ if type(x) in (list, tuple)
                    else "list", "c": [walk(v) for v in x]}
        if x is None:
            return {"t": "none"}
        if isinstance(x, torch.Tensor):
            kind = "tensor"
        elif isinstance(x, np.ndarray):
            kind = "ndarray"
        elif isinstance(x, np.generic):
            kind = "npscalar"
        elif type(x) in _SCALARS:
            kind = _SCALARS[type(x)]
        else:
            raise TypeError(
                f"cannot flatten a {type(x).__name__}: state trees hold "
                f"dicts, lists, tuples, tensors, numpy arrays and scalars")
        leaves.append(x)
        return {"t": kind}

    return leaves, walk(tree)


def leaves_of(spec: dict) -> List[str]:
    """The leaf kinds of ``spec``, in leaf order."""
    out: List[str] = []

    def walk(node):
        if node["t"] in ("dict", "list", "tuple"):
            for c in node["c"]:
                walk(c)
        elif node["t"] != "none":
            out.append(node["t"])

    walk(spec)
    return out


def unflatten(spec: dict, leaves: List[Any]) -> Any:
    """The tree of ``spec`` with ``leaves`` in leaf order (taken as they
    are: :func:`from_host` converts host leaves first)."""
    it = iter(leaves)

    def walk(node):
        t = node["t"]
        if t == "dict":
            return {k: walk(c) for k, c in zip(node["k"], node["c"])}
        if t in ("list", "tuple"):
            seq = [walk(c) for c in node["c"]]
            return tuple(seq) if t == "tuple" else seq
        if t == "none":
            return None
        return next(it)

    out = walk(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def dtype_name(x) -> str:
    """The dtype of a leaf by numpy's name (``"float32"``, ``"int64"``);
    ``"bfloat16"`` for a bfloat16 tensor."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    dtype = getattr(x, "dtype", None)
    return str(dtype if dtype is not None else np.asarray(x).dtype)


def leaf_sig(x) -> Tuple[list, str]:
    """``(shape, dtype name)`` of a leaf."""
    shape = x.shape if hasattr(x, "shape") else np.shape(x)
    return list(shape), dtype_name(x)


def to_host(x, copy: bool = True) -> np.ndarray:
    """A leaf as a numpy array; with ``copy`` one that owns its bytes
    (never a view of the caller's buffer: a background writer must not
    race an in-place update).  bfloat16 becomes its raw words
    (uint16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.to("cpu")
        elif copy:
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(x, copy=True) if copy else np.asarray(x)


def from_host(arr: np.ndarray, kind: str, dtype: str):
    """Inverse of :func:`to_host` for a leaf of ``kind`` (a
    :func:`flatten` leaf kind) whose dtype name is ``dtype``."""
    if kind == "tensor":
        # np.require keeps a 0-d array 0-d (ascontiguousarray would not)
        arr = np.require(arr, requirements="C")
        if dtype == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)
    if kind == "ndarray":
        return np.asarray(arr)
    if kind == "npscalar":
        return np.asarray(arr)[()]
    if kind in ("bool", "int", "float", "str"):
        return {"bool": bool, "int": int, "float": float,
                "str": str}[kind](np.asarray(arr).item())
    raise ValueError(f"unknown leaf kind {kind!r}")


# The globals a pickle of numpy arrays names (numpy 2 moved ``core`` to
# ``_core``; pickles written under either load).
_NUMPY_GLOBALS = {
    (mod, name)
    for core in ("numpy.core", "numpy._core")
    for mod, name in ((f"{core}.multiarray", "_reconstruct"),
                      (f"{core}.multiarray", "scalar"),
                      (f"{core}.numeric", "_frombuffer"))
} | {("numpy", "ndarray"), ("numpy", "dtype")}


class _HostUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to load {module}.{name}: a pickle of host leaves "
            f"holds only containers, scalars and numpy arrays")


def safe_loads(blob: bytes) -> Any:
    """``pickle.loads`` restricted to builtin containers and scalars,
    numpy arrays and dtypes; any other global raises
    ``pickle.UnpicklingError``."""
    return _HostUnpickler(io.BytesIO(blob)).load()


def dumps(tree: Any) -> bytes:
    """One pickle of a tree: its structure, dtype names and host leaves
    (the leaves are not copied first: pickling copies them)."""
    leaves, spec = flatten(tree)
    return pickle.dumps(
        (spec, [dtype_name(x) for x in leaves],
         [to_host(x, copy=False) for x in leaves]),
        protocol=pickle.HIGHEST_PROTOCOL)


def loads(blob: bytes) -> Any:
    """Inverse of :func:`dumps`; tensors come back on the CPU."""
    spec, dtypes, leaves = safe_loads(blob)
    return unflatten(spec, [from_host(a, k, d) for a, k, d
                            in zip(leaves, leaves_of(spec), dtypes)])


def conform(tree: Any, target: Any) -> Any:
    """``tree`` in the structure of ``target`` with each leaf of its
    target leaf's kind (a tensor on the target tensor's device).  Raises
    ``ValueError`` when the leaf counts, shapes or dtypes differ: a
    same-arity tree of another model must not restore into the wrong
    fields."""
    leaves, _ = flatten(tree)
    t_leaves, spec = flatten(target)
    if len(leaves) != len(t_leaves):
        raise ValueError(f"target has {len(t_leaves)} leaves but the "
                         f"checkpoint holds {len(leaves)}")
    out = []
    for i, (x, t, kind) in enumerate(zip(leaves, t_leaves, leaves_of(spec))):
        if leaf_sig(x) != leaf_sig(t):
            raise ValueError(f"leaf {i}: checkpoint (shape, dtype) "
                             f"{leaf_sig(x)} != target's {leaf_sig(t)}")
        y = from_host(to_host(x, copy=False), kind, dtype_name(x))
        if isinstance(t, torch.Tensor):
            y = y.to(t.device)
        out.append(y)
    return unflatten(spec, out)
