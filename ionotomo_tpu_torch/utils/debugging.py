"""NaN checking mode (port of ``ionotomo_tpu.utils.debugging``).

The engine is pure-functional, so the failure mode that matters is
numerical (an overflowing exp(m), degenerate geometry). ``checked`` wraps
a function so that, while it runs, every PyTorch operation is checked as
the reference's ``jax.experimental.checkify`` with ``float_checks |
index_checks`` checks it:

- an operation of those that can make a NaN (arithmetic, transcendental
  functions, reductions, products, solves, FFTs) raises
  ``FloatingPointError("nan generated by primitive: <op>")`` when a
  floating output holds a NaN, a NaN passed in included; operations that
  only move data (views, copies, concatenation, gathers, ``where``) do
  not, and neither does ±inf;
- a division raises ``FloatingPointError("division by zero")`` when a
  divisor is zero, before it runs;
- an indexing operation (``index``, ``index_select``, ``gather``,
  ``take``, ``select`` and the scatters) raises ``IndexError("out-of-bounds
  indexing ...")`` before it launches, where on the card an out-of-bounds
  index tensor would otherwise be a device assert. Negative indices count
  from the end, as in the reference. A Python integer index (``x[5]``) is
  checked by PyTorch itself, which raises its own ``IndexError`` before
  any operation runs.

A check reads its result on the host, so a checked call waits for the
card at every operation. The hand-written kernels (``kernels``) launch
through ``ctypes`` and are not PyTorch operations: their outputs are
checked where the next operation reads them. ``assert_all_finite`` is the
host-side guard for pipeline boundaries.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# aten operations (by name, in-place forms included) that can make a NaN:
# the counterparts of checkify's ``nan_primitives``
_NAN_OPS = frozenset("""
    add sub rsub mul div true_divide reciprocal pow exp exp2 expm1 log log2
    log10 log1p sqrt rsqrt sin cos tan asin acos atan atan2 sinh cosh tanh
    asinh acosh atanh sigmoid logit erf erfc erfinv lgamma digamma
    polygamma remainder fmod addcmul addcdiv lerp hypot xlogy logaddexp
    cumsum cumprod cummax cummin logcumsumexp sum nansum prod mean var std
    var_mean std_mean norm linalg_vector_norm logsumexp dot vdot mv mm bmm
    addmm addmv addbmm baddbmm linalg_cholesky_ex cholesky_solve
    linalg_solve_triangular triangular_solve linalg_solve linalg_inv_ex
    _fft_r2c _fft_c2r _fft_c2c convolution
""".split())
_DIVISIONS = frozenset(("div", "true_divide", "floor_divide", "reciprocal"))
# indexing operations by where their indices are: "dim": args (self, dim,
# index, ...); "list": (self, a list of index tensors, one a dimension);
# "flat": (self, index) into the flattened source; "int": select's
# (self, dim, Python index)
_INDEXING = {"index_select": "dim", "gather": "dim", "index_add": "dim",
             "index_copy": "dim", "index_fill": "dim", "scatter": "dim",
             "scatter_add": "dim", "scatter_reduce": "dim",
             "index": "list", "index_put": "list", "_index_put_impl": "list",
             "take": "flat", "select": "int"}


def _name(func) -> str:
    """The operation's name, an in-place form's trailing "_" dropped."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") else name


def _oob(shape, index, dim, size):
    raise IndexError(
        f"out-of-bounds indexing for array of shape {tuple(shape)}: index "
        f"{index} is out of bounds for axis {dim} with size {size}.")


def _check_index(shape, idx: torch.Tensor, dim: int):
    if idx.dtype == torch.bool or idx.numel() == 0:
        return
    size = shape[dim] if shape else 1
    bad = (idx >= size) | (idx < -size)
    if bool(bad.any()):
        _oob(shape, int(idx[bad].reshape(-1)[0]), dim, size)


def _check_indexing(kind, args):
    src = args[0]
    shape = tuple(src.shape)
    if kind == "dim":
        dim = args[1] % max(len(shape), 1)
        _check_index(shape, args[2], dim)
    elif kind == "list":
        for dim, idx in enumerate(args[1]):
            if idx is not None:
                _check_index(shape, idx, dim)
    elif kind == "flat":
        _check_index((src.numel(),), args[1], 0)
    else:
        dim = args[1] % max(len(shape), 1)
        size = shape[dim]
        if not -size <= args[2] < size:
            _oob(shape, args[2], dim, size)


def _has_zero(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool((x == 0).any())
    return x == 0


class _Checks(TorchDispatchMode):
    """Checkify's float and index checks on every operation run under it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if name in _INDEXING:
            _check_indexing(_INDEXING[name], args)
        if name in _DIVISIONS:
            divisor = args[0] if name == "reciprocal" else args[1]
            if _has_zero(divisor):
                raise FloatingPointError("division by zero")
        out = func(*args, **kwargs)
        if name in _NAN_OPS:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"nan generated by primitive: {name}.")
        return out


def checked(fn, enabled: bool = True):
    """Wrap ``fn`` so the float and index checks raise on call;
    ``enabled=False`` returns ``fn`` itself."""
    if not enabled:
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _Checks():
            return fn(*args, **kwargs)

    return wrapper


def _flatten_with_path(tree, path=""):
    """(path, leaf) pairs of nested dicts (keys sorted), lists, tuples and
    NamedTuples, with paths written as ``jax.tree_util.keystr`` writes
    them; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten_with_path(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for key in tree._fields:
            yield from _flatten_with_path(getattr(tree, key),
                                          f"{path}.{key}")
    elif isinstance(tree, (list, tuple)):
        for i, leaf in enumerate(tree):
            yield from _flatten_with_path(leaf, f"{path}[{i}]")
    else:
        yield path, tree


def assert_all_finite(tree, name="value"):
    """Host-side guard for pipeline boundaries (checkpoints, outputs):
    raise FloatingPointError naming the first floating leaf that holds a
    NaN or an infinity."""
    for path, leaf in _flatten_with_path(tree):
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise FloatingPointError(f"non-finite values in {name}{path}")
