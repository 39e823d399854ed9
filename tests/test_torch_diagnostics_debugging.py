"""The port's structure-function diagnostics (``utils.diagnostics``) and
NaN-check mode (``utils.debugging``) against the JAX package on the CPU.

- ``structure_function``, ``phase_structure_function`` and
  ``fit_structure_exponent`` bit for bit the reference's on the same
  inputs (a numpy copy), on ``tests/test_utils.py``'s Kolmogorov phases
  and on a DataPack's phases;
- ``checked`` raises where the reference's ``checkify`` raises, with its
  message, in the three cases measured on the reference: a NaN made by an
  operation (a NaN passed in included), a float division by zero, an
  out-of-bounds index; it raises on none of ±inf, a NaN only moved
  (reshape, concatenation) or a negative index; ``enabled=False`` returns
  the function itself;
- ``assert_all_finite`` raises FloatingPointError naming the leaf's path
  as ``jax.tree_util.keystr`` writes it.
"""
import math
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.utils import debugging as jdbg, diagnostics as jdiag
from ionotomo_tpu_torch.data.synth import generate_example_datapack
from ionotomo_tpu_torch.utils import debugging as tdbg, diagnostics as tdiag

torch.set_num_threads(2)


def kolmogorov_screen(na=40, m=600, s2=0.8, big_l=400.0):
    """``tests/test_utils.py``'s phases: antenna positions and ``m``
    realisations of a GP with k(r) = s2·exp(-(r/L)^(5/3))."""
    rng = np.random.default_rng(0)
    pos = np.concatenate([rng.uniform(0, 60, (na, 2)), np.zeros((na, 1))],
                         -1)
    r = np.linalg.norm(pos[:, None, :2] - pos[None, :, :2], axis=-1)
    k = s2 * np.exp(-((r / big_l) ** (5.0 / 3.0)))
    chol = np.linalg.cholesky(k + 1e-10 * np.eye(na))
    return pos, chol @ rng.standard_normal((na, m))


def test_structure_functions_are_the_reference_bit_for_bit():
    pos, vals = kolmogorov_screen()
    want = jdiag.structure_function(pos, vals, n_bins=10)
    got = tdiag.structure_function(pos, vals, n_bins=10)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tdiag.fit_structure_exponent(*got[:2]) \
        == jdiag.fit_structure_exponent(*want[:2])
    assert tdiag.fit_structure_exponent(got[0], got[1], r_max_km=10.0) \
        == jdiag.fit_structure_exponent(want[0], want[1], r_max_km=10.0)
    dp, _ = generate_example_datapack(n_antennas=12, n_directions=4,
                                      n_times=2, grid_shape=(12, 12, 12),
                                      n_samples=17, device="cpu")
    for f in (None, 120e6):
        want = jdiag.phase_structure_function(dp, f, n_bins=6)
        got = tdiag.phase_structure_function(dp, f, n_bins=6)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tdiag.fit_structure_exponent([1.0, np.nan], [1.0, 2.0])


def reference_message(fn, *args):
    with pytest.raises(Exception) as e:
        jdbg.checked(fn)(*(jnp.asarray(a) for a in args))
    return str(e.value).splitlines()[0]


@pytest.mark.parametrize("case", ["nan_made", "nan_passed_in",
                                  "division_by_zero", "zero_over_zero",
                                  "out_of_bounds"])
def test_checked_raises_where_the_reference_raises(case):
    x = {"nan_made": np.array([-1.0, 4.0], np.float32),
         "nan_passed_in": np.array([np.nan], np.float32),
         "division_by_zero": np.array([0.0, 1.0], np.float32),
         "zero_over_zero": np.array([0.0], np.float32),
         "out_of_bounds": np.array([1.0, 2.0, 3.0], np.float32)}[case]
    idx = np.array([5])
    fn, args = {"nan_made": (lambda v: v ** 0.5, (x,)),
                "nan_passed_in": (lambda v: v * 2, (x,)),
                "division_by_zero": (lambda v: 1.0 / v, (x,)),
                "zero_over_zero": (lambda v: v / v, (x,)),
                "out_of_bounds": (lambda v, i: v[i], (x, idx))}[case]
    want = reference_message(fn, *args)
    with pytest.raises((FloatingPointError, IndexError)) as e:
        tdbg.checked(fn)(*(torch.from_numpy(a) for a in args))
    assert str(e.value) == want.rstrip(" ")


def test_checked_lets_through_what_the_reference_lets_through():
    x = torch.tensor([1.0, 2.0, 3.0])
    nan = torch.tensor([math.nan])
    ok = {"inf": (lambda v: torch.exp(v * 1000.0), x),
          "log0": (lambda v: torch.log(v - 1.0), x),
          "reshape_nan": (lambda v: v.reshape(1, 1), nan),
          "concat_nan": (lambda v: torch.cat([v, v]), nan),
          "negative_index": (lambda v: v[torch.tensor([-1])], x)}
    for name, (fn, v) in ok.items():
        jv = jnp.asarray(v.numpy())
        jfn = {"inf": lambda a: jnp.exp(a * 1000.0),
               "log0": lambda a: jnp.log(a - 1.0),
               "reshape_nan": lambda a: a.reshape(1, 1),
               "concat_nan": lambda a: jnp.concatenate([a, a]),
               "negative_index": lambda a: a[jnp.asarray([-1])]}[name]
        want = np.asarray(jdbg.checked(jfn)(jv))
        np.testing.assert_array_equal(tdbg.checked(fn)(v).numpy(), want,
                                      err_msg=name)
    # a Python integer index past the end: PyTorch's own IndexError
    with pytest.raises(IndexError):
        tdbg.checked(lambda v: v[5])(x)
    # clean input: the checked call returns the unchecked result bitwise
    f = lambda v: (torch.exp(v) * torch.sqrt(v) / v.sum()).cumsum(0)  # noqa
    assert torch.equal(tdbg.checked(f)(x), f(x))


def test_checked_disabled_returns_the_function_itself():
    def bad(v):
        return torch.log(v)

    assert tdbg.checked(bad, enabled=False) is bad
    assert jdbg.checked(bad, enabled=False) is bad
    assert torch.isnan(bad(torch.tensor([-1.0]))).all()


class Pair(NamedTuple):
    first: object
    second: object


def test_assert_all_finite_names_the_leaf():
    clean = {"a": np.ones(3), "b": [torch.ones(2), (1.0, None)],
             "c": Pair(np.zeros(1), torch.arange(3))}
    tdbg.assert_all_finite(clean)
    cases = {"dict": {"a": np.array([1.0, np.nan]), "b": 1},
             "nested": {"z": [np.ones(1), {"k": np.array([np.inf])}]},
             "namedtuple": Pair(np.ones(2), np.array([np.nan]))}
    for name, tree in cases.items():
        with pytest.raises(FloatingPointError) as want:
            jdbg.assert_all_finite(tree, name="state")
        torch_tree = {"dict": {"a": torch.tensor([1.0, math.nan]), "b": 1},
                      "nested": {"z": [torch.ones(1),
                                       {"k": torch.tensor([math.inf])}]},
                      "namedtuple": Pair(torch.ones(2),
                                         torch.tensor([math.nan]))}[name]
        for t in (tree, torch_tree):
            with pytest.raises(FloatingPointError) as got:
                tdbg.assert_all_finite(t, name="state")
            assert str(got.value) == str(want.value), name
