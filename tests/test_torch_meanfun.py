"""Categorical coding of the port's mean formulas.

A categorical factor inside a ``:`` term takes treatment coding when the
term without it is already in the model (the intercept being the term
with no factors), as patsy codes it; otherwise it keeps all of its
levels.  ``mogp_tpu`` codes every factor inside a ``:`` term in full,
so for ``x[0] + x[0]:C(x[1])`` it gives a rank-deficient design; the
port does not, and these tests hold the port alone.

``design_matrix_fn`` builds the same columns from a tensor on its device;
it is held to the host path, and to ``mogp_tpu``'s traced path where the
two packages code a formula alike.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.models import meanfun as tmf  # noqa: E402

X = np.column_stack([np.arange(1.0, 7.0), np.repeat([0.0, 1.0, 2.0], 2)])


@pytest.mark.parametrize("formula, n_cols", [
    ("x[0] + x[0]:C(x[1])", 4),   # 1 + 1 + (3 - 1)
    ("x[0]:C(x[1])", 4),          # 1 + 3: x[0] is not in the model
    ("x[0]*C(x[1])", 6),          # 1 + 1 + 2 + 2
    ("C(x[1])", 3),               # 1 + (3 - 1)
    ("C(x[1]) - 1", 3),           # no intercept: all 3 levels
    ("x[0] - 1 + x[0]:C(x[1])", 3),
])
def test_interaction_coding_gives_a_full_rank_design(formula, n_cols):
    state = {}
    dm = tmf.design_matrix(formula, X, state=state)
    assert dm.shape == (6, n_cols)
    assert np.linalg.matrix_rank(dm) == n_cols
    assert tmf.n_mean_params(formula, 2, state=state) == n_cols
    assert tmf.n_mean_params(formula.replace("C(x[1])", "C(x[1], levels=[0, 1, 2])"), 2) == n_cols


def test_reduced_interaction_columns():
    """The baseline level's column goes; the others are x[0] times each
    remaining level's indicator."""
    dm = tmf.design_matrix("x[0] + x[0]:C(x[1])", X, state={})
    ind = X[:, 1][:, None] == np.array([1.0, 2.0])[None, :]
    np.testing.assert_array_equal(dm, np.column_stack([np.ones(6), X[:, 0], X[:, :1] * ind]))


def test_gp_mean_parameters_follow_the_rule():
    gp = mogp_tpu_torch.GaussianProcess(X, np.sin(X[:, 0]), mean="x[0] + x[0]:C(x[1])",
                                        device="cpu")
    assert gp.n_mean == 4
    assert gp.get_design_matrix(X[::-1]).shape == (6, 4)


_FORMULAS = ["x[0] + C(x[1])", "x[0] + x[0]:C(x[1])", "x[0]*C(x[1])", "x[0]:C(x[1])",
             "x[0]*x[1] + I(x[0]**2) + np.sin(x[1])", "1", None, "-1"]


@pytest.mark.parametrize("formula", _FORMULAS)
def test_design_matrix_fn_equals_the_host_path(formula):
    """``design_matrix_fn`` on a tensor gives the columns of
    ``design_matrix`` on the same points, with the training levels bound."""
    state = {}
    tmf.design_matrix(formula, X, state=state)
    q = np.vstack([X[::-1], X[:2] + [0.5, 0.0]])
    ref = tmf.design_matrix(formula, q, state=state)
    got = tmf.design_matrix_fn(formula, state=state)(torch.as_tensor(q))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    got32 = tmf.design_matrix_fn(formula, state=state)(torch.as_tensor(q, dtype=torch.float32))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("formula", ["x[0] + C(x[1])", "x[0]*x[1] + I(x[0]**2) + np.sin(x[1])",
                                     "1", "C(x[1], levels=[0, 1, 2]) - 1"])
def test_design_matrix_fn_matches_jax(formula):
    """Where the two packages code a formula alike, the traced design
    matrices agree (``mogp_tpu``'s ``design_matrix_fn``)."""
    import jax.numpy as jnp
    from mogp_tpu.models import meanfun as jmf

    tstate, jstate = {}, {}
    tmf.design_matrix(formula, X, state=tstate)
    jmf.design_matrix(formula, X, state=jstate)
    got = tmf.design_matrix_fn(formula, state=tstate)(torch.as_tensor(X))
    ref = jmf.design_matrix_fn(formula, state=jstate)(jnp.asarray(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_design_matrix_fn_raises_on_an_unseen_level():
    """A query level the training data did not bind raises, as on the host;
    ``mogp_tpu``'s traced path gives such a row zero indicators."""
    state = {}
    tmf.design_matrix("x[0] + C(x[1])", X, state=state)
    fn = tmf.design_matrix_fn("x[0] + C(x[1])", state=state)
    with pytest.raises(ValueError, match="outside its bound levels"):
        fn(torch.tensor([[1.0, 0.0], [2.0, 3.0]], dtype=torch.float64))
    with pytest.raises(ValueError, match="bound levels"):
        tmf.design_matrix_fn("x[0] + C(x[1])")(torch.as_tensor(X))


def test_design_matrix_fn_keeps_adjacent_large_levels_apart():
    """Levels are matched exactly on both paths: the adjacent levels 3e6 and
    3e6 + 1, exact in float32, give one indicator each from a float32 query
    as from the host."""
    train = np.column_stack([np.arange(4.0), [3e6, 3e6 + 1, 3e6 + 2, 3e6]])
    state = {}
    ref = tmf.design_matrix("x[0] + C(x[1])", train, state=state)
    for dtype in (torch.float64, torch.float32):
        got = tmf.design_matrix_fn("x[0] + C(x[1])", state=state)(
            torch.as_tensor(train, dtype=dtype))
        np.testing.assert_array_equal(got.numpy(), ref)
