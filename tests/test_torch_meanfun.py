"""Categorical coding of the port's mean formulas.

A categorical factor inside a ``:`` term takes treatment coding when the
term without it is already in the model (the intercept being the term
with no factors), as patsy codes it; otherwise it keeps all of its
levels.  ``mogp_tpu`` codes every factor inside a ``:`` term in full,
so for ``x[0] + x[0]:C(x[1])`` it gives a rank-deficient design; the
port does not, and these tests hold the port alone.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

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
