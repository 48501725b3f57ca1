"""Mean functions as design matrices from R-style formulas.

Port of ``mogp_tpu/models/meanfun.py``: :func:`design_matrix` on the host
(numpy), and :func:`design_matrix_fn`, the same columns from a query
tensor on its device.  The prediction of a ``MultiOutputGP`` (its
``predict``, the history-matching sweep, SMC's implausibility, the sharded
prediction) builds a formula mean's columns with the latter, one query tile
at a time, from the caller's coordinates of the tile in float64, and then
casts them to the emulators' dtype (``models/mogp.py::_queries``).

The reference builds its mean design matrix with patsy
(``GaussianProcess.py:485-515``) and keeps a separate symbolic
mean-function AST (``MeanFunction.py``) mainly for the GPU path.  Here a
small self-contained formula layer produces the design matrix directly:

* ``design_matrix(mean, inputs)`` -- the runtime entry point.  ``None`` /
  ``"0"`` / ``"-1"`` give a zero-column matrix (zero mean), ``"1"`` /
  ``"-0"`` a constant column, and any other string is parsed as an
  R-style formula over ``x[0] ... x[D-1]``.
* Formula surface: ``"y ~ a + b"`` (LHS stripped), implicit intercept
  (suppressed by ``+ 0`` or ``- 1``), ``+`` term joins, ``:`` products,
  ``*`` crossing (``a*b == a + b + a:b``), ``I(expr)`` literal arithmetic,
  numpy-style expressions on ``x`` (e.g. ``"x[0] + I(x[0]**2)"``), and
  categorical terms ``C(expr)`` / ``C(expr, levels=[...])`` with patsy's
  treatment (dummy) coding.

Categorical semantics (patsy ``C()``, ``GaussianProcess.py:505``):

* A ``C(...)`` factor expands to indicator columns over its levels.  The
  levels are captured from the data the formula is FIRST evaluated on
  (model construction) and carried in a ``state`` dict so prediction
  reuses the training levels; a value outside the bound levels raises
  (patsy behaviour).  Explicit ``levels=[...]`` pins them up front.
* Coding rule (patsy's, for the terms below): a categorical factor of a
  term gets treatment coding (``len(levels) - 1`` columns, first level
  dropped) when the term without that factor is already in the model,
  the intercept counting as the term with no factors, and full coding
  (``len(levels)`` columns) otherwise.  So a lone ``C(...)`` under an
  intercept drops a level; ``x[0] + x[0]:C(x[1])`` drops one inside the
  interaction, because ``x[0]`` spans what the baseline level would add;
  ``x[0]:C(x[1])`` alone keeps all of its levels.  This differs from
  ``mogp_tpu``, which codes every factor inside a ``:`` term in full and
  so gives a rank-deficient design for ``x[0] + x[0]:C(x[1])``.
  ``:`` products expand column-wise (numeric x each indicator;
  categorical x categorical gives all pairwise indicator products).
* ``C(...)`` must be a whole ``:``-factor; embedding it inside
  arithmetic (``I(C(x[0]) + 1)``) raises an explicit error.

Documented boundary vs patsy: arbitrary-environment name lookup (patsy
evaluates terms against the caller's frame) is not supported; terms see
only ``x`` and the numpy namespace below.

The design matrix is a plain numpy array; formula parsing happens once
on the host at model-construction time.
"""

import re

import numpy as np
import torch

__all__ = ["design_matrix", "design_matrix_fn", "parse_formula", "n_mean_params"]

# a factor that is entirely one C(...) call (categorical)
_C_FACTOR_RE = re.compile(r"^\s*C\s*\((.*)\)\s*$", re.S)


def _split_top_level(s, seps):
    """Split string on separator characters at parenthesis depth zero."""
    parts = []
    depth = 0
    current = ""
    current_sep = None
    out = []
    for ch in s:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if depth == 0 and ch in seps:
            out.append((current_sep, current))
            current = ""
            current_sep = ch
        else:
            current += ch
    out.append((current_sep, current))
    return [(sep, part.strip()) for sep, part in out]


def _expand_term(term):
    """Expand patsy-style ``*`` crossing into a list of ``:`` products.

    ``a*b`` -> ``[a, b, a:b]``; ``a:b`` stays a single product term.
    """
    pieces = _split_top_level(term, "*")
    if len(pieces) == 1:
        return [term.strip()]
    factors = [p for _, p in pieces]
    expanded = []
    # all non-empty subsets in patsy order: mains first, then interactions
    # (for two-way and higher crossings we emit mains + the full product of
    # each prefix, which covers the common a*b and a*b*c usage)
    from itertools import combinations

    for k in range(1, len(factors) + 1):
        for combo in combinations(factors, k):
            expanded.append(":".join(combo))
    return expanded


def parse_formula(formula):
    """Parse a formula string into ``(intercept, terms)``.

    ``intercept`` is a bool; ``terms`` is a list of product-term strings
    (each a ``:``-joined list of factors).
    """
    if "~" in formula:
        formula = formula.split("~", 1)[1]
    raw_terms = _split_top_level(formula, "+-")
    intercept = True
    terms = []
    for sep, term in raw_terms:
        if term == "":
            continue
        if term in ("0",):
            if sep in (None, "+"):
                intercept = False
            continue
        if term == "1":
            if sep == "-":
                intercept = False
            else:
                intercept = True
            continue
        if sep == "-":
            # term removal: drop matching previously-seen terms
            terms = [t for t in terms if t != term]
            continue
        for expanded in _expand_term(term):
            if expanded not in terms:
                terms.append(expanded)
    return intercept, terms


def _term_namespace(x_data, xp):
    """Restricted eval namespace over array module ``xp``."""
    return {
        "x": x_data,
        "I": lambda v: v,
        "np": xp,
        "log": xp.log,
        "exp": xp.exp,
        "sqrt": xp.sqrt,
        "sin": xp.sin,
        "cos": xp.cos,
        "abs": xp.abs,
        "__builtins__": {},
    }


def _eval_expr(expr, namespace):
    """Evaluate a numeric term expression with shared error mapping."""
    try:
        return eval(expr, namespace)  # noqa: S307 - restricted namespace
    except Exception as exc:
        if isinstance(exc, NameError) and re.search(r"\bC\s*\(", expr):
            raise ValueError(
                "categorical 'C(...)' must be a whole ':'-factor (e.g. "
                "'C(x[0])' or 'x[1]:C(x[0])'); it cannot be embedded in "
                "arithmetic; offending term: '{}'".format(expr)
            )
        raise ValueError(
            "Provided mean function is invalid: could not evaluate "
            "term '{}': {}".format(expr, exc)
        )


def _eval_factor(factor, x_data, xp):
    """Evaluate one numeric factor expression over ``x_data`` ``(D, n)``
    with array module ``xp``."""
    return _eval_expr(factor, _term_namespace(x_data, xp))


def _parse_categorical(factor):
    """``(expr, explicit_levels_or_None)`` for a whole-``C(...)`` factor,
    else ``None``."""
    m = _C_FACTOR_RE.match(factor)
    if m is None:
        return None
    parts = _split_top_level(m.group(1), ",")
    expr = parts[0][1]
    levels = None
    for _, extra in parts[1:]:
        extra = extra.strip()
        if extra.startswith("levels"):
            lv = extra.split("=", 1)[1]
            levels = np.asarray(
                eval(lv, {"__builtins__": {}, "np": np})  # noqa: S307
            ).ravel()
        else:
            raise ValueError(
                "unsupported C(...) argument '{}' (only 'levels=[...]' "
                "is recognised) in factor '{}'".format(extra, factor)
            )
    return expr, levels


def _term_key(term):
    """A term's identity: the set of its ``:``-factors."""
    return frozenset(f for _, f in _split_top_level(term, ":"))


def _reduced_factors(intercept, terms):
    """Per term, per factor: whether the factor takes treatment coding,
    i.e. whether the term without it is already in the model (the
    intercept is the empty term; see the module docstring)."""
    seen = {frozenset()} if intercept else set()
    flags = []
    for term in terms:
        key = _term_key(term)
        flags.append([key - {f} in seen for _, f in _split_top_level(term, ":")])
        seen.add(key)
    return flags


def _assemble(mean, x, state, xp):
    """The columns of the formula ``mean`` at inputs ``x`` ``(n, D)``, the
    one assembly of both paths.  ``xp`` is ``numpy`` (the host path: float64
    columns, and a ``C(...)`` factor binds its levels from the first data
    it sees) or ``torch`` (columns on ``x``'s device and in its type, and
    the levels must be bound already)."""
    n = x.shape[0]
    host = xp is np

    def as_col(value, dtype):
        if host:
            return np.broadcast_to(np.asarray(value, dtype=np.float64), (n,))
        if isinstance(value, (int, float)):
            # filled on the device: copying a Python number there waits for
            # the stream, so for every query tile already enqueued
            return x.new_full((n,), value, dtype=dtype)
        return torch.broadcast_to(torch.as_tensor(value, dtype=dtype, device=x.device), (n,))

    def categorical(factor, reduced):
        """Indicator columns (treatment coding when ``reduced``)."""
        expr, explicit = _parse_categorical(factor)
        # evaluated in float64 on both paths, so that a float32 query of a
        # level exact in float32 matches it without a tolerance
        x64 = np.asarray(x, dtype=np.float64) if host else x.to(torch.float64)
        col = as_col(_eval_factor(expr, x64.T, xp), torch.float64)
        key = "C({})".format(expr.strip())
        if state is not None and key in state:
            levels = np.asarray(state[key], dtype=np.float64)
        elif explicit is not None:
            levels = np.asarray(explicit, dtype=np.float64)
        elif host:
            levels = np.unique(col)
        else:
            raise ValueError(
                "categorical factor '{}' needs bound levels on the device: pass the "
                "model's mean state (gp._mean_state) or write explicit "
                "C(..., levels=[...])".format(factor)
            )
        if host and state is not None:
            state.setdefault(key, levels)
        lv = levels if host else torch.as_tensor(levels, device=x.device)
        # EXACT level matching (patsy semantics): levels are the literal
        # values seen at binding time; tolerance matching would merge
        # adjacent large-magnitude levels into overlapping indicators
        matches = col[:, None] == lv[None, :]
        unseen = ~matches.any(1)
        if bool(unseen.any()):  # on the device, one read of a flag
            raise ValueError(
                "categorical factor '{}' saw value(s) {} outside its bound "
                "levels {} (levels are fixed at model construction, as with "
                "patsy)".format(
                    factor, xp.unique(col[unseen])[:5].tolist(), levels.tolist()
                )
            )
        ind = matches.astype(np.float64) if host else matches.to(x.dtype)
        if reduced and ind.shape[1] > 1:
            ind = ind[:, 1:]  # drop first level: treatment coding
        return ind

    intercept, terms = parse_formula(mean)
    blocks = [as_col(1.0, x.dtype)[:, None]] if intercept else []
    for term, reduced in zip(terms, _reduced_factors(intercept, terms)):
        block = None
        for (_, factor), red in zip(_split_top_level(term, ":"), reduced):
            if _C_FACTOR_RE.match(factor):
                b = categorical(factor, red)
            else:
                b = as_col(_eval_factor(factor, x.T, xp), x.dtype)[:, None]
            if block is None:
                block = b
            else:  # column-wise product expansion (Khatri-Rao over columns)
                block = (block[:, :, None] * b[:, None, :]).reshape(n, -1)
        blocks.append(block)
    if not blocks:
        return np.zeros((n, 0)) if host else x.new_zeros((n, 0))
    return np.concatenate(blocks, axis=1) if host else torch.cat(blocks, dim=1)


def design_matrix(mean, inputs, state=None):
    """Design matrix for a mean specification (``GaussianProcess.py:485-515``).

    :param mean: ``None`` or a formula string.
    :param inputs: ``(n, D)`` input array.
    :param state: optional mutable dict carrying categorical level
        bindings across calls (populated on first evaluation -- model
        construction -- and reused at prediction, patsy's
        ``design_info`` role).  Only consulted for ``C(...)`` factors.
    :returns: ``(n, M)`` numpy design matrix (M may be zero).
    """
    inputs = np.asarray(inputs)
    assert inputs.ndim == 2, "bad shape for inputs"
    n = inputs.shape[0]

    if mean is None or mean == "0" or mean == "-1":
        return np.zeros((n, 0))
    if mean == "1" or mean == "-0":
        return np.ones((n, 1))
    if not isinstance(mean, str):
        # allow a precomputed design matrix or callable for flexibility
        if callable(mean):
            dm = np.asarray(mean(inputs), dtype=np.float64)
        else:
            dm = np.asarray(mean, dtype=np.float64)
        if dm.shape[0] != n:
            raise ValueError("Provided design matrix is of the wrong shape")
        return dm

    dm = _assemble(mean, inputs, state, np)
    if dm.shape[0] != n:
        raise ValueError("Provided design matrix is of the wrong shape")
    return dm


def n_mean_params(mean, D, state=None):
    """Number of mean parameters for a formula with ``D`` inputs.

    For formulas with ``C(...)`` factors the count is computed
    structurally from the bound levels -- pass the model's ``state``
    dict (``gp._mean_state``) or write explicit ``levels=[...]``; an
    unbound categorical factor raises (its column count is
    data-dependent).
    """
    if isinstance(mean, str) and re.search(r"\bC\s*\(", mean):
        intercept, terms = parse_formula(mean)
        count = 1 if intercept else 0
        for term, reduced in zip(terms, _reduced_factors(intercept, terms)):
            width = 1
            for (_, factor), red in zip(_split_top_level(term, ":"), reduced):
                parsed = _parse_categorical(factor)
                if parsed is None:
                    if re.search(r"\bC\s*\(", factor):
                        # design_matrix would reject this formula; a
                        # silent width-1 count here would be bogus
                        raise ValueError(
                            "categorical 'C(...)' must be a whole "
                            "':'-factor; it cannot be embedded in "
                            "arithmetic; offending term: '{}'".format(
                                factor
                            )
                        )
                    continue  # numeric factors are single columns
                expr, explicit = parsed
                key = "C({})".format(expr.strip())
                if state is not None and key in state:
                    k = len(np.asarray(state[key]))
                elif explicit is not None:
                    k = len(np.asarray(explicit).ravel())
                else:
                    raise ValueError(
                        "n_mean_params for categorical factor '{}' needs "
                        "bound levels: pass the model's mean state "
                        "(gp._mean_state) or explicit C(..., "
                        "levels=[...])".format(factor)
                    )
                width *= k - 1 if (red and k > 1) else k
            count += width
        return count
    probe = np.zeros((2, D))
    probe[1] = 1.0
    return design_matrix(mean, probe, state=state).shape[1]


def design_matrix_fn(mean, state=None):
    """``x (m, D) tensor -> (m, M) tensor`` on ``x``'s device and in its
    type: the columns of :func:`design_matrix` (``mogp_tpu``'s
    ``design_matrix_fn``, ``meanfun.py:348-...``).  It serves SMC's
    particles and every ``MultiOutputGP`` prediction with a formula mean,
    which calls it once a query tile on the caller's coordinates of the
    tile in float64, so that each column is computed from the values the
    host sees and rounded once to the emulators' dtype, as the host's
    float64 columns are.

    The columns come from the assembly of the host path, evaluated with
    torch on the tensor.  A ``C(...)`` factor needs its levels bound: the
    model's ``state`` dict (``gp._mean_state``) or explicit
    ``levels=[...]``.  Its expression is evaluated in float64 and matched
    to the levels exactly, as on the host, and a query value that matches
    no level raises ``ValueError``; ``mogp_tpu``'s traced path gives such
    a row zero indicators.  The check reads one flag from the device.  A
    callable mean is applied on the host.
    """
    if mean is None or mean == "0" or mean == "-1":
        return lambda x: x.new_zeros((x.shape[0], 0))
    if mean == "1" or mean == "-0":
        return lambda x: x.new_ones((x.shape[0], 1))
    if callable(mean):
        return lambda x: torch.as_tensor(
            design_matrix(mean, x.detach().cpu().numpy()), dtype=x.dtype, device=x.device)
    if not isinstance(mean, str):
        raise ValueError(
            "design matrices on the device take a formula string, callable, or None"
        )
    return lambda x: _assemble(mean, x, state, torch)
