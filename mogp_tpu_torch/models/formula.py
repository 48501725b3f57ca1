"""String-formula parser producing mean-function ASTs.

The port's own copy of ``mogp_tpu/models/formula.py`` (pure Python; it
builds ``models/meanfunction.py``'s nodes).  It covers the formula surface of the reference (``mogp_emulator/formula.py``:
``mean_from_string`` at :87, ``mean_from_patsy_formula`` at :8) with an
independent design: a regex lexer feeding a recursive-descent parser that
builds the ``MeanBase`` tree directly from the grammar

    formula := [[IDENT] ('=' | '~')] expr
    expr    := term ('+' term)*
    term    := unary ('*' unary)*
    unary   := power
    power   := postfix ('^' power)?          # right-associative
    postfix := atom ('(' expr ')')*          # call composition
    atom    := NUMBER | IDENT | '(' expr ')'

Semantics match the reference's conventions: numeric literals become
:class:`~.meanfunction.ConstantMean`, ``x[i]`` / ``inputs[i]`` become
:class:`~.meanfunction.LinearMean`, names found in ``inputdict`` map to the
indicated input dimension, and any other identifier becomes a free
:class:`~.meanfunction.Coefficient`.  ``I(...)`` is the identity wrapper and
is only legal in call position.  Patsy is not used at runtime; the native
parser covers the same formula strings (``mean_from_patsy_formula`` is an
alias).
"""

import re

from . import meanfunction as MeanFunction

__all__ = ["mean_from_string", "mean_from_patsy_formula"]

# Token kinds. '**' must be matched before '*'; an identifier may carry one
# (non-nested) square-bracket index, e.g. x[0] or inputs[12].
_TOKEN_RE = re.compile(
    r"""
    (?P<NUMBER>  \d+\.\d*(?:[eE][+-]?\d+)? | \.\d+(?:[eE][+-]?\d+)? | \d+(?:[eE][+-]?\d+)? )
  | (?P<IDENT>   [A-Za-z_][A-Za-z_0-9.]* (?:\[\s*[^][()+*^=~\s]*\s*\])? )
  | (?P<POW>     \*\* | \^ )
  | (?P<STAR>    \* )
  | (?P<PLUS>    \+ )
  | (?P<LPAREN>  [(] )
  | (?P<RPAREN>  [)] )
  | (?P<ASSIGN>  [=~] )
  | (?P<WS>      \s+ )
  | (?P<BAD>     . )
    """,
    re.VERBOSE,
)


def _lex(formula):
    """Yield ``(kind, text)`` token pairs for a formula string."""
    out = []
    for m in _TOKEN_RE.finditer(formula):
        kind = m.lastgroup
        if kind == "WS":
            continue
        text = m.group()
        if kind == "BAD":
            if text in "[]":
                raise SyntaxError(
                    "square brackets may only index a variable name in formula input"
                )
            raise SyntaxError(
                "unrecognized character {!r} in formula input".format(text)
            )
        if kind == "IDENT":
            if "[" in text and not text.endswith("]"):
                raise SyntaxError(
                    "square brackets may only index a variable name in formula input"
                )
            if text == "call":
                raise SyntaxError(
                    "'call' cannot be used as a variable name in formula input"
                )
        out.append((kind, text))
    return out


class _Parser:
    """Recursive-descent parser over the lexed token stream."""

    def __init__(self, tokens, inputdict):
        self.tokens = tokens
        self.pos = 0
        self.inputdict = dict(inputdict)

    def peek(self):
        if self.pos < len(self.tokens):
            return self.tokens[self.pos]
        return (None, None)

    def advance(self):
        tok = self.peek()
        self.pos += 1
        return tok

    def expect(self, kind, what):
        k, text = self.advance()
        if k != kind:
            raise SyntaxError(what)
        return text

    # grammar rules ------------------------------------------------------

    def parse(self):
        # optional response prefix: "y = expr" / "y ~ expr" / bare "~ expr"
        if (
            len(self.tokens) >= 2
            and self.tokens[0][0] == "IDENT"
            and self.tokens[1][0] == "ASSIGN"
        ):
            self.pos = 2
        elif self.tokens and self.tokens[0][0] == "ASSIGN":
            self.pos = 1
        node = self.expr()
        if self.pos != len(self.tokens):
            k, text = self.peek()
            if k == "ASSIGN":
                raise SyntaxError("LHS in formula is not correctly specified")
            raise SyntaxError(
                "unexpected token {!r} in formula input".format(text)
            )
        return node

    def expr(self):
        node = self.term()
        while self.peek()[0] == "PLUS":
            self.advance()
            node = _no_identity(node) + _no_identity(self.term())
        return node

    def term(self):
        node = self.power()
        while self.peek()[0] == "STAR":
            self.advance()
            node = _no_identity(node) * _no_identity(self.power())
        return node

    def power(self):
        base = self.postfix()
        if self.peek()[0] == "POW":
            self.advance()
            return _no_identity(base) ** _no_identity(self.power())
        return base

    def postfix(self):
        node = self.atom()
        while self.peek()[0] == "LPAREN":
            self.advance()
            arg = self.expr()
            self.expect("RPAREN", "string expression has mismatched parentheses")
            if arg is _IDENTITY:
                raise SyntaxError(
                    "identity operator can only be called as a function"
                )
            node = arg if node is _IDENTITY else node(arg)
        return node

    def atom(self):
        kind, text = self.advance()
        if kind == "NUMBER":
            return MeanFunction.ConstantMean(float(text))
        if kind == "IDENT":
            return self.resolve_name(text)
        if kind == "LPAREN":
            node = self.expr()
            self.expect("RPAREN", "string expression has mismatched parentheses")
            if node is _IDENTITY:
                raise SyntaxError(
                    "identity operator can only be called as a function"
                )
            return node
        if kind == "RPAREN":
            raise SyntaxError("string expression has mismatched parentheses")
        raise SyntaxError(
            "string expression is not a valid mathematical expression"
        )

    def resolve_name(self, text):
        """Map an identifier token to a mean-function leaf."""
        if text == "I":
            # identity — legal only as a call head; postfix() unwraps it
            return _IDENTITY
        name, index = _split_index(text)
        if name == "inputs":
            name = "x"
        if name in self.inputdict:
            if index is not None:
                raise SyntaxError(
                    "cannot index a name that is already mapped in inputdict"
                )
            return MeanFunction.LinearMean(self.inputdict[name])
        if name == "x":
            if index is None:
                raise ValueError("bad formula input in mean function")
            return MeanFunction.LinearMean(index)
        if index is not None:
            raise ValueError("bad formula input in mean function")
        return MeanFunction.Coefficient()


class _Identity:
    """Sentinel for the ``I`` identity operator (call position only)."""

    def __repr__(self):  # pragma: no cover
        return "I"


_IDENTITY = _Identity()


def _no_identity(node):
    """Reject the identity sentinel outside call position."""
    if node is _IDENTITY:
        raise SyntaxError("identity operator can only be called as a function")
    return node


def _split_index(text):
    """Split ``name[i]`` into ``(name, i)``; plain names give ``(name, None)``."""
    if "[" not in text:
        return text, None
    name, _, rest = text.partition("[")
    inner = rest[:-1].strip()
    try:
        index = int(inner)
    except ValueError:
        raise ValueError("index in parsed formula is not an integer")
    if index < 0:
        raise ValueError("index in formula parsing must be non-negative")
    return name, index


def mean_from_string(formula, inputdict={}):
    """Create a mean function from a string formula.

    Parity with reference ``formula.py:87-150``: accepts an optional
    ``y =`` / ``y ~`` response prefix, ``+``/``*``/``^`` (and ``**``)
    operators, parentheses, and function-call composition.
    """
    if not isinstance(formula, str):
        raise TypeError("formula must be a string")
    tokens = _lex(formula)
    if not tokens:
        raise SyntaxError("formula input is empty")
    mf = _Parser(tokens, inputdict).parse()
    if mf is _IDENTITY:
        raise SyntaxError("identity operator can only be called as a function")
    assert issubclass(type(mf), MeanFunction.MeanBase)
    return mf


def mean_from_patsy_formula(formula, inputdict={}):
    """Alias for :func:`mean_from_string`; the native parser covers the patsy
    formula surface used by the reference (``formula.py:8-86``)."""
    if not isinstance(formula, str):
        raise TypeError("formula must be a string")
    return mean_from_string(formula, inputdict)
