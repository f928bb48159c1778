"""Symbolic math-answer judge (OlympiadBench protocol).

Re-implementation of the reference's OlympiadBenchEvaluator
(lmms-eval/lmms_eval/tasks/olympiadbench/olympiadbench_evals.py:23-354)
judging protocol:

* answers are pulled out of ``\\boxed{...}`` groups (all of them,
  comma-joined), else the ``$...$`` groups on the final line, else the
  raw string;
* LaTeX decoration is normalized away (``\\left/\\right``, ``$``, ``%``,
  degree marks, primes, ``\\approx``→``=``, ``\\mathrm/\\mathbf``
  unwrapped, the RHS taken from ``x \\in S`` memberships);
* multi-answers split on top-level commas and ``\\pm`` expands into the
  +/- pair, then items match greedily in either order;
* two items are equal when any of these hold, tried in order: identical
  strings, interval equality (same bracket kinds, member-wise expression
  equality across ``\\cup`` unions), numeric equality within the
  per-question tolerance (including the reference's x100 / /100
  percentage aliases), symbolic expression equality (sympy, pi
  substituted numerically; numeric-valued expressions compare by
  ``evalf`` within tolerance, symbolic ones by ``simplify(a-b) ~ 0``),
  or equation equality (``lhs-rhs`` of one divides the other to a
  nonzero integer).

The reference parses LaTeX through antlr; this module uses sympy's lark
backend (no extra runtime dependency) and degrades to string comparison
when a parse fails.
"""

from __future__ import annotations

import math
import re
from typing import List

_SYMBOL_REWRITES = (
    ("\\left", ""), ("\\right", ""), ("∶", ":"), ("，", ","), ("$", ""),
    ("\\approx", "="), ("\\simeq", "="), ("\\sim", "="),
    ("^\\prime", "'"), ("^{\\prime}", "'"), ("^\\circ", ""), ("%", ""),
)
_STRIP_CHARS = "\n$,.:;^_=+`!@#$%^&*~，。"
_MAX_POW_EXP = 1000.0


def _parse(expr: str):
    from sympy.parsing.latex import parse_latex

    # sympy's lark grammar has no \pi terminal (an upstream TODO); the
    # reference substitutes pi numerically before comparing anyway
    # (sympy_sub_pi), so fold the substitution into parsing.
    expr = expr.replace("\\pi", "(3.141592653589793)")
    return parse_latex(expr, backend="lark")


def _sub_pi(e):
    import sympy as sp

    return e.subs(sp.Symbol("pi"), math.pi).subs(sp.pi, math.pi)


def extract_boxed(latex: str) -> str:
    """All ``\\boxed{...}`` bodies comma-joined; else the ``$...$`` groups
    of the last line; else the input unchanged."""
    out = ""
    for m in re.finditer(r"\\boxed{", latex):
        depth, i = 1, m.end()
        while depth and i < len(latex):
            depth += {"{": 1, "}": -1}.get(latex[i], 0)
            i += 1
        if depth == 0:
            out += latex[m.end():i - 1] + ","
    if out:
        return out
    last = latex.strip().split("\n")[-1]
    dollars = re.findall(r"\$(.*?)\$", last)
    if dollars:
        return ",".join(dollars) + ","
    return latex


def _normalize(expr: str) -> str:
    if "\\in " in expr:
        expr = expr.split("\\in ")[1]
    for old, new in _SYMBOL_REWRITES:
        expr = expr.replace(old, new)
    expr = expr.strip(_STRIP_CHARS)
    expr = re.sub(r"\\(?:mathrm|mathbf)\{~?([^}]*)\}", r"\1", expr)
    return expr


def split_top_level(expr: str) -> List[str]:
    """Split on commas not nested inside () or []."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(expr):
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(expr[start:i].strip())
            start = i + 1
    if start < len(expr):
        parts.append(expr[start:].strip())
    return parts


def _expand_pm(items: List[str]) -> List[str]:
    out = []
    for it in items:
        if "\\pm" in it:
            out.append(it.replace("\\pm", "+"))
            out.append(it.replace("\\pm", "-"))
        else:
            out.append(it)
    return out


def _is_interval(s: str) -> bool:
    return s.startswith(("(", "[")) and s.endswith((")", "]"))


def _numeric_equal(ref: str, pred: str, tol: float) -> bool:
    r, p = float(ref), float(pred)
    return any(abs(cand - p) <= tol * 1.01
               for cand in (r / 100.0, r, r * 100.0))


def _computable_power(e) -> bool:
    import sympy as sp

    if isinstance(e, sp.Pow):
        base, exp = e.as_base_exp()
        return (base.is_number and exp.is_number
                and abs(float(exp.evalf())) <= _MAX_POW_EXP)
    return True


def _expression_equal(ref: str, pred: str, tol: float) -> bool:
    import sympy as sp

    ref = ref.split("=", 1)[1].strip() if "=" in ref else ref.strip()
    pred = pred.split("=", 1)[1].strip() if "=" in pred else pred.strip()
    a, b = sp.sympify(_parse(ref)), sp.sympify(_parse(pred))
    if a == b:
        return True
    a, b = _sub_pi(a), _sub_pi(b)
    a_sym, b_sym = a.has(sp.Symbol), b.has(sp.Symbol)
    if a_sym != b_sym:
        return False
    if not a_sym:
        if not (_computable_power(a) and _computable_power(b)):
            return False
        return abs(float(a.evalf()) - float(b.evalf())) <= tol * 1.01
    diff = sp.simplify(a - b)
    return abs(float(diff.evalf())) < 1e-3


def _equation_equal(ref: str, pred: str) -> bool:
    import sympy as sp

    def residual(eq: str):
        lhs, rhs = eq.split("=", 1)
        return sp.simplify(_parse(lhs) - _parse(rhs))

    ra, rb = residual(ref), residual(pred)
    for num, den in ((ra, rb), (rb, ra)):
        q = sp.simplify(num / den)
        if q.is_Integer and q != 0:
            return True
    return False


def _interval_equal(ref: str, pred: str, tol: float) -> bool:
    parts_r = ref.split("\\cup")
    parts_p = pred.split("\\cup")
    if len(parts_r) != len(parts_p):
        return False
    for ir, ip in zip(parts_r, parts_p):
        ir, ip = ir.strip(), ip.strip()
        if ir[0] != ip[0] or ir[-1] != ip[-1]:
            return False
        ends_r = ir.strip("[]()").split(",")
        ends_p = ip.strip("[]()").split(",")
        if len(ends_r) != len(ends_p):
            return False
        for er, ep in zip(ends_r, ends_p):
            if not _expression_equal(er, ep, tol):
                return False
    return True


def _item_equal(ref: str, pred: str, tol: float) -> bool:
    if ref == pred and ref != "":
        return True
    if _is_interval(ref) and _is_interval(pred):
        try:
            if _interval_equal(ref, pred, tol):
                return True
        except Exception:
            return False
    try:
        if _numeric_equal(ref, pred, tol):
            return True
    except Exception:
        pass
    try:
        if _expression_equal(ref, pred, tol) \
                and not ("=" in ref and "=" in pred):
            return True
    except Exception:
        pass
    try:
        if "=" in ref and "=" in pred and _equation_equal(ref, pred):
            return True
    except Exception:
        pass
    return False


def _parse_tols(precision) -> list:
    """Normalize a tolerance spec to a non-empty list of floats.

    OlympiadBench stores per-question tolerance as a string field
    (``"1e-2"``, or comma-joined per-component ``"1e-2,1e-3"``); a str
    reaching the arithmetic (``tol * 1.01``) raises inside the equality
    helpers, whose blanket ``except`` then silently disables tolerance
    matching — so parse everything up front."""
    if precision is None:
        return [1e-8]
    if isinstance(precision, str):
        precision = [p for p in precision.split(",") if p.strip()]
    if not isinstance(precision, (list, tuple)):
        precision = [precision]
    out = []
    for p in precision:
        try:
            out.append(float(p))
        except (TypeError, ValueError):
            out.append(1e-8)
    return out or [1e-8]


def judge(reference: str, prediction: str, precision=1e-8) -> bool:
    """True when ``prediction`` matches ``reference`` under the
    OlympiadBench equivalence protocol.  ``precision`` may be a scalar,
    a per-answer-component list, or the dataset's string form of either."""
    precision = _parse_tols(precision)
    try:
        ref = _normalize(extract_boxed(str(reference)))
        pred = _normalize(extract_boxed(str(prediction)))
    except Exception:
        return False
    if ref == pred:
        return True
    ref = re.sub(r"[\u4e00-\u9fff]+", "", ref)
    pred = re.sub(r"[\u4e00-\u9fff]+", "", pred)

    ref_items = _expand_pm(split_top_level(ref))
    pred_items = _expand_pm(split_top_level(pred))
    if len(ref_items) != len(pred_items):
        return False
    # pad with the last tolerance: a spec shorter than the component
    # count must not truncate the zip below (unchecked components would
    # score as correct)
    tols = list(precision)
    if len(tols) < len(ref_items):
        tols += [tols[-1]] * (len(ref_items) - len(tols))
    for r_item, tol in list(zip(ref_items, tols)):
        for p_item in pred_items:
            if _item_equal(r_item, p_item, tol):
                pred_items.remove(p_item)
                break
        else:
            return False
    return True
