"""R-style formula parser: fixed terms, interactions, random effects.

Accepts the same grammar as the reference parser
(crates/engine-spec-builder/src/formula.rs): ``y ~ x1*x2 + a:b + (1|g) +
(1+x|h) + (1|A/B)``, with ``=`` as an alternate separator and an implicit
dependent name when none is given. Behavior is pinned by the cross-port
golden corpus (configs/formula-fixtures/cases.json), re-expressed in
tests/test_formula.py:

* ``*`` expands to all main effects then all interactions, smallest order
  first, combination order within an order;
* duplicate mains / interactions are dropped (first occurrence wins);
* ``predictors`` lists every variable name appearing anywhere in the fixed
  part (mains AND interaction components), in appearance order;
* random effects are emitted in the pinned class order: nested groups,
  explicit slopes ``(1+x|g)``, implicit slopes ``(x|g)``, then intercepts —
  the order the reference's extraction pipeline produces;
* one random-effect term per grouping variable (duplicates are an error);
* intercept suppression (``(0+x|g)``, ``(-1+x|g)``) and ``-`` term removal
  are rejected.
"""

from __future__ import annotations

import itertools
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class FormulaError(ValueError):
    pass


_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_.]*$")
_RE_GROUP = re.compile(r"\(([^()|]*)\|([^()|]*)\)")


@dataclass
class RandomEffect:
    group: str
    kind: str  # "intercept" | "slope"
    vars: List[str] = field(default_factory=list)
    parent: Optional[str] = None

    def to_dict(self) -> Dict:
        d = {"group": self.group, "kind": self.kind}
        if self.kind == "slope":
            d["vars"] = list(self.vars)
        else:
            d["parent"] = self.parent
        return d


@dataclass
class ParsedFormula:
    dependent: str
    predictors: List[str]
    terms: List[Dict]  # {"kind": "main", "name"} | {"kind": "interaction", "vars"}
    random_effects: List[RandomEffect]

    @property
    def main_names(self) -> List[str]:
        return [t["name"] for t in self.terms if t["kind"] == "main"]

    @property
    def interaction_terms(self) -> List[List[str]]:
        return [t["vars"] for t in self.terms if t["kind"] == "interaction"]


def _check_ident(name: str) -> str:
    name = name.strip()
    if not _IDENT.match(name):
        raise FormulaError(f"formula syntax error: invalid identifier {name!r}")
    return name


def _split_dependent(formula: str) -> Tuple[str, str]:
    for sep in ("~", "="):
        if sep in formula:
            lhs, rhs = formula.split(sep, 1)
            dep = lhs.strip()
            if dep:
                _check_ident(dep)
            return (dep or "explained_variable"), rhs
    return "explained_variable", formula


def _classify_re(lhs: str, group: str) -> List[RandomEffect]:
    """Classify one (lhs | group) random-effect term."""
    lhs_terms = [t.strip() for t in lhs.split("+") if t.strip()]
    if any(t in ("0", "-1") for t in lhs_terms) or lhs.strip().startswith("-1"):
        raise FormulaError(
            f"intercept suppression is not supported in random effects: "
            f"({lhs}|{group})"
        )
    if "/" in group:
        parts = [_check_ident(p) for p in group.split("/")]
        if len(parts) != 2:
            raise FormulaError(
                f"formula syntax error: nested grouping {group!r} must be A/B"
            )
        if lhs_terms != ["1"]:
            raise FormulaError(
                "random slopes on nested groupings are not supported; "
                f"got ({lhs}|{group})"
            )
        a, b = parts
        return [
            RandomEffect(group=a, kind="intercept", parent=None),
            RandomEffect(group=f"{a}:{b}", kind="intercept", parent=a),
        ]
    g = _check_ident(group)
    non_one = [t for t in lhs_terms if t != "1"]
    for v in non_one:
        _check_ident(v)
    if not non_one:
        return [RandomEffect(group=g, kind="intercept")]
    explicit = lhs_terms and lhs_terms[0] == "1"
    re_obj = RandomEffect(group=g, kind="slope", vars=non_one)
    re_obj._explicit = explicit  # ordering class marker
    return [re_obj]


def parse_formula(formula: str) -> ParsedFormula:
    if formula is None or not str(formula).strip():
        raise FormulaError("formula is empty")
    formula = str(formula)

    dependent, rhs = _split_dependent(formula)

    # Extract random-effect terms first.
    raw_res: List[Tuple[str, str]] = []

    def _stash(m):
        raw_res.append((m.group(1).strip(), m.group(2).strip()))
        return " "

    fixed_part = _RE_GROUP.sub(_stash, rhs)
    if "(" in fixed_part or ")" in fixed_part:
        raise FormulaError(
            "formula syntax error: unbalanced or malformed parentheses"
        )
    if "-" in fixed_part:
        raise FormulaError(
            "term removal with '-' is not supported; list only the terms "
            "you want in the model"
        )

    # Classify REs in the pinned class order: nested, explicit slope,
    # implicit slope, intercept (reference extraction order).
    nested: List[RandomEffect] = []
    explicit_slopes: List[RandomEffect] = []
    implicit_slopes: List[RandomEffect] = []
    intercepts: List[RandomEffect] = []
    for lhs, group in raw_res:
        for re_obj in _classify_re(lhs, group):
            if re_obj.parent is not None or ("/" in group):
                nested.append(re_obj)
            elif re_obj.kind == "slope" and getattr(re_obj, "_explicit", False):
                explicit_slopes.append(re_obj)
            elif re_obj.kind == "slope":
                implicit_slopes.append(re_obj)
            else:
                intercepts.append(re_obj)
    random_effects = nested + explicit_slopes + implicit_slopes + intercepts

    seen_groups = set()
    for re_obj in random_effects:
        if re_obj.group in seen_groups:
            raise FormulaError(f"duplicate grouping variable: {re_obj.group}")
        seen_groups.add(re_obj.group)

    # Fixed part: '+'-separated tokens of mains, a:b interactions, a*b stars.
    terms: List[Dict] = []
    predictors: List[str] = []
    seen_mains = set()
    seen_inters = set()

    def add_main(name: str):
        if name not in seen_mains:
            seen_mains.add(name)
            terms.append({"kind": "main", "name": name})
        if name not in predictors:
            predictors.append(name)

    def add_interaction(vars_: List[str]):
        key = tuple(vars_)
        if key not in seen_inters:
            seen_inters.add(key)
            terms.append({"kind": "interaction", "vars": list(vars_)})
        for v in vars_:
            if v not in predictors:
                predictors.append(v)

    for token in fixed_part.split("+"):
        token = token.strip()
        if not token:
            continue
        if "*" in token:
            names = [_check_ident(v) for v in token.split("*")]
            for n in names:
                add_main(n)
            for order in range(2, len(names) + 1):
                for combo in itertools.combinations(names, order):
                    add_interaction(list(combo))
        elif ":" in token:
            names = [_check_ident(v) for v in token.split(":")]
            add_interaction(names)
        else:
            add_main(_check_ident(token))

    return ParsedFormula(
        dependent=dependent,
        predictors=predictors,
        terms=terms,
        random_effects=random_effects,
    )
