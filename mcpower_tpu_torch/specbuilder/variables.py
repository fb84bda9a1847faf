"""Variable registry: predictor table, dummy expansion, effect naming.

Owner of the column-ordering invariant (reference:
crates/engine-spec-builder/src/variables.rs): intercept first, non-factor
predictors in formula order, factor dummies in factor declaration order
(levels 2..k, level 1 = reference), interactions last. Effect names:

* non-factor predictor: its own name
* factor dummy:        ``f[2]`` .. ``f[k]`` (1-based level labels)
* interaction:         ``a:b`` — factor components expand over their dummies
                       (``a:f[2]``, ``a:f[3]``, ...)
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .formula import ParsedFormula, parse_formula


class VariableRegistry:
    def __init__(self, formula: str):
        self.formula = formula
        self.parsed: ParsedFormula = parse_formula(formula)
        # variable types: name -> {"type": ..., params}
        self._types: Dict[str, Dict[str, Any]] = {
            name: {"type": "normal"} for name in self.parsed.predictors
        }
        self._pinned: Dict[str, bool] = {name: False for name in self.parsed.predictors}

    # ---- type declarations ----
    def set_variable_type(self, name: str, info: Dict[str, Any], pinned: bool = True):
        if name not in self._types:
            raise ValueError(f"unknown predictor {name!r}")
        self._types[name] = dict(info)
        self._pinned[name] = pinned

    def var_info(self, name: str) -> Dict[str, Any]:
        return self._types[name]

    # ---- orderings ----
    @property
    def dependent(self) -> str:
        return self.parsed.dependent

    @property
    def predictor_names(self) -> List[str]:
        return list(self.parsed.predictors)

    @property
    def factor_names(self) -> List[str]:
        return [n for n in self.parsed.predictors if self._types[n]["type"] == "factor"]

    @property
    def non_factor_names(self) -> List[str]:
        return [n for n in self.parsed.predictors if self._types[n]["type"] != "factor"]

    @property
    def grouping_names(self) -> List[str]:
        return [re.group for re in self.parsed.random_effects]

    def factor_levels(self, name: str) -> int:
        return int(self._types[name].get("n_levels", 3))

    def factor_proportions(self, name: str) -> List[float]:
        k = self.factor_levels(name)
        return list(self._types[name].get("proportions", [1.0 / k] * k))

    def factor_level_label(self, name: str, lvl: int) -> str:
        """Display label for 1-based level ``lvl``: the uploaded data value
        when pilot data supplied the levels (reference tables.py
        _factor_label — "with uploaded data the labels are the data
        values"), else the 1-based integer."""
        labels = self._types[name].get("labels")
        if labels and 1 <= lvl <= len(labels):
            return str(labels[lvl - 1])
        return str(lvl)

    def dummy_names(self, name: str) -> List[str]:
        return [
            f"{name}[{self.factor_level_label(name, lvl)}]"
            for lvl in range(2, self.factor_levels(name) + 1)
        ]

    # ---- effect naming ----
    def interaction_effect_names(self, vars_: Sequence[str]) -> List[Tuple[str, List[Tuple[str, int]]]]:
        """Expand one formula interaction over factor dummies.

        Returns [(effect_name, [(var, level_or_0)...])], level 0 = non-factor.
        """
        per_var: List[List[Tuple[str, int, str]]] = []
        for v in vars_:
            if self._types[v]["type"] == "factor":
                per_var.append(
                    [
                        (v, lvl, f"{v}[{self.factor_level_label(v, lvl)}]")
                        for lvl in range(2, self.factor_levels(v) + 1)
                    ]
                )
            else:
                per_var.append([(v, 0, v)])
        out = []
        for combo in itertools.product(*per_var):
            name = ":".join(label for _, _, label in combo)
            out.append((name, [(v, lvl) for v, lvl, _ in combo]))
        return out

    @property
    def effect_names(self) -> List[str]:
        """All nameable fixed effects in canonical term order."""
        names: List[str] = []
        for t in self.parsed.terms:
            if t["kind"] == "main":
                n = t["name"]
                if self._types[n]["type"] == "factor":
                    names.extend(self.dummy_names(n))
                else:
                    names.append(n)
        for t in self.parsed.terms:
            if t["kind"] == "interaction":
                names.extend(name for name, _ in self.interaction_effect_names(t["vars"]))
        return names

    @property
    def interaction_term_names(self) -> List[str]:
        return [":".join(t["vars"]) for t in self.parsed.terms if t["kind"] == "interaction"]
