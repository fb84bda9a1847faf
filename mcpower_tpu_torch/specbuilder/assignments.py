"""Assignment-string DSL: effects, variable types, correlations.

The v1-compatible comma-separated ``key=value`` grammar the setters accept
(reference: crates/engine-spec-builder/src/assignments.rs; fixture corpus
configs/formula-fixtures/assignments/):

* effects:        ``"x1=0.5, x2=-0.3, a:b=0.2"``
* variable types: ``"x1=binary, x2=(binary,0.3), g=(factor,0.2,0.3,0.5),
                    h=(factor,4)"`` — bare ``binary`` defaults p=.5, bare
                    ``factor`` defaults 3 equal levels; ``(factor,k)`` gives k
                    equal levels; proportions are normalized to sum 1
* correlations:   ``"corr(x1,x2)=0.4"`` — pair canonicalized to predictor
                    declaration order

Unknown names are collected as per-item diagnostics (other items still
parse); an input with no parseable assignment at all is a hard error.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import CONFIG, DISTRIBUTION_NAMES


class AssignmentError(ValueError):
    pass


SUPPORTED_VAR_TYPES = tuple(DISTRIBUTION_NAMES) + ("factor",)


@dataclass
class Assignment:
    key: Any  # name str | ("pair", (a, b))
    value: Any


def _split_top_level(s: str) -> List[str]:
    """Split on commas not inside parentheses."""
    parts: List[str] = []
    depth = 0
    cur: List[str] = []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(depth - 1, 0)
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def parse_var_type_value(value: str) -> Tuple[str, Dict[str, Any]]:
    """One RHS of a variable-type assignment -> (type_name, params)."""
    value = value.strip()
    max_levels = int(CONFIG["limits"]["factor_levels"][1])
    if value.startswith("(") and value.endswith(")"):
        content = value[1:-1]
        if "," not in content:
            raise AssignmentError(
                "Invalid tuple format. Expected '(type,value)' or "
                "'(type,val1,val2,...)'"
            )
        parts = [p.strip() for p in content.split(",")]
        vt = parts[0]
        if vt not in SUPPORTED_VAR_TYPES:
            raise AssignmentError(f"Unsupported type '{vt}'")
        if vt == "binary":
            if len(parts) != 2:
                raise AssignmentError(
                    "Binary type expects exactly 2 values: (binary, proportion)"
                )
            try:
                p = float(parts[1])
            except ValueError:
                raise AssignmentError(f"Invalid proportion value '{parts[1]}'")
            if not 0.0 <= p <= 1.0:
                raise AssignmentError("Proportion must be between 0 and 1")
            return "binary", {"proportion": p}
        if vt == "factor":
            if len(parts) == 2:
                try:
                    k = int(parts[1])
                except ValueError:
                    raise AssignmentError(
                        f"Invalid number of levels '{parts[1]}'. Must be integer"
                    )
                if k < 2:
                    raise AssignmentError("Factor must have at least 2 levels")
                if k > max_levels:
                    raise AssignmentError(
                        f"Factor cannot have more than {max_levels} levels"
                    )
                return "factor", {"n_levels": k, "proportions": [1.0 / k] * k}
            try:
                props = [float(p) for p in parts[1:]]
            except ValueError:
                raise AssignmentError("Invalid proportions. All values must be numeric")
            if len(props) < 2:
                raise AssignmentError("Factor must have at least 2 levels")
            if len(props) > max_levels:
                raise AssignmentError(
                    f"Factor cannot have more than {max_levels} levels"
                )
            if any(p <= 0 for p in props):
                raise AssignmentError(
                    "All proportions must be positive (greater than 0)"
                )
            total = sum(props)
            props = [p / total for p in props]
            return "factor", {"n_levels": len(props), "proportions": props}
        raise AssignmentError(
            "Tuple format only supported for binary and factor variables"
        )
    if value not in SUPPORTED_VAR_TYPES:
        raise AssignmentError(
            f"Unsupported type '{value}'. Valid: {', '.join(SUPPORTED_VAR_TYPES)}"
        )
    if value == "binary":
        return "binary", {"proportion": 0.5}
    if value == "factor":
        return "factor", {"n_levels": 3, "proportions": [1 / 3] * 3}
    return value, {}


def parse_assignments(
    input_string: str,
    kind: str,
    predictors: Sequence[str],
    interaction_terms: Sequence[Sequence[str]] = (),
) -> Tuple[List[Assignment], List[str]]:
    """Parse one assignment string. ``kind``: effect | variable_type |
    correlation. Returns (items, per-item error strings)."""
    if not isinstance(input_string, str) or not input_string.strip():
        raise AssignmentError("malformed assignment input: empty string")

    known = set(predictors)
    inter_keys = {":".join(t) for t in interaction_terms}
    items: List[Assignment] = []
    errors: List[str] = []
    any_assignment = False

    for piece in _split_top_level(input_string):
        if "=" not in piece:
            continue
        any_assignment = True
        key_raw, value_raw = piece.split("=", 1)
        key_raw = key_raw.strip()
        value_raw = value_raw.strip()

        if kind == "correlation":
            m = key_raw.replace(" ", "")
            if not (m.lower().startswith("corr(") and m.endswith(")")):
                errors.append(f"malformed correlation key: {key_raw!r}")
                continue
            inner = m[m.index("(") + 1 : -1]
            pair = [p.strip() for p in inner.split(",")]
            if len(pair) != 2:
                errors.append(f"correlation key needs two variables: {key_raw!r}")
                continue
            unknown = [p for p in pair if p not in known]
            if unknown:
                errors.append(f'unknown assignment name: "{unknown[0]}"')
                continue
            # canonical order = predictor declaration order
            order = {name: i for i, name in enumerate(predictors)}
            pair.sort(key=lambda p: order[p])
            try:
                v = float(value_raw)
            except ValueError:
                errors.append(f"invalid correlation value: {value_raw!r}")
                continue
            items.append(Assignment(key=("pair", tuple(pair)), value=v))
            continue

        name = key_raw
        norm = name.replace("*", ":").replace(" ", "")
        is_interaction = ":" in norm
        if kind == "effect":
            # Effect names resolve strictly against the POST-EXPANSION effect
            # list — factor dummies (g[2]) and dummy-interactions (g1[2]:g2[2])
            # are valid; base factor names (g, g1:g2) are not. Mirrors the
            # reference port (ports/py/mcpower/model.py:1484-1502).
            lookup = norm if is_interaction else name
            if lookup not in known:
                # message byte-equal to the fixture corpus
                # (formula-fixtures/assignments/err_unknown_name.json); the
                # model layer appends the available-names list.
                errors.append(f'unknown assignment name: "{name}"')
                continue
        elif is_interaction:
            if norm not in inter_keys and norm not in known:
                errors.append(f'unknown assignment name: "{name}"')
                continue
        elif name not in known:
            errors.append(f'unknown assignment name: "{name}"')
            continue

        if kind == "effect":
            try:
                v = float(value_raw)
            except ValueError:
                errors.append(f"invalid effect value for {name!r}: {value_raw!r}")
                continue
            items.append(Assignment(key=norm if is_interaction else name, value=v))
        elif kind == "variable_type":
            try:
                vt, params = parse_var_type_value(value_raw)
            except AssignmentError as e:
                errors.append(f"{name}: {e}")
                continue
            items.append(Assignment(key=name, value={"type": vt, **params}))
        else:
            raise AssignmentError(f"unknown assignment kind {kind!r}")

    if not any_assignment:
        raise AssignmentError(f"malformed assignment input: {input_string!r}")
    return items, errors
