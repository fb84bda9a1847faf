"""target_test DSL: which effects a power figure refers to.

Grammar (reference: ports/py/mcpower/spec/test_selector.py resolve_tests):
comma-separated tokens —
  "all"                    omnibus + every fixed-effect beta
  "all-contrasts"/"all-posthoc"  all-pairwise post-hoc for every factor
  "overall" (or the dependent name)  just the omnibus
  "<effect>"               a named effect (x1, f[2], a:b)
  "<f>[a] vs <f>[b]"       pairwise contrast within one factor
  "-<token>"               exclusion
"""

from __future__ import annotations

import re as _re
from typing import Dict, List, Tuple

from .variables import VariableRegistry

_VS = _re.compile(r"^(?P<a>.+?)\s+vs\s+(?P<b>.+?)$", _re.IGNORECASE)


def overall_test_available(estimator: str, has_cluster: bool) -> bool:
    """Mixed fits expose no omnibus in v1 (find_power docstring parity)."""
    return not (estimator == "mle" or has_cluster)


def _level_ref(factor: str, token: str, registry: VariableRegistry) -> str:
    """Normalize f[label] to the canonical f[level_index] form."""
    return token


def resolve_tests(
    raw: str | None,
    registry: VariableRegistry,
    *,
    overall_available: bool = True,
) -> Dict:
    """Returns {"targets": [names], "contrast_pairs": [(a,b)],
    "report_overall": bool, "posthoc_factors": [factor names]}."""
    effect_names = registry.effect_names
    dep = registry.dependent

    if raw is None:
        return {
            "targets": list(effect_names),
            "contrast_pairs": [],
            "report_overall": overall_available,
            "posthoc_factors": [],
        }

    tokens = [t.strip() for t in str(raw).split(",") if t.strip()]
    keywords: List[str] = []
    exclusions: List[str] = []
    explicit: List[str] = []
    posthoc = False
    for tok in tokens:
        low = tok.lower()
        if low == "all":
            keywords.append("all")
        elif low in ("all-contrasts", "all-posthoc"):
            if not registry.factor_names:
                raise ValueError(
                    f"{tok!r} requests all-pairwise post-hoc contrasts but the "
                    "model has no factor variables"
                )
            posthoc = True
        elif tok.startswith("-"):
            exclusions.append(tok[1:].strip())
        else:
            explicit.append(tok)

    targets: List[str] = []
    contrast_pairs: List[Tuple[str, str]] = []
    report_overall = False

    if "all" in keywords:
        targets.extend(effect_names)

    for tok in explicit:
        low = tok.lower()
        if low == "overall" or tok == dep:
            if not overall_available:
                raise ValueError(
                    "the overall/omnibus test is not available for mixed-"
                    "effects fits; remove 'overall' from target_test"
                )
            report_overall = True
            continue
        m = _VS.match(tok)
        if m:
            a, b = m.group("a").strip(), m.group("b").strip()
            for side in (a, b):
                if side not in effect_names and not _is_reference_level(side, registry):
                    raise ValueError(f"unknown contrast side {side!r}")
            contrast_pairs.append((a, b))
            continue
        if tok not in effect_names:
            if tok in registry.factor_names:
                targets.extend(registry.dummy_names(tok))
                continue
            raise ValueError(
                f"unknown test target {tok!r}; available: {effect_names}"
            )
        if tok in targets:
            raise ValueError(f"duplicate test target {tok!r}")
        targets.append(tok)

    overall_excluded = False
    for ex in exclusions:
        if ex.lower() == "overall":
            report_overall = False
            overall_excluded = True
            continue
        expanded = (
            registry.dummy_names(ex) if ex in registry.factor_names else [ex]
        )
        for e in expanded:
            if e not in targets:
                raise ValueError(f"exclusion {ex!r} does not match a selected test")
            targets.remove(e)

    if "all" in keywords and overall_available and not overall_excluded:
        report_overall = True

    if not targets and not contrast_pairs and not report_overall and not posthoc:
        raise ValueError("all tests excluded — nothing to report")

    return {
        "targets": targets,
        "contrast_pairs": contrast_pairs,
        "report_overall": report_overall,
        "posthoc_factors": list(registry.factor_names) if posthoc else [],
    }


def _is_reference_level(token: str, registry: VariableRegistry) -> bool:
    """True only when the bracket text is the factor's LEVEL-1 LABEL (the
    uploaded data value when labels came from pilot data) — label-aware:
    with labels ['0','1','2'] the baseline side is 'g[0]', and 'g[1]' is
    a dummy, not the reference."""
    m = _re.match(r"^([A-Za-z_][A-Za-z0-9_.]*)\[(.+)\]$", token)
    if not m:
        return False
    f, lvl = m.group(1), m.group(2)
    if f not in registry.factor_names:
        return False
    return lvl == registry.factor_level_label(f, 1)
