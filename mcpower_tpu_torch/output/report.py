"""Text reports: the .summary() / verbose output of a run.

Content mirrors the reference's report layer (configs/config.json report.*,
ports/py/mcpower/output/report.py + tables.py): boxed analysis header with the
effects echo (odds ratios for logit outcomes), per-test power with Monte-Carlo
Wilson CIs and corrected columns, the exactly-k / at-least-k joint significance
distribution, required-N tables from the crossing fit with outward-rounded CIs
plus the per-k joint required-N table, per-scenario estimator details, a
cross-scenario robustness comparison, and threshold-driven diagnostics.
All interpretive strings come from CONFIG["report"]["text"] (single-source,
textually identical to the reference's report.text).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..config import CONFIG

_FMT = CONFIG["report"]["format"]
_THR = CONFIG["report"]["thresholds"]
_TEXT = CONFIG["report"]["text"]
_COLS = _TEXT["columns"]


def _pct(x: float, dec: int = None) -> str:
    dec = _FMT["power_decimals_short"] if dec is None else dec
    return f"{100.0 * x:.{dec}f}%"


def _ci(pair) -> str:
    lo, hi = pair
    return f"[{100 * lo:.1f}, {100 * hi:.1f}]"


def _fmt_or(beta: float) -> str:
    """Odds-ratio display (exp(β), 2 dp) for a logit-scale effect. β stays
    the single source of truth on the wire; the OR is a display-only readout
    (reference tables.py::_fmt_or)."""
    return f"{math.exp(beta):.2f}"


def _table(
    title: Optional[str],
    columns: List[Tuple[str, str]],
    rows: List[Tuple[str, object]],
) -> str:
    """Minimal-rules text table: ``columns`` is [(header, 'l'|'r')...];
    ``rows`` entries are ("row", [cells...]) or ("span", text)."""
    headers = [h for h, _ in columns]
    widths = [len(h) for h in headers]
    for kind, payload in rows:
        if kind == "row":
            for i, c in enumerate(payload):
                widths[i] = max(widths[i], len(c))
        else:
            widths[0] = max(widths[0], len(payload))

    def render(cells):
        return "   ".join(
            c.ljust(widths[i]) if columns[i][1] == "l" else c.rjust(widths[i])
            for i, c in enumerate(cells)
        )

    head = render(headers)
    rule = "─" * len(head)
    out = ([title] if title else []) + [rule, head, rule]
    for kind, payload in rows:
        out.append(render(payload) if kind == "row" else payload)
    out.append(rule)
    return "\n".join(out)


def _scenarios_of(result: Dict) -> Dict[str, Dict]:
    if "scenarios" in result:
        return result["scenarios"]
    return {result.get("scenario", "optimistic"): result}


def _meta_of(result: Dict) -> Dict:
    return result.get("meta", {})


def _overall_label(res: Dict, meta: Dict) -> str:
    est = res.get("estimator") or meta.get("estimator") or "ols"
    return CONFIG["report"]["overall_label_by_estimator"].get(est, "Overall")


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------


def _fit_headline_numeric(fit: Optional[Dict]) -> Optional[int]:
    if not fit:
        return None
    if fit.get("kind") == "fitted":
        return int(fit["n_achievable"])
    if fit.get("kind") == "at_or_below_min":
        return int(fit["n_min"])
    return None


def _header_box(result: Dict, kind: str, *, alpha, target) -> List[str]:
    """Boxed analysis header: formula, estimator, N / required-N headline,
    sims, α, target, the effects echo (+OR for binary outcomes), correction
    and residual lines when non-default."""
    meta = _meta_of(result)
    scenarios = _scenarios_of(result)
    res0 = next(iter(scenarios.values()))
    if kind == "sample_size":
        numerics = [
            _fit_headline_numeric(f) for f in (res0.get("fitted") or {}).values()
        ]
        ceiling = max(res0.get("sample_sizes") or [0]) or None
        if numerics and all(n is not None for n in numerics):
            n_label = f"N≥{max(numerics)}"
        elif ceiling:
            n_label = f"N≥{ceiling} (not all reached)"
        else:
            n_label = "N=— (target not reached)"
    else:
        n_label = f"N={res0['sample_sizes'][0]}"

    title = _TEXT["long_title"]
    box = "=" * max(len(title) + 4, 50)
    est = (meta.get("estimator") or res0.get("estimator") or "ols").upper()
    tdec = _FMT["target_decimals"]
    lines = [box, f"  {title}", box]
    if meta.get("formula"):
        lines.append(f"formula: {meta['formula']}")
    lines.append(
        f"estimator: {est}  {n_label}  sims={res0.get('n_sims', '?')}  "
        f"α={alpha}  target={_pct(target / 100.0, tdec)}"
    )
    effects = meta.get("effects") or {}
    if effects:
        if meta.get("outcome_kind") == "binary":
            pairs = (
                f"{n}={v:.2f} (OR {_fmt_or(v)})" for n, v in effects.items()
            )
        else:
            pairs = (f"{n}={v:.2f}" for n, v in effects.items())
        lines.append("effects: " + ", ".join(pairs))
    corr = res0.get("alpha_correction", "none")
    if corr and corr != "none":
        lines.append(f"correction: {corr}")
    if meta.get("residual") and meta["residual"] != "normal":
        lines.append(f"residual: {meta['residual']}")
    return lines


# ---------------------------------------------------------------------------
# shared sections
# ---------------------------------------------------------------------------


def _diagnostics(res: Dict) -> List[str]:
    lines = []
    conv = min(res.get("convergence_rate", [1.0]))
    if conv < _THR["convergence_min"]:
        lines.append(
            f"⚠ convergence rate {conv:.1%} below {_THR['convergence_min']:.0%}"
        )
    extras = res.get("estimator_extras", {})
    # Boundary gate on HIGH-τ̂ only (reference tables.py:676-684, decision
    # 2.2): benign τ̂=0 pins are common at small ICC and stay informational
    # (surfaced in the estimator-extras block), never a red-flag warning.
    bh_ht = res.get("boundary_hit_rate_high_tau") or []
    if bh_ht:
        r = max(float(v) for v in bh_ht)
        if r > _THR["lme_boundary_hit_max"]:
            lines.append(
                f"⚠ high-τ̂ boundary {r:.1%} — the random-effect variance "
                "pinned implausibly large; the fit is suspect at this design"
            )
    glm = extras.get("glm", {})
    if glm.get("singular_fit_rate"):
        r = max(glm["singular_fit_rate"])
        if r > 1 - _THR["convergence_min"]:
            lines.append(f"⚠ GLM non-convergence in {r:.1%} of simulations")
    for w in res.get("warnings", []):
        lines.append(f"⚠ {w}")
    return lines


def _fmt_extra_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, (list, tuple)) and v and all(
        isinstance(x, (int, float)) for x in v
    ):
        if len(v) == 1:
            return _fmt_extra_value(float(v[0]))
        mean = sum(v) / len(v)
        return f"{mean:.4g} (max {max(v):.4g})"
    return str(v)


def _estimator_extras_section(scenarios: Dict[str, Dict]) -> List[str]:
    """'Estimator details' — surface GLM/MLE numerics whenever present, one
    block per scenario (reference Report._estimator_extras). OLS results carry
    no extras block → nothing rendered."""
    out: List[str] = []
    caption = _TEXT["estimator_extras_caption"]
    for label, res in scenarios.items():
        extras = res.get("estimator_extras") or {}
        items = []
        for arm, vals in extras.items():
            if not isinstance(vals, dict):
                continue
            for k, v in vals.items():
                items.append(f"  {arm}.{k}: {_fmt_extra_value(v)}")
        if not items:
            continue
        head = caption + (f" — {label}" if len(scenarios) > 1 else "")
        out.append("")
        out.append(head)
        out.extend(items)
    return out


def _joint_distribution_section(res: Dict) -> List[str]:
    """Exactly-k / at-least-k joint significance distribution table from the
    success-count histogram (reference tables.py::joint_distribution). Only
    meaningful with ≥2 targets (at-least-1-of-1 duplicates the power row)."""
    hist = res.get("success_count_histogram_uncorrected")
    n = res.get("n_sims", 0)
    if not hist or not n or len(res.get("target_labels", [])) < 2:
        return []
    row = hist[0]  # single-N results; for grids the first point
    total = sum(row)
    dec = _FMT["joint_table_decimals"]
    rows = []
    running = total
    for k, h in enumerate(row):
        rows.append(
            ("row", [str(k), _pct(h / n, dec), _pct(running / n, dec)])
        )
        running -= h
    return [
        "",
        _table(
            "Joint significance distribution",
            [("k", "l"), ("Exactly", "r"), ("At least", "r")],
            rows,
        ),
    ]


def _robustness_section(result: Dict, corrected: bool) -> List[str]:
    """Cross-scenario comparison: Δ power (pp) per test vs the baseline
    scenario (reference Report._robustness; baseline preference from
    config report.baseline_scenario)."""
    scenarios = _scenarios_of(result)
    if len(scenarios) < 2:
        return []
    names = list(scenarios)
    prefer = CONFIG["report"]["baseline_scenario"]["prefer_label"]
    base = prefer if prefer in names else names[0]
    pkey = "corrected" if corrected else "uncorrected"
    dec = _FMT["drop_decimals"]
    others = [nm for nm in names if nm != base]
    base_res = scenarios[base]
    g = 0
    rows = []
    for i, t in enumerate(base_res["target_labels"]):
        p0 = base_res["powers"][pkey][g][i]
        cells = [t] + [
            f"{(scenarios[nm]['powers'][pkey][g][i] - p0) * 100:+.{dec}f} pp"
            for nm in others
        ]
        rows.append(("row", cells))
    cols = [(_COLS["test"], "l")] + [(nm, "r") for nm in others]
    return [
        "",
        _table(f"Robustness  (Δ power {_TEXT['vs_token']} baseline: {base})",
               cols, rows),
    ]


# ---------------------------------------------------------------------------
# find_power report
# ---------------------------------------------------------------------------


def _with_factor_headers(labels, factors):
    """Display plan for a per-test table: ``[(idx_or_None, text)]``. A
    value-less header row ``fname (baseline: X)`` precedes each factor's
    first dummy row and the dummy rows indent beneath it (the reference's
    build_rows factor_header, ports/py/mcpower/output/tables.py:389);
    non-factor targets pass through unchanged."""
    rows = []
    seen = set()
    for i, t in enumerate(labels):
        fname = None
        if "[" in t and t.endswith("]") and " vs " not in t and ":" not in t:
            cand = t.split("[", 1)[0]
            if cand in (factors or {}):
                fname = cand
        if fname is None:
            rows.append((i, t))
            continue
        if fname not in seen:
            base = factors[fname].get("baseline")
            rows.append((None, f"{fname} (baseline: {base})" if base else fname))
            seen.add(fname)
        rows.append((i, "  " + t))
    return rows


def power_report(result: Dict, alpha: float = 0.05) -> str:
    """Single-N power report (optionally multi-scenario)."""
    meta = _meta_of(result)
    scenarios = _scenarios_of(result)
    target = meta.get("target_power", 100 * CONFIG["simulation"]["target_power"])
    out: List[str] = _header_box(result, "power", alpha=alpha, target=target)
    corrected = any(
        r.get("alpha_correction", "none") != "none" for r in scenarios.values()
    )
    show_or = meta.get("outcome_kind") == "binary"
    effects = meta.get("effects") or {}
    for label, res in scenarios.items():
        g = 0
        n = res["sample_sizes"][g]
        out.append("")
        title = (
            f"{_TEXT['main_caption']} at N = {n}  "
            f"(n_sims = {res['n_sims']}, α = {alpha})"
        )
        if len(scenarios) > 1:
            title += f"  — scenario: {label}"
        cols = [(_COLS["test"], "l")]
        if show_or:
            cols.append((_COLS["or"], "r"))
        cols += [(_COLS["power"], "r"), (_COLS["ci"], "r")]
        if corrected:
            cols += [
                (f"{_COLS['power']} ({res['alpha_correction']})", "r"),
                (_COLS["ci"], "r"),
            ]
        rows = []
        plan = _with_factor_headers(
            res["target_labels"], meta.get("factors") or {}
        )
        for i, disp in plan:
            if i is None:
                rows.append(("span", disp))
                continue
            t = res["target_labels"][i]
            row = [disp]
            if show_or:
                row.append(_fmt_or(effects[t]) if t in effects else "")
            row += [
                _pct(res["powers"]["uncorrected"][g][i]),
                _ci(res["powers"]["ci_uncorrected"][g][i]),
            ]
            if corrected:
                row += [
                    _pct(res["powers"]["corrected"][g][i]),
                    _ci(res["powers"]["ci_corrected"][g][i]),
                ]
            rows.append(("row", row))
        if res.get("overall_significant_rate") is not None:
            row = [_overall_label(res, meta)]
            if show_or:
                row.append("")
            row += [
                _pct(res["overall_significant_rate"][g]),
                _ci(res["overall_significant_ci"][g]),
            ]
            if corrected:
                row += ["—", "—"]
            rows.append(("row", row))
        out.append(_table(title, cols, rows))
        if (
            res.get("joint_uncorrected_rate") is not None
            and len(res["target_labels"]) > 1
        ):
            out.append(
                f"Joint (all tests significant): "
                f"{_pct(res['joint_uncorrected_rate'][g])} uncorrected"
                + (
                    f", {_pct(res['joint_corrected_rate'][g])} corrected"
                    if corrected
                    else ""
                )
            )
        out.extend(_joint_distribution_section(res))
        if res.get("posthoc"):
            out.append("")
            out.append("Post-hoc pairwise power (Tukey HSD):")
            for fname, pairs in res["posthoc"].items():
                for plabel, v in pairs.items():
                    out.append(
                        f"  {plabel}: {_pct(v['power'][g])} {_ci(v['ci'][g])}"
                    )
        out.extend(_diagnostics(res))
    out.extend(_robustness_section(result, corrected))
    out.extend(_estimator_extras_section(scenarios))
    out.append("")
    out.append(
        _TEXT["ci_footnote"].format(
            n_sims=next(iter(scenarios.values()))["n_sims"]
        )
    )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# find_sample_size report
# ---------------------------------------------------------------------------


def _joint_required_n_section(res: Dict, target: float) -> List[str]:
    """Per-k joint detection → required N table: '≥ k of m tests' rows from
    fitted_joint[j] (k = j+1) with first_joint_achieved fallback (reference
    Report._joint_required_n_table)."""
    fja = res.get("first_joint_achieved")
    if not isinstance(fja, dict) or not fja:
        return []
    fitted_joint = res.get("fitted_joint") or {}
    ceiling = max(res.get("sample_sizes") or [0]) or None
    m = len(fja)
    if m < 2:
        return []
    rows = []
    for j in range(m - 1, -1, -1):
        k = j + 1
        fj = fitted_joint.get(j, fitted_joint.get(str(j)))
        cell = None
        if fj is not None:
            kind = fj.get("kind")
            if kind == "fitted":
                cell = str(fj["n_achievable"])
            elif kind == "at_or_below_min":
                cell = f"≤ {fj['n_min']}"
            elif kind == "not_reached":
                cell = f"≥ {ceiling}" if ceiling else "—"
        if cell is None:  # non_monotone or absent → grid-empirical fallback
            n_req = fja.get(j, fja.get(str(j)))
            cell = str(n_req) if n_req is not None else (
                f"≥ {ceiling}" if ceiling else "—"
            )
        rows.append(("row", [f"≥ {k} of {m} tests", cell]))
    tdec = _FMT["target_decimals"]
    return [
        "",
        _table(
            f"Joint detection → required N (target {_pct(target / 100.0, tdec)})",
            [("Joint target", "l"), (_COLS["required_n"], "r")],
            rows,
        ),
    ]


def sample_size_report(result: Dict, target_power: float = 80.0) -> str:
    """Required-N report from the crossing fits."""
    meta = _meta_of(result)
    tp = target_power if target_power > 1 else target_power * 100
    alpha = meta.get("alpha", result.get("alpha", 0.05))
    out: List[str] = _header_box(result, "sample_size", alpha=alpha, target=tp)
    scenarios = _scenarios_of(result)
    notes = set()
    for label, res in scenarios.items():
        out.append("")
        title = (
            f"{_TEXT['sample_size_caption']} — {tp:.0f}% power  "
            f"(n_sims = {res['n_sims']})"
        )
        if len(scenarios) > 1:
            title += f"  — scenario: {label}"
        floor_n = min(res.get("sample_sizes") or [0])
        ceiling = max(res.get("sample_sizes") or [0]) or None
        rows = []
        ov_fit = res.get("fitted_overall")
        if ov_fit:
            first_ov = res.get("first_overall_achieved")
            rows.append(
                (
                    "row",
                    _required_n_cells(
                        _overall_label(res, meta), ov_fit, first_ov,
                        floor_n, ceiling, notes,
                    ),
                )
            )
        plan = _with_factor_headers(
            res["target_labels"], meta.get("factors") or {}
        )
        for i, disp in plan:
            if i is None:
                rows.append(("span", disp))
                continue
            t = res["target_labels"][i]
            fit = res["fitted"][t]
            first = res["first_achieved"].get(t)
            rows.append(
                ("row",
                 _required_n_cells(disp, fit, first, floor_n, ceiling, notes))
            )
        out.append(
            _table(
                title,
                [
                    (_COLS["test"], "l"),
                    (_COLS["required_n"], "r"),
                    (_COLS["ci"], "r"),
                    ("First grid N", "r"),
                ],
                rows,
            )
        )
        out.extend(_joint_required_n_section(res, tp))
        out.extend(_diagnostics(res))
    out.extend(_estimator_extras_section(scenarios))
    out.append("")
    out.append(_TEXT["required_n_ci_footnote"])
    out.extend(sorted(notes))
    return "\n".join(out)


def short_report(result: Dict) -> str:
    """Compact repr form (the reference's render_short, tables.py:592):
    one model line plus a minimal [Test | Power (| corrected) (| OR) |
    Target] table — no CI columns; scenario columns when multi-scenario;
    sample-size results show the Required-N headline instead; diagnostic
    warnings compress to '! ... — see summary()' lines."""
    kind = result.get("result_kind", "power")
    meta = _meta_of(result)
    scenarios = _scenarios_of(result)
    names = list(scenarios)
    inner0 = scenarios[names[0]]
    multi = len(names) > 1
    # per-run target (proportion, carries find_sample_size overrides) wins
    # over the model default in meta (percent)
    tp = inner0.get("target_power")
    target = 100.0 * tp if tp is not None else meta.get("target_power", 80.0)
    tcell = f"{target:.0f}%"
    show_or = meta.get("outcome_kind") == "binary"
    effects = meta.get("effects") or {}
    corrected = any(
        r.get("alpha_correction", "none") != "none" for r in scenarios.values()
    )

    n0 = (inner0.get("sample_sizes") or ["?"])[0]
    # Header tokens match the reference's render_short (tables.py:582-584):
    # "Power Analysis — <est>  N=..  sims=..  α=..  target=.." + a
    # "formula: .." line, so content greps written against the reference
    # port keep working.
    head = (
        f"Power Analysis — {str(meta.get('estimator', '')).upper()}"
        + (f"  N={n0}" if kind == "power" else "")
        + f"  sims={inner0.get('n_sims', '?')}"
        + f"  α={meta.get('alpha', result.get('alpha', 0.05))}"
        + f"  target={tcell}"
        + f"\nformula: {meta.get('formula', result.get('formula', ''))}"
    )

    plan = _with_factor_headers(
        inner0.get("target_labels", []), meta.get("factors") or {}
    )

    def or_cell(t):
        return [_fmt_or(effects[t]) if t in effects else ""] if show_or else []

    rows: List[Tuple[str, object]] = []
    if kind == "sample_size":
        cols = [(_COLS["test"], "l"), (_COLS["required_n"], "r"),
                (_COLS["target"], "r")]
        notes: set = set()
        floor_n = min(inner0.get("sample_sizes") or [0])
        ceiling = max(inner0.get("sample_sizes") or [0]) or None
        for i, disp in plan:
            if i is None:
                rows.append(("span", disp))
                continue
            t = inner0["target_labels"][i]
            cells = _required_n_cells(
                disp, inner0["fitted"][t],
                inner0["first_achieved"].get(t), floor_n, ceiling, notes,
            )
            rows.append(("row", [cells[0], cells[1], tcell]))
    elif multi:
        cols = (
            [(_COLS["test"], "l")]
            + [(nm, "r") for nm in names]
            + ([(_COLS["or"], "r")] if show_or else [])
            + [(_COLS["target"], "r")]
        )
        pkey = "corrected" if corrected else "uncorrected"
        for i, disp in plan:
            if i is None:
                rows.append(("span", disp))
                continue
            t = inner0["target_labels"][i]
            vals = [
                _pct(scenarios[nm]["powers"][pkey][0][i]) for nm in names
            ]
            rows.append(("row", [disp] + vals + or_cell(t) + [tcell]))
    else:
        cols = (
            [(_COLS["test"], "l")]
            + ([("Uncorr.", "r"), ("Corr.", "r")] if corrected
               else [(_COLS["power"], "r")])
            + ([(_COLS["or"], "r")] if show_or else [])
            + [(_COLS["target"], "r")]
        )
        if inner0.get("overall_significant_rate") is not None:
            # the omnibus is a single test — correction does not apply
            cells = [_overall_label(inner0, meta),
                     _pct(inner0["overall_significant_rate"][0])]
            if corrected:
                cells.append("(same)")
            if show_or:
                cells.append("")
            rows.append(("row", cells + [tcell]))
        for i, disp in plan:
            if i is None:
                rows.append(("span", disp))
                continue
            t = inner0["target_labels"][i]
            cells = [disp, _pct(inner0["powers"]["uncorrected"][0][i])]
            if corrected:
                cells.append(_pct(inner0["powers"]["corrected"][0][i]))
            rows.append(("row", cells + or_cell(t) + [tcell]))

    out = [head, _table(None, cols, rows)]
    warns = []
    for nm in names:
        for w in _diagnostics(scenarios[nm]):
            msg = w.lstrip("⚠ ").strip()
            warns.append(
                f"! {f'{nm}: {msg}' if multi else msg} — see summary()"
            )
    out.extend(warns)
    return "\n".join(out)


def _required_n_cells(
    label: str, fit: Dict, first, floor_n, ceiling, notes: set
) -> List[str]:
    """One Required-N table row: headline + outward-rounded CI + first grid N,
    collecting the reference's footnote strings (appr / floor / suppressed)."""
    if fit["kind"] == "fitted":
        ci_lo = f"{fit['ci_lo']:.0f}" if fit.get("ci_lo") else f"≤ {floor_n}"
        ci_hi = (
            f"{fit['ci_hi']:.0f}"
            if fit.get("ci_hi")
            else (f"≥ {ceiling}" if ceiling else "—")
        )
        if not fit.get("ci_lo"):
            notes.add(_TEXT["required_n_ci_footnote_floor"])
        return [label, str(fit["n_achievable"]), f"[{ci_lo}, {ci_hi}]",
                str(first) if first else "—"]
    if fit["kind"] == "at_or_below_min":
        notes.add(_TEXT["required_n_ci_footnote_floor"])
        return [label, f"≤ {fit['n_min']}", "—", str(first)]
    if fit["kind"] == "not_reached":
        appr = f"appr. {fit['n_approx']}" if fit.get("n_approx") else (
            f"≥ {ceiling}" if ceiling else "—"
        )
        if fit.get("n_approx"):
            notes.add(_TEXT["required_n_ci_footnote_appr"])
        return [label, appr, "—", "—"]
    # non_monotone
    notes.add(
        _TEXT["non_monotone_warning"].format(
            label=label, drop=f"{100 * fit['max_violation']:.1f}pp"
        )
    )
    return [label, "—", "—", str(first) if first else "—"]
