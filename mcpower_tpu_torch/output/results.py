"""Result wrapper objects: dict-compatible trees with rich presentation.

The reference's Python port returns wrapper objects exposing ``.summary()``
text reports, Jupyter HTML reprs, and plot bundles over the host-neutral
result tree (ports/py/mcpower/output/results.py). These wrappers subclass
``dict`` so every consumer of the raw tree (merge, plots, tests, JSON
serialization) keeps working unchanged — the presentation layer is additive.
"""

from __future__ import annotations

from html import escape
from typing import Any, Dict, List


class ResultBase(dict):
    """Host-neutral result tree + presentation methods."""

    _kind = "result"

    def summary(self) -> str:
        """Formatted text report (what verbose=True prints)."""
        raise NotImplementedError

    def __repr__(self) -> str:
        """Compact short form (the reference's repr contract: short on
        repr/auto-print, long via .summary())."""
        from .report import short_report

        return short_report(self)

    def short(self) -> str:
        """The short-form text explicitly (same as repr)."""
        return repr(self)

    def _repr_html_(self) -> str:
        return _html_report(self)

    def _repr_mimebundle_(self, include=None, exclude=None) -> Dict[str, Any]:
        """Jupyter rich display (reference results mimebundle): the lead
        plot block as a light-print-themed Vega-Lite payload — power bars
        for power results, the curve (or the multi-scenario overlay) for
        sample-size results — alongside the HTML table and the short text
        form."""
        from .plotting import apply_theme

        spec = next(iter(self.plots().values()))
        return {
            "application/vnd.vegalite.v5+json": apply_theme(
                spec, "light-print"
            ),
            "text/html": _html_report(self),
            "text/plain": repr(self),
        }

    @property
    def warnings(self) -> List[str]:
        if "scenarios" in self:
            out: List[str] = []
            for res in self["scenarios"].values():
                for w in res.get("warnings", []):
                    if w not in out:
                        out.append(w)
            return out
        return list(self.get("warnings", []))

    @property
    def scenarios(self) -> Dict[str, "ResultBase"]:
        """Per-scenario subtrees (single-scenario results wrap themselves)."""
        if "scenarios" in self:
            return {
                k: wrap_result(v, self.get("result_kind", self._kind))
                for k, v in self["scenarios"].items()
            }
        return {self.get("scenario", "optimistic"): self}

    def to_dict(self) -> Dict[str, Any]:
        return dict(self)

    # -- export surface (reference ports/py/mcpower/output/results.py) ------

    def plots(self) -> Dict[str, Dict]:
        raise NotImplementedError

    def save_plot(
        self, path: str, *, theme="light-print", scale: float = 2.0, ppi=None
    ) -> None:
        """Render this result's chart(s) to file(s) (png / svg / pdf / html,
        dispatched by suffix). ``.html`` is dependency-free (stacked
        vega-embed page); the other formats need the optional vl-convert
        renderer. ``theme=None`` gives theme-naked specs. Mirrors the
        reference's save_plot contract (results.py:163-176)."""
        from .plotting import save_plot_files

        save_plot_files(
            self.plots(), path, theme=theme, scale=scale, ppi=ppi,
            title=f"MCPower {self._kind} plots",
        )

    def plot(self, path: str = None) -> None:
        """No path: write ``find_{power,sample_size}.html`` in the working
        directory (stacked, CDN-backed — the reference's .plot() behavior).
        With a path: delegate to save_plot."""
        if path is None:
            name = (
                "find_power.html" if self._kind == "power"
                else "find_sample_size.html"
            )
            self.save_plot(name)
            print(f"wrote {name}")
        else:
            self.save_plot(path)

    def to_latex(self) -> str:
        """Booktabs-style LaTeX table of to_dataframe() (the reference
        roadmaps this export; here it is implemented)."""
        df = self.to_dataframe()
        cols = list(df.columns)
        lines = [
            "\\begin{tabular}{l" + "r" * (len(cols) - 1) + "}",
            "\\toprule",
            " & ".join(_latex_escape(str(c)) for c in cols) + " \\\\",
            "\\midrule",
        ]
        for _, row in df.iterrows():
            cells = []
            for c in cols:
                v = row[c]
                if v is None or (isinstance(v, float) and v != v):
                    cells.append("--")
                elif isinstance(v, float):
                    cells.append(f"{v:.3f}")
                else:
                    cells.append(_latex_escape(str(v)))
            lines.append(" & ".join(cells) + " \\\\")
        lines += ["\\bottomrule", "\\end{tabular}"]
        return "\n".join(lines)

    def to_pdf(self, path: str) -> None:
        """Typeset to_latex() to a one-page PDF. Needs a LaTeX engine
        (pdflatex / tectonic) on PATH; raises with guidance otherwise."""
        import os
        import shutil
        import subprocess
        import tempfile

        engine = shutil.which("pdflatex") or shutil.which("tectonic")
        if engine is None:
            raise RuntimeError(
                "to_pdf needs a LaTeX engine (pdflatex or tectonic) on PATH; "
                "use to_latex() to get the table source instead"
            )
        doc = (
            "\\documentclass{article}\\usepackage{booktabs}"
            "\\pagestyle{empty}\\begin{document}\n"
            + self.to_latex()
            + "\n\\end{document}\n"
        )
        with tempfile.TemporaryDirectory() as td:
            tex = os.path.join(td, "result.tex")
            with open(tex, "w") as fh:
                fh.write(doc)
            subprocess.run(
                [engine, "-interaction=batchmode", "result.tex"]
                if "pdflatex" in engine
                else [engine, "result.tex"],
                cwd=td,
                check=True,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            shutil.copyfile(os.path.join(td, "result.pdf"), path)

    def to_dataframe(self):
        raise NotImplementedError


class PowerResult(ResultBase):
    _kind = "power"

    def summary(self, alpha: float = None) -> str:
        from .report import power_report

        return power_report(self, alpha=self.get("alpha", alpha or 0.05))

    def plots(self) -> Dict[str, Dict]:
        from .plotting import power_plot_set

        res = self if "scenarios" not in self else next(
            iter(self["scenarios"].values())
        )
        return power_plot_set(res)

    def to_dataframe(self):
        """Long-format (test x scenario [x sample_size]) frame — the
        reference's column contract (test, scenario, power, ci_lo, ci_hi;
        results.py:142-161: the corrected arm when a correction is active,
        else uncorrected), plus a sample_size column when the run evaluated
        a multi-point grid."""
        import pandas as pd

        rows = []
        for scen, res in _scenario_trees(self).items():
            corr = res.get("alpha_correction", "none") != "none"
            pkey = "corrected" if corr else "uncorrected"
            ckey = f"ci_{pkey}"
            sizes = res.get("sample_sizes", [None])
            for g, n in enumerate(sizes):
                for i, lab in enumerate(res.get("target_labels", [])):
                    ci = res["powers"][ckey][g][i]
                    row = {"test": lab, "scenario": scen}
                    if len(sizes) > 1:
                        row["sample_size"] = n
                    row.update(
                        power=float(res["powers"][pkey][g][i]),
                        ci_lo=float(ci[0]),
                        ci_hi=float(ci[1]),
                    )
                    rows.append(row)
        return pd.DataFrame(rows)


class SampleSizeResult(ResultBase):
    _kind = "sample_size"

    def summary(self, target_power: float = None) -> str:
        from .report import sample_size_report

        tp = target_power
        if tp is None:
            res0 = self if "scenarios" not in self else next(
                iter(self["scenarios"].values())
            )
            tp = 100.0 * res0.get("target_power", 0.8)
        return sample_size_report(self, target_power=tp)

    def plots(self) -> Dict[str, Dict]:
        from .plotting import power_curves_overlay, sample_size_plot_set

        if "scenarios" in self:
            # multi-scenario searches lead with the envelope overlay; the
            # per-N detail blocks come from the baseline scenario
            res = next(iter(self["scenarios"].values()))
            out = {"power_curves_overlay": power_curves_overlay(self["scenarios"])}
            out.update(sample_size_plot_set(res))
            return out
        return sample_size_plot_set(self)

    def to_dataframe(self):
        """Long-format (test x scenario x required_n x ci_lo/ci_hi) frame.

        The reference's export conventions (results.py:230-271):
        required_n is n_achievable for a fitted crossing, the first_achieved
        N for a non-monotone (or missing) fit, and NA otherwise
        (not_reached / at_or_below_min render as sentinel rows in the text
        report and have no single integer to export); CI bounds are
        outward-rounded integers for fitted crossings only. All three
        columns use pandas nullable Int64."""
        import math

        import pandas as pd

        rows = []
        for scen, res in _scenario_trees(self).items():
            fitted = res.get("fitted") or {}
            first = res.get("first_achieved") or {}
            for lab in res.get("target_labels", []):
                f = fitted.get(lab)
                kind = f.get("kind") if f else None
                if kind == "fitted":
                    req = f.get("n_achievable")
                elif f is None or kind == "non_monotone":
                    req = first.get(lab)
                else:
                    req = None
                if kind == "fitted" and f.get("ci_lo") is not None:
                    ci_lo = math.floor(f["ci_lo"])
                    ci_hi = math.ceil(f["ci_hi"]) if f.get("ci_hi") is not None else None
                else:
                    ci_lo = ci_hi = None
                rows.append(
                    {
                        "test": lab,
                        "scenario": scen,
                        "required_n": req,
                        "ci_lo": ci_lo,
                        "ci_hi": ci_hi,
                    }
                )
        df = pd.DataFrame(rows)
        for col in ("required_n", "ci_lo", "ci_hi"):
            df[col] = df[col].astype("Int64")
        return df


def wrap_result(tree: Dict, kind: str) -> ResultBase:
    """Wrap a folded result tree (or scenario envelope) by result kind."""
    cls = SampleSizeResult if kind == "sample_size" else PowerResult
    if isinstance(tree, cls):
        return tree
    return cls(tree)


# ---------------------------------------------------------------------------
# Jupyter HTML rendering
# ---------------------------------------------------------------------------

_TABLE_STYLE = (
    "border-collapse:collapse;font-family:monospace;font-size:13px"
)
_TH = "text-align:left;padding:2px 10px;border-bottom:1px solid #888"
_TD = "text-align:left;padding:2px 10px"


def _pct(x: float) -> str:
    return f"{100.0 * x:.1f}%"


_LATEX_SPECIALS = {
    "&": "\\&", "%": "\\%", "$": "\\$", "#": "\\#", "_": "\\_",
    "{": "\\{", "}": "\\}", "~": "\\textasciitilde{}",
    "^": "\\textasciicircum{}", "\\": "\\textbackslash{}",
}


def _latex_escape(s: str) -> str:
    return "".join(_LATEX_SPECIALS.get(c, c) for c in s)


def _scenario_trees(result: Dict) -> Dict[str, Dict]:
    if "scenarios" in result:
        return result["scenarios"]
    return {result.get("scenario", "optimistic"): result}


def _html_power_table(res: Dict) -> str:
    labels = res.get("target_labels", [])
    powers = res.get("powers", {})
    corrected = res.get("alpha_correction", "none") != "none"
    head = ["Test", "Power", "CI 95%"] + (
        ["Power (corr)", "CI 95%"] if corrected else []
    )
    rows = []
    g = len(res.get("sample_sizes", [0])) - 1  # last grid point
    for i, lab in enumerate(labels):
        cells = [
            escape(lab),
            _pct(powers["uncorrected"][g][i]),
            "[" + ", ".join(_pct(v) for v in powers["ci_uncorrected"][g][i]) + "]",
        ]
        if corrected:
            cells += [
                _pct(powers["corrected"][g][i]),
                "[" + ", ".join(_pct(v) for v in powers["ci_corrected"][g][i]) + "]",
            ]
        rows.append(cells)
    if res.get("overall_significant_rate") is not None:
        rows.append(
            [
                "Overall",
                _pct(res["overall_significant_rate"][g]),
                "["
                + ", ".join(_pct(v) for v in res["overall_significant_ci"][g])
                + "]",
            ]
            + ([""] * 2 if corrected else [])
        )
    body = "".join(
        "<tr>" + "".join(f'<td style="{_TD}">{c}</td>' for c in r) + "</tr>"
        for r in rows
    )
    header = "".join(f'<th style="{_TH}">{escape(h)}</th>' for h in head)
    return (
        f'<table style="{_TABLE_STYLE}"><thead><tr>{header}</tr></thead>'
        f"<tbody>{body}</tbody></table>"
    )


def _html_sample_size_table(res: Dict) -> str:
    fits = res.get("fitted", {})
    first = res.get("first_achieved", {})
    head = ["Test", "Required N", "CI 95%", "First achieved"]
    rows = []
    for lab, fit in fits.items():
        n_star = fit.get("n_achievable") or fit.get("n_star")
        ci = (
            f"[{fit['ci_lo']}, {fit['ci_hi']}]"
            if fit.get("ci_lo") is not None
            else "—"
        )
        rows.append(
            [
                escape(lab),
                str(n_star) if n_star is not None else f"> {res['sample_sizes'][-1]}",
                ci,
                str(first.get(lab, "—")),
            ]
        )
    body = "".join(
        "<tr>" + "".join(f'<td style="{_TD}">{c}</td>' for c in r) + "</tr>"
        for r in rows
    )
    header = "".join(f'<th style="{_TH}">{escape(h)}</th>' for h in head)
    return (
        f'<table style="{_TABLE_STYLE}"><thead><tr>{header}</tr></thead>'
        f"<tbody>{body}</tbody></table>"
    )


def _html_report(result: Dict) -> str:
    kind = result.get("result_kind", "power")
    parts = ['<div style="font-family:sans-serif">']
    title = "Power analysis" if kind == "power" else "Sample-size search"
    sub = []
    if result.get("formula"):
        sub.append(escape(str(result["formula"])))
    if result.get("family"):
        sub.append(f"family={escape(str(result['family']))}")
    parts.append(
        f"<h3 style='margin:4px 0'>MCPower · {title}</h3>"
        + (f"<p style='margin:2px 0;color:#555'>{' · '.join(sub)}</p>" if sub else "")
    )
    for label, res in _scenario_trees(result).items():
        if len(_scenario_trees(result)) > 1:
            parts.append(f"<h4 style='margin:8px 0 2px'>{escape(label)}</h4>")
        n = res.get("sample_sizes", ["?"])[-1]
        parts.append(
            f"<p style='margin:2px 0;color:#555'>N = {n}, "
            f"n_sims = {res.get('n_sims', '?')}</p>"
        )
        if kind == "sample_size" and res.get("fitted"):
            parts.append(_html_sample_size_table(res))
        else:
            parts.append(_html_power_table(res))
        for w in res.get("warnings", []):
            parts.append(
                f"<p style='margin:2px 0;color:#b45309'>⚠ {escape(w)}</p>"
            )
    parts.append("</div>")
    return "".join(parts)
