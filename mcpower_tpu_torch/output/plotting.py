"""Vega-Lite v5 plot emitters — theme-naked specs, one per result shape.

The port contract of the reference's plot layer
(crates/engine-orchestrator/src/plot.rs): every plot is a self-contained
Vega-Lite JSON spec with inline data and no theme (hosts graft their theme
on top). Emitters: per-test power bars, power-vs-N curves with Wilson CI
bands, joint-detection curves, exactly-k detection curves.

``to_html`` wraps any spec in a minimal vega-embed page for notebook-free
viewing.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

_SCHEMA = "https://vega.github.io/schema/vega-lite/v5.json"


def power_bars(result: Dict, *, corrected: bool = False, g: int = 0) -> Dict:
    """Per-test power bars with Wilson CI whiskers at one grid point."""
    which = "corrected" if corrected else "uncorrected"
    rows = []
    for i, t in enumerate(result["target_labels"]):
        lo, hi = result["powers"][f"ci_{which}"][g][i]
        rows.append(
            {
                "test": t,
                "power": 100.0 * result["powers"][which][g][i],
                "ci_lo": 100.0 * lo,
                "ci_hi": 100.0 * hi,
            }
        )
    target = 100.0 * result.get("target_power", 0.8)
    return {
        "$schema": _SCHEMA,
        "description": f"Per-test power ({which})",
        "data": {"values": rows},
        "layer": [
            {
                "mark": "bar",
                "encoding": {
                    "x": {"field": "test", "type": "nominal", "sort": None},
                    "y": {
                        "field": "power",
                        "type": "quantitative",
                        "scale": {"domain": [0, 100]},
                        "title": "Power (%)",
                    },
                },
            },
            {
                "mark": {"type": "errorbar", "ticks": True},
                "encoding": {
                    "x": {"field": "test", "type": "nominal", "sort": None},
                    "y": {"field": "ci_lo", "type": "quantitative", "title": ""},
                    "y2": {"field": "ci_hi"},
                },
            },
            {
                # target-power reference rule (the reference's find_power
                # spec carries the same dashed line)
                "mark": {"type": "rule", "strokeDash": [6, 4]},
                "data": {"values": [{"target": target}]},
                "encoding": {"y": {"field": "target", "type": "quantitative"}},
            },
        ],
    }


def power_curves(result: Dict, *, corrected: bool = True) -> Dict:
    """Power vs N curves with CI bands (sample-size search results)."""
    which = "corrected" if corrected else "uncorrected"
    rows = []
    for gi, n in enumerate(result["sample_sizes"]):
        for i, t in enumerate(result["target_labels"]):
            lo, hi = result["powers"][f"ci_{which}"][gi][i]
            rows.append(
                {
                    "N": n,
                    "test": t,
                    "power": 100.0 * result["powers"][which][gi][i],
                    "ci_lo": 100.0 * lo,
                    "ci_hi": 100.0 * hi,
                }
            )
    target = 100.0 * result.get("target_power", 0.8)
    return {
        "$schema": _SCHEMA,
        "description": f"Power vs sample size ({which})",
        "data": {"values": rows},
        "layer": [
            {
                "mark": {"type": "errorband", "opacity": 0.25},
                "encoding": {
                    "x": {"field": "N", "type": "quantitative"},
                    "y": {"field": "ci_lo", "type": "quantitative", "title": "Power (%)"},
                    "y2": {"field": "ci_hi"},
                    "color": {"field": "test", "type": "nominal"},
                },
            },
            {
                "mark": {"type": "line", "point": True},
                "encoding": {
                    "x": {"field": "N", "type": "quantitative", "title": "Sample size"},
                    "y": {
                        "field": "power",
                        "type": "quantitative",
                        "scale": {"domain": [0, 100]},
                    },
                    "color": {"field": "test", "type": "nominal"},
                },
            },
            {
                "mark": {"type": "rule", "strokeDash": [6, 4]},
                "data": {"values": [{"target": target}]},
                "encoding": {"y": {"field": "target", "type": "quantitative"}},
            },
        ],
    }


def joint_detection_curves(result: Dict, *, corrected: bool = True) -> Dict:
    """P(all tests significant) vs N."""
    key = "joint_corrected_rate" if corrected else "joint_uncorrected_rate"
    rows = [
        {"N": n, "joint": 100.0 * result[key][gi]}
        for gi, n in enumerate(result["sample_sizes"])
    ]
    return {
        "$schema": _SCHEMA,
        "description": "Joint detection (all tests significant) vs sample size",
        "data": {"values": rows},
        "mark": {"type": "line", "point": True},
        "encoding": {
            "x": {"field": "N", "type": "quantitative", "title": "Sample size"},
            "y": {
                "field": "joint",
                "type": "quantitative",
                "title": "P(all significant) (%)",
                "scale": {"domain": [0, 100]},
            },
        },
    }


def exactly_k_curves(result: Dict, *, corrected: bool = False) -> Dict:
    """P(exactly k of the targets significant) vs N, one line per k."""
    key = (
        "success_count_histogram_corrected"
        if corrected
        else "success_count_histogram_uncorrected"
    )
    hist = result[key]
    n_sims = result["n_sims"]
    rows = []
    for gi, n in enumerate(result["sample_sizes"]):
        for k, cnt in enumerate(hist[gi]):
            rows.append({"N": n, "k": str(k), "p": 100.0 * cnt / max(n_sims, 1)})
    return {
        "$schema": _SCHEMA,
        "description": "Exactly-k detection curves",
        "data": {"values": rows},
        "mark": {"type": "line", "point": True},
        "encoding": {
            "x": {"field": "N", "type": "quantitative", "title": "Sample size"},
            "y": {"field": "p", "type": "quantitative", "title": "P(exactly k) (%)"},
            "color": {"field": "k", "type": "nominal", "title": "k significant"},
        },
    }


def power_curves_overlay(scenarios: Dict[str, Dict], *, corrected: bool = True) -> Dict:
    """Scenario-envelope overlay: one line per (test, scenario), scenarios
    distinguished by dash pattern (the reference's multi-scenario
    sample-size view is the same overlay)."""
    which = "corrected" if corrected else "uncorrected"
    rows = []
    target = 80.0
    for scen, result in scenarios.items():
        target = 100.0 * result.get("target_power", 0.8)
        for gi, n in enumerate(result["sample_sizes"]):
            for i, t in enumerate(result["target_labels"]):
                rows.append(
                    {
                        "N": n,
                        "test": t,
                        "scenario": scen,
                        "power": 100.0 * result["powers"][which][gi][i],
                    }
                )
    return {
        "$schema": _SCHEMA,
        "description": f"Power vs sample size by scenario ({which})",
        "data": {"values": rows},
        "layer": [
            {
                "mark": {"type": "line", "point": True},
                "encoding": {
                    "x": {"field": "N", "type": "quantitative", "title": "Sample size"},
                    "y": {
                        "field": "power",
                        "type": "quantitative",
                        "title": "Power (%)",
                        "scale": {"domain": [0, 100]},
                    },
                    "color": {"field": "test", "type": "nominal"},
                    "strokeDash": {"field": "scenario", "type": "nominal"},
                },
            },
            {
                "mark": {"type": "rule", "strokeDash": [6, 4]},
                "data": {"values": [{"target": target}]},
                "encoding": {"y": {"field": "target", "type": "quantitative"}},
            },
        ],
    }


def power_plot_set(result: Dict) -> Dict[str, Dict]:
    """The find_power plot bundle (the cross-port plot contract)."""
    out = {"power_bars": power_bars(result)}
    if result.get("alpha_correction", "none") != "none":
        out["power_bars_corrected"] = power_bars(result, corrected=True)
    return out


def sample_size_plot_set(result: Dict) -> Dict[str, Dict]:
    """The find_sample_size plot bundle."""
    out = {"power_curves": power_curves(result)}
    if "joint_corrected_rate" in result:
        out["joint_detection"] = joint_detection_curves(result)
        out["exactly_k"] = exactly_k_curves(result)
    return out


def _embed_json(spec: Dict) -> str:
    """JSON for inline <script> embedding: '</' is escaped so a label
    containing '</script>' cannot terminate the tag and break (or script-
    inject) the page — same hazard the reference's stacked-html writer
    escapes (its test_stacked_html_escapes_script_tag)."""
    return json.dumps(spec).replace("</", "<\\/")


def to_html(spec: Dict, title: str = "MCPower plot") -> str:
    """Standalone vega-embed HTML page for one spec."""
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<script src="https://cdn.jsdelivr.net/npm/vega@5"></script>
<script src="https://cdn.jsdelivr.net/npm/vega-lite@5"></script>
<script src="https://cdn.jsdelivr.net/npm/vega-embed@6"></script>
</head><body><div id="vis"></div>
<script>vegaEmbed('#vis', {_embed_json(spec)});</script>
</body></html>"""


# The four cross-port plot themes, byte-derived from the reference's
# single-source configs/plot-themes.json (config truth data, same
# verbatim-loading precedent as the scenario presets): print variants
# carry a colorblind-safe category range; app variants restyle for the
# GUI host's light/dark chrome.
_THEMES = {
    "light-print": {
        "background": "#ffffff",
        "font": "sans-serif",
        "view": {
            "stroke": "transparent"
        },
        "axis": {
            "labelColor": "#000000",
            "titleColor": "#000000",
            "tickColor": "#000000",
            "domainColor": "#000000",
            "gridColor": "#dddddd"
        },
        "legend": {
            "labelColor": "#000000",
            "titleColor": "#000000"
        },
        "range": {
            "category": [
                "#0072B2",
                "#E69F00",
                "#009E73",
                "#D55E00",
                "#56B4E9",
                "#CC79A7",
                "#F0E442",
                "#000000"
            ]
        }
    },
    "dark-print": {
        "background": "#1e1e1e",
        "font": "sans-serif",
        "view": {
            "stroke": "transparent"
        },
        "axis": {
            "labelColor": "#e0e0e0",
            "titleColor": "#ffffff",
            "tickColor": "#888888",
            "domainColor": "#888888",
            "gridColor": "#3a3a3a"
        },
        "legend": {
            "labelColor": "#e0e0e0",
            "titleColor": "#ffffff"
        },
        "range": {
            "category": [
                "#56B4E9",
                "#E69F00",
                "#00C49A",
                "#F0772E",
                "#F0E442",
                "#D0D0D0"
            ]
        }
    },
    "light-app": {
        "background": "#ffffff",
        "view": {
            "stroke": "transparent"
        },
        "mark": {
            "color": "#c2356b"
        },
        "range": {
            "category": [
                "#c2356b",
                "#3d7d6e",
                "#5a7a9a",
                "#b58936",
                "#8a909a"
            ]
        },
        "axis": {
            "labelColor": "#6a7280",
            "titleColor": "#14161a",
            "gridColor": "#d4dae0",
            "domainColor": "#d4dae0",
            "tickColor": "#d4dae0"
        },
        "legend": {
            "labelColor": "#14161a",
            "titleColor": "#14161a"
        },
        "header": {
            "labelColor": "#14161a",
            "titleColor": "#14161a"
        },
        "title": {
            "color": "#14161a"
        }
    },
    "dark-app": {
        "background": "#110b1c",
        "view": {
            "stroke": "transparent"
        },
        "mark": {
            "color": "#ff5e8a"
        },
        "range": {
            "category": [
                "#ff5e8a",
                "#d9a55a",
                "#9b8ad9",
                "#6dbca5",
                "#9b8ea0"
            ]
        },
        "axis": {
            "labelColor": "#8e8295",
            "titleColor": "#ede5f0",
            "gridColor": "#2a2138",
            "domainColor": "#2a2138",
            "tickColor": "#2a2138"
        },
        "legend": {
            "labelColor": "#ede5f0",
            "titleColor": "#ede5f0"
        },
        "header": {
            "labelColor": "#ede5f0",
            "titleColor": "#ede5f0"
        },
        "title": {
            "color": "#ede5f0"
        }
    }
}


def available_themes():
    """Theme names accepted by save_plot/apply_theme (plus None)."""
    return sorted(_THEMES)


def apply_theme(spec: Dict, theme) -> Dict:
    """Return a copy of ``spec`` with the named theme's config merged in
    (spec-level config keys win). ``theme=None`` returns the spec unchanged
    ("theme-naked" output, same contract as the reference's save_plot)."""
    if theme is None:
        return spec
    if theme not in _THEMES:
        raise ValueError(
            f"unknown theme {theme!r}; available: {sorted(_THEMES)} or None"
        )
    themed = dict(spec)
    cfg = dict(_THEMES[theme])
    for k, v in (spec.get("config") or {}).items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k] = {**cfg[k], **v}
        else:
            cfg[k] = v
    themed["config"] = cfg
    return themed


def page_html(specs: Dict[str, Dict], title: str = "MCPower plots") -> str:
    """One standalone vega-embed page stacking every spec in the bundle
    (the reference's .plot() writes the same stacked, CDN-backed page)."""
    from html import escape

    divs = []
    embeds = []
    for i, (name, spec) in enumerate(specs.items()):
        divs.append(f'<h3 style="font-family:sans-serif">{escape(name)}</h3>'
                    f'<div id="vis{i}"></div>')
        embeds.append(f"vegaEmbed('#vis{i}', {_embed_json(spec)});")
    body = "\n".join(divs)
    script = "\n".join(embeds)
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<script src="https://cdn.jsdelivr.net/npm/vega@5"></script>
<script src="https://cdn.jsdelivr.net/npm/vega-lite@5"></script>
<script src="https://cdn.jsdelivr.net/npm/vega-embed@6"></script>
</head><body>{body}
<script>{script}</script>
</body></html>"""


def save_plot_files(
    specs: Dict[str, Dict],
    path: str,
    *,
    theme="light-print",
    scale: float = 2.0,
    ppi=None,
    title: str = "MCPower plots",
) -> None:
    """Render a plot bundle to file(s), dispatched on the path suffix.

    ``.html``/``.htm`` writes ONE stacked self-contained page (no optional
    dependency). ``.svg``/``.png``/``.pdf`` need the optional ``vl-convert``
    renderer and write one file per plot block with derived names
    (``out.png`` -> ``out.power_bars.png`` ...), mirroring the reference's
    save_plot contract (ports/py/mcpower/output/results.py:163-176)."""
    import os

    themed = {k: apply_theme(s, theme) for k, s in specs.items()}
    root, ext = os.path.splitext(path)
    ext = ext.lower()
    if ext in (".html", ".htm"):
        with open(path, "w") as fh:
            fh.write(page_html(themed, title=title))
        return
    if ext not in (".svg", ".png", ".pdf"):
        raise ValueError(
            f"save_plot: unsupported suffix {ext!r} (use .html, .svg, .png, "
            "or .pdf)"
        )
    try:
        import vl_convert as vlc
    except ImportError as e:
        raise ImportError(
            "save_plot to .svg/.png/.pdf needs the optional vl-convert "
            "renderer (pip install vl-convert-python); .html output has no "
            "extra dependency"
        ) from e
    for name, spec in themed.items():
        out = f"{root}.{name}{ext}" if len(themed) > 1 else path
        if ext == ".svg":
            data = vlc.vegalite_to_svg(vl_spec=json.dumps(spec))
            with open(out, "w") as fh:
                fh.write(data)
        elif ext == ".png":
            data = vlc.vegalite_to_png(
                vl_spec=json.dumps(spec), scale=scale, ppi=ppi or 72
            )
            with open(out, "wb") as fh:
                fh.write(data)
        else:
            data = vlc.vegalite_to_pdf(vl_spec=json.dumps(spec))
            with open(out, "wb") as fh:
                fh.write(data)
