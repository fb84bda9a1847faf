"""MCPower: the user-facing model class (Python-port API parity).

Mirrors the public surface of the reference's Python port
(ports/py/mcpower/model.py ``MCPower``): an R-style formula plus chained
deferred ``set_*`` configuration, two entry operations (``find_power`` /
``find_sample_size``), robustness scenarios, and text summaries. Two
independent axes configure every analysis:

* ``family=`` — the data-generating process: "ols" (continuous), "logit" /
  "probit" (binary), "poisson" (count), "lme" (continuous + clusters).
* ``estimator=`` / ``solve_as=`` — the model FITTED to each simulated
  dataset; defaults to the correctly-specified match, override to study
  misspecification (e.g. estimator="ols" on a clustered DGP).

The runs go through the PyTorch engine: ``find_power`` and
``find_sample_size`` take ``device=`` ("cuda", the default, or "cpu" for the
plain PyTorch versions of the kernels) and raise rather than fall back when
the card is missing. Designs the engine does not run yet raise
``NotImplementedError`` naming their ROADMAP item before any run starts.
"""

from __future__ import annotations

import math
import warnings as _warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .config import (
    CONFIG,
    RESIDUAL_NAMES,
    get_default_scenario_config,
    get_simulation_defaults,
    normalize_correction,
)
from .engine import datagen
from .engine.adapter import contract_to_lowered
from .orchestrator import grid as gridmod, runner
from .orchestrator.progress import CancellationToken
from .specbuilder.assignments import parse_assignments
from .specbuilder.project import build_contracts
from .specbuilder.testsel import overall_test_available, resolve_tests
from .specbuilder.variables import VariableRegistry

_FAMILIES = ("ols", "logit", "probit", "poisson", "lme")
# Accepted spellings for the continuous-outcome family: the AppSpec layer
# tags it "linear" and R users reach for "gaussian"; all map to "ols".
_FAMILY_ALIASES = {"gaussian": "ols", "linear": "ols"}
_ESTIMATORS = ("ols", "glm", "mle")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"not ported yet: {what} (ROADMAP {item})")


class MCPower:
    """Monte Carlo power analysis for OLS / GLM / mixed-effects designs."""

    def __init__(
        self,
        formula: str,
        *,
        family: str = "ols",
        estimator: Optional[str] = None,
        solve_as: Optional[str] = None,
    ) -> None:
        family = str(family).lower()
        family = _FAMILY_ALIASES.get(family, family)
        if family not in _FAMILIES:
            raise ValueError(f"family must be one of {_FAMILIES}, got {family!r}")
        self.family = family

        if family in ("logit", "probit"):
            self.outcome_kind = "binary"
        elif family == "poisson":
            self.outcome_kind = "count"
        else:
            self.outcome_kind = "continuous"
        self.link: Optional[str] = "probit" if family == "probit" else None

        est = estimator if estimator is not None else solve_as
        if est is not None and str(est).lower() not in _ESTIMATORS:
            raise ValueError(f"estimator must be one of {_ESTIMATORS}, got {est!r}")
        if est is not None:
            self.estimator = str(est).lower()
        elif family in ("logit", "probit", "poisson"):
            self.estimator = "glm"
        elif family == "lme":
            self.estimator = "mle"
        else:
            self.estimator = "ols"

        sim = get_simulation_defaults()
        self.seed: Optional[int] = sim["seed"]
        self.power: float = sim["target_power"] * 100.0
        self.alpha: float = sim["alpha"]
        self.n_simulations: int = sim["n_sims"]["mixed" if family == "lme" else "ols"]
        self.max_failed_simulations: float = sim["max_failed_fraction"]

        self._registry = VariableRegistry(formula)
        self._scenario_configs: Dict[str, Dict[str, Any]] = get_default_scenario_config()

        self._residual: Tuple[str, bool] = ("normal", False)
        self._het_driver: Optional[str] = None
        self._pending_variable_types: List[str] = []
        self._pending_effects: List[str] = []
        self._pending_correlations: List[Any] = []
        self._applied = False
        self._effects: Dict[str, float] = {}
        self._corr_matrix: Optional[List[List[float]]] = None
        self._corr_pairs: List[Tuple[Tuple[str, str], float]] = []
        self._pending_baseline_probability: Optional[float] = None
        self._pending_baseline_rate: Optional[float] = None
        self._warned_once: set = set()
        self.intercept: float = 0.0
        self._clusters: Dict[str, Dict[str, Any]] = {}
        self._uploaded = None
        # index into _pending_variable_types at upload time: declarations
        # made AFTER upload_data override the detection lock (explicit user
        # intent), earlier ones are superseded by it
        self._upload_vt_index: Optional[int] = None
        self.last_result: Optional[Dict] = None

    def __getattr__(self, name: str) -> Any:
        """Loud, instructive errors for the reference's removed ``set_*``
        setters (ports/py/mcpower/model.py:318-344): ``target_test`` and
        ``correction`` are per-call kwargs on find_power/find_sample_size,
        not model state. ``__getattr__`` only fires on lookups ordinary
        resolution missed, so this never shadows a real attribute."""
        if name == "set_tests":
            raise AttributeError(
                "MCPower.set_tests was removed — pass target_test=... directly "
                "to find_power()/find_sample_size() instead, e.g. "
                "find_power(160, target_test='all, -x2')."
            )
        if name == "set_correction_method":
            raise AttributeError(
                "MCPower.set_correction_method was removed — pass correction=... "
                "directly to find_power()/find_sample_size() instead, e.g. "
                "find_power(160, correction='bh')."
            )
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    # ------------------------------------------------------------------
    # introspection properties
    # ------------------------------------------------------------------
    @property
    def equation(self) -> str:
        return self._registry.formula

    @property
    def predictor_vars_order(self) -> List[str]:
        return self._registry.predictor_names

    @property
    def effect_names(self) -> List[str]:
        self._ensure_applied()
        return self._registry.effect_names

    @property
    def correlation_matrix(self) -> Optional[List[List[float]]]:
        self._ensure_applied()
        return self._corr_matrix

    def effect_skeleton(self) -> str:
        """A fill-in template for set_effects (the reference's skeleton)."""
        self._ensure_applied()
        return ", ".join(f"{n}=0.0" for n in self._registry.effect_names)

    # ------------------------------------------------------------------
    # setters (deferred; applied before each run)
    # ------------------------------------------------------------------
    def set_parallel(self, *_a, **_k) -> "MCPower":
        # Removed setter raises like the reference (model.py:369-372, its
        # message points at set_n_threads): parallelism is automatic here —
        # each chunk of sims runs as one batch of kernels on the device.
        raise AttributeError(
            "MCPower has no set_parallel — parallelism is automatic (each "
            "chunk of simulations runs as one batch on the device chosen by "
            "find_power(device=...)); set_n_threads has no equivalent."
        )

    def set_seed(self, seed: Optional[int]) -> "MCPower":
        if seed is not None:
            if not isinstance(seed, int):
                raise TypeError("seed must be an integer or None")
            if seed < 0:
                raise ValueError("seed must be non-negative")
        self.seed = seed
        return self

    def set_power(self, power: float) -> "MCPower":
        if not 0 < float(power) < 100:
            raise ValueError("target power must be in (0, 100)")
        self.power = float(power)
        return self

    def set_alpha(self, alpha: float) -> "MCPower":
        if not 0.0 < alpha < 1.0:
            raise ValueError("alpha must be in (0, 1)")
        if alpha > CONFIG["limits"]["max_alpha"]:
            _warnings.warn(
                f"alpha={alpha} is unusually large (> {CONFIG['limits']['max_alpha']})",
                UserWarning,
                stacklevel=2,
            )
        self.alpha = float(alpha)
        return self

    def set_simulations(self, n_simulations: int) -> "MCPower":
        n = int(n_simulations)
        if n < 1:
            raise ValueError("n_simulations must be positive")
        self.n_simulations = n
        return self

    def set_max_failed_simulations(self, fraction: float) -> "MCPower":
        if not 0 <= fraction <= 1:
            raise ValueError("fraction must be between 0 and 1")
        self.max_failed_simulations = float(fraction)
        return self

    def set_effects(self, spec: Union[str, Dict[str, float]]) -> "MCPower":
        if isinstance(spec, dict):
            spec = ", ".join(f"{k}={v}" for k, v in spec.items())
        if not isinstance(spec, str) or not spec.strip():
            raise TypeError("set_effects expects a non-empty string or dict")
        self._pending_effects.append(spec)
        self._applied = False
        return self

    def set_variable_type(self, spec: str) -> "MCPower":
        if not isinstance(spec, str):
            raise TypeError("set_variable_type expects a string")
        self._pending_variable_types.append(spec)
        self._applied = False
        return self

    def set_correlations(self, spec) -> "MCPower":
        if isinstance(spec, dict):
            self._pending_correlations.append(
                ", ".join(f"corr({a},{b})={v}" for (a, b), v in spec.items())
            )
        elif isinstance(spec, str):
            self._pending_correlations.append(spec)
        elif hasattr(spec, "tolist"):
            self._pending_correlations = [spec.tolist()]
        elif isinstance(spec, list):
            self._pending_correlations = [spec]
        else:
            raise TypeError(
                "set_correlations expects a string, matrix (list/ndarray), or dict"
            )
        self._applied = False
        return self

    def set_residual_distribution(self, name: str) -> "MCPower":
        if name not in RESIDUAL_NAMES:
            raise ValueError(
                f"unknown residual distribution {name!r}; must be one of "
                f"{sorted(RESIDUAL_NAMES)}"
            )
        self._residual = (name, True)  # explicit choice pins it
        return self

    def set_heteroskedasticity_driver(self, var: Optional[str] = None) -> "MCPower":
        if var is not None:
            non_factor = self._registry.non_factor_names
            if var not in non_factor:
                raise ValueError(
                    f"heteroskedasticity variable {var!r} must be a non-factor "
                    f"predictor; available: {non_factor}"
                )
        if self.family != "ols":
            _warnings.warn(
                f"set_heteroskedasticity_driver() has no effect for family="
                f"{self.family!r}; heteroskedasticity is an OLS-only DGP knob.",
                UserWarning,
                stacklevel=2,
            )
        self._het_driver = var
        return self

    def set_baseline_probability(self, p: float) -> "MCPower":
        if self.family not in ("logit", "probit"):
            raise ValueError(
                "set_baseline_probability is only for family='logit'/'probit'; "
                f"family={self.family!r} sizes the intercept by set_baseline_rate="
            )
        if not 0.0 < p < 1.0:
            raise ValueError("baseline probability must be in (0, 1)")
        lo, hi = CONFIG["limits"]["baseline_p_warn"]
        if not lo <= p <= hi:
            _warnings.warn(
                f"baseline probability {p} is extreme; power estimates may be "
                "unstable at small N",
                UserWarning,
                stacklevel=2,
            )
        self._pending_baseline_probability = float(p)
        self._applied = False
        return self

    def set_baseline_rate(self, rate: float) -> "MCPower":
        if self.family != "poisson":
            raise ValueError(
                "set_baseline_rate is only for family='poisson'; "
                f"family={self.family!r} sizes the intercept by "
                "set_baseline_probability="
            )
        if rate <= 0:
            raise ValueError("baseline rate must be > 0")
        self._pending_baseline_rate = float(rate)
        self._applied = False
        return self

    def set_cluster(
        self,
        grouping_var: str,
        ICC: Optional[float] = None,
        n_clusters: Optional[int] = None,
        cluster_size: Optional[int] = None,
        *,
        tau_squared: Optional[float] = None,
        random_slopes: Optional[List[str]] = None,
        slope_variance: float = 0.0,
        slope_intercept_corr: float = 0.0,
        n_per_parent: Optional[int] = None,
        cluster_level_vars: Optional[List[str]] = None,
    ) -> "MCPower":
        groups = self._registry.grouping_names
        if grouping_var not in groups:
            raise ValueError(
                f"grouping variable {grouping_var!r} is not a random-effect "
                f"grouping in the formula; available: {groups}"
            )
        if self.family == "poisson":
            if ICC is not None:
                raise ValueError(
                    "family='poisson' sizes the random effect by tau_squared, "
                    "not ICC; pass tau_squared= instead of ICC="
                )
        elif tau_squared is not None and ICC is not None:
            raise ValueError("pass either ICC= or tau_squared=, not both")
        if ICC is not None:
            if not 0.0 <= ICC < 1.0:
                raise ValueError("ICC must be in [0, 1)")
            lo, hi = CONFIG["limits"]["icc_stability"]
            if ICC != 0.0 and not lo <= ICC <= hi:
                _warnings.warn(
                    f"ICC={ICC} outside the numerically stable band [{lo}, {hi}]",
                    UserWarning,
                    stacklevel=2,
                )
        if n_clusters is not None and cluster_size is not None:
            raise ValueError("pass either n_clusters= or cluster_size=, not both")
        if n_clusters is None and cluster_size is None and n_per_parent is None:
            raise ValueError(
                "Must specify n_clusters= or cluster_size= (or n_per_parent= "
                "for a nested child grouping)"
            )
        if n_clusters is not None and n_clusters < CONFIG["limits"]["min_clusters"]:
            raise ValueError(
                f"n_clusters must be >= {CONFIG['limits']['min_clusters']}"
            )
        if ":" in grouping_var and not n_per_parent:
            raise ValueError(
                f"nested grouping {grouping_var!r} requires n_per_parent="
            )
        for v in cluster_level_vars or []:
            if v in self._registry.grouping_names:
                raise ValueError(
                    f"cluster_level_vars: {v!r} is the grouping variable "
                    "itself, not a predictor"
                )
            if v not in self._registry.predictor_names:
                raise ValueError(f"cluster_level_vars: {v!r} is not a predictor")
            if self._uploaded is not None and v in self._uploaded.columns:
                raise ValueError(
                    f"cluster_level_vars: {v!r} is bound to uploaded data — "
                    "uploaded rows carry no cluster structure to broadcast"
                )
        for v in random_slopes or []:
            if v not in self._registry.predictor_names:
                raise ValueError(f"random_slopes: {v!r} is not a predictor")
        self._clusters[grouping_var] = {
            "icc": ICC,
            "tau_squared": tau_squared,
            "n_clusters": n_clusters,
            "cluster_size": cluster_size,
            "random_slopes": list(random_slopes or []),
            "slope_variance": slope_variance,
            "slope_intercept_corr": slope_intercept_corr,
            "n_per_parent": n_per_parent,
            "cluster_level_vars": list(cluster_level_vars or []),
        }
        self._applied = False
        return self

    def upload_data(
        self,
        data,
        columns: Optional[List[str]] = None,
        mode: str = "partial",
        verbose: bool = True,
    ) -> "MCPower":
        """Attach pilot data to drive the generation process.

        ``data`` accepts a dict of columns, a list of row dicts, a csv/tsv
        path, a DataFrame-like, or a bare 2-D matrix together with
        ``columns`` naming its columns (reference model.py:841-847 form).

        ``mode='partial'`` (NORTA): uploaded columns keep their empirical
        marginals through the Gaussian copula; correlations are measured
        (Spearman -> latent scale) unless you set them explicitly.
        ``mode='strict'``: whole pilot rows are bootstrap-resampled, exactly
        preserving the empirical joint. Column types are auto-detected and
        type-locked against the model's declarations.
        """
        raise _not_ported("uploaded pilot data", "A13")

    def _lock_uploaded_types(self, reg) -> None:
        """Write uploaded-column detection into ``reg``. Called from
        upload_data AND from every _apply(): _apply rebuilds the registry
        from the pending declarations, which would otherwise silently drop
        the detected factor levels/labels as soon as any later setter
        re-applies."""
        if self._uploaded is None:
            return
        for n, col in self._uploaded.columns.items():
            if n not in reg.predictor_names:
                continue
            if col.kind == "factor":
                labels = list(col.labels)
                # labels must survive the set_effects assignment grammar —
                # a data value containing its metacharacters would make the
                # level unaddressable; fall back to 1-based integers
                if any(
                    any(ch in str(lab) for ch in ",=[]") for lab in labels
                ):
                    msg = (
                        f"uploaded factor {n!r} has level values containing "
                        "',', '=', '[' or ']' — using positional labels "
                        f"{n}[1..{col.n_levels}] instead of the data values"
                    )
                    if msg not in self._warned_once:
                        self._warned_once.add(msg)
                        _warnings.warn(msg, UserWarning, stacklevel=2)
                    labels = [str(i + 1) for i in range(col.n_levels)]
                reg.set_variable_type(
                    n, {"type": "factor", "n_levels": col.n_levels,
                        "proportions": list(col.proportions),
                        "labels": labels},
                )
            elif col.kind == "binary":
                reg.set_variable_type(
                    n, {"type": "binary", "proportion": col.param}
                )

    def get_effects_from_data(self, y: Optional[str] = None, *, verbose: bool = True) -> str:
        """Fit the model to the uploaded pilot data and return a standardized
        effect-size string you can paste into set_effects."""
        raise _not_ported("effect recovery from uploaded data", "A13")

    def set_scenario_configs(self, configs: Dict[str, Dict[str, Any]]) -> "MCPower":
        if not isinstance(configs, dict):
            raise ValueError("set_scenario_configs expects {label: {knob: value}}")
        from .config import DISTRIBUTION_NAMES, RESIDUAL_NAMES

        for label, cfg in configs.items():
            base = self._scenario_configs.setdefault(
                label, dict(self._scenario_configs.get("realistic", {}))
            )
            unknown = set(cfg) - set(base)
            if unknown:
                raise ValueError(
                    f"unknown scenario keys for {label!r}: {sorted(unknown)}"
                )
            # Distribution-name whitelists (reference APIC-80: an unknown
            # name in new_distributions/residual_dists is a loud error, not
            # a silent engine fallback).
            for key, allowed in (
                ("new_distributions", DISTRIBUTION_NAMES),
                ("residual_dists", RESIDUAL_NAMES),
            ):
                bad = [d for d in cfg.get(key, []) if d not in allowed]
                if bad:
                    raise ValueError(
                        f"unknown distribution(s) {bad} in {label!r}.{key}; "
                        f"valid: {sorted(allowed)}"
                    )
            base.update(cfg)
        return self

    # ------------------------------------------------------------------
    # apply + lowering
    # ------------------------------------------------------------------
    def _ensure_applied(self):
        if not self._applied:
            self._apply()

    def _apply(self) -> None:
        reg = VariableRegistry(self._registry.formula)
        idx = (
            self._upload_vt_index
            if self._upload_vt_index is not None
            else len(self._pending_variable_types)
        )

        def apply_frags(frags):
            for frag in frags:
                items, errors = parse_assignments(
                    frag, "variable_type", reg.predictor_names
                )
                if errors:
                    raise ValueError("; ".join(errors))
                for it in items:
                    reg.set_variable_type(it.key, it.value)

        # pre-upload declarations, then the upload detection lock, then any
        # post-upload declarations (explicit overrides win over detection)
        apply_frags(self._pending_variable_types[:idx])
        self._lock_uploaded_types(reg)
        apply_frags(self._pending_variable_types[idx:])
        self._registry = reg

        self._effects = {}
        inter_terms = [t["vars"] for t in reg.parsed.terms if t["kind"] == "interaction"]
        # Strict reference semantics: effect names must be POST-EXPANSION
        # effect names (g[2], g1[2]:g2[2], x1, x1:x2) — base factor names are
        # rejected here, not later at projection (reference model.py:1497-1500).
        known_effect_keys = reg.effect_names
        for frag in self._pending_effects:
            items, errors = parse_assignments(
                frag, "effect", known_effect_keys, interaction_terms=inter_terms
            )
            if errors:
                raise ValueError(
                    "; ".join(errors)
                    + f" (available: {', '.join(reg.effect_names)})"
                )
            for it in items:
                self._effects[it.key] = it.value
        self._warn_effect_scale(reg)

        self._corr_matrix = None
        self._corr_pairs = []
        for entry in self._pending_correlations:
            if isinstance(entry, list):
                self._validate_corr_matrix(entry, reg)
                self._corr_matrix = entry
                self._corr_pairs = []
            else:
                items, errors = parse_assignments(
                    entry, "correlation", reg.non_factor_names
                )
                if errors:
                    raise ValueError("; ".join(errors))
                for it in items:
                    self._corr_pairs.append((it.key[1], it.value))

        # intercept from baseline
        if self._pending_baseline_probability is not None:
            p = self._pending_baseline_probability
            if self.family == "probit":
                from scipy import stats as _st

                self.intercept = float(_st.norm.ppf(p))
            else:
                self.intercept = math.log(p / (1 - p))
        elif self._pending_baseline_rate is not None:
            self.intercept = math.log(self._pending_baseline_rate)

        self._applied = True

    @staticmethod
    def _validate_corr_matrix(mat, reg) -> None:
        """Structural checks on a full correlation matrix (reference
        APIC-35/81/82): shape matches the non-factor predictor count,
        symmetric, unit diagonal. Asymmetry and a non-unit diagonal are
        wire-unrepresentable (only the upper triangle crosses the engine
        boundary), so they must be rejected loudly here, not silently
        symmetrized."""
        a = np.asarray(mat, dtype=np.float64)
        k = len(reg.non_factor_names)
        if a.ndim != 2 or a.shape != (k, k):
            raise ValueError(
                f"correlation matrix must be {k}x{k} (one row per non-factor "
                f"predictor: {reg.non_factor_names}); got shape "
                f"{tuple(a.shape)}"
            )
        if not np.allclose(a, a.T, atol=1e-12):
            raise ValueError("correlation matrix must be symmetric")
        if not np.allclose(np.diag(a), 1.0, atol=1e-12):
            raise ValueError("correlation matrix diagonal must be 1.0")
        off = a[~np.eye(k, dtype=bool)]
        if off.size and (np.min(off) < -1.0 or np.max(off) > 1.0):
            raise ValueError("correlations must lie in [-1, 1]")

    def _resolve_scenarios_arg(self, scenarios) -> List[str]:
        if scenarios is False or scenarios is None:
            return ["optimistic"]
        if scenarios is True:
            return ["optimistic", "realistic", "doomer"]
        names = list(scenarios)
        if not names:
            raise ValueError(
                "scenarios=[] selects nothing — pass True, False, or a "
                "non-empty list of scenario labels"
            )
        for n in names:
            if n not in self._scenario_configs:
                raise ValueError(
                    f"unknown scenario {n!r}; configured: "
                    f"{sorted(self._scenario_configs)}"
                )
        return names

    def _resolve_estimation(self, wald_se, agq) -> Tuple[str, int]:
        est = CONFIG["estimation"]
        ws = (wald_se or est["wald_se"]).lower()
        if ws not in ("rx", "hessian"):
            raise ValueError("wald_se must be 'rx' or 'hessian'")
        nagq = int(agq) if agq is not None else int(est["nagq"])
        if nagq != 1:
            has_slopes = any(
                cfg.get("random_slopes") for cfg in self._clusters.values()
            )
            eligible = (
                self.outcome_kind in ("binary", "count")
                and len(self._clusters) == 1  # single grouping only
                and not has_slopes  # AGQ is intercept-only (lme4 parity)
                and nagq % 2 == 1
                and 3 <= nagq <= 25
            )
            if not eligible:
                _warnings.warn(
                    f"agq={nagq} is not eligible for this design; running at "
                    "Laplace (agq=1) instead",
                    UserWarning,
                    stacklevel=3,
                )
                nagq = 1
        return ws, nagq

    def _project(self, names, *, target_test, correction, wald_se, nagq,
                 test_formula=None):
        tests = resolve_tests(
            target_test,
            self._registry,
            overall_available=overall_test_available(
                self.estimator, bool(self._clusters)
            ),
        )
        # Tukey HSD is a family-wide correction for post-hoc contrast
        # families; pointing it at explicitly requested marginal β tests is a
        # category error — warn and proceed (reference
        # spec_builder.py:306-323). The target_test=None default ("all
        # betas" shorthand) carries no specific Tukey-family intent, so it
        # stays silent.
        if (
            normalize_correction(correction) == "tukey_hsd"
            and target_test is not None
            and tests.get("targets")
        ):
            _warnings.warn(
                "Tukey HSD applies only to post-hoc contrast families; the "
                "marginal coefficient test(s) you requested compare against "
                "each factor's studentized-range threshold (non-factor "
                "targets are never significant under Tukey).",
                UserWarning,
                stacklevel=3,
            )
        projected = build_contracts(
            self._registry,
            outcome_kind=self.outcome_kind,
            link=self.link,
            estimator=self.estimator,
            intercept=self.intercept,
            effects=self._effects,
            correlation_matrix=self._corr_matrix,
            correlation_pairs=self._corr_pairs,
            residual=self._residual,
            het_driver_name=self._het_driver,
            clusters=self._clusters or None,
            alpha=self.alpha,
            correction=normalize_correction(correction),
            tests=tests,
            scenario_labels=names,
            scenario_configs=self._scenario_configs,
            wald_se=wald_se,
            nagq=nagq,
            max_failed_fraction=self.max_failed_simulations,
            upload=self._uploaded,
        )
        if test_formula is not None:
            from .specbuilder.formula import parse_formula

            test_parsed = parse_formula(test_formula)
            for ps in projected:
                ps.contract.test_design = _test_design_terms(
                    test_parsed, ps.contract, self._registry
                )
        return projected

    def _run_preflight(self) -> None:
        """Run-entry preconditions shared by find_power / find_sample_size
        / debug: every formula-declared grouping needs a set_cluster call
        (reference: find_power without set_cluster raises — otherwise the
        DGP silently generates without the random effect), and poisson
        designs need an explicit baseline rate."""
        missing = [
            g for g in self._registry.grouping_names if g not in self._clusters
        ]
        if missing:
            raise ValueError(
                f"random-effect grouping(s) {missing} have no sizing: call "
                "set_cluster() for each grouping in the formula before running"
            )
        # Poisson designs must anchor the count scale explicitly (reference:
        # 'baseline rate required' at find_power) — a silent rate-1 default
        # materially changes power.
        if self.family == "poisson" and self._pending_baseline_rate is None:
            raise ValueError(
                "baseline rate required for family='poisson': call "
                "set_baseline_rate(r) to anchor the expected count at the "
                "predictor means (the intercept is log r)"
            )
        # Binary families likewise hard-require an anchored baseline
        # (reference model.py:1262-1266 '_validate_logit_runtime'): a silent
        # p=0.5 default materially changes power for rare-event designs.
        if (
            self.family in ("logit", "probit")
            and self._pending_baseline_probability is None
        ):
            raise ValueError(
                f"baseline probability required for family={self.family!r}: "
                "call set_baseline_probability(p) to anchor the outcome rate "
                "at the predictor means (the intercept is the link of p)"
            )
        # cluster_level_vars × upload interplay is order-independent here
        # (the setter can only catch upload-then-set_cluster): an uploaded
        # column carries no cluster structure to broadcast.
        if self._uploaded is not None:
            for gvar, cfg in self._clusters.items():
                bad = [
                    v for v in cfg.get("cluster_level_vars", [])
                    if v in self._uploaded.columns
                ]
                if bad:
                    raise ValueError(
                        f"cluster_level_vars for {gvar!r}: {bad} are bound "
                        "to uploaded data — uploaded rows carry no cluster "
                        "structure to broadcast"
                    )

    def _primary_cluster(self):
        if not self._clusters:
            return None
        for ps in self._project(
            ["optimistic"], target_test=None, correction=None,
            wald_se="rx", nagq=1,
        ):
            return ps.contract.generation.cluster
        return None

    # ------------------------------------------------------------------
    # entry operations
    # ------------------------------------------------------------------
    def find_power(
        self,
        sample_size: int,
        *,
        target_test: Optional[str] = None,
        correction: Optional[str] = None,
        wald_se: Optional[str] = None,
        agq: Optional[int] = None,
        test_formula: Optional[str] = None,
        n_sims: Optional[int] = None,
        seed: Optional[int] = None,
        sim_id_offset: int = 0,
        scenarios: Union[bool, List[str]] = False,
        progress_callback: Any = None,
        verbose: bool = True,
        device: str = "cuda",
    ) -> Dict[str, Any]:
        """Estimate power at a single sample size.

        ``sim_id_offset`` starts the global sim-id range at an offset so a
        worker pool can run disjoint ranges of ONE seed and pool the part
        results exactly (``orchestrator.merge``) — the host-side analogue
        of the reference's browser worker fan-out (ports/wasm/src/seeds.ts),
        with a byte-stable guarantee its per-worker-seed scheme lacks.

        ``device`` is the torch device the simulations run on: the CUDA card
        by default (``RuntimeError`` when there is none), ``"cpu"`` for the
        plain PyTorch versions of the kernels."""
        self._ensure_applied()
        self._run_preflight()
        sample_size = int(sample_size)
        if sample_size < 2:
            raise ValueError("sample_size must be >= 2")
        # Green's rule of thumb (reference validators.py:165, hard error):
        # N >= 15 + p where p counts design-matrix columns excl. intercept.
        n_variables = len(self._registry.effect_names)
        min_required = 15 + n_variables
        if sample_size < min_required:
            raise ValueError(
                f"sample_size={sample_size} is below the minimum for this "
                f"model: need at least 15 + {n_variables} predictors = "
                f"{min_required} observations (Green's rule)"
            )
        wald_se_r, nagq = self._resolve_estimation(wald_se, agq)
        names = self._resolve_scenarios_arg(scenarios)
        projected = self._project(
            names, target_test=target_test, correction=correction,
            wald_se=wald_se_r, nagq=nagq, test_formula=test_formula,
        )

        preflight = self._factor_preflight(sample_size)
        lowered = []
        snap_warning = None
        for ps in projected:
            ps.warnings.extend(preflight)
            spec_probe, _ = contract_to_lowered(ps.contract, [max(sample_size, 2)])
            n_snapped, snap_warning = gridmod.snap_single_n(
                spec_probe.cluster, sample_size
            )
            spec, arrays = contract_to_lowered(ps.contract, [n_snapped])
            w = ps.warnings + ([snap_warning] if snap_warning else [])
            lowered.append(
                runner.LoweredScenario(
                    label=ps.label, spec=spec, arrays=arrays,
                    target_labels=ps.target_labels,
                    posthoc_labels=ps.posthoc_labels, warnings=w,
                )
            )
        _check_all_supported(lowered)

        n = int(n_sims) if n_sims is not None else self.n_simulations
        base_seed = self._base_seed(seed)
        token = CancellationToken()
        results = runner.find_power(
            lowered, n_sims=n, base_seed=base_seed, progress=progress_callback,
            cancel=token, sim_id_offset=int(sim_id_offset), device=device,
        )
        # Reference boundary semantics (engine-py): a cancelled run raises
        # KeyboardInterrupt at the API edge — callers opt into cancellation
        # (callback returns False / raises), so partial counts are discarded.
        if token.is_cancelled():
            raise KeyboardInterrupt("power run cancelled by progress callback")
        out = self._package(results, names, kind="power")
        if verbose:
            print(out.summary())
            # the SNAPPED N — what the datasets were actually drawn at
            self._emit_reuse_notes(out, sample_size=n_snapped)
        self.last_result = out
        return out

    def find_sample_size(
        self,
        *,
        target_test: Optional[str] = None,
        correction: Optional[str] = None,
        wald_se: Optional[str] = None,
        agq: Optional[int] = None,
        test_formula: Optional[str] = None,
        target_power: Optional[float] = None,
        from_size: Optional[int] = None,
        to_size: Optional[int] = None,
        by: Union[int, str, None] = None,
        mode: str = "linear",
        n_sims: Optional[int] = None,
        seed: Optional[int] = None,
        sim_id_offset: int = 0,
        scenarios: Union[bool, List[str]] = False,
        progress_callback: Any = None,
        verbose: bool = True,
        device: str = "cuda",
    ) -> Dict[str, Any]:
        """Search the smallest N reaching target power (CRN grid search).

        ``device`` as in :meth:`find_power`."""
        self._ensure_applied()
        self._run_preflight()
        ssb = CONFIG["simulation"]["sample_size_bounds"]
        from_size = int(from_size) if from_size is not None else ssb["from"]
        to_size = int(to_size) if to_size is not None else ssb["to"]
        by = by if by is not None else ssb["by"]
        tpow = float(target_power) if target_power is not None else self.power

        wald_se_r, nagq = self._resolve_estimation(wald_se, agq)
        names = self._resolve_scenarios_arg(scenarios)
        projected = self._project(
            names, target_test=target_test, correction=correction,
            wald_se=wald_se_r, nagq=nagq, test_formula=test_formula,
        )

        spec_probe, _ = contract_to_lowered(projected[0].contract, [max(to_size, 4)])
        atom = gridmod.cluster_atom(spec_probe.cluster)
        hard_min = gridmod.hard_min_n(spec_probe.cluster)
        grid_ns, grid_warnings = gridmod.build_grid(
            from_size, to_size, by, mode, atom, hard_min
        )

        preflight = self._factor_preflight(grid_ns[0], grid_ns=grid_ns)
        lowered = []
        for ps in projected:
            spec, arrays = contract_to_lowered(ps.contract, grid_ns)
            lowered.append(
                runner.LoweredScenario(
                    label=ps.label, spec=spec, arrays=arrays,
                    target_labels=ps.target_labels,
                    posthoc_labels=ps.posthoc_labels,
                    warnings=ps.warnings + grid_warnings + preflight,
                )
            )
        _check_all_supported(lowered)

        n = int(n_sims) if n_sims is not None else self.n_simulations
        base_seed = self._base_seed(seed)
        token = CancellationToken()
        results = runner.find_sample_size(
            lowered, n_sims=n, base_seed=base_seed, target_power=tpow,
            atom=atom, progress=progress_callback, cancel=token,
            sim_id_offset=int(sim_id_offset), device=device,
        )
        if token.is_cancelled():
            raise KeyboardInterrupt(
                "sample-size run cancelled by progress callback"
            )
        out = self._package(results, names, kind="sample_size")
        if verbose:
            print(out.summary(target_power=tpow))
            self._emit_reuse_notes(out)
        self.last_result = out
        return out

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _base_seed(self, seed) -> int:
        if seed is not None:
            return int(seed)
        if self.seed is not None:
            return int(self.seed)
        return 0

    def _factor_preflight(
        self, n_min: int, grid_ns: Optional[List[int]] = None
    ) -> List[str]:
        """Expected-count warnings before any simulation runs (the
        reference's factor preflight, find_power.rs:62-115).

        With ``grid_ns`` (a sample-size search), the warning also names the
        smallest N in the searched range that clears the minimum — the
        reference's documented search-preflight behavior
        (web/documentation/concepts/limitations.md "Sparse factor levels")."""
        out: List[str] = []
        min_count = int(CONFIG["limits"]["factor_min_level_count"])
        for name in self._registry.factor_names:
            props = self._registry.factor_proportions(name)
            pmin = min(props)
            expected_min = n_min * pmin
            if expected_min < min_count:
                if grid_ns:
                    clearing = next(
                        (int(n) for n in grid_ns if n * pmin >= min_count),
                        None,
                    )
                    if clearing is None:
                        out.append(
                            f"factor {name!r}: the rarest level expects fewer "
                            f"than {min_count} rows at every N in the "
                            f"searched range (max {int(grid_ns[-1])}) — the "
                            "factor will be excluded throughout; raise the "
                            "range or the level's proportion"
                        )
                    else:
                        out.append(
                            f"factor {name!r}: the rarest level expects fewer "
                            f"than {min_count} rows below N={clearing}; the "
                            "factor will be excluded at smaller grid points "
                            f"(smallest N in range clearing the minimum: "
                            f"{clearing})"
                        )
                else:
                    out.append(
                        f"factor {name!r}: the rarest level expects only "
                        f"{expected_min:.1f} rows at N={n_min} (< {min_count}); "
                        "its dummies will be unstable or excluded in many "
                        "simulations"
                    )
        # Deterministic confounding: under fixed (non-sampled) allocation —
        # the default scenario — every factor's level sequence is the same
        # Hamilton walk of its proportions over rows 0..N-1 (reference
        # data_gen.rs:943 fixed_level_next), so two factors with identical
        # proportion vectors produce row-identical dummies and a singular
        # design. Surface the cause up front; the rank check fails every fit.
        seen: Dict[tuple, str] = {}
        identical_pairs: set = set()
        fixed_names: List[str] = []
        for name in self._registry.factor_names:
            if self._registry.var_info(name).get("sampled_proportions"):
                continue  # per-factor override: independently sampled per row
            if self._uploaded is not None and name in self._uploaded.columns:
                # uploaded factors generate from the pilot frame
                # (factor_from_frame), not the shared Hamilton walk
                continue
            fixed_names.append(name)
            key = tuple(round(p, 12) for p in self._registry.factor_proportions(name))
            if key in seen:
                identical_pairs.add((seen[key], name))
                msg = (
                    f"factors {seen[key]!r} and {name!r} have identical "
                    "proportions under deterministic (fixed) allocation — "
                    "their level sequences are row-identical, so the design "
                    "is perfectly confounded and every fit will be singular. "
                    "Give the factors different proportions, or run a "
                    "scenario with sampled factor proportions "
                    "(e.g. scenarios=True: 'realistic'/'doomer' sample them)."
                )
                out.append(msg)
                _warnings.warn(msg, UserWarning, stacklevel=3)
            else:
                seen[key] = name
        # General exact check: the fixed walk is a pure function of
        # (proportions, row), so the dummy columns two factors will produce
        # are KNOWN before any simulation — build them for the largest N and
        # rank-test each pair. This catches partial structural confounding
        # the identical-proportions rule misses: e.g. uniform 6- and 4-level
        # walks are both round-robins, so 'level parity' is the same column
        # in both dummy blocks and every fit is exactly singular (the
        # reference shares this generation rule, data_gen.rs:943, and fails
        # the same way at runtime — here the cause is named up front).
        if len(fixed_names) >= 2:
            import math
            from fractions import Fraction

            # The fixed walks are PERIODIC (each repeats once L * p_i are
            # all integers), so a bounded prefix covering a few joint
            # periods decides linear dependence exactly — testing the full
            # N_max just repeats the same rows through the SVD (with many
            # factors and a large to_size that was measurable host
            # latency). Estimate each walk's period from rationalized
            # proportions, take the joint lcm (capped), and test
            # min(N_max, a few periods).
            joint_period = 1
            for name in fixed_names:
                per = 1
                for p in self._registry.factor_proportions(name):
                    per = math.lcm(
                        per, Fraction(p).limit_denominator(64).denominator
                    )
                joint_period = math.lcm(joint_period, min(per, 512))
                if joint_period >= 4096:
                    joint_period = 4096
                    break
            n_chk = int(grid_ns[-1]) if grid_ns else int(n_min)
            n_chk = min(n_chk, max(256, 2 * joint_period))
            dummies: Dict[str, np.ndarray] = {}
            for name in fixed_names:
                codes = datagen.fixed_allocation_codes(
                    self._registry.factor_proportions(name), n_chk
                )
                k = len(self._registry.factor_proportions(name))
                dummies[name] = (
                    codes[:, None] == np.arange(1, k)[None, :]
                ).astype(np.float64)
            ones = np.ones((n_chk, 1))
            for i, a in enumerate(fixed_names):
                for b in fixed_names[i + 1:]:
                    if (a, b) in identical_pairs:
                        continue  # already reported with the sharper message
                    X = np.column_stack([ones, dummies[a], dummies[b]])
                    if np.linalg.matrix_rank(X) < X.shape[1]:
                        msg = (
                            f"factors {a!r} and {b!r} are structurally "
                            "confounded under deterministic (fixed) "
                            "allocation: their level sequences share an "
                            f"exact linear dependence at N={n_chk} (their "
                            "walks are both periodic row patterns), so every "
                            "fit will be rank-deficient. Give the factors "
                            "co-prime level structures or different "
                            "proportions, or run a scenario with sampled "
                            "factor proportions (e.g. scenarios=True)."
                        )
                        out.append(msg)
                        _warnings.warn(msg, UserWarning, stacklevel=3)
        return out

    def _upload_reuse_warning(self, n_target: int) -> Optional[str]:
        """Strict-bootstrap pilot-reuse warning (reference model.py:100-109)."""
        if self._uploaded is None or self._uploaded.mode != "strict":
            return None
        raise _not_ported("uploaded pilot data", "A13")

    def _emit_reuse_notes(self, out, *, sample_size: Optional[int] = None) -> None:
        """Verbose ``[strict bootstrap]`` row-reuse note (reference
        model.py:2035-2043 for power runs, 2275-2295 for sample-size runs):
        power runs report the expected reuse fraction at the requested N;
        sample-size runs report it at each target's first-achieved N."""
        if self._uploaded is None or self._uploaded.mode != "strict":
            return
        raise _not_ported("uploaded pilot data", "A13")

    def _min_cluster_size(self, n: int) -> Optional[int]:
        """Smallest per-cluster row count of the primary grouping at N."""
        cl = self._primary_cluster()
        if cl is None or not cl.sizing_value:
            return None
        if cl.sizing_mode == "fixed_clusters":
            return n // max(int(cl.sizing_value), 1)
        return int(cl.sizing_value)

    def _small_cluster_warning(self, res: Dict) -> Optional[str]:
        """Reliability warning for thin clusters (reference cluster
        validator: warn below ~10 rows per cluster): variance components
        estimated from very few rows per group are unstable."""
        if not self._clusters:
            return None
        n_min = min(res.get("sample_sizes", [0]))
        min_size = self._min_cluster_size(n_min)
        rel = int(CONFIG["limits"]["reliable_rows_per_cluster"])
        rec = int(CONFIG["limits"]["recommended_rows_per_cluster"])
        if min_size is not None and min_size < rel:
            return (
                f"clusters have only {min_size} rows each at N={n_min} "
                f"(< {rel}; {rec}+ recommended) — random-effect variance "
                "estimates will be unstable; increase N or reduce n_clusters"
            )
        return None

    def _glmm_laplace_bias_warning(self, res: Dict) -> Optional[str]:
        """Laplace-bias warning for clustered binary/count fits at nagq=1
        (reference ports/py/mcpower/model.py:111-147): fires when the
        estimated random-intercept variance is large AND clusters are small
        — the regime where the Laplace approximation is optimistic."""
        if self.outcome_kind == "continuous" or not self._clusters:
            return None
        extras = res.get("estimator_extras") or {}
        arm = extras.get("glm") or extras.get("mle") or {}
        tau_means = arm.get("tau_squared_hat_mean")
        if not tau_means:
            return None
        tau = max(tau_means)
        thr = float(CONFIG["report"]["thresholds"]["glmm_tau_sq_warn"])
        rec = int(CONFIG["limits"]["recommended_rows_per_cluster"])
        n_min = min(res.get("sample_sizes", [0]))
        min_size = self._min_cluster_size(n_min)
        if min_size is None:
            return None
        if tau > thr and min_size < rec:
            return (
                f"Laplace-approximation bias likely: estimated random-"
                f"intercept variance tau^2 = {tau:.2f} exceeds {thr:.2f} with "
                f"small clusters (min cluster size {min_size} < {rec}). GLMM "
                "power may be optimistic — interpret with caution, increase "
                "cluster size, or set agq > 1."
            )
        return None

    def _glm_baseline_drift_warning(self, res: Dict) -> Optional[str]:
        """Warn when the realized marginal outcome rate drifts from the
        requested baseline probability by more than the configured
        threshold (reference diagnostic 'GLM baseline drift'): nonzero
        predictor effects shift the marginal rate away from the intercept's
        baseline, which surprises users sizing rare-event designs."""
        if self._pending_baseline_probability is None:
            return None
        extras = (res.get("estimator_extras") or {}).get("glm") or {}
        realized = extras.get("baseline_prob_realized")
        if realized is None:
            return None
        req = self._pending_baseline_probability
        vals = realized if isinstance(realized, (list, tuple)) else [realized]
        worst = max(abs(float(r) - req) for r in vals)
        thr = CONFIG["report"]["thresholds"]["glm_baseline_drift_max"]
        if worst > thr:
            return (
                f"GLM baseline drift {worst:.3f}: the realized outcome rate "
                f"deviates from the requested baseline {req} (> {thr}) — "
                "nonzero effects shift the marginal rate; re-anchor the "
                "baseline if the marginal prevalence matters"
            )
        return None

    def _check_failure_threshold(self, res: Dict) -> None:
        conv = res.get("convergence_rate", [1.0])
        worst_idx = min(range(len(conv)), key=lambda i: conv[i])
        worst = conv[worst_idx]
        if 1.0 - worst > self.max_failed_simulations:
            msg = (
                f"{(1.0 - worst) * 100:.1f}% of simulations failed to converge "
                f"(> max_failed_simulations={self.max_failed_simulations}); "
                "the design is likely unstable at this N"
            )
            # When the preflight already named the structural cause, repeat
            # it here — the generic message would send the user hunting.
            for w in res.get("warnings", []):
                if "confounded" in w:
                    msg += f". Known cause: {w}"
                    break
            # Mixed-model boundary breakdown at the worst N (reference
            # output/results.py _check_failure_threshold message).
            tz = res.get("boundary_hit_rate_tau_zero") or []
            ht = res.get("boundary_hit_rate_high_tau") or []
            if worst_idx < len(tz) and (any(tz) or any(ht)):
                msg += (
                    f". Boundary-hit breakdown at that N: "
                    f"tau_zero={tz[worst_idx]:.1%} (τ̂=0, common for small "
                    f"ICC), high_tau={ht[worst_idx]:.1%} (τ̂ implausibly "
                    "large, potential red flag). Raise the threshold via "
                    "set_max_failed_simulations() or increase n_clusters / "
                    "sample size."
                )
            raise RuntimeError(msg)

    def _warn_effect_scale(self, reg) -> None:
        """Two-tier scale-mismatch warning for logit/probit effects
        (reference validators.py:386): |β|>5 on any effect looks like an
        input error (OR > ~150); |β|>3 on an all-continuous effect looks
        like a raw-scale OR pasted where a standardized log-odds belongs.
        Each message fires once per model instance."""
        if self.family not in ("logit", "probit"):
            return
        non_cont = set(reg.factor_names) | {
            n for n in reg.predictor_names
            if reg.var_info(n)["type"] == "binary"
        }

        def all_continuous(name: str) -> bool:
            return all(
                p.split("[", 1)[0] not in non_cont for p in name.split(":")
            )

        for name, beta in self._effects.items():
            if abs(beta) > 5.0:
                msg = (
                    f"effect {name}={beta} has |β|>5 (odds ratio > ~150) — "
                    "logit effects are log-odds; check for an input error"
                )
            elif abs(beta) > 3.0 and all_continuous(name):
                msg = (
                    f"effect {name}={beta} has |β|>3 (odds ratio > ~20) on a "
                    "standardized continuous predictor — a raw-scale odds "
                    "ratio may have been pasted where a log-odds belongs"
                )
            else:
                continue
            if msg not in self._warned_once:
                self._warned_once.add(msg)
                _warnings.warn(msg, UserWarning, stacklevel=3)

    def _run_meta(self) -> Dict[str, Any]:
        """Run-level metadata for the report header (the reference port's
        `meta` dict fed to output/report.py: formula, estimator, effects echo
        with OR for logit outcomes, residual, target)."""
        return {
            "formula": self._registry.formula,
            "family": self.family,
            "estimator": self.estimator,
            "outcome_kind": self.outcome_kind,
            "alpha": self.alpha,
            "effects": dict(self._effects),
            "residual": self._residual[0],
            "target_power": self.power,
            # per-factor label store for the report's factor-header rows
            # (baseline = level 1; labels are the uploaded data values when
            # pilot data supplied the levels)
            "factors": {
                fname: {
                    "baseline": self._registry.factor_level_label(fname, 1),
                    "levels": [
                        self._registry.factor_level_label(fname, lvl)
                        for lvl in range(
                            1, self._registry.factor_levels(fname) + 1
                        )
                    ],
                }
                for fname in self._registry.factor_names
            },
        }

    def _package(self, results: Dict[str, Dict], names: List[str], kind: str):
        for res in results.values():
            self._check_failure_threshold(res)
            res["result_kind"] = kind
            res["family"] = self.family
            res["formula"] = self._registry.formula
            # every scenario tree carries the run's target as a proportion:
            # sample-size runs already set it (incl. per-call overrides);
            # power runs get the model's target so plots/short-form render
            # the real line, not a default
            res.setdefault("target_power", self.power / 100.0)
            n_max = max(res.get("sample_sizes", [0]))
            for w in (
                self._upload_reuse_warning(n_max),
                self._glmm_laplace_bias_warning(res),
                self._glm_baseline_drift_warning(res),
                self._small_cluster_warning(res),
            ):
                if w and w not in res["warnings"]:
                    res["warnings"].append(w)
        from .output.results import wrap_result

        if len(names) == 1:
            out = dict(results[names[0]])
            out["alpha"] = self.alpha
            out["meta"] = self._run_meta()
            return wrap_result(out, kind)
        return wrap_result(
            {
                "scenarios": results,
                "comparison": {
                    "labels": names,
                    "power_corrected_by_scenario": {
                        n: results[n]["powers"]["corrected"] for n in names
                    },
                },
                "result_kind": kind,
                "alpha": self.alpha,
                "formula": self._registry.formula,
                "family": self.family,
                "meta": self._run_meta(),
            },
            kind,
        )

    def debug(
        self,
        sample_size: int,
        *,
        stages: Optional[List[str]] = None,
        n_sims: int = 200,
        seed: Optional[int] = None,
        scenario: str = "optimistic",
    ) -> Dict[str, Any]:
        """Staged introspection report (input/data/dispatch/stats/crit/power).

        Re-walks the same deterministic seed chain the production run uses
        and captures every intermediate the engine computes — the deep
        observability path (reference debug.rs / introspect.rs)."""
        raise _not_ported("the staged debug report", "A15")

    def plot_power(self, result: Optional[Dict] = None) -> Dict[str, Dict]:
        """Vega-Lite plot bundle for the last (or given) find_power result."""
        from .output.plotting import power_plot_set

        res = result or self.last_result
        if res is None:
            raise RuntimeError("run find_power first")
        return power_plot_set(res if "scenarios" not in res else
                              next(iter(res["scenarios"].values())))

    def plot_sample_size(self, result: Optional[Dict] = None) -> Dict[str, Dict]:
        """Vega-Lite plot bundle for the last find_sample_size result."""
        from .output.plotting import sample_size_plot_set

        res = result or self.last_result
        if res is None:
            raise RuntimeError("run find_sample_size first")
        return sample_size_plot_set(res if "scenarios" not in res else
                                    next(iter(res["scenarios"].values())))

    def to_simulation_spec(
        self,
        scenario_name: str = "optimistic",
        *,
        test_formula: Optional[str] = None,
    ) -> Dict[str, Any]:
        """The contract dict for one scenario — the exact L1 wire payload.

        Parity with the reference port's ``to_simulation_spec``
        (ports/py/mcpower/model.py:1621): returns the label-free
        ``SimulationContract`` the engine would receive for
        ``scenario_name``, fully serializable (``contract.wire`` turns the
        same dict into msgpack for the CLI host).
        """
        self._ensure_applied()
        if not self._effects:
            raise RuntimeError(
                "no effect sizes configured; call set_effects() before "
                "to_simulation_spec()"
            )
        if scenario_name not in self._scenario_configs:
            raise ValueError(
                f"unknown scenario {scenario_name!r}; configured: "
                f"{sorted(self._scenario_configs)}"
            )
        wald_se_r, nagq = self._resolve_estimation(None, None)
        projected = self._project(
            [scenario_name], target_test=None, correction=None,
            wald_se=wald_se_r, nagq=nagq, test_formula=test_formula,
        )
        return projected[0].contract.to_dict()

    def summary(self) -> Dict[str, Any]:
        self._ensure_applied()
        return {
            "formula": self._registry.formula,
            "family": self.family,
            "estimator": self.estimator,
            "effects": dict(self._effects),
            "predictors": self._registry.predictor_names,
            "effect_names": self._registry.effect_names,
            "alpha": self.alpha,
            "n_simulations": self.n_simulations,
            "seed": self.seed,
            "clusters": dict(self._clusters),
        }

    def __repr__(self) -> str:
        return (
            f"MCPower({self._registry.formula!r}, family={self.family!r}, "
            f"estimator={self.estimator!r})"
        )


def _check_all_supported(lowered) -> None:
    """Raise the engine's ``NotImplementedError`` for the first scenario it
    cannot run yet, before any scenario runs (a realistic scenario must not
    fail after the optimistic one has spent its time)."""
    for sc in lowered:
        datagen.check_supported(sc.spec)


def _test_design_terms(test_parsed, contract, registry):
    """Build the misspecified-test design term list for test_formula=."""
    terms = [("const",)]
    col_of = {n: i for i, n in enumerate(registry.predictor_names)}
    pos_of: Dict[Any, int] = {}
    for t in test_parsed.terms:
        if t["kind"] == "main":
            name = t["name"]
            if name not in col_of:
                raise ValueError(f"test_formula references unknown predictor {name!r}")
            if registry.var_info(name)["type"] == "factor":
                for lvl in range(2, registry.factor_levels(name) + 1):
                    terms.append(("dummy", col_of[name], lvl - 1))
                    pos_of[(name, lvl)] = len(terms) - 1
            else:
                terms.append(("direct", col_of[name]))
                pos_of[name] = len(terms) - 1
    for t in test_parsed.terms:
        if t["kind"] == "interaction":
            for _, parts in registry.interaction_effect_names(t["vars"]):
                comp = []
                for v, lvl in parts:
                    key = v if lvl == 0 else (v, lvl)
                    if key not in pos_of:
                        raise ValueError(
                            "test_formula interaction needs its main terms present"
                        )
                    comp.append(pos_of[key])
                terms.append(("interaction", comp))
    return terms
