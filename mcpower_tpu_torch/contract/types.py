"""SimulationContract: the label-free wire boundary between hosts and engine.

Mirrors the reference's contract crate (crates/engine-contract/src/
contract.rs, generation.rs, design.rs, outcome.rs, estimator.rs,
test_spec.rs, scenarios.rs): hosts assemble a fully-resolved, name-free
description of ONE scenario's DGP + analysis; ``validate()``
(``contract.validate``) is the single gate; the engine adapter
(``engine.adapter``) lowers it to the static SimSpec. Evolution is
additive-only: every field has a default, unknown keys are ignored on read.

JSON (and msgpack, when available) round-trips via ``to_dict``/``from_dict``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def _from(cls, d):
    if d is None:
        return None
    known = {f for f in cls.__dataclass_fields__}
    return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class ColumnSpec:
    """One generated predictor column (pre-dummy-expansion).

    kind: synthetic | resampled | resampled_binary | factor_synthetic |
          factor_from_frame
    dist: marginal for synthetic kinds (normal/binary/right_skewed/
          left_skewed/high_kurtosis/uniform)
    """

    kind: str = "synthetic"
    dist: str = "normal"
    param: float = 0.5  # binary proportion / resampled-binary p
    pinned: bool = False  # pinned against scenario distribution swaps
    n_levels: int = 0  # factor kinds
    proportions: List[float] = field(default_factory=list)
    sampled: Optional[bool] = None  # per-factor allocation override
    frame_col: Optional[int] = None  # uploaded-frame column index


@dataclass
class SlopeTerm:
    column: int  # generation column id whose slope varies
    variance: float = 0.0
    intercept_corr: float = 0.0


@dataclass
class GroupingSpec:
    relation: str = "crossed"  # crossed | nested
    n_clusters: int = 0  # crossed: level count; nested: levels per parent
    tau_squared: float = 0.0
    slopes: List[SlopeTerm] = field(default_factory=list)


@dataclass
class ClusterSpec:
    sizing_mode: str = "fixed_clusters"  # fixed_clusters | fixed_size
    sizing_value: int = 0
    tau_squared: float = 0.0
    slopes: List[SlopeTerm] = field(default_factory=list)
    extra_groupings: List[GroupingSpec] = field(default_factory=list)
    between_columns: List[int] = field(default_factory=list)  # cluster-level cols


@dataclass
class UploadedFrame:
    n_rows: int = 0
    n_cols: int = 0
    data: List[float] = field(default_factory=list)  # row-major standardized
    bootstrap: bool = False  # strict whole-row resampling


@dataclass
class GenerationSpec:
    columns: List[ColumnSpec] = field(default_factory=list)
    correlations: List[List[float]] = field(default_factory=list)  # cont-only
    cluster: Optional[ClusterSpec] = None
    frame: Optional[UploadedFrame] = None


# Design terms: ("const",) | ("direct", col) | ("dummy", col, level) |
# ("interaction", [component term indices])
DesignTerm = Tuple


@dataclass
class ResidualSpec:
    dist: str = "normal"
    pinned: bool = False


@dataclass
class OutcomeSpec:
    kind: str = "continuous"  # continuous | binary | count
    link: Optional[str] = None  # "probit" override; None = canonical
    intercept: float = 0.0
    coefficients: List[float] = field(default_factory=list)  # one per design term
    residual: ResidualSpec = field(default_factory=ResidualSpec)
    heteroskedasticity_column: Optional[int] = None  # generation col; None = lp


@dataclass
class EstimatorSpec:
    kind: str = "ols"  # ols | glm | mle
    wald_se: str = "rx"  # rx | hessian (GLMM)
    nagq: int = 1  # 1 = Laplace; odd 3..25 = AGQ

    @property
    def uses_student_t(self) -> bool:
        return self.kind == "ols"


@dataclass
class PosthocSpec:
    factor_column: int = 0  # generation column id of the factor
    terms: List[int] = field(default_factory=list)  # its dummy design terms


@dataclass
class TestSpec:
    # targets: ("marginal", term) | ("joint", [terms]) | ("contrast", pos, neg)
    targets: List[Tuple] = field(default_factory=list)
    correction: str = "none"
    alpha: float = 0.05
    posthoc: List[PosthocSpec] = field(default_factory=list)
    report_overall: bool = False


@dataclass
class ScenarioBlock:
    label: str = "optimistic"
    heterogeneity: float = 0.0
    heteroskedasticity_ratio: float = 1.0
    correlation_noise_sd: float = 0.0
    sampled_factor_proportions: bool = False
    truth_start: bool = True
    distribution_change_prob: float = 0.0
    new_distributions: List[str] = field(default_factory=lambda: ["right_skewed", "left_skewed", "uniform"])
    residual_change_prob: float = 0.0
    residual_dists: List[str] = field(default_factory=lambda: ["high_kurtosis", "right_skewed"])
    residual_df: float = 10.0
    random_effect_dist: str = "normal"
    random_effect_df: float = 5.0
    icc_noise_sd: float = 0.0


@dataclass
class SimulationContract:
    generation: GenerationSpec = field(default_factory=GenerationSpec)
    design: List[DesignTerm] = field(default_factory=list)  # DGP design terms
    test_design: Optional[List[DesignTerm]] = None  # fitted model (None = same)
    outcome: OutcomeSpec = field(default_factory=OutcomeSpec)
    estimator: EstimatorSpec = field(default_factory=EstimatorSpec)
    test: TestSpec = field(default_factory=TestSpec)
    scenario: ScenarioBlock = field(default_factory=ScenarioBlock)
    max_failed_fraction: float = 0.1

    # ---- serialization ----
    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["design"] = [list(t) for t in self.design]
        if self.test_design is not None:
            d["test_design"] = [list(t) for t in self.test_design]
        d["test"]["targets"] = [list(t) for t in self.test.targets]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SimulationContract":
        gen_d = dict(d.get("generation", {}))
        cluster_d = gen_d.get("cluster")
        cluster = None
        if cluster_d:
            cluster = _from(ClusterSpec, cluster_d)
            cluster.slopes = [_from(SlopeTerm, s) for s in cluster_d.get("slopes", [])]
            egs = []
            for g in cluster_d.get("extra_groupings", []):
                eg = _from(GroupingSpec, g)
                eg.slopes = [_from(SlopeTerm, s) for s in g.get("slopes", [])]
                egs.append(eg)
            cluster.extra_groupings = egs
        gen = GenerationSpec(
            columns=[_from(ColumnSpec, c) for c in gen_d.get("columns", [])],
            correlations=gen_d.get("correlations", []),
            cluster=cluster,
            frame=_from(UploadedFrame, gen_d.get("frame")),
        )
        out_d = dict(d.get("outcome", {}))
        out = _from(OutcomeSpec, out_d)
        out.residual = _from(ResidualSpec, out_d.get("residual", {})) or ResidualSpec()
        test_d = dict(d.get("test", {}))
        test = _from(TestSpec, test_d)
        test.targets = [tuple(t) for t in test_d.get("targets", [])]
        test.posthoc = [_from(PosthocSpec, p) for p in test_d.get("posthoc", [])]
        return cls(
            generation=gen,
            design=[tuple(t) for t in d.get("design", [])],
            test_design=(
                [tuple(t) for t in d["test_design"]]
                if d.get("test_design") is not None
                else None
            ),
            outcome=out,
            estimator=_from(EstimatorSpec, d.get("estimator", {})),
            test=test,
            scenario=_from(ScenarioBlock, d.get("scenario", {})),
            max_failed_fraction=d.get("max_failed_fraction", 0.1),
        )

    def to_json(self) -> str:
        import json

        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "SimulationContract":
        import json

        return cls.from_dict(json.loads(s))
