"""The port's lowering against the JAX reference's, design by design.

``lower`` is host code on both sides (numpy and scipy), so the spec must be
equal field by field and every array equal key by key, dtype included.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from mcpower_tpu.engine import lower as ref_lower
from mcpower_tpu.engine.spec import ClusterStatic as RefCluster
from mcpower_tpu_torch.engine import carry, lower
from mcpower_tpu_torch.engine.spec import ClusterStatic

# The main path's three designs, plus two that reach the other branches of
# the crit tables and the blocked cluster layout.
EXTRA = {
    "lmm_blocked_holm": dict(
        grid=[100, 200],
        var_types=["normal", "binary"],
        var_params=[0.5, 0.3],
        effects=[0.0, 0.3, 0.2],
        target_cols=[1, 2],
        estimator="mle",
        correction="holm",
        report_overall=True,
        cluster=dict(sizing_mode="fixed_size", sizing_value=10, tau_squared=0.5),
    ),
    "ols_bh_contrast": dict(
        grid=[60, 120],
        var_types=["normal"] * 3,
        effects=[0.1, 0.3, 0.2, 0.1],
        target_cols=[1, 2, 3],
        contrasts=[(1, 2)],
        correction="benjamini_hochberg",
        report_overall=True,
    ),
}
DESIGNS = {**chip_smoke.DESIGNS, **EXTRA}


def _lower(mod, cluster_cls, name):
    kw = dict(DESIGNS[name])
    for key in ("corr", "effects"):
        if key in kw:
            kw[key] = np.asarray(kw[key], dtype=np.float64)
    if "cluster" in kw:
        kw["cluster"] = cluster_cls(**kw["cluster"])
    return mod.lower(**kw)


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_lower_returns_the_reference_arrays_key_by_key(name):
    ref_spec, ref_arr = _lower(ref_lower, RefCluster, name)
    spec, arr = _lower(lower, ClusterStatic, name)
    assert sorted(arr) == sorted(ref_arr)
    for key, want in ref_arr.items():
        want = np.asarray(want)
        got = arr[key]
        assert isinstance(got, np.ndarray) or np.isscalar(got), key
        got = np.asarray(got)
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert carry.from_reference(ref_spec, ref_arr)[0] == spec


@pytest.mark.parametrize("name", sorted(chip_smoke.DESIGNS))
def test_from_reference_round_trips_the_spec(name):
    ref_spec, ref_arr = _lower(ref_lower, RefCluster, name)
    spec, arr = carry.from_reference(ref_spec, ref_arr)
    assert type(spec).__module__ == "mcpower_tpu_torch.engine.spec"
    assert hash(spec) == hash(_lower(lower, ClusterStatic, name)[0])
    # every field, nested dataclasses included, reads back as the reference's
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    if ref_spec.cluster is not None:
        assert type(spec.cluster) is ClusterStatic
    for key, v in arr.items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, np.asarray(ref_arr[key]))


def test_from_reference_refuses_a_spec_whose_fields_differ():
    @dataclasses.dataclass(frozen=True)
    class ClusterStatic:  # same name as the port's class, one field more
        sizing_mode: str
        sizing_value: int
        tau_squared: float
        slopes: tuple = ()
        extra_groupings: tuple = ()
        between_cols: tuple = ()
        icc: float = 0.0

    with pytest.raises(TypeError, match="fields differ"):
        carry.from_reference(ClusterStatic("fixed_clusters", 20, 0.25), {})
