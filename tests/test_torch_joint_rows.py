"""The per-level row lists that kernels K2 (joint mode) and K12 walk.

K2's joint mode sums each entry of ztz, ztx and zty over the rows of one
level of one grouping, in ascending row order, segment by grid segment; K12
walks each level's rows from ``glmmfit.extras_row_lists`` and stages a cell's
rows in the order of the primary grouping's list. Both rest on the lists
being, per grouping, every row once, ascending within each level, with
level offsets equal to the levels' row counts. On the CPU (no card, no JAX):

* ``extras_row_lists`` has those properties for a crossed, a nested, a dense
  (slope) and a two-grouping design;
* summing each joint-Z entry over its level's list, segment by segment (the
  kernel's order), gives the same bits as a walk over every row in order
  (the first version's order), and agrees with ``joint_suffstats_plain``.
"""

import numpy as np
import pytest
import torch

from mcpower_tpu_torch.engine import datagen, glmmfit, lower, olsfit
from mcpower_tpu_torch.engine.spec import ClusterStatic, ExtraGroupingStatic, SlopeStatic

SEED = 2137
SIMS = 3
REL = 1e-13  # chip_smoke.K2_JOINT_REL: row order against scatter_add's
# sizing, extras (relation, levels, tau^2), primary slope on x1, grid
DESIGNS = {
    "crossed": (("fixed_clusters", 12), [("crossed", 5, 0.15)], False, [60, 120]),
    "nested": (("fixed_clusters", 8), [("nested", 3, 0.1)], False, [48, 96]),
    "dense": (("fixed_clusters", 6), [("crossed", 4, 0.15)], True, [72]),
    "two": (("fixed_clusters", 6), [("crossed", 4, 0.15), ("nested", 2, 0.1)], False, [48, 96]),
}


@pytest.fixture(scope="module", params=sorted(DESIGNS))
def design(request):
    (mode, value), extras, slope, grid = DESIGNS[request.param]
    slopes = (SlopeStatic(design_col=1, variance=0.1, intercept_corr=0.2),) if slope else ()
    spec, arr = lower.lower(
        grid=grid, var_types=["normal", "normal"], corr=np.array([[1.0, 0.3], [0.3, 1.0]]),
        effects=np.array([0.0, 0.3, 0.2]), target_cols=[1, 2], estimator="mle",
        cluster=ClusterStatic(mode, value, 0.25, slopes=slopes, extra_groupings=tuple(
            ExtraGroupingStatic(rel, lv, tau2) for rel, lv, tau2 in extras)))
    X, y, _ = datagen.generate_batch(spec, datagen.to_device(arr, "cpu"), SEED, 0,
                                     torch.arange(SIMS, dtype=torch.int64), plain=True)
    groups, M = olsfit.joint_layout(spec)
    return dict(name=request.param, spec=spec, X=X, y=y, groups=groups, M=M)


def test_each_grouping_lists_every_row_once_ascending_by_level(design):
    spec, groups = design["spec"], design["groups"]
    ids, offs, rows = glmmfit.extras_row_lists(groups, spec.max_n)
    assert ids.shape == rows.shape == (len(groups), spec.max_n)
    start = 0
    for g, (lv_ids, m, _) in enumerate(groups):
        lv_ids = lv_ids.numpy()
        np.testing.assert_array_equal(ids[g], lv_ids)
        off = offs[start:start + m + 1]
        start += m + 1
        np.testing.assert_array_equal(off, np.concatenate([[0], np.cumsum(
            np.bincount(lv_ids, minlength=m))]))
        np.testing.assert_array_equal(np.sort(rows[g]), np.arange(spec.max_n))
        for lv in range(m):
            seg = rows[g][off[lv]:off[lv + 1]]
            assert (lv_ids[seg] == lv).all()
            assert (np.diff(seg) > 0).all()
    assert start == len(offs)


def _entries(design):
    """Per sim and grid point, ztz, ztx and zty summed two ways in f64: each
    entry over its level's rows from the lists, segment by segment, and a
    walk over every row in order."""
    spec, groups, M = design["spec"], design["groups"], design["M"]
    X = design["X"].numpy().astype(np.float64)
    y = design["y"].numpy().astype(np.float64)
    fit = list(spec.effective_fit_cols)
    _, offs, rows = glmmfit.extras_row_lists(groups, spec.max_n)
    comps, start = [], 0  # per component: grouping, column offset, q, r, X column
    lofs, off = [], 0
    for g, (lv_ids, m, scols) in enumerate(groups):
        q = 1 + len(scols)
        comps += [(g, off, q, r, None if r == 0 else scols[r - 1]) for r in range(q)]
        lofs.append(start)
        start += m + 1
        off += m * q
    ids = [g[0].numpy() for g in groups]

    def col(c, i):
        g, o, q, r, xc = comps[c]
        return o + ids[g][i] * q + r

    def val(c, s, i):
        xc = comps[c][4]
        return 1.0 if xc is None else X[s, i, xc]

    out = {}
    for how in ("lists", "rows"):
        zz = np.zeros((SIMS, len(spec.grid), M, M))
        zx = np.zeros((SIMS, len(spec.grid), M, len(fit)))
        zy = np.zeros((SIMS, len(spec.grid), M))
        for s in range(SIMS):
            a_zz, a_zx, a_zy = np.zeros((M, M)), np.zeros((M, len(fit))), np.zeros(M)
            prev = 0
            for gi, n in enumerate(spec.grid):
                for ca, (ga, _, _, _, _) in enumerate(comps):
                    if how == "rows":
                        walks = [range(prev, n)]
                    else:
                        m = groups[ga][1]
                        o = offs[lofs[ga]:lofs[ga] + m + 1]
                        walks = [[i for i in rows[ga][o[lv]:o[lv + 1]] if prev <= i < n]
                                 for lv in range(m)]
                    for walk in walks:
                        for i in walk:
                            ia, va = col(ca, i), val(ca, s, i)
                            for cb in range(len(comps)):
                                a_zz[ia, col(cb, i)] += va * val(cb, s, i)
                            for k, fc in enumerate(fit):
                                a_zx[ia, k] += va * X[s, i, fc]
                            a_zy[ia] += va * y[s, i]
                zz[s, gi], zx[s, gi], zy[s, gi] = a_zz, a_zx, a_zy
                prev = n
        out[how] = dict(ztz=zz, ztx=zx, zty=zy)
    return out


def test_level_walks_add_each_entrys_rows_in_row_order(design):
    sums = _entries(design)
    plain = olsfit.joint_suffstats_plain(design["spec"], design["X"], design["y"])
    for key in ("ztz", "ztx", "zty"):
        np.testing.assert_array_equal(sums["lists"][key], sums["rows"][key])
        want = plain[key].numpy()
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(sums["lists"][key] - want).max() <= REL * scale, key
