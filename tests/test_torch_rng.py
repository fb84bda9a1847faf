"""The port's Philox streams against the JAX reference and the Pallas kernel.

Integer streams must be bit-identical: the cipher, the per-sim keys and the
words of every fill. Normals go through an f32 log in the Acklam tail, where
PyTorch's CPU log and XLA:CPU's may differ by an ULP or two; the measured
maximum over the 948,344 draws of test_batch_fill_matches_reference_streams
(at most 317,440 at each table of chip_smoke.K1_CHECKS) is 7 ULP (797 lanes
differ, all tail lanes, |z| > 1.97), pinned here at 8.
The reference here is ``norm_ppf_f32`` evaluated operation by operation; its
fused (jitted) form differs more, see
test_fill_matches_the_pallas_kernel_in_interpret_mode.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mcpower_tpu.engine import rng as ref_rng
from mcpower_tpu_torch.engine import datagen, lower, rng
from mcpower_tpu_torch.engine.spec import ClusterStatic

from test_rng import philox4x32_ref

NORMAL_MAX_ULP = 8

_PALLAS = pathlib.Path(__file__).parent.parent / "benchmarks" / "pallas_datagen.py"


@pytest.fixture(scope="module", autouse=True)
def _first_cpu_math_call():
    """Take the process's first multi-threaded call of torch's CPU log
    before any comparison: that call has been seen, in a loaded process, to
    return logs ~1e-5 off on part of a tensor (tens of ULP on tail normals)."""
    x = torch.rand(1 << 20) + 0.5
    for t in (x, x.double()):
        torch.log(t), torch.log1p(t), torch.exp(t), torch.sqrt(t)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_philox_bit_identical_to_reference_and_oracle():
    rs = np.random.RandomState(11)
    words = rs.randint(0, 2**32, size=(6, 512), dtype=np.uint64).astype(np.uint32)
    got = np.stack([w.numpy() for w in rng.philox4x32(*[_t(w) for w in words])])
    want = np.stack([np.asarray(w) for w in ref_rng.philox4x32(*[jnp.asarray(w) for w in words])])
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for i in range(0, 512, 37):
        ctr = tuple(int(w) for w in words[:4, i])
        key = tuple(int(w) for w in words[4:, i])
        assert tuple(int(v) for v in got[:, i]) == philox4x32_ref(ctr, key)


def test_philox_random123_kat():
    ones = 0xFFFFFFFF
    for ctr, key, want in [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((ones,) * 4, (ones, ones), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ]:
        got = tuple(int(v) for v in rng.philox4x32(*ctr, *key))
        assert got == want == philox4x32_ref(ctr, key)


def test_sim_key_and_fill_raw_bit_identical():
    sims = np.array([0, 1, 7, 4095, 2**31 + 5, 2**32 - 1], dtype=np.uint32)
    for seed in (2137, 0, 2**32 - 1):
        k0, k1 = rng.sim_key(seed, _t(sims))
        r0, r1 = ref_rng.sim_key(jnp.uint32(seed), jnp.asarray(sims))
        np.testing.assert_array_equal(k0.numpy(), np.asarray(r0).astype(np.int64))
        np.testing.assert_array_equal(k1.numpy(), np.asarray(r1).astype(np.int64))
    key = (k0, k1)
    ref_key = (r0, r1)
    for cls, col, start, stop in [(0, 1, 0, 200), (3, 0, 0, 20), (1, 2, 3, 18), (2, 5, 7, 7)]:
        got = rng.fill_raw(key, cls, col, start, stop).numpy()
        want = np.stack([
            np.asarray(ref_rng.fill_raw((ref_key[0][i], ref_key[1][i]), cls, col, start, stop))
            for i in range(len(sims))
        ])
        np.testing.assert_array_equal(got, want.astype(np.int64).reshape(got.shape))
        rows = torch.arange(start, stop)
        np.testing.assert_array_equal(
            rng.raw_words((k0[:, None], k1[:, None]), cls, col, rows).numpy(), got
        )


# Draws per K1_CHECKS table, at most: 512 sims of the LMM plan's 620 rows;
# the curve's 3,000-row plan gets 105 sims. The plain fill takes ~7 us a
# draw on the CPU, so this keeps each case near a second.
FILL_DRAWS = 512 * 620
FILL_FLAT = 1 << 19  # every table, padded to one size


def _fill_sims(plan) -> int:
    return min(512, FILL_DRAWS // sum(rows for _, _, rows in plan))


@pytest.mark.parametrize("name", sorted(chip_smoke.K1_CHECKS))
def test_batch_fill_matches_reference_streams(name):
    """fill_streams (the main path's fill; on the CPU its plain version, which
    chip_smoke.py holds kernel K1 against on the card) against the
    reference's fills under run_one_sim's key (counter (sim, 0, SIMKEY, 0),
    64-bit seed), at every table of chip_smoke.K1_CHECKS: the arms' stream
    plans, rows 13, 3 and 201 at sim ids from 2**31 - 2, the words fill of a
    sampled factor, the realistic LMM's three fills and 33 streams (two K1
    launches on the card)."""
    import jax

    plan, sim0, seed_hi = chip_smoke.k1_table(lower, ClusterStatic, datagen, name)
    seed_lo = chip_smoke.SEED
    n_sims = _fill_sims(plan)
    sims = np.arange(sim0, sim0 + n_sims, dtype=np.uint32)
    words = rng.fill_streams(seed_lo, seed_hi, _t(sims), plan, rng.MODE_WORDS).numpy()
    normals = rng.fill_streams(seed_lo, seed_hi, _t(sims), plan, rng.MODE_NORMAL).numpy()
    unif = rng.fill_streams(seed_lo, seed_hi, _t(sims), plan, rng.MODE_OPEN_UNIFORM).numpy()

    def ref_one(sid):
        k0, k1, _, _ = ref_rng.philox4x32(
            sid, jnp.uint32(0), jnp.uint32(ref_rng.CLASS_SIMKEY), jnp.uint32(0),
            jnp.uint32(seed_lo), jnp.uint32(seed_hi),
        )
        return [ref_rng.fill_raw((k0, k1), c, col, 0, rows) for c, col, rows in plan]

    ref_words = [np.asarray(w) for w in jax.jit(jax.vmap(ref_one))(jnp.asarray(sims))]
    # The reference's maps op by op (not jitted: see the module docstring),
    # on all streams at once, padded to one size so each eager op compiles
    # once per process.
    flat = np.concatenate([w.ravel() for w in ref_words])
    assert flat.size <= FILL_FLAT
    flat = jnp.asarray(np.pad(flat, (0, FILL_FLAT - flat.size)))
    u_ref = ref_rng.u32_to_open_uniform(flat)
    u_ref, z_ref = np.asarray(u_ref), np.asarray(ref_rng.norm_ppf_f32(u_ref))
    off = 0
    for s, (_, _, rows) in enumerate(plan):
        cut = slice(off, off + n_sims * rows)
        off = cut.stop
        np.testing.assert_array_equal(words[:, s, :rows], ref_words[s].astype(np.int64))
        for got in (words, unif, normals):
            assert not got[:, s, rows:].any()
        np.testing.assert_array_equal(unif[:, s, :rows].ravel(), u_ref[cut])
        ulp = _ulp(normals[:, s, :rows].ravel(), z_ref[cut])
        assert ulp.max() <= NORMAL_MAX_ULP, ulp.max()
        # every lane that differs is a tail lane (the f32 log)
        assert np.all(np.abs(z_ref[cut][ulp > 0]) > 1.95)


def test_normal_fill_matches_reference_normal_fill():
    import jax

    sims = np.arange(2048, dtype=np.uint32)
    key = rng.sim_key(2137, _t(sims))
    got = rng.normal_fill(key, rng.CLASS_XNORM, 1, 0, 200).numpy()
    k0, k1 = ref_rng.sim_key(jnp.uint32(2137), jnp.asarray(sims))
    want = np.asarray(jax.vmap(lambda a, b: ref_rng.normal_fill((a, b), 0, 1, 0, 200))(k0, k1))
    ulp = _ulp(got, want)
    assert ulp.max() <= NORMAL_MAX_ULP, ulp.max()
    assert (ulp == 0).mean() > 0.99


def _ppf_contracted(p):
    """The f32 Acklam ppf with every Horner step a fused multiply-add, as
    XLA:CPU contracts it inside a fused program (numpy; a product of two f32
    is exact in f64, so one f64 add and one rounding to f32 is the fma)."""
    f32, f64 = np.float32, np.float64
    a, b, c, d = (
        [f32(v) for v in vals]
        for vals in (ref_rng._ACKLAM_A, ref_rng._ACKLAM_B, ref_rng._ACKLAM_C, ref_rng._ACKLAM_D)
    )

    def fma(x, y, z):
        return (f64(x) * f64(y) + f64(z)).astype(f32)

    def horner(coeffs, x):
        acc = coeffs[0]
        for k in coeffs[1:]:
            acc = fma(acc, x, k)
        return acc

    pc = np.clip(p, f32(1e-38), f32(1.0 - 6e-8))
    lower = pc < 0.5
    q = np.where(lower, pc, f32(1.0) - pc)
    s = np.sqrt(f32(-2.0) * np.log(q))
    t = horner(c, s) / fma(horner(d, s), s, f32(1.0))
    qq = pc - f32(0.5)
    r = qq * qq
    mid = (qq * horner(a, r)) / fma(horner(b, r), r, f32(1.0))
    in_tail = (pc < 0.02425) | (pc > 1.0 - 0.02425)
    return np.where(in_tail, np.where(lower, t, -t), mid).astype(f32), in_tail


def test_fill_matches_the_pallas_kernel_in_interpret_mode():
    """The Pallas kernel runs inside one fused XLA program, where XLA:CPU
    contracts the ppf's Horner steps into fused multiply-adds; the central
    rational cancels near |p - 0.5| = 0.47, so those lanes move by up to a
    few thousand ULP (3.6e-4 over 1,638,400 draws). The port's words are the
    kernel's, bit for bit: through a contracted ppf they give the kernel's
    central lanes exactly and its tail lanes within the log's ULPs."""
    spec = importlib.util.spec_from_file_location("pallas_datagen", _PALLAS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sims, rows, cols = 8, 18, 2
    pallas = np.asarray(mod.make_pallas_fill(sims, rows, cols, tile=8, interpret=True)(jnp.uint32(2137)))
    plan = [(rng.CLASS_XNORM, c, rows) for c in range(cols)]
    got = rng.fill_streams(2137, 0, torch.arange(sims), plan, rng.MODE_NORMAL).numpy()
    assert got.shape == pallas.shape == (sims, cols, rows)
    assert np.abs(got - pallas).max() <= 5e-4
    u = rng.fill_streams(2137, 0, torch.arange(sims), plan, rng.MODE_OPEN_UNIFORM).numpy()
    contracted, in_tail = _ppf_contracted(u)
    np.testing.assert_array_equal(contracted[~in_tail], pallas[~in_tail])
    assert _ulp(contracted[in_tail], pallas[in_tail]).max() <= NORMAL_MAX_ULP


def test_norm_cdf_and_uniform_maps():
    z = np.linspace(-5, 5, 20001).astype(np.float32)
    got = rng.norm_cdf(torch.as_tensor(z)).numpy()
    want = np.asarray(ref_rng.norm_cdf(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)
    w = np.random.RandomState(3).randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    w = np.concatenate([w, np.array([0, 1, 2**24, 2**32 - 1], np.uint32)])
    np.testing.assert_array_equal(
        rng.u32_to_uniform(_t(w)).numpy(), np.asarray(ref_rng.u32_to_uniform(jnp.asarray(w)))
    )
    np.testing.assert_array_equal(
        rng.u32_to_open_uniform(_t(w)).numpy(),
        np.asarray(ref_rng.u32_to_open_uniform(jnp.asarray(w))),
    )
