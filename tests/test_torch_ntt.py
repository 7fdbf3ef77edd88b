"""The port's NTT (kernel K1's plain path on the CPU) against the JAX
package: the Pallas kernel `ntt_pallas.fused_final_stages` / `dif_fused` in
interpret mode, and the transforms of `ops/ntt.py`. The sweep feeds the
reference numpy arrays, so it runs its host path with no XLA compile (that
path is bit-identical to the jnp one); two cases use jnp inputs across the
four-step threshold. Every comparison is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_prover_tpu.fields import babybear as ref_bb
from zkvm_prover_tpu.ops import ntt as ref_ntt
from zkvm_prover_tpu.ops import ntt_pallas
from zkvm_prover_tpu_torch.fields import babybear as bb
from zkvm_prover_tpu_torch.ops import ntt, ntt_fused

P = ref_bb.P


def _rand(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return bb.as_tensor(a, "cpu")


def _same(got, want):
    np.testing.assert_array_equal(bb.to_numpy(got), np.asarray(want, np.uint32))


@pytest.mark.parametrize("log_n", [1, 3, 10, 14])
@pytest.mark.parametrize("inverse", [False, True])
def test_stage_twiddles_match_reference(log_n, inverse):
    np.testing.assert_array_equal(ntt_fused.stage_twiddles_np(log_n, inverse),
                                  ref_ntt._stage_tw_flat(log_n, inverse))


@pytest.mark.parametrize("log_n", [2, 7])
def test_powers_bitrev_match_reference(log_n):
    np.testing.assert_array_equal(ntt.powers_bitrev_np(31, log_n),
                                  ref_ntt._powers_bitrev_monty(31, log_n))


# --- against the Pallas kernel (interpret mode) -------------------------

PALLAS_CASES = [(3, 3, 2, False), (6, 4, 8, True), (7, 5, 3, False)]


@pytest.mark.parametrize("log_n,k,w,inverse", PALLAS_CASES)
def test_block_stages_match_pallas_kernel(log_n, k, w, inverse):
    x = _rand(log_n * 10 + k, (1 << log_n, w))
    want = ntt_pallas.fused_final_stages(jnp.asarray(x), k, inverse,
                                         interpret=True)
    _same(ntt_fused.block_stages(_t(x), k, inverse), np.asarray(want))


@pytest.mark.parametrize("log_n,k,w,inverse", PALLAS_CASES)
def test_dif_matches_dif_fused(log_n, k, w, inverse):
    x = _rand(log_n * 10 + k + 1, (1 << log_n, w))
    want = ntt_pallas.dif_fused(jnp.asarray(x), log_n, inverse, k=k,
                                interpret=True)
    _same(ntt_fused.dif(_t(x), log_n, inverse, k=k), np.asarray(want))


@pytest.mark.parametrize("k", [1, 4, 6])
@pytest.mark.parametrize("inverse", [False, True])
def test_dit_mirror_matches_reference(k, inverse):
    """The DIT block stages over a whole 2^k block are the reference `_dit`."""
    x = _rand(k + 40, (1 << k, 5))
    _same(ntt_fused.block_stages(_t(x), k, inverse, dit=True),
          ref_ntt._dit(x, k, inverse))


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("dit", [False, True])
def test_block_plus_wide_stages_equal_full_transform(k, dit):
    log_n = 8
    x = _rand(k + 60, (1 << log_n, 3))
    ref = ref_ntt._dit if dit else ref_ntt._dif
    got = (ntt_fused.dit if dit else ntt_fused.dif)(_t(x), log_n, False, k=k)
    _same(got, ref(x, log_n, False))


@pytest.mark.parametrize("log_n,k", [(8, 3), (8, 1), (7, 4), (9, 9)])
@pytest.mark.parametrize("w", [1, 33, 40])
@pytest.mark.parametrize("dit", [False, True])
def test_pass_groupings_equal_reference(log_n, k, w, dit):
    """ceil(log_n / k) passes of at most k stages (three at log_n = 8,
    k = 3) compose to the reference's whole transform."""
    x = _rand(log_n * 7 + k + w, (1 << log_n, w))
    sizes = ntt_fused.pass_sizes(log_n, k)
    assert sum(sizes) == log_n and len(sizes) == -(-log_n // k)
    assert max(sizes) - min(sizes) <= 1
    for inverse in (False, True):
        ref = ref_ntt._dit if dit else ref_ntt._dif
        got = (ntt_fused.dit if dit else ntt_fused.dif)(_t(x), log_n, inverse, k=k)
        _same(got, ref(x, log_n, inverse))


def test_pass_sizes_at_the_main_path():
    assert ntt_fused.pass_sizes(18) == [9, 9]
    assert ntt_fused.pass_sizes(20) == [10, 10]
    assert ntt_fused.pass_sizes(5) == [5]
    with pytest.raises(ValueError):
        ntt_fused.pass_sizes(18, ntt_fused.K_MAX + 1)


@pytest.mark.parametrize("a,L", [(0, 3), (2, 3), (5, 2), (4, 4)])
@pytest.mark.parametrize("dit", [False, True])
def test_one_pass_with_multipliers(a, L, dit):
    """One pass with both per-row multipliers, into a row-strided output,
    is the reference's stages between bb.mul of the two tables."""
    log_n, w = 8, 6
    x = _rand(a * 10 + L, (1 << log_n, w))
    pre, post = _rand(1, (1 << log_n,)), _rand(2, (1 << log_n,))
    want = ref_bb.mul(x, pre[:, None])
    tw = ref_ntt._stage_twiddles(log_n, False)
    for s in (range(a + 1, a + L + 1) if dit else range(a + L, a, -1)):
        h = 1 << (s - 1)
        v = want.reshape(-1, 2, h, w)
        lo, hi = v[:, 0], v[:, 1]
        t = tw[s - 1].reshape(1, h, 1)
        if dit:
            hi = ref_bb.mul(hi, t)
            want = np.stack([ref_bb.add(lo, hi), ref_bb.sub(lo, hi)], 1)
        else:
            want = np.stack([ref_bb.add(lo, hi), ref_bb.mul(ref_bb.sub(lo, hi), t)], 1)
        want = want.reshape(1 << log_n, w)
    want = ref_bb.mul(want, post[:, None])
    out = bb.as_tensor(np.zeros((1 << log_n, 2 * w), np.uint32), "cpu")
    got = ntt_fused.ntt_pass(_t(x), a, L, dit=dit, pre=_t(pre), post=_t(post),
                             out=out[:, 1:1 + w])
    assert got.data_ptr() == out[:, 1:].data_ptr()
    _same(out[:, 1:1 + w], want)
    assert not out[:, 0].any() and not out[:, 1 + w:].any()


# --- transforms against ops/ntt.py --------------------------------------

SWEEP = [(log_n, w) for log_n in (1, 2, 5, 9, 10, 13, 14, 15)
         for w in (1, 8, 33)]
TRANSFORMS = ["ntt_natural_to_rev", "ntt_rev_to_natural",
              "intt_natural_to_rev", "intt_rev_to_natural"]


@pytest.mark.parametrize("log_n,w", SWEEP)
def test_transforms(log_n, w):
    x = _rand(log_n * 100 + w, (1 << log_n, w))
    for name in TRANSFORMS:
        _same(getattr(ntt, name)(_t(x)), getattr(ref_ntt, name)(x))


@pytest.mark.parametrize("log_n,w", SWEEP)
def test_coset_lde(log_n, w):
    x = _rand(log_n * 100 + w + 1, (1 << log_n, w))
    c_rev = ntt.interpolate_coset_rev(_t(x), 7)
    want_c = ref_ntt.interpolate_coset_rev(x, 7)
    _same(c_rev, want_c)
    _same(ntt.eval_coset_from_rev(c_rev, 1, 31),
          ref_ntt.eval_coset_from_rev(want_c, 1, 31))
    _same(ntt.coset_lde(_t(x), 1), ref_ntt.coset_lde(x, 1))


@pytest.mark.parametrize("log_n,w", SWEEP)
def test_eval_poly_at_point_ext(log_n, w):
    c = _rand(log_n * 100 + w + 2, (1 << log_n, w))
    z = _rand(log_n + 3, (4,))
    _same(ntt.eval_poly_at_point_ext(_t(c), _t(z)),
          ref_ntt.eval_poly_at_point_ext(c, z))


@pytest.mark.parametrize("name", ["ntt_natural_to_rev", "intt_rev_to_natural"])
def test_four_step_jnp_path(name):
    """jnp input: the reference's four-step form (log_n >= 14)."""
    log_n = ref_ntt.FOUR_STEP_MIN_LOG_N
    x = _rand(77, (1 << log_n, 2))
    want = np.asarray(getattr(ref_ntt, name)(jnp.asarray(x)))
    _same(getattr(ntt, name)(_t(x)), want)



SHIFTS_IN = [1, 7, 31 * 5]


@pytest.mark.parametrize("shift_in", SHIFTS_IN)
def test_fused_lde_against_reference(shift_in, monkeypatch):
    """The scalings fused into the passes: 1/n and shift_in^-bitrev(j) on
    the INTT's last store, the coset powers on each DIT's first load, the
    cosets stored interleaved (blowup 2), at (2^9, 33) and k = 5 (two
    passes per transform)."""
    monkeypatch.setattr(ntt_fused, "K_MAX", 5)
    assert ntt_fused.pass_sizes(9) == [5, 4]
    log_n, w = 9, 33
    x = _rand(shift_in, (1 << log_n, w))
    want_c = ref_ntt.interpolate_coset_rev(x, shift_in)
    c_rev = ntt.interpolate_coset_rev(_t(x), shift_in)
    _same(c_rev, want_c)
    _same(ntt.eval_coset_from_rev(c_rev, 1, 31), ref_ntt.eval_coset_from_rev(want_c, 1, 31))
    _same(ntt.coset_lde(_t(x), 1, 31, shift_in), ref_ntt.coset_lde(x, 1, 31, shift_in))


@pytest.mark.parametrize("shift_in", SHIFTS_IN)
def test_interpolate_canonical_input_folds_to_monty(shift_in):
    """canonical=True: a canonical input gives the Montgomery coefficients
    of its to_monty (the conversion rides on the INTT's table)."""
    x = _rand(shift_in + 5, (1 << 9, 33))
    want = ref_ntt.interpolate_coset_rev(ref_bb.to_monty(x), shift_in)
    _same(ntt.interpolate_coset_rev(_t(x), shift_in, canonical=True), want)


def test_lde_of_strided_chunks_into_strided_output():
    """The prover's quotient chunks: rows r::2 of a (2n, 4) matrix read in
    place, each coset LDE written into its 4-column block of one (2n, 8)."""
    log_n = 6
    n = 1 << log_n
    q = _rand(11, (2 * n, 4))
    out = torch.zeros((2 * n, 8), dtype=bb.DTYPE)
    for r in range(2):
        shift = 31 * (r + 2)
        c = ntt.interpolate_coset_rev(_t(q)[r::2], shift)
        want_c = ref_ntt.interpolate_coset_rev(np.ascontiguousarray(q[r::2]), shift)
        _same(c, want_c)
        ntt.eval_coset_from_rev(c, 1, 31, out=out[:, 4 * r:4 * r + 4])
        _same(out[:, 4 * r:4 * r + 4], ref_ntt.eval_coset_from_rev(want_c, 1, 31))


@pytest.mark.parametrize("log_n,w", [(9, 33), (6, 1)])
def test_eval_poly_at_two_points_ext(log_n, w):
    """The OOD phase's fused call (both points from one read of the
    coefficients) equals the reference called once per point."""
    c = _rand(log_n * 7 + w, (1 << log_n, w))
    z1, z2 = _rand(log_n + 5, (4,)), _rand(log_n + 6, (4,))
    got = ntt.eval_poly_at_points_ext(_t(c), [_t(z1), _t(z2)])
    assert len(got) == 2
    _same(got[0], ref_ntt.eval_poly_at_point_ext(c, z1))
    _same(got[1], ref_ntt.eval_poly_at_point_ext(c, z2))


@pytest.mark.parametrize("transpose_a", [False, True])
def test_mont_matmul_plain_two_rhs(transpose_a):
    """k = 2 right-hand sides side by side equal two k = 1 calls."""
    from zkvm_prover_tpu_torch.ops import mont_matmul as mm

    a = _t(_rand(31, (300, 33)))
    b = _t(_rand(32, (300 if transpose_a else 33, 8)))
    got = mm.mont_matmul(a, b, transpose_a)
    assert got.shape == (33 if transpose_a else 300, 8)
    for i in range(2):
        assert torch.equal(got[:, 4 * i:4 * i + 4],
                           mm.mont_matmul(a, b[:, 4 * i:4 * i + 4].contiguous(),
                                          transpose_a))
