"""The port's BN254 layer (plain torch and host, CPU) against the JAX
package's: `fields/bn254.py` (curve laws, pairing, KZG), the host engine
`fields/bn254_native.py`, the Fq `Field` of `ops/bigint.py`, and the MSM of
`ops/msm.py` (the plain version of kernel K4), on the same inputs made with
numpy from a seed. Every comparison is exact: field elements and affine
points are unique, so there is no tolerance."""

import numpy as np
import pytest
import torch

from zkvm_prover_tpu.fields import bn254 as ref_bn
from zkvm_prover_tpu.ops import bigint as ref_bigint
from zkvm_prover_tpu.ops import msm as ref_msm
from zkvm_prover_tpu_torch.fields import bn254 as bn
from zkvm_prover_tpu_torch.fields import bn254_native
from zkvm_prover_tpu_torch.ops import bigint
from zkvm_prover_tpu_torch.ops import msm

F, REF_F = bigint.BN254_FQ, ref_bigint.BN254_FQ


def _ints(seed, n, modulus, edges=()):
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "little") % modulus for _ in range(n)]
    out[:len(edges)] = edges
    return out


def _points(seed, n):
    """n distinct points: a random multiple of G1, then steps of another."""
    rng = np.random.default_rng(seed)
    p = ref_bn.g1_mul(ref_bn.G1_GEN, int(rng.integers(1, 1 << 62)))
    step = ref_bn.g1_mul(ref_bn.G1_GEN, int(rng.integers(1, 1 << 62)))
    out = []
    for _ in range(n):
        out.append(p)
        p = ref_bn.g1_add(p, step)
    return out


def test_constants_match():
    assert (bn.Q, bn.R, bn.B, bn.ATE_LOOP_COUNT) == (ref_bn.Q, ref_bn.R, ref_bn.B,
                                                     ref_bn.ATE_LOOP_COUNT)
    assert (bn.G1_GEN, bn.G2_GEN, bn._B2) == (ref_bn.G1_GEN, ref_bn.G2_GEN, ref_bn._B2)
    assert (F.q, F.K, F.R, F.R2, F.np0) == (REF_F.q, REF_F.K, REF_F.R, REF_F.R2, int(REF_F.np0))
    np.testing.assert_array_equal(F.q_limbs, REF_F.q_limbs.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_group_law(seed):
    ks = _ints(seed, 4, bn.R, (bn.R - 1, 2))
    for k in ks:
        p = bn.g1_mul(bn.G1_GEN, k)
        assert p == ref_bn.g1_mul(ref_bn.G1_GEN, k) and bn.g1_is_on_curve(p)
        assert bn.g1_mul_jac(bn.G1_GEN, k) == p
        assert bn.g1_add(p, bn.G1_GEN) == ref_bn.g1_add(p, ref_bn.G1_GEN)
        assert bn.g1_add(p, bn.g1_neg(p)) is None
    q = bn.g2_mul(bn.G2_GEN, ks[2])
    assert q == ref_bn.g2_mul(ref_bn.G2_GEN, ks[2]) and bn.g2_is_on_curve(q)
    assert bn.g2_add(q, bn.G2_GEN) == ref_bn.g2_add(q, ref_bn.G2_GEN)
    assert bn.g1_mul(bn.G1_GEN, bn.R) is None and bn.g2_mul(bn.G2_GEN, bn.R) is None
    a = bn.fq12(*_ints(seed, 12, bn.Q))
    assert bn.fq12_inv(a) == ref_bn.fq12_inv(a)
    assert bn.fq12_mul(a, bn.fq12_inv(a)) == bn.FQ12_ONE


def test_pairing_bilinearity():
    f1 = bn.pairing(bn.g2_mul(bn.G2_GEN, 5), bn.G1_GEN)
    f2 = bn.pairing(bn.G2_GEN, bn.g1_mul(bn.G1_GEN, 5))
    assert f1 == f2 == ref_bn.pairing(ref_bn.G2_GEN, ref_bn.g1_mul(ref_bn.G1_GEN, 5))
    assert f1 != bn.FQ12_ONE
    p, q = bn.g1_mul(bn.G1_GEN, 7), bn.g2_mul(bn.G2_GEN, 3)
    assert bn.pairing_check([(q, p), (bn.g2_neg(bn.G2_GEN), bn.g1_mul(bn.G1_GEN, 21))])
    assert not bn.pairing_check([(q, p), (bn.g2_neg(bn.G2_GEN), bn.g1_mul(bn.G1_GEN, 22))])


def test_kzg_commit_and_open_match_reference():
    srs = bn.KzgSrs.generate_insecure(4, tau=0xBEEF)
    ref_srs = ref_bn.KzgSrs.generate_insecure(4, tau=0xBEEF)
    assert srs.g1_powers == ref_srs.g1_powers and srs.tau_g2 == ref_srs.tau_g2
    for coeffs in ([5, 3, 0, 7, 11, 2, 9, 1], _ints(3, 16, bn.R, (0, bn.R - 1))):
        c = bn.kzg_commit(srs, coeffs, device="cpu")
        assert c == ref_bn.kzg_commit(ref_srs, coeffs)
        z = 0x1234
        y, proof = bn.kzg_open(srs, coeffs, z, device="cpu")
        assert (y, proof) == ref_bn.kzg_open(ref_srs, coeffs, z)
        assert bn.kzg_verify(srs.tau_g2, c, z, y, proof)
        assert ref_bn.kzg_verify(ref_srs.tau_g2, c, z, y, proof)
        assert not bn.kzg_verify(srs.tau_g2, c, z, (y + 1) % bn.R, proof)


# ---------------------------------------------------------------------------
# the plain Fq field against ops/bigint.py (numpy path)
# ---------------------------------------------------------------------------

EDGES = (0, 1, bn.Q - 1, bn.Q - 2, (1 << 255) % bn.Q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_field_matches_reference(seed):
    xs = _ints(seed, 64, bn.Q, EDGES)
    ys = _ints(seed + 10, 64, bn.Q, EDGES[::-1])
    ra = np.stack([REF_F.to_monty_int(x) for x in xs])
    rb = np.stack([REF_F.to_monty_int(y) for y in ys])
    a, b = F.to_monty(xs), F.to_monty(ys)
    np.testing.assert_array_equal(a.numpy(), ra.astype(np.int64))
    for op in ("add", "sub", "mul"):
        np.testing.assert_array_equal(getattr(F, op)(a, b).numpy(),
                                      getattr(REF_F, op)(ra, rb).astype(np.int64), err_msg=op)
    np.testing.assert_array_equal(F.neg(a).numpy(), REF_F.neg(ra).astype(np.int64))
    assert F.from_monty_batch(F.mul(a, b)) == [x * y % bn.Q for x, y in zip(xs, ys)]
    np.testing.assert_array_equal(F.is_zero(a).numpy(), REF_F.is_zero(ra))


def test_words_round_trip_and_fq_mul_plain():
    xs, ys = _ints(4, 32, bn.Q, EDGES), _ints(5, 32, bn.Q, EDGES)
    a, b = F.to_monty(xs), F.to_monty(ys)
    wa, wb = bigint.to_words(a), bigint.to_words(b)
    assert wa.dtype == torch.int32 and wa.shape == (32, 8)
    assert torch.equal(bigint.from_words(wa), a)
    # the words are the residue's little-endian 32-bit limbs
    for x, row in zip(xs, wa.numpy().view(np.uint32)):
        assert int.from_bytes(row.tobytes(), "little") == x * F.R % bn.Q
    assert torch.equal(msm.fq_mul(wa, wb), bigint.to_words(F.mul(a, b)))


# ---------------------------------------------------------------------------
# the MSM: plain version, host engine, reference
# ---------------------------------------------------------------------------


def _msm_case(n, seed):
    """n points with repeats, an opposite pair and an infinity; scalars
    with zeros, r - 1, scalars >= r and a repeated one."""
    pts = _points(seed, n)
    sc = _ints(seed, n, 1 << 256)
    sc[0], sc[1], sc[2] = 0, bn.R - 1, bn.R + 3
    pts[3] = pts[4]
    pts[5] = None
    pts[6] = bn.g1_neg(pts[7])
    sc[6] = sc[7]
    return pts, sc


@pytest.mark.parametrize("n", [8, 61, 256])
def test_msm_matches_reference(n):
    pts, sc = _msm_case(n, n)
    want = ref_bn.msm(pts, sc)
    assert msm.msm_device(pts, sc, "cpu") == want
    assert bn254_native.msm(pts, sc) == want
    assert bn.msm_jac(pts, sc, device="cpu") == want == ref_bn.msm_jac(pts, sc)


@pytest.mark.parametrize("c", [4, 6])
def test_msm_windows_match_reference(c):
    pts, sc = _msm_case(40, c)
    want = ref_bn.msm(pts, sc)
    assert msm.msm_device(pts, sc, "cpu", c=c) == want


def test_msm_infinity_results():
    p = bn.g1_mul(bn.G1_GEN, 99)
    for pts, sc in (([p] * 8, [0] * 8), ([None] * 8, [5] * 8),
                    ([p, bn.g1_neg(p)] * 4, [7] * 8), ([p] * 8, [bn.R] * 8)):
        assert msm.msm_device(pts, sc, "cpu") is None
        assert bn254_native.msm(pts, sc) is None
        assert ref_bn.msm(pts, sc) is None


def test_msm_one_bucket_of_repeats():
    """Every point in one bucket of every window: the doubling lane of the
    unified add in each round of the segmented combine."""
    pts = [bn.G1_GEN] * 9 + [bn.g1_mul(bn.G1_GEN, 3)] * 7
    sc = [0x1111111111111111] * 16
    want = ref_bn.msm(pts, sc)
    assert msm.msm_device(pts, sc, "cpu") == want == bn254_native.msm(pts, sc)


def test_point_formulas_match_reference():
    pts = [bn.g1_mul(bn.G1_GEN, k) for k in (1, 2, 5, 77, 123457)]
    q_list = [pts[1], pts[0], bn.g1_neg(pts[2]), None, pts[4]]
    X, Y, Z = ref_msm.affine_to_limbs(pts)
    Xq, Yq, Zq = ref_msm.affine_to_limbs(q_list)
    t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    got = msm.pt_add((t(X), t(Y), t(Z)), (t(Xq), t(Yq), t(Zq)))
    want = ref_msm.pt_add((X, Y, Z), (Xq, Yq, Zq))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    got = msm.pt_double((t(X), t(Y), t(Z)))
    for g, w in zip(got, ref_msm.pt_double((X, Y, Z))):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_digits_and_sort():
    sc = _ints(9, 50, 1 << 256)
    for c in (4, 5, 9, 10):
        words = torch.from_numpy(msm.scalar_words(sc).view(np.int32).copy())
        dig = msm.digits(words, c)
        want = ref_msm._digits(sc, c)
        np.testing.assert_array_equal(dig.numpy(), want.T)
        order, offsets = msm.sort_by_digit(dig, c)
        assert offsets.shape == (msm.n_windows(c), (1 << c) + 1)
        for w in range(dig.shape[0]):
            for k in (0, 1, (1 << c) - 1):
                run = order[w, offsets[w, k]:offsets[w, k + 1]].tolist()
                assert run == [i for i in range(50) if want[i, w] == k]


def test_window_steps_take_the_plain_version_on_cpu():
    pts, sc = _msm_case(16, 3)
    c = msm.window_bits(16)
    before = dict(msm.launches)
    p = torch.from_numpy(msm.affine_words(pts).view(np.int32).copy())
    dig = msm.digits(torch.from_numpy(msm.scalar_words(sc).view(np.int32).copy()), c)
    buckets = msm.window_buckets(p, dig, c)
    assert buckets.shape == (msm.n_windows(c), 1 << c, 24) and buckets.dtype == torch.int32
    assert msm.combine_windows(msm.window_sums(buckets, c), c) == ref_bn.msm(pts, sc)
    assert msm.launches == before


# ---------------------------------------------------------------------------
# K4's split of the bucket step and of the window sums (plain versions)
# ---------------------------------------------------------------------------


def _words_t(values):
    return torch.from_numpy(np.ascontiguousarray(values).view(np.int32).copy())


def _ref_buckets(pts, sc, c):
    """The JAX package's bucket step (its numpy path) as K4's words."""
    grid = ref_msm.window_buckets(ref_msm.affine_to_limbs(pts), ref_msm._digits(sc, c), c,
                                  use_jax=False)
    return torch.cat([bigint.to_words(torch.from_numpy(g.astype(np.int64))) for g in grid], -1)


def _ref_affine(grid):
    X, Y, Z = grid
    return [ref_msm.pt_to_affine_int((x, y, z)) for x, y, z in
            zip(X.reshape(-1, X.shape[-1]), Y.reshape(-1, X.shape[-1]), Z.reshape(-1, X.shape[-1]))]


def _digit_case(kind, n, seed):
    """Points (one at infinity) and scalars whose digits are uniform, all
    equal, two-valued or mostly 0 (64-bit scalars: every upper window 0)."""
    pts = _points(seed, n)
    pts[2] = None
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        sc = _ints(seed, n, bn.R)
    elif kind == "all_equal":
        sc = [_ints(seed, 1, bn.R)[0]] * n
    elif kind == "two_buckets":
        a, b = _ints(seed, 2, bn.R)
        sc = [a if rng.random() < 0.5 else b for _ in range(n)]
    else:
        sc = [int(v) for v in rng.integers(0, 1 << 63, size=n)]
    return pts, sc


def _plan(pts, sc, c, m):
    p = _words_t(msm.affine_words(pts))
    dig = msm.digits(_words_t(msm.scalar_words(sc)), c)
    order, offsets = msm.sort_by_digit(dig, c)
    return p, dig, msm.chunk_plan(order, offsets, (p == 0).all(-1), c, m)


def _reduce_all(p, plan, W, c):
    """The bucket step as the kernels run it, on the plain versions."""
    out = torch.zeros((W, 1 << c, 24), dtype=torch.int32)
    pieces, keys = msm.chunk_partials(p, plan, out), plan.piece_key
    levels = 0
    while keys.shape[0] > 2:
        pieces, keys = msm.reduce_segments(pieces, keys, out)
        levels += 1
    return out, levels


@pytest.mark.parametrize("kind", ["uniform", "all_equal", "two_buckets", "digit0_heavy"])
def test_chunk_plan_covers_every_live_point(kind):
    """Every live entry (digit > 0, point not at infinity) of every window
    sits in exactly one chunk under its own bucket; each piece slot names the
    bucket of the run it holds (a bucket in several chunks: the first one's
    tail, every later one's head, and the tail of a chunk it covers whole;
    its slots side by side); the runs are at most chunks + occupied
    buckets; the buckets that follow equal the JAX package's."""
    n, c, m = 10, 4, 3
    pts, sc = _digit_case(kind, n, 7)
    p, dig, plan = _plan(pts, sc, c, m)
    W, nb = dig.shape[0], 1 << c
    want = sorted((w, i) for w in range(W) for i in range(n)
                  if dig[w, i] != 0 and pts[i] is not None)
    key, idx = plan.key.tolist(), plan.idx.tolist()
    assert sorted((k // nb, i) for k, i in zip(key, idx)) == want
    assert all(k % nb == dig[k // nb, i] for k, i in zip(key, idx)) and key == sorted(key)
    starts = plan.starts().tolist()
    assert starts[0] == 0 and starts[-1] == len(key) and len(starts) == -(-len(key) // m) + 1
    assert all(0 < b - a <= m for a, b in zip(starts, starts[1:]))
    chunks_of = {}
    for t, (a, b) in enumerate(zip(starts, starts[1:])):
        for k in key[a:b]:
            chunks_of.setdefault(k, []).append(t)
    slots = plan.piece_key.tolist()
    for k, ts in chunks_of.items():
        ts = sorted(set(ts))
        want_slots = [] if len(ts) == 1 else [2 * ts[0] + 1] + [s for t in ts[1:] for s in (
            (2 * t, 2 * t + 1) if t != ts[-1] else (2 * t,))]
        assert [i for i, v in enumerate(slots) if v == k] == want_slots
    runs = sum(len(set(key[a:b])) for a, b in zip(starts, starts[1:]))
    assert runs <= len(starts) - 1 + len(chunks_of)
    buckets, _ = _reduce_all(p, plan, W, c)
    assert msm.to_affine(buckets) == _ref_affine(ref_msm.window_buckets(
        ref_msm.affine_to_limbs(pts), ref_msm._digits(sc, c), c, use_jax=False))


@pytest.mark.parametrize("c", [4, 6])
def test_chunk_partials_and_reduction_match_reference(c, monkeypatch):
    """The chunk partials and the levels of the reduction (tiles of 4 here,
    so that a heavy bucket spans several levels) against the JAX package's
    bucket step, with a heavy bucket (half the scalars equal), a repeated
    point in it, an opposite pair and a point at infinity."""
    monkeypatch.setattr(msm, "TILE", 4)
    pts, sc = _msm_case(20, c)
    sc[8:18] = [sc[8]] * 10
    pts[9:12] = [pts[9]] * 3
    pts[14], sc[14] = bn.g1_neg(pts[15]), sc[15]
    p, dig, plan = _plan(pts, sc, c, 3)
    buckets, levels = _reduce_all(p, plan, dig.shape[0], c)
    assert levels >= 3
    assert msm.to_affine(buckets) == msm.to_affine(_ref_buckets(pts, sc, c))


@pytest.mark.parametrize("c,log_s", [(4, 2), (5, 5), (6, 3)])
def test_window_sum_split_matches_reference(c, log_s):
    """K4's window-sum split (2^log_s leaves of L buckets by running sums,
    then the (A, V, D) tree) on the JAX package's buckets, per window as
    affine points: at c = 4 against its `_weighted_bucket_sum`; at c = 5 and
    6 (where that numpy scan takes 10-22 s) against sum_k k B_k by its host
    group law; and the whole MSM against the host engine."""
    pts, sc = _msm_case(10, c)
    grid = ref_msm.window_buckets(ref_msm.affine_to_limbs(pts), ref_msm._digits(sc, c), c,
                                  use_jax=False)
    buckets = torch.cat([bigint.to_words(torch.from_numpy(g.astype(np.int64))) for g in grid], -1)
    if c == 4:
        want = _ref_affine(ref_msm._weighted_bucket_sum(grid, c, use_jax=False))
    else:
        aff, nb = _ref_affine(grid), 1 << c
        want = []
        for w in range(buckets.shape[0]):
            acc = None
            for k in range(1, nb):
                acc = ref_bn.g1_add(acc, ref_bn.g1_mul(aff[w * nb + k], k) if aff[w * nb + k]
                                    else None)
            want.append(acc)
    sums = msm.window_sums(buckets, c, log_s)
    assert msm.to_affine(sums) == want
    assert msm.combine_windows(sums, c) == bn254_native.msm(pts, sc)


def test_wrappers_reject_bad_input():
    p = torch.zeros((8, 16), dtype=torch.int32)
    dig = torch.zeros((msm.n_windows(4), 8), dtype=torch.int64)
    with pytest.raises(TypeError):
        msm.window_buckets(p.to(torch.int64), dig, 4)
    with pytest.raises(ValueError):
        msm.window_buckets(p[:, :8], dig, 4)
    with pytest.raises(ValueError):
        msm.window_buckets(p, dig, 5)  # 51 windows of 5 bits, not 64
    with pytest.raises(ValueError):
        msm.window_sums(torch.zeros((3, 16, 23), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        msm.window_sums(torch.zeros((3, 16, 24), dtype=torch.int32), 4, 5)  # 32 leaves of 16
    plan = msm.ChunkPlan(*(torch.zeros(9, dtype=torch.int32),) * 2, 4,
                         torch.zeros(6, dtype=torch.int32))
    with pytest.raises(TypeError):
        msm.chunk_partials(p.to(torch.int64), plan, torch.zeros((1, 16, 24), dtype=torch.int32))
    with pytest.raises(ValueError):  # 9 entries in chunks of 4: 3 chunks, 6 slots
        msm.chunk_partials(p, plan._replace(m=2), torch.zeros((1, 16, 24), dtype=torch.int32))
    with pytest.raises(ValueError):
        msm.reduce_segments(torch.zeros((4, 24), dtype=torch.int32),
                            torch.zeros(5, dtype=torch.int32),
                            torch.zeros((1, 16, 24), dtype=torch.int32))
    with pytest.raises(TypeError):
        msm.fq_mul(torch.zeros((4, 8), dtype=torch.int64), torch.zeros((4, 8), dtype=torch.int64))


def test_msm_without_a_device_means_the_card():
    """`device=None` is the card: without one an MSM of eight or more points
    raises (fewer points take the python path and need no device)."""
    pts, sc = _msm_case(8, 1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bn.msm_jac(pts, sc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bn.kzg_commit(bn.KzgSrs(pts, bn.G2_GEN), sc)
    assert bn.msm_jac(pts[:7], sc[:7]) == ref_bn.msm(pts[:7], sc[:7])


def test_native_failure_raises(monkeypatch, tmp_path):
    """No fallback: a missing g++ and a nonzero return code raise."""
    pts, sc = _msm_case(8, 2)
    with pytest.raises(RuntimeError, match="bn254_msm failed"):
        bn254_native.msm(pts, sc, c=0)
    monkeypatch.setattr(bn254_native, "_SO", tmp_path / "libbn254.so")
    monkeypatch.setattr(bn254_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        bn254_native.build_native()


def test_native_library_is_built_into_build():
    path = bn254_native.build_native()
    assert path.parent.name == "bn254" and path.parent.parent.name == "build"
    assert path.resolve() != (bn254_native._REPO_ROOT / "native" / "bn254" / "libbn254.so").resolve()
