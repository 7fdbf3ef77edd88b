"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `gpu`: each test decides inside itself whether a card exists and
skips with a reason where there is none (as on a CPU-only host). Exact
equality throughout. This file imports no JAX, so on a machine with the
card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from zkvm_prover_tpu_torch.fields import babybear as bb
from zkvm_prover_tpu_torch.ops import mont_matmul as mm
from zkvm_prover_tpu_torch.ops import ntt, ntt_fused
from zkvm_prover_tpu_torch.ops import poseidon2 as p2

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(seed, shape, device):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, bb.P, size=shape, dtype=np.uint64).astype(np.uint32)
    return bb.as_tensor(a, device)


def _same(a, b):
    assert a.shape == b.shape
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("log_n,w", [(1, 3), (10, 8), (12, 495), (13, 4)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernels(cuda, log_n, w, inverse):
    x = _rand(log_n + w, (1 << log_n, w), cuda)
    before = ntt_fused.launches["ntt_pass"]
    _same(ntt_fused.dif(x, log_n, inverse), ntt_fused.dif_plain(x, log_n, inverse))
    _same(ntt_fused.dit(x, log_n, inverse), ntt_fused.dit_plain(x, log_n, inverse))
    passes = len(ntt_fused.pass_sizes(log_n))
    assert passes == (2 if log_n > ntt_fused.K_MAX else 1)
    assert ntt_fused.launches["ntt_pass"] == before + 2 * passes


@pytest.mark.parametrize("log_n,k,passes", [(9, 9, 1), (10, 5, 2), (12, 4, 3), (7, 3, 3)])
@pytest.mark.parametrize("w", [1, 4, 31, 33, 495])
@pytest.mark.parametrize("dit", [False, True])
def test_ntt_pass_groupings(cuda, log_n, k, passes, w, dit):
    """1, 2 and 3 passes per transform (forced with k), the ragged column
    tile (W = 1, 31, 33, 495) and the narrow packed tile (W = 4)."""
    x = _rand(log_n * w + k, (1 << log_n, w), cuda)
    before = ntt_fused.launches["ntt_pass"]
    fn, plain = (ntt_fused.dit, ntt_fused.dit_plain) if dit else \
        (ntt_fused.dif, ntt_fused.dif_plain)
    for inverse in (False, True):
        _same(fn(x, log_n, inverse, k=k), plain(x, log_n, inverse))
    assert ntt_fused.launches["ntt_pass"] == before + 2 * passes


@pytest.mark.parametrize("a,L", [(0, 10), (0, 1), (3, 5), (8, 4), (11, 1)])
@pytest.mark.parametrize("w", [1, 4, 16, 17, 40])
@pytest.mark.parametrize("dit", [False, True])
def test_ntt_pass_multipliers_in_place(cuda, a, L, w, dit):
    """One pass with both per-row multipliers, run in place."""
    n = 1 << 12
    x = _rand(a * 31 + L + w, (n, w), cuda)
    pre, post = _rand(1, (n,), cuda), _rand(2, (n,), cuda)
    want = ntt_fused.ntt_pass_plain(x, a, L, True, dit, pre, post)
    y = x.clone()
    assert ntt_fused.ntt_pass(y, a, L, True, dit, pre, post, out=y) is y
    _same(y, want)


def test_ntt_pass_strided_views(cuda):
    """Input rows r::2 of a wider matrix, output into a column block of
    rows r::2 of another: pitches other than W on both sides."""
    n = 1 << 11
    src = _rand(5, (2 * n, 12), cuda)
    dst = torch.zeros((2 * n, 20), dtype=bb.DTYPE, device=cuda)
    x = src[1::2, 3:10]
    ntt_fused.dif(x, 11, False, k=6, out=dst[1::2, 5:12])
    _same(dst[1::2, 5:12], ntt_fused.dif_plain(x, 11, False))
    assert not dst[0::2].any() and not dst[:, :5].any() and not dst[:, 12:].any()


@pytest.mark.parametrize("w", [1, 4, 33, 495])
def test_coset_lde_cuda_equals_cpu(cuda, w):
    """The fused LDE (scalings on the passes, cosets stored interleaved)."""
    x = _rand(3 + w, (1 << 11, w), cuda)
    before = ntt_fused.launches["ntt_pass"]
    _same(ntt.coset_lde(x, 1, 31, 7), ntt.coset_lde(x.cpu(), 1, 31, 7))
    assert ntt_fused.launches["ntt_pass"] == before + 3 * 2  # 3 transforms, k = 10
    _same(ntt.interpolate_coset_rev(x, 7, canonical=True),
          ntt.interpolate_coset_rev(x.cpu(), 7, canonical=True))


def test_chunk_lde_strided_cuda_equals_cpu(cuda):
    """The prover's quotient chunks: strided input, column-block output."""
    n = 1 << 12
    q = _rand(8, (2 * n, 4), cuda)
    outs = []
    for dev in (cuda, "cpu"):
        out = torch.zeros((2 * n, 8), dtype=bb.DTYPE, device=dev)
        for r in range(2):
            c = ntt.interpolate_coset_rev(q.to(dev)[r::2], 31 * (r + 2))
            ntt.eval_coset_from_rev(c, 1, 31, out=out[:, 4 * r:4 * r + 4])
        outs.append(out)
    _same(*outs)


@pytest.mark.parametrize("rows", [1, 127, 129, 4097])
@pytest.mark.parametrize("cols", [1, 7, 8, 9, 16, 63, 64, 65, 495])
def test_hash_rows_kernel(cuda, cols, rows):
    """Widths around the 8-word block and the 32-word staged chunk; row
    counts around the 128-row tile."""
    m = _rand(cols * rows, (rows, cols), cuda)
    _same(p2.hash_rows(m), p2.hash_rows_plain(m))


def test_hash_rows_unaligned_view(cuda):
    """The row sponge reads 4-byte words: a view one word past an aligned
    start is taken as it is."""
    m = _rand(5, (300 * 65 + 1,), cuda)[1:].view(300, 65)
    assert m.data_ptr() % 16
    _same(p2.hash_rows(m), p2.hash_rows_plain(m))


def test_permute_and_compress_kernels(cuda):
    s = _rand(1, (777, 16), cuda)
    _same(p2.permute(s), p2.permute_plain(s))
    _same(p2.compress16(s), p2.permute_plain(s)[:, :8])


@pytest.fixture(params=["shift", "general"])
def instance24(request):
    """The width-24 kernel instance the installed constants choose: the
    derived ones take the shift-form diagonal; a random diagonal (the
    derived round constants kept) takes the general one. Yields the
    counter of the instance."""
    saved = dict(p2._OVERRIDES)
    if request.param == "general":
        ext, internal, _ = (bb.from_monty_np(t) for t in p2.constants(24))
        p2.load_constants(24, ext, internal,
                          np.random.default_rng(9).integers(0, bb.P, 24))
    try:
        assert p2.shift_diag24() == (request.param == "shift")
        yield "poseidon2_permute24" if request.param == "shift" else "poseidon2_permute24_general"
    finally:
        p2.reset_constants()
        p2._OVERRIDES.update(saved)


def _wave24(n):
    """n, or "wave+1": one state past a whole wave of the launch geometry."""
    if n == "wave+1":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return sms * p2.PERMUTE24_WAVE_PER_SM + 1
    return n


@pytest.mark.parametrize("n", [1, 3, 1000, 1 << 18, (1 << 18) + 1, "wave+1"])
def test_permute24_kernel(cuda, instance24, n):
    """The width-24 permutation, both instances: one launch of its own
    counter, none of the other instance's or of width 16's; exact against
    the plain version."""
    n = _wave24(n)
    s = _rand(24 + n, (n, 24), cuda)
    assert s.data_ptr() % 16 == 0
    before16, before24 = dict(p2.launches), dict(p2.launches_w24)
    got = p2.permute(s)
    assert p2.launches_w24 == {**before24, instance24: before24[instance24] + 1}
    assert p2.launches == before16
    _same(got, p2.permute_plain(s))


def test_permute24_edge_states(cuda, instance24):
    """All 0, all p - 1, and lanes alternating 1 and p - 1."""
    s = torch.zeros((3, 24), dtype=bb.DTYPE, device=cuda)
    s[1] = bb.P - 1
    s[2, 0::2] = 1
    s[2, 1::2] = bb.P - 1
    _same(p2.permute(s), p2.permute_plain(s))


def test_permute24_standard_diagonal_other_round_constants(cuda):
    """An override that keeps the standard diagonal runs the shift instance
    under its own round constants."""
    s = _rand(10, (1000, 24), cuda)
    saved = dict(p2._OVERRIDES)
    try:
        rng = np.random.default_rng(12)
        diag = bb.from_monty_np(p2.constants(24)[2])
        p2.load_constants(24, rng.integers(0, bb.P, (8, 24)), rng.integers(0, bb.P, 21), diag)
        assert p2.shift_diag24()
        before = p2.launches_w24["poseidon2_permute24"]
        got = p2.permute(s)
        assert p2.launches_w24["poseidon2_permute24"] == before + 1
        _same(got, p2.permute_plain(s))
    finally:
        p2.reset_constants()
        p2._OVERRIDES.update(saved)
    assert not torch.equal(p2.permute(s).cpu(), got.cpu())


def test_permute16_unchanged_beside_width_24(cuda):
    """Width 16 after a width-24 launch: its own kernel and counter, equal
    to the plain version and to the host's C++ permutation."""
    p2.permute(_rand(5, (64, 24), cuda))
    s = _rand(6, (1000, 16), cuda)
    before = p2.launches["poseidon2_permute"]
    got = p2.permute(s)
    assert p2.launches["poseidon2_permute"] == before + 1
    _same(got, p2.permute_plain(s))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  p2.permute_np(s.cpu().numpy().view(np.uint32)))


def test_permute24_follows_overrides(cuda):
    """`load_constants(24, ...)` reaches the width-24 kernel's tables (and
    leaves width 16's alone); `reset_constants` brings the derived ones back."""
    s24, s16 = _rand(7, (300, 24), cuda), _rand(8, (300, 16), cuda)
    want16 = p2.permute_plain(s16)
    saved = dict(p2._OVERRIDES)
    try:
        rng = np.random.default_rng(11)
        p2.load_constants(24, rng.integers(0, bb.P, (8, 24)), rng.integers(0, bb.P, 21),
                          rng.integers(0, bb.P, 24))
        got = p2.permute(s24)
        _same(got, p2.permute_plain(s24))
        _same(p2.permute(s16), want16)
    finally:
        p2.reset_constants()
        p2._OVERRIDES.update(saved)
    assert not torch.equal(p2.permute(s24).cpu(), got.cpu())
    _same(p2.permute(s24), p2.permute_plain(s24))


@pytest.mark.parametrize("log_h", range(1, 14))
def test_compress_levels_kernel(cuda, log_h):
    d = _rand(log_h, (1 << log_h, 8), cuda)
    before = p2.launches["poseidon2_compress"]
    got = p2.compress_levels(d, log_h)
    assert p2.launches["poseidon2_compress"] - before == -(-log_h // p2.LEVELS_PER_LAUNCH)
    want = p2.compress_levels_plain(d, log_h)
    assert len(got) == len(want) == log_h
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("shapes", [[(64, 17), (64, 8), (16, 3), (2, 6)],
                                    [(4096, 4), (4, 2)], [(8, 2), (1, 3)]])
def test_commit_cuda_equals_cpu(cuda, shapes):
    from zkvm_prover_tpu_torch.stark import merkle

    mats = [_rand(h * w, (h, w), cuda) for h, w in shapes]
    a = merkle.commit(mats)
    b = merkle.commit([m.cpu() for m in mats])
    assert len(a.levels) == len(b.levels)
    for x, y in zip(a.levels, b.levels):
        _same(x, y)


def test_poseidon2_constants_follow_overrides(cuda):
    """Every K2 kernel follows `load_constants` and `reset_constants`."""
    s = _rand(2, (64, 16), cuda)
    m = _rand(3, (200, 20), cuda)

    def check():
        _same(p2.permute(s), p2.permute_plain(s))
        _same(p2.hash_rows(m), p2.hash_rows_plain(m))
        for a, b in zip(p2.compress_levels(s.view(128, 8), 7),
                        p2.compress_levels_plain(s.view(128, 8), 7)):
            _same(a, b)

    saved = dict(p2._OVERRIDES)
    try:
        rng = np.random.default_rng(9)
        p2.load_constants(16, rng.integers(0, bb.P, (8, 16)),
                          rng.integers(0, bb.P, 13), rng.integers(0, bb.P, 16))
        check()
    finally:
        p2.reset_constants()
        p2._OVERRIDES.update(saved)
    check()


K3_WIDTHS = [1, 4, 8, 31, 33, 495]


@pytest.mark.parametrize("k", mm.KS)
@pytest.mark.parametrize("c", K3_WIDTHS)
@pytest.mark.parametrize("r", [1, 37, 129, 4097])
def test_mont_matmul_rows(cuda, r, c, k):
    """Widths around the 4/8/16/32-column staged chunk, row counts around
    the 128-row tile, k = 1 and 2 right-hand sides."""
    a, b = _rand(r * c, (r, c), cuda), _rand(c + k, (c, 4 * k), cuda)
    before = mm.launches["mont_matmul_rows"]
    _same(mm.mont_matmul(a, b), mm.mont_matmul_plain(a, b))
    assert mm.launches["mont_matmul_rows"] == before + 1


@pytest.mark.parametrize("k", mm.KS)
@pytest.mark.parametrize("c", K3_WIDTHS)
@pytest.mark.parametrize("r", [1, 3000, 70001])
def test_mont_matmul_cols(cuda, r, c, k):
    a, b = _rand(r + c, (r, c), cuda), _rand(c + 1, (r, 4 * k), cuda)
    _same(mm.mont_matmul(a, b, transpose_a=True),
          mm.mont_matmul_plain(a, b, transpose_a=True))


@pytest.mark.parametrize("transpose_a,r,c", [(False, 4097, 495), (True, 1 << 18, 495)])
def test_mont_matmul_all_p_minus_1(cuda, transpose_a, r, c):
    """Every entry p - 1: the largest products, through the accumulator's
    carry path (the 96-bit sum's top word) and its final reduction."""
    a = torch.full((r, c), bb.P - 1, dtype=bb.DTYPE, device=cuda)
    b = torch.full((r if transpose_a else c, 8), bb.P - 1, dtype=bb.DTYPE, device=cuda)
    _same(mm.mont_matmul(a, b, transpose_a), mm.mont_matmul_plain(a, b, transpose_a))


def test_two_point_ood_and_deep_combine_cuda_equal_cpu(cuda):
    from zkvm_prover_tpu_torch.stark import prover

    n, w = 1 << 10, 33
    c = _rand(1, (n, w), cuda)
    zs = [_rand(2, (4,), cuda), _rand(3, (4,), cuda)]
    for got, want in zip(ntt.eval_poly_at_points_ext(c, zs),
                         ntt.eval_poly_at_points_ext(c.cpu(), [z.cpu() for z in zs])):
        _same(got, want)
    rng = np.random.default_rng(4)
    opened = [rng.integers(0, bb.P, size=s, dtype=np.uint64).astype(np.uint32)
              for s in ((4,), (4,), (w, 4), (w, 4), (8, 4), (4,))]
    mats = [_rand(5, (2 * n, w), cuda), _rand(6, (2 * n, 8), cuda), _rand(7, (2 * n,), cuda)]
    before = mm.launches["mont_matmul_rows"]
    got = prover._deep_combine(*mats, *opened)
    assert mm.launches["mont_matmul_rows"] == before + 2  # trace once, chunks once
    _same(got, prover._deep_combine(*[t.cpu() for t in mats], *opened))


def test_wrappers_reject_bad_input(cuda):
    x = _rand(4, (64, 6), cuda)
    with pytest.raises(ValueError):
        ntt_fused.block_stages(x[:, ::2], 4)  # not contiguous
    with pytest.raises(TypeError):
        p2.hash_rows(x.to(torch.int64))
    with pytest.raises(ValueError):
        mm.mont_matmul(x, _rand(5, (5, 4), cuda))
    with pytest.raises(ValueError):
        mm.mont_matmul(x[:, ::2], _rand(5, (3, 4), cuda))  # not contiguous
    with pytest.raises(ValueError):
        mm.mont_matmul(x, _rand(5, (6, 12), cuda))  # k = 3


def test_wrappers_reject_misaligned_input(cuda):
    """Views one word past an aligned start: the kernels read these as
    16-byte vectors, so the wrappers raise before launching."""
    with pytest.raises(ValueError):
        p2.permute(_rand(6, (16 * 8 + 1,), cuda)[1:].view(8, 16))
    with pytest.raises(ValueError):
        p2.permute(_rand(6, (24 * 8 + 1,), cuda)[1:].view(8, 24))
    with pytest.raises(ValueError):
        p2.compress16(_rand(7, (16 * 8 + 1,), cuda)[1:].view(8, 16))
    with pytest.raises(ValueError):
        p2.compress_levels(_rand(7, (8 * 8 + 1,), cuda)[1:].view(8, 8), 3)
    a = _rand(8, (8, 5), cuda)
    with pytest.raises(ValueError):
        mm.mont_matmul(a, _rand(9, (4 * 5 + 1,), cuda)[1:].view(5, 4))
    with pytest.raises(ValueError):
        mm.mont_matmul(a, _rand(9, (8 * 8 + 1,), cuda)[1:].view(8, 8), transpose_a=True)


def test_small_proof_cuda_equals_cpu(cuda):
    from zkvm_prover_tpu_torch.models.poseidon2_air import Poseidon2Air
    from zkvm_prover_tpu_torch.stark import prover, verifier
    from zkvm_prover_tpu_torch.stark.config import fast_test_config

    rng = np.random.default_rng(11)
    inputs = rng.integers(0, bb.P, (256, 16), dtype=np.uint64).astype(np.uint32)
    trace = Poseidon2Air.generate_trace(inputs, np.ones(256, np.uint32))
    air = Poseidon2Air()
    a = prover.prove(air, trace, [], fast_test_config(), device=cuda)
    b = prover.prove(air, trace, [], fast_test_config(), device="cpu")
    assert verifier.verify(air, a, fast_test_config())
    assert a.trace_root.tolist() == b.trace_root.tolist()
    assert a.fri_proof.commitments[-1].tolist() == b.fri_proof.commitments[-1].tolist()
    assert a.fri_proof.pow_witness == b.fri_proof.pow_witness


# The machine cell's shapes (chip_smoke.py phase 4) at full size: RangeCheckedAir
# (1 column) and the permutation traces (12 and 8 columns) at 2^18 rows,
# RangeTableAir (2 columns), its permutation trace (8) and quotient chunks (4)
# at 2^16; the leaves of each height side by side.
@pytest.mark.parametrize("log_n,w", [(18, 1), (18, 12), (18, 8), (16, 2), (16, 8), (16, 4)])
def test_machine_ntt_shapes(cuda, log_n, w):
    x = _rand(log_n + 7 * w, (1 << log_n, w), cuda)
    _same(ntt_fused.dif(x, log_n, True), ntt_fused.dif_plain(x, log_n, True))
    _same(ntt_fused.dit(x, log_n, False), ntt_fused.dit_plain(x, log_n, False))


@pytest.mark.parametrize("rows,cols", [(1 << 19, 496), (1 << 19, 20), (1 << 19, 16),
                                       (1 << 17, 2), (1 << 17, 8)])
def test_machine_hash_rows_shapes(cuda, rows, cols):
    m = _rand(cols, (rows, cols), cuda)
    _same(p2.hash_rows(m), p2.hash_rows_plain(m))


def test_machine_compress_join(cuda):
    """Where the 2^17 tree joins the 2^19 one: compress(level, leaf digests)."""
    a, b = _rand(1, (1 << 17, 8), cuda), _rand(2, (1 << 17, 8), cuda)
    _same(p2.compress(a, b), p2.compress_plain(a, b))


@pytest.mark.parametrize("transpose_a,r,c,k", [
    (False, 1 << 19, 1, 2), (False, 1 << 19, 12, 2), (False, 1 << 19, 8, 2),
    (False, 1 << 17, 2, 2), (False, 1 << 17, 8, 2), (False, 1 << 17, 8, 1),
    (True, 1 << 18, 1, 2), (True, 1 << 18, 12, 2), (True, 1 << 18, 8, 2),
    (True, 1 << 16, 2, 2), (True, 1 << 16, 8, 2), (True, 1 << 16, 4, 1)])
def test_machine_mont_matmul_shapes(cuda, transpose_a, r, c, k):
    a = _rand(r + c, (r, c), cuda)
    b = _rand(c + k, (r if transpose_a else c, 4 * k), cuda)
    _same(mm.mont_matmul(a, b, transpose_a), mm.mont_matmul_plain(a, b, transpose_a))


def _proofs_equal(a, b):
    """Field by field, `stat` (timings) excepted."""
    if hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            if f != "stat":
                _proofs_equal(getattr(a, f), getattr(b, f))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _proofs_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _proofs_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    else:
        assert a == b


def test_small_machine_proof_cuda_equals_cpu(cuda):
    """Mixed heights (2^7, 2^6, 2^5, 2^4), a logUp bus and plain AIRs."""
    from zkvm_prover_tpu_torch.models.doubling import DoublingAir
    from zkvm_prover_tpu_torch.models.fibonacci import FibonacciAir
    from zkvm_prover_tpu_torch.models.lookup import RangeCheckedAir, RangeTableAir
    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import fast_test_config

    values = np.random.default_rng(13).integers(0, 1 << 6, size=1 << 7)
    fib, dbl = FibonacciAir(), DoublingAir()
    (t_fib, pv_fib), (t_dbl, pv_dbl) = fib.generate_trace(5), dbl.generate_trace(4)
    airs = [RangeTableAir(), RangeCheckedAir(), fib, dbl]
    insts = [machine.AirInstance(airs[0], airs[0].generate_trace(6, values), []),
             machine.AirInstance(airs[1], airs[1].generate_trace(values), []),
             machine.AirInstance(fib, t_fib, pv_fib), machine.AirInstance(dbl, t_dbl, pv_dbl)]
    a = machine.prove_machine(insts, fast_test_config(), device=cuda)
    b = machine.prove_machine(insts, fast_test_config(), device="cpu")
    _proofs_equal(a, b)
    assert machine.verify_machine(airs, a, fast_test_config())


# The rv32 machine proof's shapes (chip_smoke.py phase 6: the benchmark guest
# bench_guest_program(8, 256), 18 AIRs from 2^2 to 2^16 rows): every matrix
# LDE (log_n, width, canonical input), the quotient chunk path at each height,
# the leaves of each height side by side and the FRI codewords, every tree
# height, and K3 at each (rows, width, k). chip_smoke derives the same lists
# from the AIRs (`rv32_shapes`).
RV32_LDE = [(2, 1, True), (2, 4, True), (2, 12, False), (2, 36, False), (3, 1116, True),
            (3, 1384, False), (5, 6, True), (5, 7, True), (5, 12, False), (5, 55, True),
            (5, 92, False), (5, 160, False), (7, 1, True), (7, 8, False), (7, 10, True),
            (8, 2, True), (8, 8, False), (8, 67, True), (8, 2609, True), (11, 70, True),
            (11, 100, True), (11, 109, True), (11, 168, False), (11, 240, False),
            (11, 248, False), (12, 58, True), (12, 72, False), (13, 72, True),
            (13, 140, False), (14, 69, True), (14, 120, False), (16, 1, True), (16, 3, True),
            (16, 8, False)]
RV32_CHUNKS = [2, 3, 5, 7, 8, 11, 12, 13, 14, 16]
RV32_HASH_ROWS = [(4, 4), (8, 4), (8, 5), (8, 16), (8, 48), (16, 4), (16, 8), (16, 1116),
                  (16, 1384), (32, 4), (64, 4), (64, 32), (64, 123), (64, 276), (128, 4),
                  (256, 1), (256, 4), (256, 8), (256, 10), (512, 4), (512, 16), (512, 67),
                  (512, 2611), (1024, 4), (2048, 4), (4096, 4), (4096, 24), (4096, 279),
                  (4096, 656), (8192, 4), (8192, 8), (8192, 58), (8192, 72), (16384, 4),
                  (16384, 8), (16384, 72), (16384, 140), (32768, 4), (32768, 8), (32768, 69),
                  (32768, 120), (65536, 4), (131072, 2), (131072, 4), (131072, 16)]
RV32_TREES = list(range(2, 18))  # log2 of every tree's leaf count
RV32_K3_ROWS = [(8, 1, 2), (8, 4, 2), (8, 8, 1), (8, 12, 2), (8, 36, 2), (16, 8, 1),
                (16, 1116, 2), (16, 1384, 2), (64, 6, 2), (64, 7, 2), (64, 8, 1), (64, 12, 2),
                (64, 55, 2), (64, 92, 2), (64, 160, 2), (256, 1, 2), (256, 8, 1), (256, 8, 2),
                (256, 10, 2), (512, 2, 2), (512, 8, 1), (512, 8, 2), (512, 67, 2),
                (512, 2609, 2), (4096, 8, 1), (4096, 70, 2), (4096, 100, 2), (4096, 109, 2),
                (4096, 168, 2), (4096, 240, 2), (4096, 248, 2), (8192, 8, 1), (8192, 58, 2),
                (8192, 72, 2), (16384, 8, 1), (16384, 72, 2), (16384, 140, 2), (32768, 8, 1),
                (32768, 69, 2), (32768, 120, 2), (131072, 1, 2), (131072, 3, 2),
                (131072, 8, 1), (131072, 8, 2)]
RV32_K3_COLS = [(4, 1, 2), (4, 4, 1), (4, 4, 2), (4, 12, 2), (4, 36, 2), (8, 4, 1),
                (8, 1116, 2), (8, 1384, 2), (32, 4, 1), (32, 6, 2), (32, 7, 2), (32, 12, 2),
                (32, 55, 2), (32, 92, 2), (32, 160, 2), (128, 1, 2), (128, 4, 1), (128, 8, 2),
                (128, 10, 2), (256, 2, 2), (256, 4, 1), (256, 8, 2), (256, 67, 2),
                (256, 2609, 2), (2048, 4, 1), (2048, 70, 2), (2048, 100, 2), (2048, 109, 2),
                (2048, 168, 2), (2048, 240, 2), (2048, 248, 2), (4096, 4, 1), (4096, 58, 2),
                (4096, 72, 2), (8192, 4, 1), (8192, 72, 2), (8192, 140, 2), (16384, 4, 1),
                (16384, 69, 2), (16384, 120, 2), (65536, 1, 2), (65536, 3, 2), (65536, 4, 1),
                (65536, 8, 2)]


@pytest.mark.parametrize("log_n,w,canonical", RV32_LDE)
def test_rv32_lde_shapes(cuda, log_n, w, canonical):
    """The prover's LDE of one matrix: bit-reversed coefficients and the
    two cosets, against the same call on the CPU (the plain versions)."""
    from zkvm_prover_tpu_torch.stark import machine

    x = _rand(log_n + 3 * w, (1 << log_n, w), cuda)
    shift = pow(31, 1 << (17 - log_n), bb.P)
    for a, b in zip(machine._lde(x, shift, 1, canonical=canonical),
                    machine._lde(x.cpu(), shift, 1, canonical=canonical)):
        _same(a, b)


@pytest.mark.parametrize("log_n", RV32_CHUNKS)
def test_rv32_quotient_chunk_shapes(cuda, log_n):
    n = 1 << log_n
    q = _rand(log_n, (2 * n, 4), cuda)
    w_m = bb.two_adic_generator_int(log_n + 1)
    outs = []
    for dev in (cuda, "cpu"):
        out = torch.zeros((2 * n, 8), dtype=bb.DTYPE, device=dev)
        for r in range(2):
            c = ntt.interpolate_coset_rev(q.to(dev)[r::2], 31 * pow(w_m, r, bb.P) % bb.P)
            ntt.eval_coset_from_rev(c, 1, 31, out=out[:, 4 * r:4 * r + 4])
        outs.append(out)
    _same(*outs)


@pytest.mark.parametrize("rows,cols", RV32_HASH_ROWS)
def test_rv32_hash_rows_shapes(cuda, rows, cols):
    m = _rand(rows + cols, (rows, cols), cuda)
    _same(p2.hash_rows(m), p2.hash_rows_plain(m))


@pytest.mark.parametrize("log_h", RV32_TREES)
def test_rv32_tree_shapes(cuda, log_h):
    leaves = _rand(log_h, (1 << log_h, 8), cuda)
    for a, b in zip(p2.compress_levels(leaves, log_h),
                    p2.compress_levels_plain(leaves, log_h)):
        _same(a, b)


@pytest.mark.parametrize("transpose_a,r,c,k", [(False, *s) for s in RV32_K3_ROWS]
                         + [(True, *s) for s in RV32_K3_COLS])
def test_rv32_mont_matmul_shapes(cuda, transpose_a, r, c, k):
    a = _rand(r + c, (r, c), cuda)
    b = _rand(c + k, (r if transpose_a else c, 4 * k), cuda)
    _same(mm.mont_matmul(a, b, transpose_a), mm.mont_matmul_plain(a, b, transpose_a))


def test_small_rv32_proof_cuda_equals_cpu(cuda):
    """bench_guest_program(1, 4): 124 cycles, one keccak call, 18 AIRs."""
    from zkvm_prover_tpu_torch.models import rv32_v2
    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import fast_test_config
    from zkvm_prover_tpu_torch.vm import executor, guests

    prog = guests.bench_guest_program(1, 4)
    ex = executor.Rv32Executor()
    ex.load_program(prog)
    assert ex.run(1 << 18) == executor.HALTED
    air_traces = rv32_v2.generate_traces(prog, ex.records(), data_base=0x3000)
    insts = [machine.AirInstance(a, t, p) for a, t, p in air_traces]
    a = machine.prove_machine(insts, fast_test_config(), device=cuda)
    b = machine.prove_machine(insts, fast_test_config(), device="cpu")
    _proofs_equal(a, b)
    assert machine.verify_machine([x for x, _, _ in air_traces], a, fast_test_config())


def test_small_rv32_kernel_census(cuda):
    """The small rv32 proof on the card under the device-only profiler
    (`kernel_report.kernel_census`): every C entry point's kernels launched,
    the plain torch launches and the device's idle share, printed as one
    JSON line."""
    import json

    from zkvm_prover_tpu_torch import _build
    from zkvm_prover_tpu_torch.kernel_report import ENTRY_KERNELS, SNARK_ENTRIES, kernel_census
    from zkvm_prover_tpu_torch.models import rv32_v2
    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import fast_test_config
    from zkvm_prover_tpu_torch.vm import executor, guests

    prog = guests.bench_guest_program(1, 4)
    ex = executor.Rv32Executor()
    ex.load_program(prog)
    assert ex.run(1 << 18) == executor.HALTED
    air_traces = rv32_v2.generate_traces(prog, ex.records(), data_base=0x3000)
    insts = [machine.AirInstance(a, t, p) for a, t, p in air_traces]
    _build.lib()
    census = kernel_census(lambda: machine.prove_machine(insts, fast_test_config(), device=cuda))
    print("rv32 kernel census " + json.dumps(census), flush=True)
    launched = {k.split("<")[0] for k, v in census["per_kind"].items() if v["launches"]}
    assert all(launched & set(ks) for e, ks in ENTRY_KERNELS.items() if e not in SNARK_ENTRIES)
    assert 0 < census["device_busy_ms"] <= census["wall_ms"]


def test_ext_guest_proof_cuda_equals_cpu(cuda):
    """The ECDSA-verify guest at 16-bit scalars: every extension syscall
    family (modop, ec_add, ec_double, keccak, sha256, fp2, defer), 29 AIRs."""
    from zkvm_prover_tpu_torch.models import rv32_v2
    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import fast_test_config
    from zkvm_prover_tpu_torch.vm import executor, guests

    prog, _ = guests.ecdsa_verify_program(seed=3, scalar_bits=16)
    ex = executor.Rv32Executor()
    ex.load_program(prog)
    assert ex.run(1 << 18) == executor.HALTED and ex.exit_code == 0
    air_traces = rv32_v2.generate_traces(prog, ex.records(), data_base=guests.ECDSA_BASE)
    insts = [machine.AirInstance(a, t, p) for a, t, p in air_traces]
    a = machine.prove_machine(insts, fast_test_config(), device=cuda)
    b = machine.prove_machine(insts, fast_test_config(), device="cpu")
    _proofs_equal(a, b)
    assert machine.verify_machine([x for x, _, _ in air_traces], a, fast_test_config())


# ---------------------------------------------------------------------------
# the host entry point (zkvm_prover_tpu_torch/host)
# ---------------------------------------------------------------------------

HOST_WITNESS = {"fibonacci": {"log_n": 4, "x0": 1, "x1": 1},
                "fib-double": {"log_n_fib": 4, "log_n_dbl": 3}}


def _host_envelope(app_name, device):
    import json

    from zkvm_prover_tpu_torch.host import Prover, ProverConfig, ProvingTask
    from zkvm_prover_tpu_torch.stark.config import fast_test_config

    prover = Prover(ProverConfig(app_name, stark=fast_test_config(), device=device))
    task = ProvingTask(serialized_witness=[json.dumps(HOST_WITNESS[app_name]).encode()])
    return prover.gen_proof_stark(task)


@pytest.mark.parametrize("app_name", list(HOST_WITNESS))
def test_host_envelope_cuda_equals_cpu(cuda, app_name):
    a, b = _host_envelope(app_name, "cuda"), _host_envelope(app_name, "cpu")
    for name in ("proof", "user_pvs_proof", "baseline", "deferral_merkle_proofs"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.stat.total_cycles == b.stat.total_cycles


def test_host_prover_defaults_to_the_card(cuda):
    """ProverConfig(device=None) proves on the card: every kernel launches."""
    counters = (ntt_fused.launches, p2.launches, mm.launches)
    before = [dict(c) for c in counters]
    _host_envelope("fibonacci", None)
    for c, b in zip(counters, before):
        for key in c:
            assert c[key] > b[key], key


# ---------------------------------------------------------------------------
# a re-executed chunk (zkvm_prover_tpu_torch/execution)
# ---------------------------------------------------------------------------


def test_reexecuted_chunk_cuda_equals_cpu(cuda):
    """One block of real transactions (`chip_smoke.build_chain` from a seed:
    16 funded EOAs, 8 transactions with the L1 message, the contract
    creation, the precompile call and the reverting call) in a chunk task,
    re-executed and proved at fast_test_config() on cuda and on cpu: the
    envelopes are equal in every field but `stat`."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from zkvm_prover_tpu_torch.circuits.chunk_circuit import ChunkCircuit
    from zkvm_prover_tpu_torch.host import Prover, ProverConfig, ProvingTask
    from zkvm_prover_tpu_torch.stark.config import fast_test_config
    from zkvm_prover_tpu_torch.types.base.version import Version
    from zkvm_prover_tpu_torch.types.chunk.witness import ChunkWitness

    chain = chip_smoke.build_chain(chip_smoke.execution_api(), 5, accounts=16, signers=4,
                                   blocks=1, txs=8)
    version = Version.galileo_v2()
    w = ChunkWitness(version=version.as_version_byte(), blocks=[],
                     prev_msg_queue_hash=b"\x00" * 32, fork_name=version.fork,
                     prev_state_root=chain["genesis_root"], chain_id=chip_smoke.REEXEC_CHAIN_ID,
                     block_witnesses=chain["witnesses"])
    task = ProvingTask(serialized_witness=[ChunkCircuit.serialize_witness(w)])
    a, b = (Prover(ProverConfig("chunk", stark=fast_test_config(), device=device))
            .gen_proof_stark(task) for device in ("cuda", "cpu"))
    for name in ("proof", "user_pvs_proof", "baseline", "deferral_merkle_proofs"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.stat.total_cycles == b.stat.total_cycles


# ---------------------------------------------------------------------------
# recursion (zkvm_prover_tpu_torch/recursion)
# ---------------------------------------------------------------------------


def _tiny():
    from zkvm_prover_tpu_torch.stark.config import StarkConfig
    from zkvm_prover_tpu_torch.stark.fri import FriConfig

    return StarkConfig(fri=FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2))


def test_recursion_pre_roots_cuda_equal_cpu(cuda):
    """The preprocessed commitments of a wire program (WireAluAir and
    WirePoseidonAir at two heights), made on the card and on the host."""
    from zkvm_prover_tpu_torch.recursion import CircuitBuilder
    from zkvm_prover_tpu_torch.recursion import stark_verifier as sv

    bld = CircuitBuilder()
    acc = bld.const(3)
    for _ in range(40):
        acc = bld.mul(acc, bld.add(acc, bld.one()))
    for w in bld.poseidon([acc] * 16):
        bld.assert_zero(bld.mul(w, bld.zero()))
    insts = bld.finalize()
    airs = [i.air for i in insts]
    shape = sv.shape_of(airs, [int(i.trace.shape[0]).bit_length() - 1 for i in insts], _tiny())
    a, b = sv.compute_pre_roots(airs, shape, cuda), sv.compute_pre_roots(airs, shape, "cpu")
    assert sorted(a) == sorted(b) and len(a) == 2
    for lm in a:
        np.testing.assert_array_equal(a[lm], b[lm])


def test_recursion_leaf_node_cuda_equals_cpu(cuda):
    """A leaf node over one Fibonacci child at 2 queries: the node proof on
    the card equals the host's, and verifies."""
    from zkvm_prover_tpu_torch.models.fibonacci import FibonacciAir
    from zkvm_prover_tpu_torch.recursion import aggregation as agg
    from zkvm_prover_tpu_torch.stark import machine

    air = FibonacciAir()
    trace, pvs = air.generate_trace(3)
    child = machine.prove_machine([machine.AirInstance(air, trace, pvs)], _tiny(), device="cpu")
    proofs = {}
    for dev in (cuda, "cpu"):
        slot = agg.ChildSlot([FibonacciAir()], [3], _tiny(), dev)
        prog = agg.AggNodeProgram(agg.TAG_LEAF, [slot], _tiny(), dev)
        proofs[str(dev)], pi = prog.prove([child])
        assert prog.verify(proofs[str(dev)], expected_digest=pi)
    _proofs_equal(proofs["cuda"], proofs["cpu"])


# ---------------------------------------------------------------------------
# deferred aggregation (host/deferred.py) and continuations
# (models/rv32_continuations.py)
# ---------------------------------------------------------------------------


def _fibonacci_children(cfg, device, log_n):
    from zkvm_prover_tpu_torch.host import Prover, ProverConfig, ProvingTask

    prover = Prover(ProverConfig("fibonacci", stark=cfg, device=device))
    witness = [f'{{"log_n": {log_n}}}'.encode()]
    return [prover.gen_proof_stark(ProvingTask(identifier=f"child-{i}",
                                               serialized_witness=witness))
            for i in range(2)]


def test_deferred_envelope_cuda_equals_cpu(cuda):
    """A deferred envelope over two fibonacci children (log_n 3) at 2
    queries: the parent and discharge proofs made on the card equal the
    host's, and the card's envelope verifies."""
    from zkvm_prover_tpu_torch.host import DeferredProver, verify_deferred

    children = _fibonacci_children(_tiny(), "cpu", 3)
    a = DeferredProver(_tiny(), device=cuda).prove(children)
    b = DeferredProver(_tiny(), device="cpu").prove(children)
    for name in ("proof", "user_pvs_proof", "baseline", "deferral_merkle_proofs",
                 "input_commits", "deferral_discharge"):
        assert getattr(a, name) == getattr(b, name), name
    assert verify_deferred(a, _tiny(), device=cuda)


def test_segment_chain_cuda_equals_cpu(cuda):
    """A segmented keccak guest that reveals its digest (three 512-cycle
    segments) at 2 queries: the segment proofs made on the card equal the
    host's, and the card's chain verifies."""
    from zkvm_prover_tpu_torch.models import rv32_continuations as cont
    from zkvm_prover_tpu_torch.vm import asm

    msg, base, out = b"segmented keccak!", 0x3000, 0x3080
    body = []
    padded = msg + b"\x00" * (-len(msg) % 4)
    for i in range(0, len(padded), 4):
        body += asm.li("t0", int.from_bytes(padded[i:i + 4], "little"))
        body += asm.li("t1", base + i)
        body.append(asm.sw("t0", "t1", 0))
    body += [*asm.li("s0", 0), *asm.li("s1", 300), ("label", "spin1"),
             asm.addi("s0", "s0", 1), ("branch", asm.bne, "s0", "s1", "spin1")]
    body += asm.keccak256(base, len(msg), out)
    body += [*asm.li("s0", 0), ("label", "spin2"),
             asm.addi("s0", "s0", 1), ("branch", asm.bne, "s0", "s1", "spin2")]
    for w in range(8):      # verify_chain wants every PV word revealed once
        body += [*asm.li("t1", out + 4 * w), asm.lw("t0", "t1", 0), *asm.reveal("t0", w)]
    prog = asm.assemble(body + [asm.halt(0)])
    segs = cont.execute_segments(prog, 512, data_base=base)
    assert len(segs) == 3
    a = cont.prove_segments(prog, segs, _tiny(), data_base=base, device=cuda)
    b = cont.prove_segments(prog, segs, _tiny(), data_base=base, device="cpu")
    for x, y in zip(a, b):
        _proofs_equal(x.proof, y.proof)
    assert cont.verify_chain(a, _tiny(), device=cuda)


def test_deferred_over_chunk_child_cuda(cuda, tmp_path, monkeypatch):
    """A deferred aggregation over chunk 0's envelope at default_config():
    the child a real batch defers. Its discharge node verifies chunk 0's
    proof in a 2^24-row wire program; the envelope verifies through
    `UniversalVerifier` and a flipped child public value does not."""
    import time

    from zkvm_prover_tpu_torch.host import (DeferredAggApp, DeferredProver, StarkProof,
                                            UniversalVerifier)
    from zkvm_prover_tpu_torch.integration import ChunkTaskGenerator
    from zkvm_prover_tpu_torch.stark.config import default_config

    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path))
    cfg = default_config()
    gen = ChunkTaskGenerator(stark=cfg)
    t0 = time.perf_counter()
    chunk = gen.prover.gen_proof_stark(gen.task(0))
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    env = DeferredProver(cfg).prove([chunk], identifier="deferred-chunk-0")
    t2 = time.perf_counter()
    vk = DeferredAggApp().vk_bytes()
    assert UniversalVerifier.verify_stark_proof_with_vk(vk, env, cfg)
    t3 = time.perf_counter()
    bad = StarkProof.from_dict(env.to_dict())
    bad.agg_children[0].pvs[0] ^= 1
    assert not UniversalVerifier.verify_stark_proof_with_vk(vk, bad, cfg)
    print(f"chunk 0 {t1 - t0:.1f} s; DeferredProver.prove {t2 - t1:.1f} s; verify "
          f"{t3 - t2:.1f} s; peak {torch.cuda.max_memory_allocated()} bytes")


# ---------------------------------------------------------------------------
# K4: the BN254 MSM (zkvm_prover_tpu_torch/ops/msm.py, csrc/bn254_msm.cu)
# ---------------------------------------------------------------------------


def _msm_inputs(n, seed):
    """n points (distinct, with a repeat, an opposite pair and infinity) and
    scalars (0, r - 1, r + 3, a repeat, the rest below 2^256)."""
    from zkvm_prover_tpu_torch.fields import bn254 as bn

    rng = np.random.default_rng(seed)
    p = bn.g1_mul(bn.G1_GEN, int(rng.integers(1, 1 << 62)))
    step = bn.g1_mul(bn.G1_GEN, int(rng.integers(1, 1 << 62)))
    pts = []
    for _ in range(n):
        pts.append(p)
        p = bn.g1_add(p, step)
    sc = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    sc[0], sc[1], sc[2] = 0, bn.R - 1, bn.R + 3
    pts[3], pts[5], pts[6] = pts[4], None, bn.g1_neg(pts[7])
    sc[6] = sc[7]
    return pts, sc


def _skewed(sc, kind):
    """Scalars whose digits crowd into few buckets: all equal but a few
    (a selector polynomial's commitment), or two values."""
    if kind == "uniform":
        return sc
    if kind == "equal_but_3":
        return [sc[0]] * (len(sc) - 3) + sc[-3:]
    return [sc[i % 2] for i in range(len(sc))]


def _same_points(a, b):
    from zkvm_prover_tpu_torch.ops import msm

    assert msm.to_affine(a) == msm.to_affine(b)


@pytest.mark.parametrize("n,c,kind", [(8, 4, "uniform"), (100, 5, "uniform"),
                                      (512, 6, "uniform"), (512, 8, "uniform"),
                                      (3000, 9, "uniform"), (3000, 9, "equal_but_3"),
                                      (512, 6, "two_values"), (4096, 9, "equal_but_3")])
def test_msm_kernels_match_plain(cuda, n, c, kind):
    """Each entry of K4 against its plain version on the card, as affine
    points (Jacobian bits are free): the chunk partials, every level of the
    reduction (pieces, their buckets, the buckets written) and the window
    sums; the bucket step against the reference's segmented combine and the
    whole MSM against the host engine; uniform and skewed digits; the
    points given as a contiguous view one word into its storage (4-byte
    aligned only)."""
    from zkvm_prover_tpu_torch.fields import bn254_native
    from zkvm_prover_tpu_torch.ops import msm

    pts, sc = _msm_inputs(n, n + c)
    sc = _skewed(sc, kind)
    store = torch.zeros(16 * n + 1, dtype=torch.int32, device=cuda)
    view = store[1:].view(n, 16)
    view.copy_(msm.words_tensor(msm.affine_words(pts), cuda))
    assert view.data_ptr() % 16 == 4
    dig = msm.digits(msm.words_tensor(msm.scalar_words(sc), cuda), c)
    order, offsets = msm.sort_by_digit(dig, c)
    plan = msm.chunk_plan(order, offsets, (view == 0).all(-1), c)
    before = dict(msm.launches)
    buckets = torch.zeros((dig.shape[0], 1 << c, 24), dtype=torch.int32, device=cuda)
    ref_buckets = torch.zeros_like(buckets)
    pieces = msm.chunk_partials(view, plan, buckets)
    ref_pieces = msm.chunk_partials_plain(view, plan, ref_buckets)
    keys = plan.piece_key
    _same_points(pieces[keys >= 0], ref_pieces[keys >= 0])
    _same_points(buckets, ref_buckets)
    levels = 0
    while keys.shape[0] > 2:
        ref_buckets = buckets.clone()
        nxt, nkeys = msm.reduce_segments(pieces, keys, buckets)
        ref_nxt, ref_keys = msm.reduce_level_plain(pieces, keys, ref_buckets)
        assert torch.equal(nkeys, ref_keys)
        _same_points(nxt[nkeys >= 0], ref_nxt[nkeys >= 0])
        _same_points(buckets, ref_buckets)
        pieces, keys, levels = nxt, nkeys, levels + 1
    _same_points(buckets, msm.window_buckets_plain(view, dig, c))
    _same_points(msm.window_buckets(view, dig, c), buckets)
    sums = msm.window_sums(buckets, c)
    _same_points(sums, msm.window_sums_plain(buckets, c))
    assert msm.combine_windows(sums, c) == bn254_native.msm(pts, sc)
    assert msm.launches["bn254_msm_chunks"] == before["bn254_msm_chunks"] + 2
    assert msm.launches["bn254_msm_reduce"] == before["bn254_msm_reduce"] + 2 * levels
    assert msm.launches["bn254_msm_window_sums"] == before["bn254_msm_window_sums"] + 1
    for log_s in range(max(0, c - 3), c + 1):
        _same_points(msm.window_sums(buckets, c, log_s), sums)
    with pytest.raises(ValueError):
        msm.window_buckets(torch.zeros((2 * n, 16), dtype=torch.int32, device=cuda)[::2],
                           dig, c)


@pytest.mark.parametrize("n,kind", [(8, "repeated"), (1 << 12, "uniform"),
                                    (1 << 13, "uniform"), (1 << 13, "equal_scalars"),
                                    (1 << 13, "equal_points")])
def test_msm_jac_on_cuda_is_k4(cuda, n, kind):
    """msm_jac on the card: one launch of the chunk and window-sum entries
    and at least one of the reduction, the host engine's point: a
    repeated-scalar case at 8 (every point in one bucket a window), uniform
    scalars, all scalars equal (each window one bucket of n points) and all
    points equal at 2^13."""
    from zkvm_prover_tpu_torch.fields import bn254 as bn
    from zkvm_prover_tpu_torch.fields import bn254_native
    from zkvm_prover_tpu_torch.ops import msm

    pts, sc = _msm_inputs(n, n)
    if kind == "repeated":
        sc = [0x1111111111111111] * n
    elif kind == "equal_scalars":
        sc = [sc[1]] * n
    elif kind == "equal_points":
        pts = [pts[4]] * n
    before = dict(msm.launches)
    assert bn.msm_jac(pts, sc, device=cuda) == bn254_native.msm(pts, sc)
    assert msm.launches["bn254_msm_chunks"] == before["bn254_msm_chunks"] + 1
    assert msm.launches["bn254_msm_window_sums"] == before["bn254_msm_window_sums"] + 1
    assert msm.launches["bn254_msm_reduce"] >= before["bn254_msm_reduce"] + (n > 8)


def test_fq_kernel_matches_plain(cuda):
    from zkvm_prover_tpu_torch.fields import bn254 as bn
    from zkvm_prover_tpu_torch.ops import bigint, msm

    rng = np.random.default_rng(3)
    xs = [int.from_bytes(rng.bytes(32), "little") % bn.Q for _ in range(4096)]
    ys = [int.from_bytes(rng.bytes(32), "little") % bn.Q for _ in range(4096)]
    xs[:4], ys[:4] = [0, 1, bn.Q - 1, bn.Q - 1], [bn.Q - 1, bn.Q - 1, bn.Q - 1, 0]
    words = lambda v: msm.words_tensor(np.frombuffer(  # noqa: E731
        b"".join(x.to_bytes(32, "little") for x in v), dtype=np.uint32).reshape(-1, 8), cuda)
    a, b = words(xs), words(ys)
    got = msm.fq_mul(a, b)
    want = bigint.to_words(bigint.BN254_FQ.mul(bigint.from_words(a), bigint.from_words(b)))
    assert torch.equal(got, want)
    r_inv = pow(1 << 256, -1, bn.Q)
    assert [int.from_bytes(r.tobytes(), "little") for r in got.cpu().numpy().view(np.uint32)] \
        == [x * y * r_inv % bn.Q for x, y in zip(xs, ys)]


def test_cuda_msm_does_not_fall_back(cuda, monkeypatch):
    """Without the kernel library a CUDA MSM raises, and so does every K4
    entry on CUDA tensors: neither the host engine, the python path nor a
    plain version answers for it."""
    from zkvm_prover_tpu_torch import _build
    from zkvm_prover_tpu_torch.fields import bn254 as bn
    from zkvm_prover_tpu_torch.fields import bn254_native
    from zkvm_prover_tpu_torch.ops import msm

    def missing():
        raise RuntimeError("the kernel library is missing")

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA MSM reached the host engine or a plain version")

    pts, sc = _msm_inputs(64, 1)
    c = msm.window_bits(64)
    p = msm.words_tensor(msm.affine_words(pts), cuda)
    dig = msm.digits(msm.words_tensor(msm.scalar_words(sc), cuda), c)
    order, offsets = msm.sort_by_digit(dig, c)
    plan = msm.chunk_plan(order, offsets, (p == 0).all(-1), c)
    buckets = torch.zeros((dig.shape[0], 1 << c, 24), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", missing)
    for name in ("chunk_partials_plain", "reduce_level_plain", "window_sums_plain",
                 "window_buckets_plain"):
        monkeypatch.setattr(msm, name, refuse)
    monkeypatch.setattr(bn254_native, "msm", refuse)
    before = dict(msm.launches)
    entries = {
        "bn254_msm_chunks": lambda: msm.chunk_partials(p, plan, buckets),
        "bn254_msm_reduce": lambda: msm.reduce_segments(
            torch.zeros((4, 24), dtype=torch.int32, device=cuda), plan.piece_key[:4].contiguous(),
            buckets),
        "bn254_msm_window_sums": lambda: msm.window_sums(buckets, c),
        "bn254_fq_mul": lambda: msm.fq_mul(p[:, :8].contiguous(), p[:, 8:].contiguous()),
        "window_buckets": lambda: msm.window_buckets(p, dig, c),
        "msm_jac": lambda: bn.msm_jac(pts, sc, device=cuda),
        "kzg_commit": lambda: bn.kzg_commit(bn.KzgSrs(pts, bn.G2_GEN), sc, device=None),
    }
    assert set(msm.launches) <= set(entries)
    for name, call in entries.items():
        with pytest.raises(RuntimeError, match="kernel library is missing"):
            call()
    assert msm.launches == before


def test_evm_proof_cuda_equals_cpu(cuda):
    """The fibonacci app's EvmProof (`gen_proof_universal(with_snark=True)`)
    built on the card equals the one built on the CPU, and verifies on
    both."""
    import json

    from zkvm_prover_tpu_torch.host import Prover, ProverConfig, ProvingTask, UniversalVerifier
    from zkvm_prover_tpu_torch.ops import msm
    from zkvm_prover_tpu_torch.stark.config import fast_test_config

    task = ProvingTask(serialized_witness=[json.dumps(HOST_WITNESS["fibonacci"]).encode()])
    before = msm.launches["bn254_msm_chunks"]
    eps = {d: Prover(ProverConfig("fibonacci", stark=fast_test_config(), device=d))
           .gen_proof_universal(task, with_snark=True) for d in ("cuda", "cpu")}
    assert msm.launches["bn254_msm_chunks"] > before
    assert (eps["cuda"].proof, eps["cuda"].instances) == (eps["cpu"].proof, eps["cpu"].instances)
    for d in ("cuda", "cpu"):
        assert UniversalVerifier("fibonacci", fast_test_config(), device=d) \
            .verify_evm_proof(eps[d])


# ---------------------------------------------------------------------------
# parallel/ (the sharded NTT on logical shards of the card, the leaf pool),
# the rv32 chipset v0, chunk_benchmark
# ---------------------------------------------------------------------------


def test_sharded_ntt_four_shards_of_the_card(cuda):
    """The four-step NTT at (2^22, 2) over four logical shards of the card
    equals the single-device transform."""
    from zkvm_prover_tpu_torch.parallel.mesh import make_mesh
    from zkvm_prover_tpu_torch.parallel.ntt_sharded import ntt_natural_to_rev_sharded

    x = _rand(22, (1 << 22, 2), cuda)
    mesh = make_mesh(4, devices=[cuda] * 4)
    _same(ntt_natural_to_rev_sharded(x, mesh).gather(), ntt.ntt_natural_to_rev(x))


def test_leaf_pool_on_the_card_equals_serial(cuda):
    """Two sibling leaf nodes (2 queries) proved by two spawned workers on
    the card: each byte-equal to the same node proved serially here."""
    from zkvm_prover_tpu_torch.host import serialization
    from zkvm_prover_tpu_torch.host.app import get_app
    from zkvm_prover_tpu_torch.models.fibonacci import FibonacciAir
    from zkvm_prover_tpu_torch.recursion import aggregation as agg
    from zkvm_prover_tpu_torch.stark import machine

    air = FibonacciAir()
    kids = [machine.prove_machine([machine.AirInstance(air, *air.generate_trace(3, 0, x1))],
                                  _tiny(), device=cuda) for x1 in (1, 2)]
    slot = agg.ChildSlot([FibonacciAir()], [3], _tiny())
    serial, _ = agg.AggNodeProgram(agg.TAG_LEAF, [slot, slot], _tiny()).prove(kids)
    pooled = agg._prove_leaf_nodes_pool([kids, kids], get_app("fibonacci").vk_bytes(),
                                        slot, _tiny(), 2)
    for p, stat in pooled:
        assert serialization.encode_machine_proof(p) == \
            serialization.encode_machine_proof(serial)
        # each worker reports its own launches and C calls
        assert stat["device"] == "cuda" and stat["calls"]
        assert all(stat["launches"][k] for k in ("ntt_pass", "poseidon2_hash_rows",
                                                  "poseidon2_compress", "mont_matmul_rows"))


def test_rv32_v0_proof_cuda_equals_cpu(cuda):
    """The v0 chipset's straight-line program proved at fast_test_config()
    on the card and on the host: equal but for `stat`; the card's verifies."""
    from zkvm_prover_tpu_torch.models import rv32_v0
    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import fast_test_config
    from zkvm_prover_tpu_torch.vm import asm

    words = asm.assemble([asm.addi("t0", "zero", 5), asm.addi("t1", "zero", 7),
                          asm.add("t2", "t0", "t1"), asm.sub("t3", "t2", "t0"), asm.halt(0)])
    _, _, air_traces = rv32_v0.execute_and_trace(words)
    insts = [machine.AirInstance(a, t, []) for a, t in air_traces]
    a = machine.prove_machine(insts, fast_test_config(), device=cuda)
    b = machine.prove_machine(insts, fast_test_config(), device="cpu")
    _proofs_equal(a, b)
    assert machine.verify_machine([x for x, _ in air_traces], a, fast_test_config(), device=cuda)


def test_rv32_v1_proof_cuda_equals_cpu(cuda):
    """The v1 chipset's array-sum loop (branches, LW/SW) proved at
    fast_test_config() on the card and on the host: equal but for `stat`;
    the card's verifies, and not against another program."""
    from zkvm_prover_tpu_torch.models import rv32_v1
    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import fast_test_config
    from zkvm_prover_tpu_torch.vm import asm

    words = asm.assemble([
        asm.lui("s2", 1), asm.addi("t0", "zero", 1), asm.addi("t1", "zero", 0),
        asm.addi("t2", "zero", 40), ("label", "fill"), asm.add("t6", "s2", "t1"),
        asm.sw("t0", "t6", 0), asm.addi("t0", "t0", 3), asm.addi("t1", "t1", 4),
        ("branch", asm.bne, "t1", "t2", "fill"), asm.addi("s0", "zero", 0),
        asm.addi("t1", "zero", 0), ("label", "sum"), asm.add("t6", "s2", "t1"),
        asm.lw("t3", "t6", 0), asm.add("s0", "s0", "t3"), asm.addi("t1", "t1", 4),
        ("branch", asm.bne, "t1", "t2", "sum"), ("jal", "ra", "done"),
        asm.addi("s0", "zero", 0), ("label", "done"), asm.halt(0)])
    ex, _, air_traces = rv32_v1.execute_and_trace(words)
    assert ex.get_reg(asm.REGS["s0"]) == sum(1 + 3 * i for i in range(10))
    insts = [machine.AirInstance(a, t, []) for a, t in air_traces]
    a = machine.prove_machine(insts, fast_test_config(), device=cuda)
    b = machine.prove_machine(insts, fast_test_config(), device="cpu")
    _proofs_equal(a, b)
    airs = [x for x, _ in air_traces]
    assert machine.verify_machine(airs, a, fast_test_config(), device=cuda)
    other = list(words)
    other[1] = asm.assemble([asm.addi("t0", "zero", 2)])[0]
    assert not machine.verify_machine([airs[0], rv32_v1.ProgramAirV1(other)] + airs[2:], a,
                                      fast_test_config(), device=cuda)


def test_chunk_benchmark_on_the_card(cuda, tmp_path, monkeypatch, capsys):
    """`python -m zkvm_prover_tpu_torch.bin.chunk_benchmark` at
    default_config() on the card: its JSON stats (printed with -s) and
    metrics.json."""
    import json

    from zkvm_prover_tpu_torch.bin import chunk_benchmark

    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "run"))
    metrics = tmp_path / "metrics.json"
    chunk_benchmark.main(["--metrics", str(metrics)])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    with capsys.disabled():
        print(f"\nchunk_benchmark: {out}")
    stats = json.loads(out)
    assert stats["device"].startswith("cuda") and stats["cycles_per_gas"] <= 35
    assert set(json.loads(metrics.read_text())) == {"chunk/execute", "chunk/prove"}
