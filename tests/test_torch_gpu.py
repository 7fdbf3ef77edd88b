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


@pytest.mark.parametrize("r,c", [(1, 1), (37, 495), (4096, 8), (5000, 33)])
def test_mont_matmul_rows(cuda, r, c):
    a, b = _rand(r, (r, c), cuda), _rand(c, (c, 4), cuda)
    _same(mm.mont_matmul(a, b), mm.mont_matmul_plain(a, b))


@pytest.mark.parametrize("r,c", [(1, 1), (3000, 495), (70000, 4)])
def test_mont_matmul_cols(cuda, r, c):
    a, b = _rand(r, (r, c), cuda), _rand(c + 1, (r, 4), cuda)
    _same(mm.mont_matmul(a, b, transpose_a=True),
          mm.mont_matmul_plain(a, b, transpose_a=True))


def test_wrappers_reject_bad_input(cuda):
    x = _rand(4, (64, 6), cuda)
    with pytest.raises(ValueError):
        ntt_fused.block_stages(x[:, ::2], 4)  # not contiguous
    with pytest.raises(TypeError):
        p2.hash_rows(x.to(torch.int64))
    with pytest.raises(ValueError):
        mm.mont_matmul(x, _rand(5, (5, 4), cuda))


def test_wrappers_reject_misaligned_input(cuda):
    """Views one word past an aligned start: the kernels read these as
    16-byte vectors, so the wrappers raise before launching."""
    with pytest.raises(ValueError):
        p2.permute(_rand(6, (16 * 8 + 1,), cuda)[1:].view(8, 16))
    with pytest.raises(ValueError):
        p2.compress16(_rand(7, (16 * 8 + 1,), cuda)[1:].view(8, 16))
    with pytest.raises(ValueError):
        p2.compress_levels(_rand(7, (8 * 8 + 1,), cuda)[1:].view(8, 8), 3)
    a = _rand(8, (8, 5), cuda)
    with pytest.raises(ValueError):
        mm.mont_matmul(a, _rand(9, (4 * 5 + 1,), cuda)[1:].view(5, 4))


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
