"""The port's Poseidon2 (kernel K2's plain path on the CPU, and the host
permutations), the challenger and Merkle commitments against the JAX package's
`ops/poseidon2.py` and `stark/merkle.py`. Most cases use the reference's
numpy entry points (no compile); one uses jnp. Every comparison is exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest

from zkvm_prover_tpu.fields import babybear as ref_bb
from zkvm_prover_tpu.ops import p2_native as ref_native
from zkvm_prover_tpu.ops import poseidon2 as ref_p2
from zkvm_prover_tpu.stark import merkle as ref_merkle
from zkvm_prover_tpu.stark.challenger import Challenger as RefChallenger
from zkvm_prover_tpu_torch import convert
from zkvm_prover_tpu_torch.fields import babybear as bb
from zkvm_prover_tpu_torch.ops import poseidon2 as p2
from zkvm_prover_tpu_torch.stark import merkle
from zkvm_prover_tpu_torch.stark.challenger import Challenger

P = ref_bb.P


def _rand(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return bb.as_tensor(a, "cpu")


def _same(got, want):
    np.testing.assert_array_equal(bb.to_numpy(got), np.asarray(want, np.uint32))


@pytest.fixture
def restore_constants():
    """Save and restore both packages' constant overrides."""
    ref_saved = dict(ref_p2._OVERRIDES)
    port_saved = dict(p2._OVERRIDES)
    yield
    ref_p2._OVERRIDES.clear()
    ref_p2._OVERRIDES.update(ref_saved)
    ref_native.reset()
    p2.reset_constants()
    p2._OVERRIDES.update(port_saved)


@pytest.mark.parametrize("width", [16, 24])
def test_constants_match(width):
    for mine, ref in zip(p2.constants(width), ref_p2.constants(width)):
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("width", [16, 24])
def test_permute(width):
    s = _rand(width, (7, width))
    s[0] = 0
    _same(p2.permute(_t(s)), ref_p2.permute_np(s))


@pytest.mark.parametrize("width", [16, 24])
def test_host_permute_np(width):
    s = _rand(width + 1, (5, width))
    np.testing.assert_array_equal(p2.permute_np(s), ref_p2.permute_np(s))


def test_challenger_matches_reference():
    """The port's transcript (observe, sample, sample_bits, grind) equals
    the reference challenger's, value for value."""
    mine, ref = Challenger(), RefChallenger()
    vals = _rand(3, (21,))
    for c in (mine, ref):
        c.observe_slice(vals[:13])
    assert [mine.sample() for _ in range(11)] == [ref.sample() for _ in range(11)]
    for c in (mine, ref):
        c.observe_slice(vals[13:])
    assert mine.sample_ext().tolist() == ref.sample_ext().tolist()
    assert mine.sample_bits(7) == ref.sample_bits(7)
    assert mine.grind(6, device="cpu", batch=16) == ref.grind(6, batch=16)
    assert mine.sample() == ref.sample()


def test_grind_without_device_needs_a_card(monkeypatch):
    """device=None means the card; with none it raises, never falls back."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Challenger().grind(4)


def test_permute_jnp_reference():
    s = _rand(4, (6, 16))
    _same(p2.permute(_t(s)), np.asarray(ref_p2.permute(jnp.asarray(s))))


@pytest.mark.parametrize("cols", [1, 8, 9, 495])
def test_hash_rows(cols):
    m = _rand(cols, (6, cols))
    _same(p2.hash_rows(_t(m)), ref_p2.hash_rows_np(m))
    np.testing.assert_array_equal(p2.hash_rows_np(m), ref_p2.hash_rows_np(m))


def test_compress():
    left, right = _rand(5, (9, 8)), _rand(6, (9, 8))
    _same(p2.compress(_t(left), _t(right)), ref_p2.compress_np(left, right))
    _same(p2.compress16(_t(np.concatenate([left, right], 1))),
          ref_p2.compress_np(left, right))
    np.testing.assert_array_equal(p2.compress_np(left, right),
                                  ref_p2.compress_np(left, right))


def test_load_reference_constants(restore_constants):
    """The same override reaches both packages and changes both alike."""
    ext = _rand(10, (8, 16))
    internal = _rand(11, (13,))
    diag = _rand(12, (16,))
    s = _rand(13, (4, 16))
    before = bb.to_numpy(p2.permute(_t(s)))
    ref_p2.load_constants(16, ext, internal, diag)
    convert.load_reference_constants(ext, internal, diag)
    after = bb.to_numpy(p2.permute(_t(s)))
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, ref_p2.permute_np(s))
    np.testing.assert_array_equal(p2.permute_np(s), after)


# ---------------------------------------------------------------------------
# Merkle commitments
# ---------------------------------------------------------------------------

MIXED = [[(16, 3)], [(16, 9), (16, 2)], [(32, 5), (8, 4), (4, 1)],
         [(64, 17), (64, 8), (16, 3), (2, 6)], [(2048, 4), (4, 2)],
         [(8, 2), (1, 3)], [(1, 5)]]


@pytest.mark.parametrize("shapes", MIXED, ids=["one", "same-height",
                                               "mixed", "mixed-wide",
                                               "tall-skip", "joins-root",
                                               "one-row"])
def test_merkle_root_and_openings(shapes):
    mats = [_rand(17 * i + h, (h, w)) for i, (h, w) in enumerate(shapes)]
    ref_tree = ref_merkle.commit(mats)
    tree = merkle.commit([_t(m) for m in mats])
    np.testing.assert_array_equal(tree.root_np(), ref_tree.root_np())
    for lvl, ref_lvl in zip(tree.levels, ref_tree.levels):
        _same(lvl, ref_lvl)
    h_max = shapes[0][0]
    idx = sorted({0, h_max - 1, h_max // 2, min(1, h_max - 1)})
    heights = [h for h, _ in shapes]
    ops = merkle.open_indices(tree, idx)
    for op, i in zip(ops, idx):
        ref_op = ref_merkle.open_index(ref_tree, i)
        assert op.index == ref_op.index
        for a, b in zip(op.rows + op.siblings, ref_op.rows + ref_op.siblings):
            np.testing.assert_array_equal(a, b)
    assert merkle.verify_openings(tree.root_np(), ops, heights)
    assert ref_merkle.verify_openings(ref_tree.root_np(), ops, heights)


@pytest.mark.parametrize("log_h", [1, 4, 11])
def test_compress_levels(log_h):
    """Every level above the leaves from one call, against the reference's
    level loop (`_commit_levels`)."""
    m = _rand(50 + log_h, (1 << log_h, 3))
    ref_levels = ref_merkle._commit_levels([m])
    got = p2.compress_levels(_t(ref_levels[0]), log_h)
    assert len(got) == log_h
    for lvl, ref_lvl in zip(got, ref_levels[1:]):
        _same(lvl, ref_lvl)
    with pytest.raises(ValueError):
        p2.compress_levels(_t(ref_levels[0]), log_h + 1)


def test_merkle_rejects_bad_openings():
    mats = [_rand(40, (16, 5))]
    tree = merkle.commit([_t(m) for m in mats])
    root = tree.root_np()
    ops = merkle.open_indices(tree, [3, 8])
    assert merkle.verify_openings(root, ops, [16])
    bad = merkle.open_indices(tree, [3, 8])
    bad[0].rows[0][2] ^= 1
    assert not merkle.verify_openings(root, bad, [16])
    bad = merkle.open_indices(tree, [3, 8])
    bad[1].siblings[2][0] ^= 1
    assert not merkle.verify_openings(root, bad, [16])
    bad = merkle.open_indices(tree, [3, 8])
    bad[1].index = 9
    assert not merkle.verify_openings(root, bad, [16])


def test_merkle_ragged_rows_return_false():
    """Ragged rows or siblings give False (the reference raises ValueError
    there; the port does not copy that)."""
    tree = merkle.commit([_t(_rand(41, (8, 4)))])
    root = tree.root_np()
    ops = merkle.open_indices(tree, [1, 2])
    ops[1].rows[0] = ops[1].rows[0][:3]
    assert merkle.verify_openings(root, ops, [8]) is False
    ops = merkle.open_indices(tree, [1, 2])
    ops[0].siblings[0] = ops[0].siblings[0][:5]
    assert merkle.verify_openings(root, ops, [8]) is False
