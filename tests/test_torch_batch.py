"""The port's batch and bundle layers (`zkvm_prover_tpu_torch/utils/zstd.py`,
`fields/bls12_381.py`, `types/batch`, `types/bundle`,
`circuits/{batch,bundle}_circuit.py`, the batch and bundle apps and task
generators) against the JAX package's, exactly.

- zstd: the port's decoder gives the bytes `zstandard` gives on a corpus
  of frames that `zstandard` wrote (sizes, data kinds, levels, checksum and
  content-size flags, multi-block frames, a hypothesis property), raises
  where `zstandard` raises, and its counter shows every block, literals
  and sequence-mode type; the port's Raw-block writer round-trips through
  both decoders.
- BLS12-381 and KZG: group operations, encodings, the pairing value and
  `verify_kzg_proof` equal the reference's.
- The blob, the headers, the v6/v7 envelopes and payloads, the builders
  and the circuits equal the reference's on the cases of
  `tests/test_batch_types.py`, `tests/test_payload_v6_validium.py` and
  `tests/test_e2e_chain.py`; rejections raise in both.
- The batch and bundle apps execute the reference's witnesses (carried by
  `convert.witness_from_reference`) to the reference's machine; a task the
  reference pickled raises `pickle.UnpicklingError` in the port.
- The port's generators build witnesses that the reference's circuits
  accept, and the port's packages import without `jax`, `zstandard`,
  `cryptography` or the reference.
- Under `slow`: the batch and bundle envelopes at a tiny config equal the
  reference's and cross-verify.
"""

import copy
import dataclasses
import enum
import json
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

import zkvm_prover_tpu.circuits.batch_circuit as ref_batch_circuit_mod
import zkvm_prover_tpu.types.base as ref_base
import zkvm_prover_tpu.types.batch as ref_batch
import zkvm_prover_tpu.types.batch.builder as ref_builder
import zkvm_prover_tpu.types.batch.header as ref_header
import zkvm_prover_tpu.types.batch.payload as ref_payload
import zkvm_prover_tpu.types.batch.witness as ref_batch_witness
import zkvm_prover_tpu.types.bundle as ref_bundle
import zkvm_prover_tpu.types.chunk.witness as ref_chunk_witness
from zkvm_prover_tpu.circuits import BatchCircuit as RefBatchCircuit
from zkvm_prover_tpu.circuits import BundleCircuit as RefBundleCircuit
from zkvm_prover_tpu.circuits import ChunkCircuit as RefChunkCircuit
from zkvm_prover_tpu.fields import bls12_381 as ref_bls
from zkvm_prover_tpu.host import ProofEnum as RefProofEnum
from zkvm_prover_tpu.host import ProvingTask as RefProvingTask
from zkvm_prover_tpu.host import UniversalVerifier as RefVerifier
from zkvm_prover_tpu.host.app import get_app as ref_get_app
from zkvm_prover_tpu.integration import BatchTaskGenerator as RefBatchTaskGenerator
from zkvm_prover_tpu.integration import BundleTaskGenerator as RefBundleTaskGenerator
from zkvm_prover_tpu.integration import ChunkTaskGenerator as RefChunkTaskGenerator
from zkvm_prover_tpu.ops.keccak import keccak256 as ref_keccak256
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import StarkConfig as RefStarkConfig
from zkvm_prover_tpu.stark.fri import FriConfig as RefFriConfig
from zkvm_prover_tpu.types.batch import blob as ref_blob
from zkvm_prover_tpu_torch import convert
from zkvm_prover_tpu_torch.circuits import BatchCircuit, BundleCircuit, ChunkCircuit
from zkvm_prover_tpu_torch.circuits.batch_circuit import BatchCircuitWitness
from zkvm_prover_tpu_torch.fields import bls12_381 as bls
from zkvm_prover_tpu_torch.host import ProofEnum, Prover, ProverConfig, ProvingTask
from zkvm_prover_tpu_torch.host import UniversalVerifier, scroll_apps
from zkvm_prover_tpu_torch.host.app import app_for_vk, get_app
from zkvm_prover_tpu_torch.integration import BatchTaskGenerator, BundleTaskGenerator
from zkvm_prover_tpu_torch.integration import ChunkTaskGenerator
from zkvm_prover_tpu_torch.ops.keccak import keccak256
from zkvm_prover_tpu_torch.stark.config import StarkConfig
from zkvm_prover_tpu_torch.stark.fri import FriConfig
from zkvm_prover_tpu_torch.types import base as port_base
from zkvm_prover_tpu_torch.types import batch as port_batch
from zkvm_prover_tpu_torch.types.batch import blob as port_blob
from zkvm_prover_tpu_torch.types.batch import builder as port_builder
from zkvm_prover_tpu_torch.types.batch import header as port_header
from zkvm_prover_tpu_torch.types.batch import payload as port_payload
from zkvm_prover_tpu_torch.types.batch import witness as port_batch_witness
from zkvm_prover_tpu_torch.types import bundle as port_bundle
from zkvm_prover_tpu_torch.types.chunk import witness as port_chunk_witness
from zkvm_prover_tpu_torch.utils import zstd

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 1 << 26                 # the envelope codec's max_output_size
PACKAGES = ("reference", "port")
ZSTD = zstandard.ZstdDecompressor()


@pytest.fixture(scope="module", autouse=True)
def _restore_tau_g2_overrides():
    """Both packages' BatchCircuit keep the KZG test setup in a class
    attribute; put back what was there when the module ends."""
    saved = RefBatchCircuit.tau_g2_override, BatchCircuit.tau_g2_override
    yield
    RefBatchCircuit.tau_g2_override, BatchCircuit.tau_g2_override = saved


# ---------------------------------------------------------------------------
# zstd: the corpus
# ---------------------------------------------------------------------------

_WORDS = ("the of and to in is was for on that with as by at from his her an were are "
          "which this be or has had not but one all their they it first new more after "
          "batch chunk bundle proof blob envelope commitment header payload state root "
          "block withdraw queue message hash prover verifier").split()


def _data(kind: str, n: int, seed: int = 0) -> bytes:
    """Seeded corpus inputs: random bytes, word-salad text, runs of one
    byte (random bytes, random run lengths)."""
    rng = np.random.default_rng([seed, n, len(kind)])
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "text":
        words = rng.integers(0, len(_WORDS), n // 2 + 1)
        return " ".join(_WORDS[int(w)] for w in words).encode()[:n]
    out = bytearray()
    while len(out) < n:
        out += bytes([int(rng.integers(256))]) * int(rng.integers(1, 300))
    return bytes(out[:n])


def _frame(data: bytes, level: int, checksum: bool = False, content_size: bool = True):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


def _decode_both(frame: bytes, limit: int = LIMIT):
    """(zstandard's result, the port's): bytes, or the exception's type."""
    out = []
    for fn in (lambda: ZSTD.decompress(frame, max_output_size=limit),
               lambda: zstd.decompress(frame, limit)):
        try:
            out.append(fn())
        except Exception as e:          # noqa: BLE001 (compared below)
            out.append(type(e))
    return out


def _assert_same(frame: bytes, expect: bytes = None):
    ref, port = _decode_both(frame)
    assert isinstance(ref, bytes), ref
    assert port == ref
    if expect is not None:
        assert port == expect


FLAGS = [(ck, cs) for ck in (False, True) for cs in (False, True)]


@pytest.mark.parametrize("level", [1, 3, 9, 19])
@pytest.mark.parametrize("size", [0, 1, 31, 350, 4096, 20480])
@pytest.mark.parametrize("kind", ["random", "text", "runs"])
def test_zstd_decoder_equals_zstandard(kind, size, level):
    data = _data(kind, size)
    for checksum, content_size in FLAGS:
        _assert_same(_frame(data, level, checksum, content_size), data)


@pytest.fixture(scope="module")
def chunk_payloads(tmp_path_factory):
    """PayloadV7 bytes of ChunkTaskGenerator chunks 0-3, one batch each."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OUTPUT_DIR", str(tmp_path_factory.mktemp("payloads")))
    try:
        gen = ChunkTaskGenerator(device="cpu")
    finally:
        mp.undo()
    out = []
    for i in range(4):
        w = gen.witness(i)
        info, version = ChunkCircuit.validate(w)
        out.append(port_batch.PayloadV7(
            version=int(version.stf_version),
            prev_msg_queue_hash=info.prev_msg_queue_hash,
            post_msg_queue_hash=info.post_msg_queue_hash,
            initial_block_number=info.initial_block_number,
            num_blocks=len(info.block_ctxs), block_contexts=info.block_ctxs,
            tx_data=b"".join(tx for b in w.blocks for tx in b.encoded_l2_txs)).to_bytes())
    return out


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_zstd_decoder_equals_zstandard_on_chunk_payloads(chunk_payloads, i):
    data = chunk_payloads[i]
    for level in (1, 3, 9, 19):
        for checksum, content_size in FLAGS:
            _assert_same(_frame(data, level, checksum, content_size), data)


@pytest.mark.parametrize("level", [3, 19])
@pytest.mark.parametrize("kind", ["random", "text", "runs"])
def test_zstd_decoder_equals_zstandard_at_the_largest_envelope_body(kind, level):
    """126,971 bytes: the largest body an envelope holds."""
    assert port_blob.N_BLOB_BYTES - 5 == 126_971
    data = _data(kind, 126_971)
    _assert_same(_frame(data, level), data)


def _multi_block_inputs():
    """Inputs over 128 KiB: text, one byte repeated (an RLE block), and a
    random block followed by 32-byte slices of it each with a 'Q' (at level
    19 the second block's literals are all 'Q': RLE literals)."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, 1 << 17, dtype=np.uint8).tobytes()
    starts = rng.integers(0, (1 << 17) - 64, 600)
    return {
        "text": _data("text", 300_000, 7),
        "one_byte": b"\x07" * 200_000,
        "slices": base + b"".join(base[int(s):int(s) + 32] + b"Q" for s in starts),
    }


MULTI_BLOCK = _multi_block_inputs()


@pytest.mark.parametrize("name", sorted(MULTI_BLOCK))
def test_zstd_decoder_equals_zstandard_on_multi_block_frames(name):
    data = MULTI_BLOCK[name]
    for checksum in (False, True):
        _assert_same(_frame(data, 19, checksum), data)


@settings(max_examples=50, deadline=None, database=None)
@given(data=st.binary(max_size=4096), level=st.sampled_from([1, 3, 9, 19]),
       checksum=st.booleans(), content_size=st.booleans())
def test_zstd_decoder_property(data, level, checksum, content_size):
    _assert_same(_frame(data, level, checksum, content_size), data)


def test_zstd_counter_shows_every_type():
    """The decoder's counter over a corpus that reaches every block,
    literals and sequence-mode type `zstandard` writes."""
    rng = np.random.default_rng(1)
    frames = [_frame(_data(k, n), lv) for k in ("random", "text", "runs")
              for n in (350, 20480) for lv in (1, 19)]
    frames += [_frame(d, 19) for d in MULTI_BLOCK.values()]
    frames += [_frame(MULTI_BLOCK["text"], 9)]       # its third block repeats a table
    frames += [_frame(rng.integers(0, 16, 4096, dtype=np.uint8).tobytes(), 3)]
    zstd.reset_counts()
    for f in frames:
        _assert_same(f)
    counts = dict(zstd.counts)
    for key in ("block_raw", "block_rle", "block_compressed", "literals_raw", "literals_rle",
                "literals_huffman_1", "literals_huffman_4", "literals_treeless",
                "huffman_weights_fse", "huffman_weights_direct", "seq_predefined",
                "seq_rle", "seq_fse_compressed", "seq_repeat"):
        assert counts[key] > 0, (key, counts)


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65791, 65792, 126_971, 300_000])
def test_zstd_writer_round_trips_through_both_decoders(size):
    data = _data("random", size, 3)
    frame = zstd.compress(data)
    assert frame[:4] == b"\x28\xb5\x2f\xfd"
    fhd = frame[4]
    assert fhd & 0x20 and not fhd & 0x04 and not fhd & 0x03   # single segment, no checksum
    assert ZSTD.decompress(frame, max_output_size=LIMIT) == data
    zstd.reset_counts()
    assert zstd.decompress(frame, LIMIT) == data
    # a frame that declares content size 0 decodes to b"" unread (as zstandard)
    assert zstd.counts["block_raw"] == -(-size // (1 << 17))
    assert zstd.counts["block_compressed"] == zstd.counts["block_rle"] == 0


def _flip(frame: bytes, i: int) -> bytes:
    b = bytearray(frame)
    b[i] ^= 1
    return bytes(b)


def _with_block_type(frame: bytes, kind: int) -> bytes:
    """The frame with its first block's type field set to `kind`."""
    b = bytearray(frame)
    pos = 6 if b[4] == 0x20 else None          # single segment, 1-byte content size
    assert pos is not None
    head = int.from_bytes(b[pos:pos + 3], "little")
    b[pos:pos + 3] = ((head & ~6) | (kind << 1)).to_bytes(3, "little")
    return bytes(b)


_HELLO = b"hello world " * 10
_REJECTS = {
    "truncated": lambda: _frame(_HELLO, 3)[:-3],
    "truncated_header": lambda: _frame(_HELLO, 3)[:5],
    "empty": lambda: b"",
    "bad_magic": lambda: b"\x00" + _frame(_HELLO, 3)[1:],
    "flipped_checksum_byte": lambda: _flip(_frame(_HELLO, 3, checksum=True), -2),
    "reserved_block_type": lambda: _with_block_type(_frame(_HELLO, 3), 3),
    "dictionary_id": lambda: (b"\x28\xb5\x2f\xfd\x21\x05" + bytes([len(_HELLO)])
                              + _frame(_HELLO, 3)[6:]),
    "over_max_output_size": lambda: _frame(_HELLO, 3, content_size=False),
    "reserved_header_bit": lambda: (lambda f: f[:4] + bytes([f[4] | 0x08]) + f[5:])(
        _frame(_HELLO, 3)),
}


@pytest.mark.parametrize("case", sorted(_REJECTS))
def test_zstd_rejections_raise_in_both(case):
    frame = _REJECTS[case]()
    limit = 50 if case == "over_max_output_size" else LIMIT
    ref, port = _decode_both(frame, limit)
    assert isinstance(ref, type) and issubclass(ref, Exception), ref
    assert port is not None and isinstance(port, type) and issubclass(port, ValueError), port


def _skippable(payload: bytes, nibble: int = 0) -> bytes:
    return (0x184D2A50 | nibble).to_bytes(4, "little") + len(payload).to_bytes(4, "little") + payload


_EDGES = {
    "concatenated": lambda: _frame(_HELLO, 3) + _frame(b"second frame", 3),
    "concatenated_no_content_size": lambda: (_frame(_HELLO, 3, content_size=False)
                                             + _frame(b"second", 3)),
    "skippable_first": lambda: _skippable(b"abc", 15) + _frame(_HELLO, 3),
    "empty_skippable_first": lambda: _skippable(b"") + _frame(_HELLO, 3),
    "skippable_after": lambda: _frame(_HELLO, 3) + _skippable(b"abc"),
    "trailing_bytes": lambda: _frame(_HELLO, 3) + b"\x00\x01\x02",
    "no_content_size": lambda: _frame(_HELLO, 3, content_size=False),
    "no_content_size_at_the_limit": lambda: _frame(b"x" * 50 + bytes(range(50)), 1,
                                                   content_size=False),
    "empty_frame": lambda: _frame(b"", 3),
    "declared_empty_with_a_block": lambda: (b"\x28\xb5\x2f\xfd\x20\x00"
                                            + ((5 << 3) | 1).to_bytes(3, "little") + b"abcde"),
    # a dictionary ID with a declared content size of 0: b"", unread
    "declared_empty_with_a_dictionary": lambda: bytes.fromhex("28b52ffd26000100"),
    # window log 30 (1.5 GiB) with a declared content size of 70,000 bytes
    "large_window_with_content_size": lambda: bytes.fromhex(
        "28b52ffd84a47011010055000010010101006b1139c002314d4e5f"),
    "large_window_without_content_size": lambda: bytes.fromhex(
        "28b52ffd04a47055000010010101006b1139c002314d4e5f"),
    # 4-stream Huffman literals whose bits do not end at the last symbol (one
    # bit flipped in a level-1 frame of 400 skewed letters): libzstd decodes
    # bytes that depend on how its decoder reads past the end; the port
    # rejects (the recorded divergence, `utils/zstd.py`'s docstring)
    "huffman_4_streams_not_exact": lambda: bytes.fromhex(
        "28b52ffd6090008d05006615240cd0a53164ef9da464000017011e001d0020009578ef2bc722305c"
        "e3bcec4ee48336900440680a3d9a8c3a1246edd55375ba1468ca398d3caa65dcbf9af0366dccd554"
        "92f7040aad918dd9a844053fe02c236c4689531eb11188a8d54e17a0b07078868825c06e4980baaf"
        "8fc23017a4424c05c0788c43c9d9861bce85766e688d3b22431e6700bb025fcc8028cc05200a003e"
        "2d1975cecea0a63c7e7d006b43bc096760d9de199a41c16eea50a2"),
}
# cases where zstandard returns bytes and the port deliberately raises
_DIVERGENT = {"huffman_4_streams_not_exact"}


@pytest.mark.parametrize("case", sorted(_EDGES))
def test_zstd_edge_cases_behave_as_zstandard(case):
    limit = 100 if case == "no_content_size_at_the_limit" else LIMIT
    ref, port = _decode_both(_EDGES[case](), limit)
    if case in _DIVERGENT:
        assert isinstance(ref, bytes), ref
        assert isinstance(port, type) and issubclass(port, ValueError), port
    elif isinstance(ref, bytes):
        assert port == ref
    else:
        assert isinstance(port, type) and issubclass(port, ValueError), (ref, port)


def test_zstd_declared_size_above_the_limit_raises_before_decoding():
    """The one divergence: `zstandard` trusts a declared content size above
    max_output_size and decodes; the port never grows past the limit."""
    frame = _frame(_HELLO, 3)
    assert ZSTD.decompress(frame, max_output_size=50) == _HELLO
    with pytest.raises(ValueError, match="max_output_size"):
        zstd.decompress(frame, 50)
    huge = b"\x28\xb5\x2f\xfd\xe0" + (1 << 40).to_bytes(8, "little") + frame[6:]
    with pytest.raises(ValueError):
        zstd.decompress(huge, LIMIT)


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    for n in (1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        data = _data("random", n, 9)
        frame = _frame(data, 3, checksum=True)
        assert int.from_bytes(frame[-4:], "little") == zstd.xxh64(data) & 0xFFFFFFFF


def test_zstd_malformed_input_raises_only_value_error():
    """Seeded byte corruptions of valid frames: every failure is a
    ValueError (no IndexError or other exception escapes the module)."""
    rng = np.random.default_rng(11)
    frames = [_frame(d, lv, ck) for lv in (1, 19) for ck in (False, True)
              for d in (_data("text", 3000), _data("runs", 3000), _data("random", 600))]
    for _ in range(400):
        f = bytearray(frames[int(rng.integers(len(frames)))])
        for _ in range(int(rng.integers(1, 5))):
            f[int(rng.integers(len(f)))] = int(rng.integers(256))
        cut = int(rng.integers(len(f) // 2, len(f) + 1))
        try:
            zstd.decompress(bytes(f[:cut]), LIMIT)
        except ValueError:
            pass


# ---------------------------------------------------------------------------
# BLS12-381 and KZG
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(2024)
SCALARS = [int.from_bytes(_rng.bytes(32), "big") % bls.R for _ in range(3)]


def test_g1_g2_operations_equal_reference():
    a, b, _ = SCALARS
    p, q = bls.g1_mul(bls.G1_GEN, a), bls.g1_mul(bls.G1_GEN, b)
    assert p == ref_bls.g1_mul(ref_bls.G1_GEN, a)
    assert bls.g1_add(p, q) == ref_bls.g1_add(p, q) == bls.g1_mul(bls.G1_GEN, a + b)
    assert bls.g1_neg(p) == ref_bls.g1_neg(p)
    assert bls.g1_add(p, bls.g1_neg(p)) is None
    p2, q2 = bls.g2_mul(bls.G2_GEN, a), bls.g2_mul(bls.G2_GEN, b)
    assert p2 == ref_bls.g2_mul(ref_bls.G2_GEN, a)
    assert bls.g2_add(p2, q2) == ref_bls.g2_add(p2, q2) == bls.g2_mul(bls.G2_GEN, a + b)
    assert bls.g2_neg(p2) == ref_bls.g2_neg(p2)
    assert bls.g1_is_on_curve(p) and bls.g2_is_on_curve(p2)
    enc = bls.g1_to_compressed_be(p)
    assert enc == ref_bls.g1_to_compressed_be(p)
    assert bls.g1_from_compressed_be(enc) == p == ref_bls.g1_from_compressed_be(enc)
    assert bls.g1_from_compressed_be(bls.g1_to_compressed_be(None)) is None
    assert bls.KZG_G2_SETUP_BYTES == ref_bls.KZG_G2_SETUP_BYTES
    assert bls.kzg_tau_g2() == ref_bls.kzg_tau_g2()


def test_pairing_equals_reference_and_is_bilinear():
    a, b, _ = SCALARS
    p, q = bls.g1_mul(bls.G1_GEN, a), bls.g2_mul(bls.G2_GEN, b)
    e = bls.pairing(q, p)
    assert e == ref_bls.pairing(q, p)
    assert e != bls.FQ12_ONE
    assert e == bls.pairing(bls.G2_GEN, bls.g1_mul(bls.G1_GEN, a * b))


@pytest.fixture(scope="module")
def kzg_opening():
    """An honest opening of a seeded polynomial under an insecure setup."""
    setup = bls.InsecureKzgSetup.generate(tau=0xDEADBEEFCAFE)
    rng = np.random.default_rng(7)
    coeffs = [int.from_bytes(rng.bytes(32), "big") % bls.R for _ in range(16)]
    z = SCALARS[2]
    y, proof = setup.prove_eval_coeffs_fast(coeffs, z)
    ref_setup = ref_bls.InsecureKzgSetup.generate(tau=0xDEADBEEFCAFE)
    assert ref_setup.prove_eval_coeffs_fast(coeffs, z) == (y, proof)
    assert setup.commit_coeffs_fast(coeffs) == ref_setup.commit_coeffs_fast(coeffs)
    return setup, setup.commit_coeffs_fast(coeffs), z, y, proof


@pytest.mark.parametrize("case", ["honest", "wrong_y", "wrong_proof", "wrong_z", "ceremony_tau"])
def test_verify_kzg_proof_equals_reference(kzg_opening, case):
    setup, commitment, z, y, proof = kzg_opening
    tau = setup.tau_g2
    if case == "wrong_y":
        y = (y + 1) % bls.R
    elif case == "wrong_proof":
        proof = bls.g1_add(proof, bls.G1_GEN)
    elif case == "wrong_z":
        z = (z + 1) % bls.R
    elif case == "ceremony_tau":
        tau = None
    got = bls.verify_kzg_proof(z, y, commitment, proof, tau)
    assert got is ref_bls.verify_kzg_proof(z, y, commitment, proof, tau)
    assert got is (case == "honest")


# ---------------------------------------------------------------------------
# the blob, the headers, the envelopes and the builders
# ---------------------------------------------------------------------------


def test_blob_functions_equal_reference(kzg_opening):
    setup = kzg_opening[0]
    data = _data("random", 5000, 4)
    blob, ref_blob_poly = port_blob.BlobPolynomial(data), ref_blob.BlobPolynomial(data)
    assert blob.coefficients == ref_blob_poly.coefficients
    assert blob.to_blob_bytes() == ref_blob_poly.to_blob_bytes()
    assert port_blob.roots_of_unity_brp() == ref_blob.roots_of_unity_brp()
    digest = port_blob.challenge_digest(data[:300], b"\x01" * 32)
    assert digest == ref_blob.challenge_digest(data[:300], b"\x01" * 32)
    z, y = blob.evaluate(digest)
    assert (z, y) == ref_blob_poly.evaluate(digest)
    root = port_blob.roots_of_unity_brp()[17]
    for point in (root, root + bls.R):
        assert port_blob.point_evaluation(blob.coefficients, point) == \
            ref_blob.point_evaluation(blob.coefficients, point)
    assert port_blob._inverse_ntt_brp(blob.coefficients) == \
        ref_blob._inverse_ntt_brp(blob.coefficients)
    commitment = port_blob.commit_blob(setup, blob)
    assert commitment == ref_blob.commit_blob(setup, ref_blob_poly)
    assert port_blob.prove_blob_eval(setup, blob, z) == ref_blob.prove_blob_eval(setup, ref_blob_poly, z)
    enc = bls.g1_to_compressed_be(commitment)
    assert port_blob.kzg_to_versioned_hash(enc) == ref_blob.kzg_to_versioned_hash(enc)


_HEADER_FIELDS = {
    "BatchHeaderV7": dict(version=9, batch_index=5, parent_batch_hash=b"\x01" * 32,
                          blob_versioned_hash=b"\x02" * 32),
    "BatchHeaderV6": dict(version=6, batch_index=1, l1_message_popped=2,
                          total_l1_message_popped=3, parent_batch_hash=b"\x04" * 32,
                          last_block_timestamp=99, data_hash=b"\x05" * 32,
                          blob_versioned_hash=b"\x06" * 32,
                          blob_data_proof=[b"\x07" * 32, b"\x08" * 32]),
    "BatchHeaderValidiumV1": dict(version=65, batch_index=1, parent_batch_hash=b"\x01" * 32,
                                  post_state_root=b"\x02" * 32, withdraw_root=b"\x03" * 32,
                                  commitment=b"\x04" * 32),
}


@pytest.mark.parametrize("name", sorted(_HEADER_FIELDS))
def test_header_batch_hash_equals_reference(name):
    fields = _HEADER_FIELDS[name]
    port = getattr(port_header, name)(**copy.deepcopy(fields))
    ref = getattr(ref_header, name)(**copy.deepcopy(fields))
    assert port.batch_hash() == ref.batch_hash()
    assert len(port.batch_hash()) == 32
    for key in ("batch_index", "parent_batch_hash"):
        other = getattr(port_header, name)(**{**copy.deepcopy(fields), key: (
            fields[key] + 1 if isinstance(fields[key], int) else b"\x0f" * 32)})
        assert other.batch_hash() != port.batch_hash()


def _ns(pkg):
    """The batch-layer names of one package."""
    if pkg == "reference":
        return SimpleNamespace(
            bls=ref_bls, keccak256=ref_keccak256, base=ref_base, batch=ref_batch,
            blob=ref_blob, payload=ref_payload, builder=ref_builder, header=ref_header,
            witness=ref_batch_witness)
    return SimpleNamespace(
        bls=bls, keccak256=keccak256, base=port_base, batch=port_batch, blob=port_blob,
        payload=port_payload, builder=port_builder, header=port_header,
        witness=port_batch_witness)


def _mk_chunks(ns):
    """tests/test_batch_types.py::_mk_chunks in either package."""
    ctx = lambda t: ns.base.BlockContextV2(timestamp=t, base_fee=100, gas_limit=10_000_000,
                                           num_txs=2, num_l1_msgs=0)
    tx1, tx2 = b"\xaa" * 40, b"\xbb" * 25
    c1 = ns.base.ChunkInfo(
        chain_id=534352, prev_state_root=b"\x01" * 32, post_state_root=b"\x02" * 32,
        withdraw_root=b"\x03" * 32, tx_data_digest=ns.keccak256(tx1),
        prev_msg_queue_hash=b"\x0a" * 32, post_msg_queue_hash=b"\x0b" * 32,
        tx_data_length=len(tx1), initial_block_number=100, block_ctxs=[ctx(1000), ctx(1001)])
    c2 = ns.base.ChunkInfo(
        chain_id=534352, prev_state_root=b"\x02" * 32, post_state_root=b"\x04" * 32,
        withdraw_root=b"\x05" * 32, tx_data_digest=ns.keccak256(tx2),
        prev_msg_queue_hash=b"\x0b" * 32, post_msg_queue_hash=b"\x0c" * 32,
        tx_data_length=len(tx2), initial_block_number=102, block_ctxs=[ctx(1002)])
    payload = ns.batch.PayloadV7(
        version=9, prev_msg_queue_hash=c1.prev_msg_queue_hash,
        post_msg_queue_hash=c2.post_msg_queue_hash, initial_block_number=100, num_blocks=3,
        block_contexts=c1.block_ctxs + c2.block_ctxs, tx_data=tx1 + tx2)
    return [c1, c2], payload


def _fields(obj) -> dict:
    """A dataclass's fields as plain values (enums by value), for comparing
    objects of the two packages."""
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    return obj


def test_envelope_v7_round_trip_equals_reference():
    """test_batch_types.py::test_envelope_payload_roundtrip_zstd: the
    reference's zstd envelope decodes alike in both; the port's own
    (Raw-block) envelope decodes to the same payload."""
    (ref_chunks, ref_payload_obj), (chunks, payload) = _mk_chunks(_ns("reference")), \
        _mk_chunks(_ns("port"))
    assert payload.to_bytes() == ref_payload_obj.to_bytes()
    ref_env = ref_batch.EnvelopeV7.build(9, ref_payload_obj.to_bytes(), encode=True)
    port_from_ref = port_batch.EnvelopeV7.from_slice(ref_env.envelope_bytes)
    assert _fields(port_from_ref) == _fields(ref_env)
    back, ref_back = port_batch.PayloadV7.from_envelope(port_from_ref), \
        ref_batch.PayloadV7.from_envelope(ref_env)
    assert _fields(back) == _fields(ref_back)
    assert back.num_blocks == 3 and back.tx_data == payload.tx_data
    assert back.validate(chunks) is not None and ref_back.validate(ref_chunks) is not None
    assert port_from_ref.challenge_digest(b"\x05" * 32) == ref_env.challenge_digest(b"\x05" * 32)
    own = port_batch.EnvelopeV7.build(9, payload.to_bytes(), encode=True)
    assert own.is_encoded == 1
    assert own.envelope_bytes != ref_env.envelope_bytes         # the writer's Raw blocks
    assert _fields(port_batch.PayloadV7.from_envelope(own)) == _fields(ref_back)
    # the reference decodes the port's envelope alike
    assert _fields(ref_batch.PayloadV7.from_envelope(
        ref_batch.EnvelopeV7.from_slice(own.envelope_bytes))) == _fields(ref_back)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_envelope_raw_and_padding_check(pkg):
    """test_batch_types.py::test_envelope_raw_and_padding_check in both."""
    ns = _ns(pkg)
    _, payload = _mk_chunks(ns)
    env = ns.batch.EnvelopeV7.build(9, payload.to_bytes(), encode=False)
    ref_env = ref_batch.EnvelopeV7.build(9, payload.to_bytes(), encode=False)
    assert env.envelope_bytes == ref_env.envelope_bytes
    assert ns.batch.PayloadV7.from_envelope(env).tx_data == payload.tx_data
    raw = bytearray(env.envelope_bytes)
    raw[-1] = 1
    with pytest.raises(AssertionError):
        ns.batch.EnvelopeV7.from_slice(bytes(raw))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_payload_validate_rejects_wrong_digest(pkg):
    ns = _ns(pkg)
    chunks, payload = _mk_chunks(ns)
    chunks[0].tx_data_digest = b"\xff" * 32
    with pytest.raises(AssertionError):
        payload.validate(chunks)


def test_blob_point_evaluation_consistency():
    """test_batch_types.py::test_blob_point_evaluation_consistency: the
    barycentric value equals Horner on the inverse NTT, in both."""
    data = bytes(range(256)) * 4
    blob = port_blob.BlobPolynomial(data)
    z = 987654321987654321
    y = port_blob.point_evaluation(blob.coefficients, z)
    horner = 0
    for c in reversed(port_blob._inverse_ntt_brp(blob.coefficients)):
        horner = (horner * z + c) % bls.R
    assert y == horner == ref_blob.point_evaluation(blob.coefficients, z)


def _full_v7_witness(ns, setup):
    """test_batch_types.py::test_full_batch_builder_v7's witness, built
    with `ns` (its envelope written by that package's zstd writer)."""
    chunks, payload = _mk_chunks(ns)
    env = ns.batch.EnvelopeV7.build(10, payload.to_bytes(), encode=True)
    blob = ns.blob.BlobPolynomial(env.envelope_bytes)
    commitment = ns.blob.commit_blob(setup, blob)
    versioned_hash = ns.blob.kzg_to_versioned_hash(ns.bls.g1_to_compressed_be(commitment))
    header = ns.batch.BatchHeaderV7(version=10, batch_index=7, parent_batch_hash=b"\x09" * 32,
                                    blob_versioned_hash=versioned_hash)
    z, y = blob.evaluate(env.challenge_digest(versioned_hash))
    y2, proof = ns.blob.prove_blob_eval(setup, blob, z)
    assert y2 == y
    pe = ns.batch.PointEvalWitness(
        kzg_commitment_x=commitment[0].to_bytes(48, "big"),
        kzg_commitment_y=commitment[1].to_bytes(48, "big"),
        kzg_proof_x=proof[0].to_bytes(48, "big"), kzg_proof_y=proof[1].to_bytes(48, "big"))
    return ns.batch.BatchWitness(
        version=ns.base.Version.galileo_v2().as_version_byte(), chunk_infos=chunks,
        blob_bytes=env.envelope_bytes.rstrip(b"\x00"), header=header, point_eval_witness=pe)


def test_full_batch_builder_v7_equals_reference():
    """test_batch_types.py::test_full_batch_builder_v7: the reference's
    witness through both builders (equal BatchInfo), and a tampered KZG
    proof point rejected by both."""
    setup = ref_bls.InsecureKzgSetup.generate(tau=0xDEADBEEFCAFE)
    ref_w = _full_v7_witness(_ns("reference"), setup)
    w = convert.witness_from_reference(ref_w)
    info = port_builder.build_batch_info_v7(w, tau_g2=setup.tau_g2)
    ref_info = ref_builder.build_batch_info_v7(ref_w, tau_g2=setup.tau_g2)
    assert _fields(info) == _fields(ref_info)
    assert info.batch_hash == w.header.batch_hash()
    for wit, build in ((w, port_builder.build_batch_info_v7),
                       (ref_w, ref_builder.build_batch_info_v7)):
        bad = copy.deepcopy(wit)
        bad.point_eval_witness.kzg_proof_x = wit.point_eval_witness.kzg_commitment_x
        bad.point_eval_witness.kzg_proof_y = wit.point_eval_witness.kzg_commitment_y
        with pytest.raises(AssertionError):
            build(bad, tau_g2=setup.tau_g2)


def _chunk_infos_v6(ns, tx_datas):
    """tests/test_payload_v6_validium.py::_chunk_infos_v6."""
    infos, prev = [], b"\x01" * 32
    for i, txd in enumerate(tx_datas):
        infos.append(ns.base.ChunkInfo(
            chain_id=534352, prev_state_root=prev, post_state_root=bytes([10 + i]) * 32,
            withdraw_root=b"\x63" * 32, data_hash=ns.keccak256(b"datahash%d" % i),
            tx_data_digest=ns.keccak256(txd)))
        prev = bytes([10 + i]) * 32
    return infos


def test_payload_v6_round_trip_equals_reference():
    tx_datas = [b"\x01" * 10, b"\x02" * 33, b""]
    payload_bytes = port_payload.PayloadV6.build_payload_bytes(tx_datas)
    assert payload_bytes == ref_payload.PayloadV6.build_payload_bytes(tx_datas)
    assert len(payload_bytes) == port_payload.N_BYTES_METADATA_V6 + 43
    for encode in (True, False):
        ref_blob_bytes = ref_payload.EnvelopeV6.build(payload_bytes, encode=encode)
        env = port_payload.EnvelopeV6.from_slice(ref_blob_bytes)
        ref_env = ref_payload.EnvelopeV6.from_slice(ref_blob_bytes)
        assert _fields(env) == _fields(ref_env) and env.is_encoded is encode
        p, ref_p = port_payload.PayloadV6.from_envelope(env), \
            ref_payload.PayloadV6.from_envelope(ref_env)
        assert _fields(p) == _fields(ref_p)
        assert p.chunk_data_digests == [keccak256(d) for d in tx_datas]
        assert p.challenge_digest(b"\x03" * 32) == ref_p.challenge_digest(b"\x03" * 32)
        own = port_payload.EnvelopeV6.build(payload_bytes, encode=encode)
        assert _fields(ref_payload.PayloadV6.from_envelope(
            ref_payload.EnvelopeV6.from_slice(own))) == _fields(ref_p)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_payload_v6_rejects_bad_segmentation(pkg):
    ns = _ns(pkg)
    payload_bytes = ns.payload.PayloadV6.build_payload_bytes([b"ab"])
    broken = ns.payload.EnvelopeV6.build(payload_bytes + b"x", encode=False)
    with pytest.raises(AssertionError):
        ns.payload.PayloadV6.from_envelope(ns.payload.EnvelopeV6.from_slice(broken))


def _v6_witness(ns):
    """test_payload_v6_validium.py::test_builder_v6_end_to_end's witness
    (its zstd body written by the reference)."""
    tx_datas = [b"\x11" * 20, b"\x22" * 5]
    infos = _chunk_infos_v6(ns, tx_datas)
    blob_bytes = ref_payload.EnvelopeV6.build(
        ref_payload.PayloadV6.build_payload_bytes(tx_datas), encode=True)
    versioned_hash = b"\x03" * 32
    padded = blob_bytes + bytes(ns.blob.N_BLOB_BYTES - len(blob_bytes))
    payload = ns.payload.PayloadV6.from_envelope(ns.payload.EnvelopeV6.from_slice(blob_bytes))
    z, y = ns.blob.BlobPolynomial(padded).evaluate(payload.challenge_digest(versioned_hash))
    header = ns.header.BatchHeaderV6(
        version=4, batch_index=12, l1_message_popped=0, total_l1_message_popped=0,
        parent_batch_hash=b"\x07" * 32, last_block_timestamp=1700000000,
        data_hash=ns.keccak256(b"".join(ci.data_hash for ci in infos)),
        blob_versioned_hash=versioned_hash,
        blob_data_proof=[z.to_bytes(32, "big"), y.to_bytes(32, "big")])
    return ns.witness.BatchWitness(version=4, chunk_infos=infos, blob_bytes=blob_bytes,
                                   header=header)


def test_builder_v6_equals_reference():
    ref_w = _v6_witness(_ns("reference"))
    w = _v6_witness(_ns("port"))
    assert _fields(w) == _fields(ref_w)
    info, ref_info = port_builder.build_batch_info_v6(w), ref_builder.build_batch_info_v6(ref_w)
    assert _fields(info) == _fields(ref_info)
    assert info.batch_hash == w.header.batch_hash()
    for wit, build in ((w, port_builder.build_batch_info_v6),
                       (ref_w, ref_builder.build_batch_info_v6)):
        wit.header.blob_data_proof[1] = b"\xee" * 32
        with pytest.raises(AssertionError):
            build(wit)


def _validium_witness(ns):
    info = ns.base.ChunkInfo(
        chain_id=111, prev_state_root=b"\x01" * 32, post_state_root=b"\x02" * 32,
        withdraw_root=b"\x03" * 32, prev_msg_queue_hash=b"\x04" * 32,
        post_msg_queue_hash=b"\x05" * 32, post_blockhash=b"\x06" * 32,
        encryption_key=b"\xab" * 33)
    header = ns.header.BatchHeaderValidiumV1(
        version=1, batch_index=3, parent_batch_hash=b"\x09" * 32, post_state_root=b"\x02" * 32,
        withdraw_root=b"\x03" * 32, commitment=b"\x06" * 32)
    return ns.witness.BatchWitness(version=ns.base.Version.validium_v1().as_version_byte(),
                                   chunk_infos=[info], blob_bytes=b"", header=header)


def test_builder_validium_equals_reference():
    ref_w, w = _validium_witness(_ns("reference")), _validium_witness(_ns("port"))
    info = port_builder.build_batch_info_validium(w)
    assert _fields(info) == _fields(ref_builder.build_batch_info_validium(ref_w))
    assert info.encryption_key == b"\xab" * 33
    for wit, build in ((w, port_builder.build_batch_info_validium),
                       (ref_w, ref_builder.build_batch_info_validium)):
        wit.header.post_state_root = b"\xff" * 32
        with pytest.raises(AssertionError):
            build(wit)


# ---------------------------------------------------------------------------
# the chunk -> batch -> bundle chain of tests/test_e2e_chain.py
# ---------------------------------------------------------------------------

E2E_SETUP = ref_bls.InsecureKzgSetup.generate(tau=0x5EED)


def _e2e_chunk(start_block, prev_state, prev_q, seed):
    """tests/test_e2e_chain.py::mk_chunk_witness, in the reference."""
    version = ref_base.Version.galileo_v2()
    blocks, state = [], prev_state
    for i in range(2):
        n = start_block + i
        state = ref_keccak256(state + b"state")
        blocks.append(ref_chunk_witness.BlockExecutionSummary(
            number=n, timestamp=1_700_000_000 + n, base_fee_per_gas=1000,
            gas_limit=30_000_000, gas_used=1_000_000, state_root_after=state,
            block_hash=ref_keccak256(seed + n.to_bytes(8, "big")),
            encoded_l2_txs=[b"\x02" + bytes([n % 256]) * 20],
            l1_msg_hashes=[ref_keccak256(b"l1msg" + n.to_bytes(8, "big"))], num_txs=2))
    return ref_chunk_witness.ChunkWitness(
        version=version.as_version_byte(), blocks=blocks, prev_msg_queue_hash=prev_q,
        fork_name=ref_base.ForkName.GALILEO_V2, prev_state_root=prev_state,
        withdraw_root=b"\x07" * 32, chain_id=534352)


@pytest.fixture(scope="module")
def e2e_chain():
    """The reference's chain (two chunks, a batch over both, a bundle over
    the batch), its infos and PI hashes, and the port's results on the same
    witnesses."""
    version = ref_base.Version.galileo_v2()
    w1 = _e2e_chunk(100, b"\x01" * 32, b"\x00" * 32, b"\xaa")
    info1, _ = RefChunkCircuit.validate(w1)
    w2 = _e2e_chunk(102, info1.post_state_root, info1.post_msg_queue_hash, b"\xbb")
    info2, _ = RefChunkCircuit.validate(w2)
    payload = ref_batch.PayloadV7(
        version=int(version.stf_version), prev_msg_queue_hash=info1.prev_msg_queue_hash,
        post_msg_queue_hash=info2.post_msg_queue_hash,
        initial_block_number=info1.initial_block_number,
        num_blocks=len(info1.block_ctxs) + len(info2.block_ctxs),
        block_contexts=info1.block_ctxs + info2.block_ctxs,
        tx_data=b"".join(tx for w in (w1, w2) for b in w.blocks for tx in b.encoded_l2_txs))
    env = ref_batch.EnvelopeV7.build(int(version.stf_version), payload.to_bytes(), encode=True)
    blob = ref_batch.BlobPolynomial(env.envelope_bytes)
    commitment = ref_blob.commit_blob(E2E_SETUP, blob)
    versioned_hash = ref_batch.kzg_to_versioned_hash(ref_bls.g1_to_compressed_be(commitment))
    header = ref_batch.BatchHeaderV7(version=int(version.stf_version), batch_index=42,
                                     parent_batch_hash=b"\x09" * 32,
                                     blob_versioned_hash=versioned_hash)
    z, _ = blob.evaluate(env.challenge_digest(versioned_hash))
    _, proof = ref_blob.prove_blob_eval(E2E_SETUP, blob, z)
    ref_batch_w = ref_batch_circuit_mod.BatchCircuitWitness(
        inner=ref_batch.BatchWitness(
            version=version.as_version_byte(), chunk_infos=[info1, info2],
            blob_bytes=env.envelope_bytes.rstrip(b"\x00"), header=header,
            point_eval_witness=ref_batch.PointEvalWitness(
                kzg_commitment_x=commitment[0].to_bytes(48, "big"),
                kzg_commitment_y=commitment[1].to_bytes(48, "big"),
                kzg_proof_x=proof[0].to_bytes(48, "big"),
                kzg_proof_y=proof[1].to_bytes(48, "big"))),
        chunk_proofs=[ref_base.AggregationInput.from_pi_hash(i.pi_hash_by_version(version))
                      for i in (info1, info2)])
    RefBatchCircuit.tau_g2_override = BatchCircuit.tau_g2_override = E2E_SETUP.tau_g2
    ref_batch_info, _ = RefBatchCircuit.validate(ref_batch_w)
    ref_bundle_w = ref_bundle.BundleWitness(
        version=version.as_version_byte(),
        batch_proofs=[ref_base.AggregationInput.from_pi_hash(
            ref_batch_info.pi_hash_by_version(version))],
        batch_infos=[ref_batch_info], fork_name=ref_base.ForkName.GALILEO_V2)
    ref_bundle_info, _ = RefBundleCircuit.validate(ref_bundle_w)
    batch_w = convert.witness_from_reference(ref_batch_w)
    bundle_w = convert.witness_from_reference(ref_bundle_w)
    batch_info, batch_version = BatchCircuit.validate(batch_w)
    bundle_info, bundle_version = BundleCircuit.validate(bundle_w)
    return SimpleNamespace(
        version=version, ref_batch_w=ref_batch_w, ref_bundle_w=ref_bundle_w,
        ref_batch_info=ref_batch_info, ref_bundle_info=ref_bundle_info, batch_w=batch_w,
        bundle_w=bundle_w, batch_info=batch_info, bundle_info=bundle_info,
        batch_version=batch_version, bundle_version=bundle_version)


def test_e2e_batch_and_bundle_equal_reference(e2e_chain):
    c = e2e_chain
    assert isinstance(c.batch_w, BatchCircuitWitness)
    assert type(c.batch_w.inner.header).__module__.startswith("zkvm_prover_tpu_torch.")
    assert _fields(c.batch_info) == _fields(c.ref_batch_info)
    assert _fields(c.bundle_info) == _fields(c.ref_bundle_info)
    v = c.version
    assert c.batch_info.pi_hash_by_version(c.batch_version) == \
        c.ref_batch_info.pi_hash_by_version(v)
    assert c.bundle_info.pi_hash_by_version(c.bundle_version) == \
        c.ref_bundle_info.pi_hash_by_version(v)
    assert c.bundle_info.num_batches == 1 and c.bundle_info.batch_hash == c.batch_info.batch_hash
    assert c.bundle_info.pi_by_version(c.bundle_version)[31] == v.as_version_byte()


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("what", ["unchained_chunks", "wrong_child_pi_hash"])
def test_e2e_batch_rejections_raise_in_both(e2e_chain, what, pkg):
    bad = copy.deepcopy(e2e_chain.ref_batch_w if pkg == "reference" else e2e_chain.batch_w)
    if what == "unchained_chunks":
        bad.inner.chunk_infos = bad.inner.chunk_infos[::-1]
    else:
        bad.chunk_proofs[0].public_values[0] ^= 1
    with pytest.raises(AssertionError):
        (RefBatchCircuit if pkg == "reference" else BatchCircuit).validate(bad)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_e2e_bundle_rejects_wrong_child_pi_hash(e2e_chain, pkg):
    bad = copy.deepcopy(e2e_chain.ref_bundle_w if pkg == "reference" else e2e_chain.bundle_w)
    bad.batch_proofs[0].public_values[3] ^= 1
    with pytest.raises(AssertionError):
        (RefBundleCircuit if pkg == "reference" else BundleCircuit).validate(bad)


def test_witness_from_reference_builds_port_classes(e2e_chain):
    w = e2e_chain.batch_w
    assert type(w.inner).__module__ == "zkvm_prover_tpu_torch.types.batch.witness"
    assert type(w.inner.chunk_infos[0]).__module__ == "zkvm_prover_tpu_torch.types.base.chunk"
    assert type(e2e_chain.bundle_w.fork_name).__module__ == \
        "zkvm_prover_tpu_torch.types.base.fork_name"
    assert _fields(w) == _fields(e2e_chain.ref_batch_w)
    with pytest.raises(TypeError):
        convert.witness_from_reference(object())


# ---------------------------------------------------------------------------
# the apps, without a proof
# ---------------------------------------------------------------------------


class _StubProof:
    """Stands in for a child proof envelope: its PI hash only."""

    def __init__(self, pi_hash: bytes):
        self.user_pvs_proof = pi_hash


def _stub_chunk_proofs(gen, chunk_circuit):
    gen.get_or_build_proof = lambda i: _StubProof(chunk_circuit.pi_hash(gen.witness(i)))


@pytest.fixture(scope="module")
def reference_tasks(tmp_path_factory):
    """The reference generator's batch 0 (one chunk) and the bundle over
    it, with stubbed chunk proofs: (witnesses, reference tasks, port tasks,
    and both packages' executed machines)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OUTPUT_DIR", str(tmp_path_factory.mktemp("ref-tasks")))
    try:
        chunks = RefChunkTaskGenerator()
        _stub_chunk_proofs(chunks, RefChunkCircuit)
        batches = RefBatchTaskGenerator(chunks=chunks, chunks_per_batch=1)
    finally:
        mp.undo()
    BatchCircuit.tau_g2_override = batches.kzg_setup.tau_g2
    inner, children, _ = batches.witness_and_children(0)
    info, version = RefBatchCircuit.validate(
        ref_batch_circuit_mod.BatchCircuitWitness(inner=inner, chunk_proofs=children))
    bundle = ref_bundle.BundleWitness(
        version=version.as_version_byte(),
        batch_proofs=[ref_base.AggregationInput.from_pi_hash(info.pi_hash_by_version(version))],
        batch_infos=[info], fork_name=version.fork)
    ref_tasks = {"batch": RefProvingTask(serialized_witness=[pickle.dumps((inner, children))]),
                 "bundle": RefProvingTask(serialized_witness=[pickle.dumps(bundle)])}
    port_tasks = {
        "batch": ProvingTask(serialized_witness=[pickle.dumps(
            convert.witness_from_reference((inner, children)))]),
        "bundle": ProvingTask(serialized_witness=[pickle.dumps(
            convert.witness_from_reference(bundle))])}
    executed = {name: (*ref_get_app(name).execute(ref_tasks[name]),
                       *get_app(name).execute(port_tasks[name])) for name in ref_tasks}
    return SimpleNamespace(inner=inner, children=children, bundle=bundle, info=info,
                           ref_tasks=ref_tasks, port_tasks=port_tasks, executed=executed)


@pytest.mark.parametrize("app_name", ["batch", "bundle"])
def test_vk_bytes_equal(app_name):
    vk = get_app(app_name).vk_bytes()
    assert len(vk) == 64 and vk == ref_get_app(app_name).vk_bytes()
    assert vk != get_app("chunk").vk_bytes()


@pytest.mark.parametrize("app_name", ["chunk", "batch", "bundle"])
def test_app_for_vk_finds_the_scroll_apps(app_name):
    app = app_for_vk(get_app(app_name).vk_bytes())
    assert app is not None and app.name == app_name


@pytest.mark.parametrize("app_name", ["batch", "bundle"])
def test_execute_equals_reference(reference_tasks, app_name):
    ref_insts, ref_pi, insts, pi = reference_tasks.executed[app_name]
    assert pi == ref_pi and len(pi) == 32
    assert len(insts) == len(ref_insts) == 18
    for a, b in zip(insts, ref_insts):
        assert type(a.air).__name__ == type(b.air).__name__
        assert a.trace.dtype == b.trace.dtype
        np.testing.assert_array_equal(a.trace, b.trace)
        assert [int(v) for v in a.public_values] == [int(v) for v in b.public_values]
    assert type(insts[scroll_apps.KECCAKF_IDX].air).__name__ == "KeccakfAir"
    assert insts[scroll_apps.KECCAKF_IDX].trace.shape[0] == 1 << 6
    meta = [(int(x.trace.shape[0]).bit_length() - 1, int(x.trace.shape[1]),
             [int(v) for v in x.public_values]) for x in insts]
    airs = get_app(app_name).airs_for_meta(meta)
    assert [type(a).__name__ for a in airs] == [type(x.air).__name__ for x in insts]
    assert [type(a).__name__ for a in ref_get_app(app_name).airs_for_meta(meta)] == \
        [type(a).__name__ for a in airs]
    assert airs[scroll_apps.KECCAKF_IDX].log_n == 6
    assert get_app(app_name).pi_hash_from_meta(meta) == pi
    assert ref_get_app(app_name).pi_hash_from_meta(meta) == pi


def test_bundle_pi_hash_equals_the_circuit(reference_tasks):
    """The bundle machine reveals the bundle circuit's PI hash."""
    bundle = convert.witness_from_reference(reference_tasks.bundle)
    assert reference_tasks.executed["bundle"][3] == BundleCircuit.pi_hash(bundle)
    assert reference_tasks.executed["batch"][3] == \
        reference_tasks.info.pi_hash_by_version(ref_base.Version.galileo_v2())


@pytest.mark.parametrize("app_name", ["batch", "bundle"])
def test_reference_pickled_task_raises_unpickling_error(reference_tasks, app_name):
    with pytest.raises(pickle.UnpicklingError, match="zkvm_prover_tpu\\."):
        get_app(app_name).execute(reference_tasks.ref_tasks[app_name])


@pytest.mark.parametrize("what", ["function", "module_attribute", "builtin", "dotted",
                                  "missing_module", "missing_class"])
def test_witness_unpickler_admits_only_witness_classes(what):
    """Globals a pickle could name in an admitted module that are not
    witness classes raise too."""
    module, name = {
        "function": ("zkvm_prover_tpu_torch.types.batch.blob", "kzg_to_versioned_hash"),
        "module_attribute": ("zkvm_prover_tpu_torch.types.batch.blob", "hashlib"),
        "builtin": ("builtins", "eval"),
        "dotted": ("zkvm_prover_tpu_torch.types.batch.blob", "hashlib.sha256"),
        "missing_module": ("zkvm_prover_tpu_torch.types.nothing", "BatchWitness"),
        "missing_class": ("zkvm_prover_tpu_torch.types.batch.witness", "Nothing"),
    }[what]
    data = f"c{module}\n{name}\n.".encode()         # GLOBAL, STOP
    with pytest.raises(pickle.UnpicklingError):
        scroll_apps.load_witness(data)


def test_witness_unpickler_loads_port_tasks(reference_tasks):
    inner, children = scroll_apps.load_witness(
        reference_tasks.port_tasks["batch"].serialized_witness[0])
    assert _fields(inner) == _fields(reference_tasks.inner)
    assert _fields(children) == _fields(reference_tasks.children)


# ---------------------------------------------------------------------------
# the port's generators
# ---------------------------------------------------------------------------


def _generators(pkg, chunks_per_batch):
    """A package's chunk and batch generators, chunk proofs stubbed."""
    if pkg == "reference":
        chunks = RefChunkTaskGenerator()
        _stub_chunk_proofs(chunks, RefChunkCircuit)
        return chunks, RefBatchTaskGenerator(chunks=chunks, chunks_per_batch=chunks_per_batch)
    chunks = ChunkTaskGenerator(device="cpu")
    _stub_chunk_proofs(chunks, ChunkCircuit)
    return chunks, BatchTaskGenerator(chunks=chunks, chunks_per_batch=chunks_per_batch)


def _ref_classes():
    """The reference's witness classes by name (for carrying the port's
    witnesses back)."""
    out = {}
    for module in (ref_base.fork_name, ref_base.version, ref_base.aggregation, ref_base.chunk,
                   ref_base.batch, ref_base.bundle, ref_header, ref_batch_witness,
                   ref_bundle.witness, ref_batch_circuit_mod):
        for obj in vars(module).values():
            if isinstance(obj, type) and obj.__module__ == module.__name__ and (
                    dataclasses.is_dataclass(obj) or issubclass(obj, enum.Enum)):
                out[obj.__name__] = obj
    return out


@pytest.mark.parametrize("chunks_per_batch", [1, 2])
def test_generators_build_witnesses_the_reference_accepts(tmp_path, monkeypatch,
                                                          chunks_per_batch):
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path))
    _, ref_batches = _generators("reference", chunks_per_batch)
    chunks, batches = _generators("port", chunks_per_batch)
    task = batches.task(0)
    inner, children = scroll_apps.load_witness(task.serialized_witness[0])
    header = inner.header
    ref_inner, ref_children, ref_header_obj = ref_batches.witness_and_children(0)
    assert _fields(inner.chunk_infos) == _fields(ref_inner.chunk_infos)
    assert _fields(children) == _fields(ref_children)
    assert (header.version, header.batch_index, header.parent_batch_hash) == (
        ref_header_obj.version, ref_header_obj.batch_index, ref_header_obj.parent_batch_hash)
    pad = lambda b: b + bytes(port_blob.N_BLOB_BYTES - len(b))
    payload = port_batch.PayloadV7.from_envelope(port_batch.EnvelopeV7.from_slice(
        pad(inner.blob_bytes)))
    ref_payload_obj = ref_batch.PayloadV7.from_envelope(ref_batch.EnvelopeV7.from_slice(
        pad(ref_inner.blob_bytes)))
    assert _fields(payload) == _fields(ref_payload_obj)
    # the port's witness, carried back, passes the reference's circuit
    RefBatchCircuit.tau_g2_override = ref_batches.kzg_setup.tau_g2
    back = convert.rebuild((inner, children), _ref_classes())
    ref_info, ref_version = RefBatchCircuit.validate(
        ref_batch_circuit_mod.BatchCircuitWitness(inner=back[0], chunk_proofs=back[1]))
    stub = _StubProof(b"")
    batches.add_proof(0, task, stub)
    info = batches._infos[0]
    assert _fields(info) == _fields(ref_info)
    assert info.pi_hash_by_version(ref_version) == ref_info.pi_hash_by_version(ref_version)
    assert batches._state["parent_batch_hash"] == header.batch_hash()
    assert batches.get_or_build_proof(0) is stub
    stub.user_pvs_proof = info.pi_hash_by_version(ref_version)
    bundles = BundleTaskGenerator(batches=batches, batches_per_bundle=1)
    bundle_w = scroll_apps.load_witness(bundles.task().serialized_witness[0])
    ref_bundle_info, _ = RefBundleCircuit.validate(convert.rebuild(bundle_w, _ref_classes()))
    bundle_info, _ = BundleCircuit.validate(bundle_w)
    assert _fields(bundle_info) == _fields(ref_bundle_info)
    assert bundles.prover.config.device == batches.prover.config.device == "cpu"
    assert bundles.prover.config.child_verification == "host"


# ---------------------------------------------------------------------------
# no JAX, zstandard, cryptography or reference
# ---------------------------------------------------------------------------

_BLOCKED_IMPORT = """
import importlib.abc, os, sys, tempfile
BLOCKED = ("jax", "jaxlib", "cryptography", "zstandard", "zkvm_prover_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
os.environ["OUTPUT_DIR"] = tempfile.mkdtemp()
import zkvm_prover_tpu_torch.types.batch, zkvm_prover_tpu_torch.types.bundle
import zkvm_prover_tpu_torch.fields.bls12_381, zkvm_prover_tpu_torch.circuits
import zkvm_prover_tpu_torch.host.scroll_apps, zkvm_prover_tpu_torch.integration
from zkvm_prover_tpu_torch.circuits import BatchCircuit, ChunkCircuit
from zkvm_prover_tpu_torch.circuits.batch_circuit import BatchCircuitWitness
from zkvm_prover_tpu_torch.integration import BatchTaskGenerator, ChunkTaskGenerator
from zkvm_prover_tpu_torch.utils import zstd
class Stub:
    def __init__(self, h):
        self.user_pvs_proof = h
chunks = ChunkTaskGenerator(device="cpu")
chunks.get_or_build_proof = lambda i: Stub(ChunkCircuit.pi_hash(chunks.witness(i)))
batches = BatchTaskGenerator(chunks=chunks, chunks_per_batch=1)
inner, children, _ = batches.witness_and_children(0)
zstd.reset_counts()
info, _ = BatchCircuit.validate(BatchCircuitWitness(inner=inner, chunk_proofs=children))
assert zstd.counts["frame"] == 1 and info.batch_hash == inner.header.batch_hash()
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("clean")
"""


def test_batch_layer_imports_and_validates_without_blocked_packages():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# ---------------------------------------------------------------------------
# the batch and bundle envelopes (slow: several minutes of proving here)
# ---------------------------------------------------------------------------


def _with_reference_on_host(fn):
    """Run a reference prove on its host numpy path (its machine prover
    would send the machine's 2^17-row matrices to JAX)."""
    saved = ref_machine._DEVICE_MIN_ELEMS
    ref_machine._DEVICE_MIN_ELEMS = 1 << 62
    try:
        return fn()
    finally:
        ref_machine._DEVICE_MIN_ELEMS = saved


def _carried(proof_enum, envelope):
    return proof_enum.from_dict(json.loads(json.dumps(envelope.to_dict())))


@pytest.mark.slow
def test_batch_and_bundle_envelopes_equal_reference(tmp_path, monkeypatch):
    """Chunk 0, batch 0 (one chunk) and the bundle (one batch) at TINY (2
    queries, 2 PoW bits): the reference builds all three; the port proves
    the reference's batch witness with the reference's chunk envelope as
    its host-verified child, then the bundle over the reference's batch
    envelope, on device="cpu". Every envelope equals the reference's in
    every field but `stat`, each verifier accepts the other's, and both
    reject it with one PI-hash byte flipped."""
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path))
    tiny = StarkConfig(fri=FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2))
    ref_tiny = RefStarkConfig(fri=RefFriConfig(log_blowup=1, num_queries=2,
                                               proof_of_work_bits=2))
    ref_chunks = RefChunkTaskGenerator(stark=ref_tiny)
    ref_batches = RefBatchTaskGenerator(chunks=ref_chunks, chunks_per_batch=1)
    ref_bundles = RefBundleTaskGenerator(batches=ref_batches, batches_per_bundle=1)
    ref_bundle_env = _with_reference_on_host(ref_bundles.build_proof)
    ref_chunk_env, ref_batch_env = ref_chunks.get_or_build_proof(0), \
        ref_batches.get_or_build_proof(0)
    BatchCircuit.tau_g2_override = ref_batches.kzg_setup.tau_g2

    # batch 0's witness as it was proven (proving it chained the parent hash on)
    ref_batches._state["parent_batch_hash"] = b"\x09" * 32
    inner, children, _ = ref_batches.witness_and_children(0)
    version = ref_base.Version.galileo_v2()
    ref_bundle_w = ref_bundle.BundleWitness(
        version=version.as_version_byte(),
        batch_proofs=[ref_base.AggregationInput.from_pi_hash(bytes(ref_batch_env.user_pvs_proof))],
        batch_infos=[ref_batches._infos[0]], fork_name=version.fork)
    envelopes = {}
    for name, witness, child, ref_env in (
            ("batch", (inner, children), ref_chunk_env, ref_batch_env),
            ("bundle", ref_bundle_w, ref_batch_env, ref_bundle_env)):
        prover = Prover.setup(ProverConfig(app_name=name, stark=tiny, device="cpu",
                                           child_verification="host"))
        task = ProvingTask(serialized_witness=[pickle.dumps(
            convert.witness_from_reference(witness))],
            aggregated_proofs=[_carried(ProofEnum, child)], fork_name="galileoV2",
            identifier=f"{name}-0", vk=prover.get_app_vk())
        port = prover.gen_proof_stark(task)
        for field in ("proof", "user_pvs_proof", "baseline", "deferral_merkle_proofs"):
            assert getattr(port, field) == getattr(ref_env, field), (name, field)
        assert port.stat.total_cycles == ref_env.stat.total_cycles
        verifier = UniversalVerifier(name, tiny, device="cpu")
        assert verifier.verify_stark_proof(_carried(ProofEnum, ref_env))
        assert RefVerifier(name, ref_tiny).verify_stark_proof(_carried(RefProofEnum, port))
        for proof_enum, verifier in ((ProofEnum, verifier),
                                     (RefProofEnum, RefVerifier(name, ref_tiny))):
            bad = _carried(proof_enum, port)
            bad.user_pvs_proof = bytes([bad.user_pvs_proof[0] ^ 1]) + bad.user_pvs_proof[1:]
            assert verifier.verify_stark_proof(bad) is False
        envelopes[name] = port
    assert envelopes["bundle"].user_pvs_proof != envelopes["batch"].user_pvs_proof
