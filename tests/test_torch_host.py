"""The port's host API (`zkvm_prover_tpu_torch/host/`, `types/`,
`circuits/`, `integration/`) against the JAX package's.

Every case of the reference's `tests/test_host_api.py` runs through both
packages: the fibonacci app (log_n 4) and the fib-double app, each proven
once per module by each package (the port on `device="cpu"`) at
`fast_test_config`. The envelopes are equal in every field but `stat`,
each verifier accepts the other's envelope after a JSON round trip, and
tampered or wrong-vk envelopes give False in both; a task with an
aggregated child proves it in-circuit by default. The stored proof
`tests/testdata/fibonacci-proof.json` verifies through the port. The chunk
app is held to the reference without a proof (witnesses, serialized
witness bytes, PI hash, the executed machine's traces and public values);
its whole envelope at a tiny config runs under `slow`. The paths the port
does not have yet raise `NotImplementedError`, and the port's host,
integration, chunk and recursion packages import neither JAX nor
`cryptography`."""

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from zkvm_prover_tpu.circuits.chunk_circuit import ChunkCircuit as RefChunkCircuit
from zkvm_prover_tpu.host import ProofEnum as RefProofEnum
from zkvm_prover_tpu.host import Prover as RefProver
from zkvm_prover_tpu.host import ProverConfig as RefProverConfig
from zkvm_prover_tpu.host import ProvingTask as RefProvingTask
from zkvm_prover_tpu.host import UniversalVerifier as RefVerifier
from zkvm_prover_tpu.host import scroll_apps as ref_scroll_apps
from zkvm_prover_tpu.host import deferral as ref_deferral
from zkvm_prover_tpu.host.app import get_app as ref_get_app
from zkvm_prover_tpu.host.prover import ProverError as RefProverError
from zkvm_prover_tpu.integration import ChunkTaskGenerator as RefChunkTaskGenerator
from zkvm_prover_tpu.models import poseidon2_air as ref_poseidon2_air
from zkvm_prover_tpu.ops.keccak import keccak256 as ref_keccak256
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import StarkConfig as RefStarkConfig
from zkvm_prover_tpu.stark.config import fast_test_config as ref_fast_config
from zkvm_prover_tpu.stark.fri import FriConfig as RefFriConfig
from zkvm_prover_tpu_torch.circuits.chunk_circuit import ChunkCircuit
from zkvm_prover_tpu_torch.host import EvmProof, ProofEnum, Prover, ProverConfig
from zkvm_prover_tpu_torch.host import ProvingTask, StarkProof, UniversalVerifier
from zkvm_prover_tpu_torch.host import deferral, scroll_apps
from zkvm_prover_tpu_torch.host.app import get_app
from zkvm_prover_tpu_torch.host.proof_types import AggChildRecord
from zkvm_prover_tpu_torch.host.prover import ProverError
from zkvm_prover_tpu_torch.integration import ChunkTaskGenerator
from zkvm_prover_tpu_torch.models import poseidon2_air
from zkvm_prover_tpu_torch.ops.keccak import keccak256
from zkvm_prover_tpu_torch.stark.config import StarkConfig, fast_test_config
from zkvm_prover_tpu_torch.stark.fri import FriConfig

ROOT = Path(__file__).resolve().parents[1]
STORED = ROOT / "tests" / "testdata" / "fibonacci-proof.json"

# the reference's test_host_api.py witnesses
WITNESS = {
    "fibonacci": {"log_n": 4, "x0": 1, "x1": 1},
    "fib-double": {"log_n_fib": 4, "log_n_dbl": 3},
}
PACKAGES = ("reference", "port")


def _api(pkg):
    """The names a caller of each package's host API uses."""
    if pkg == "reference":
        return dict(Prover=RefProver, ProverConfig=RefProverConfig, ProvingTask=RefProvingTask,
                    Verifier=RefVerifier, ProofEnum=RefProofEnum, ProverError=RefProverError,
                    cfg=ref_fast_config(), get_app=ref_get_app, extra={})
    return dict(Prover=Prover, ProverConfig=ProverConfig, ProvingTask=ProvingTask,
                Verifier=UniversalVerifier, ProofEnum=ProofEnum, ProverError=ProverError,
                cfg=fast_test_config(), get_app=get_app, extra={"device": "cpu"})


def _prover(pkg, app_name, **kw):
    api = _api(pkg)
    return api["Prover"].setup(api["ProverConfig"](
        app_name=app_name, stark=api["cfg"], **api["extra"], **kw))


def _task(pkg, app_name, identifier="t-1", **kw):
    return _api(pkg)["ProvingTask"](
        serialized_witness=[json.dumps(WITNESS[app_name]).encode()],
        fork_name="galileo", identifier=identifier, **kw)


def _carried(pkg, envelope):
    """An envelope carried into `pkg` through its JSON."""
    return _api(pkg)["ProofEnum"].from_dict(json.loads(json.dumps(envelope.to_dict())))


def _with_reference_on_host(fn):
    """Run a reference prove on its host numpy path (its machine prover
    would send the chunk machine's 2^17-row matrices to JAX)."""
    saved = ref_machine._DEVICE_MIN_ELEMS
    ref_machine._DEVICE_MIN_ELEMS = 1 << 62
    try:
        return fn()
    finally:
        ref_machine._DEVICE_MIN_ELEMS = saved


@pytest.fixture(scope="module")
def proven(tmp_path_factory):
    """Per app and package: (prover, task, envelope, cache directory)."""
    out = {}
    for app_name in WITNESS:
        for pkg in PACKAGES:
            cache = tmp_path_factory.mktemp(f"{pkg}-{app_name}")
            prover = _prover(pkg, app_name, cache_dir=str(cache))
            task = _task(pkg, app_name)
            out[app_name, pkg] = (prover, task, prover.gen_proof_universal(task), cache)
    return out


# ---------------------------------------------------------------------------
# vk and envelope parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app_name", ["fibonacci", "fib-double", "chunk"])
def test_vk_bytes_equal(app_name):
    vk = get_app(app_name).vk_bytes()
    assert len(vk) == 64
    assert vk == ref_get_app(app_name).vk_bytes()


@pytest.mark.parametrize("app_name", list(WITNESS))
def test_envelope_equals_reference(proven, app_name):
    ref = proven[app_name, "reference"][2]
    port = proven[app_name, "port"][2]
    assert isinstance(port, StarkProof)
    for name in ("proof", "user_pvs_proof", "baseline", "deferral_merkle_proofs"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.stat.total_cycles == ref.stat.total_cycles
    assert len(port.user_pvs_proof) == 32
    if app_name == "fibonacci":
        assert port.stat.total_cycles == 16


@pytest.mark.parametrize("app_name", list(WITNESS))
@pytest.mark.parametrize("verifier_pkg", PACKAGES)
def test_each_verifier_accepts_the_other(proven, app_name, verifier_pkg):
    other = "port" if verifier_pkg == "reference" else "reference"
    api = _api(verifier_pkg)
    v = api["Verifier"](app_name, api["cfg"], **api["extra"])
    for pkg in (other, verifier_pkg):
        assert v.verify_stark_proof(_carried(verifier_pkg, proven[app_name, pkg][2])) is True


@pytest.mark.parametrize("app_name", list(WITNESS))
@pytest.mark.parametrize("pkg", PACKAGES)
def test_proof_cache_roundtrip(proven, app_name, pkg):
    prover, task, proof, cache = proven[app_name, pkg]
    assert [f.name for f in cache.glob("*.json")] == [f"{app_name}-t-1.json"]
    again = prover.gen_proof_universal(task)
    assert again.proof == proof.proof
    assert again.user_pvs_proof == proof.user_pvs_proof


@pytest.mark.parametrize("app_name", list(WITNESS))
@pytest.mark.parametrize("pkg", PACKAGES)
def test_json_schema_roundtrip(proven, app_name, pkg):
    proof = proven[app_name, pkg][2]
    d = proof.to_dict()
    assert sorted(d) == ["baseline", "deferral_merkle_proofs", "proof", "stat",
                         "user_pvs_proof"]
    for into in PACKAGES:
        back = _carried(into, proof)
        assert back.proof == proof.proof
        assert back.stat.total_cycles == proof.stat.total_cycles
        assert back.to_dict() == d


def _tampered(pkg, app_name, proven, what):
    """(vk, envelope) in `pkg`'s types with one thing wrong."""
    env = _carried(pkg, proven[app_name, "port"][2])
    vk = env.baseline
    if what == "wrong_vk":
        vk = b"\x00" * 64
    elif what == "pi_hash_byte":
        env.user_pvs_proof = bytes([env.user_pvs_proof[0] ^ 1]) + env.user_pvs_proof[1:]
    elif what == "other_app":
        other = "fib-double" if app_name == "fibonacci" else "fibonacci"
        vk = _api(pkg)["get_app"](other).vk_bytes()
    return vk, env


@pytest.mark.parametrize("what", ["wrong_vk", "pi_hash_byte", "other_app"])
@pytest.mark.parametrize("app_name", list(WITNESS))
@pytest.mark.parametrize("pkg", PACKAGES)
def test_tampered_envelope_rejected(proven, pkg, app_name, what):
    api = _api(pkg)
    vk, env = _tampered(pkg, app_name, proven, what)
    assert not api["Verifier"].verify_stark_proof_with_vk(vk, env, api["cfg"], **api["extra"])
    if what == "pi_hash_byte":
        assert not api["Verifier"](app_name, api["cfg"], **api["extra"]).verify_stark_proof(env)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_all_zero_pv_precheck(pkg):
    prover = _prover(pkg, "fibonacci")

    class ZeroApp(type(prover.app)):
        def execute(self, task):
            insts, _ = super().execute(task)
            return insts, b"\x00" * 32

    prover.app = ZeroApp()
    with pytest.raises(_api(pkg)["ProverError"]):
        prover.gen_proof_stark(_task(pkg, "fibonacci", "t-zero"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_task_with_wrong_vk_raises(pkg):
    prover = _prover(pkg, "fibonacci")
    with pytest.raises(_api(pkg)["ProverError"]):
        prover.gen_proof_stark(_task(pkg, "fibonacci", vk=b"\x01" * 64))


@pytest.mark.parametrize("dump_pkg", PACKAGES)
@pytest.mark.parametrize("setup_pkg", PACKAGES)
def test_vk_dump_and_setup(tmp_path, dump_pkg, setup_pkg):
    _api(dump_pkg)["Verifier"]("fibonacci", _api(dump_pkg)["cfg"]).dump_vk(str(tmp_path))
    v = _api(setup_pkg)["Verifier"].setup(str(tmp_path))
    assert v.app.name == "fibonacci"
    assert v.app.vk_bytes() == get_app("fibonacci").vk_bytes()


def test_stored_proof_verifies_and_rejects_a_flipped_byte():
    """The port's counterpart of tests/test_stored_proof.py."""
    d = json.loads(STORED.read_text())
    app = get_app(d["app_name"])
    proof = StarkProof.from_dict(d["proof"])
    assert proof.baseline == app.vk_bytes()
    cfg = StarkConfig(fri=FriConfig(log_blowup=1, **d["fri"]))
    assert UniversalVerifier.verify_stark_proof_with_vk(app.vk_bytes(), proof, cfg,
                                                    device="cpu") is True
    raw = bytearray(proof.proof)
    raw[len(raw) // 2] ^= 1
    bad = StarkProof.from_dict(d["proof"])
    bad.proof = bytes(raw)
    assert UniversalVerifier.verify_stark_proof_with_vk(app.vk_bytes(), bad, cfg,
                                                    device="cpu") is False


@pytest.mark.parametrize("child_ok", [True, False])
def test_host_child_verification(proven, child_ok):
    """A fibonacci task carrying one fibonacci child envelope, its child
    verified on the host: equal envelopes in both packages; a child with a
    flipped PI-hash byte raises ProverError in both."""
    envelopes = {}
    for pkg in PACKAGES:
        child = _carried(pkg, proven["fibonacci", pkg][2])
        if not child_ok:
            child.user_pvs_proof = bytes([child.user_pvs_proof[0] ^ 1]) + child.user_pvs_proof[1:]
        prover = _prover(pkg, "fibonacci", child_verification="host")
        task = _task(pkg, "fibonacci", "with-child", aggregated_proofs=[child])
        if child_ok:
            envelopes[pkg] = prover.gen_proof_stark(task)
        else:
            with pytest.raises(_api(pkg)["ProverError"]):
                prover.gen_proof_stark(task)
    if child_ok:
        ref, port = envelopes["reference"], envelopes["port"]
        for name in ("proof", "user_pvs_proof", "baseline", "deferral_merkle_proofs",
                     "agg_children", "input_commits"):
            assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("length", [0, 135, 136, 137, 313])
def test_keccak256_equals_reference(length):
    """Around the 136-byte rate and at a chunk PI preimage's length."""
    data = bytes(np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8))
    assert keccak256(data) == ref_keccak256(data)


def test_canonical_poseidon2_equals_reference():
    x = np.random.default_rng(7).integers(0, 2**31 - 2**27 + 1, (5, 16)).astype(np.uint32)
    np.testing.assert_array_equal(poseidon2_air.permute_canonical(x),
                                  ref_poseidon2_air.permute_canonical(x))
    np.testing.assert_array_equal(poseidon2_air.compress_canonical(x[:, :8], x[:, 8:]),
                                  ref_poseidon2_air.compress_canonical(x[:, :8], x[:, 8:]))


@pytest.mark.parametrize("n", [1, 3])
def test_deferral_bytes_equal_reference(n):
    """encode_deferral / decode_and_verify over the canonical host
    Poseidon2: equal bytes in both packages, a flipped byte rejected."""
    rng = np.random.default_rng(n)
    commits = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
    blob = deferral.encode_deferral(commits)
    assert blob == ref_deferral.encode_deferral(commits)
    assert deferral.decode_and_verify(blob, commits) is True
    bad = bytearray(blob)
    bad[5] ^= 1
    assert deferral.decode_and_verify(bytes(bad), commits) is False
    assert not ref_deferral.decode_and_verify(bytes(bad), commits)


# ---------------------------------------------------------------------------
# the chunk app, without a proof
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """Both packages' chunk task generators and, per chunk 0 and 1, both
    packages' executed machines: {i: (ref instances, ref PI hash, port
    instances, port PI hash)}."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OUTPUT_DIR", str(tmp_path_factory.mktemp("chunk-run")))
    try:
        ref_gen, gen = RefChunkTaskGenerator(), ChunkTaskGenerator(device="cpu")
    finally:
        mp.undo()
    executed = {}
    for i in (0, 1):
        ref_task = RefProvingTask(
            serialized_witness=[RefChunkCircuit.serialize_witness(ref_gen.witness(i))])
        executed[i] = (*ref_get_app("chunk").execute(ref_task),
                       *get_app("chunk").execute(gen.task(i)))
    return ref_gen, gen, executed


@pytest.mark.parametrize("i", [0, 1])
def test_chunk_witnesses_equal_and_chained(chunks, i):
    ref_gen, gen, _ = chunks
    w, ref_w = gen.witness(i), ref_gen.witness(i)
    assert ChunkCircuit.serialize_witness(w) == RefChunkCircuit.serialize_witness(ref_w)
    assert ChunkCircuit.pi_hash(w) == RefChunkCircuit.pi_hash(ref_w)
    back = ChunkCircuit.deserialize_witness(ChunkCircuit.serialize_witness(w))
    assert ChunkCircuit.serialize_witness(back) == ChunkCircuit.serialize_witness(w)
    if i:
        info0, _ = ChunkCircuit.validate(gen.witness(0))
        info1, version = ChunkCircuit.validate(w)
        assert info1.prev_state_root == info0.post_state_root
        assert info1.prev_msg_queue_hash == info0.post_msg_queue_hash
        info1.validate(info0, version)


@pytest.mark.parametrize("i", [0, 1])
def test_chunk_execute_equals_reference(chunks, i):
    ref_gen, gen, executed = chunks
    ref_insts, ref_pi, insts, pi = executed[i]
    assert pi == ref_pi == ChunkCircuit.pi_hash(gen.witness(i))
    assert len(insts) == len(ref_insts) == 18
    for a, b in zip(insts, ref_insts):
        assert type(a.air).__name__ == type(b.air).__name__
        assert a.trace.dtype == b.trace.dtype
        np.testing.assert_array_equal(a.trace, b.trace)
        assert [int(v) for v in a.public_values] == [int(v) for v in b.public_values]
    meta = [(int(x.trace.shape[0]).bit_length() - 1, int(x.trace.shape[1]),
             [int(v) for v in x.public_values]) for x in insts]
    assert get_app("chunk").pi_hash_from_meta(meta) == pi
    assert ref_get_app("chunk").pi_hash_from_meta(meta) == pi


def test_chunk_airs_match_the_executed_machine(chunks):
    """The AIR list the verifier rebuilds has one AIR per executed
    instance, in order, with KECCAKF_IDX and PV_IDX on their AIRs."""
    _, _, executed = chunks
    insts = executed[0][2]
    meta = [(int(x.trace.shape[0]).bit_length() - 1, 0, []) for x in insts]
    airs = get_app("chunk").airs_for_meta(meta)
    assert [type(a).__name__ for a in airs] == [type(x.air).__name__ for x in insts]
    assert len(get_app("chunk").airs()) == 18
    assert type(airs[scroll_apps.KECCAKF_IDX]).__name__ == "KeccakfAir"
    assert type(airs[scroll_apps.PV_IDX]).__name__ == "PublicValuesAir"
    assert (scroll_apps.KECCAKF_IDX, scroll_apps.PV_IDX) == (
        ref_scroll_apps.KECCAKF_IDX, ref_scroll_apps.PV_IDX)
    assert not hasattr(scroll_apps, "N_MACHINE_AIRS")


@pytest.mark.parametrize("what", ["short", "keccak_below_5", "keccak_above_20"])
@pytest.mark.parametrize("pkg", PACKAGES)
def test_airs_for_meta_rejects(chunks, pkg, what):
    insts = chunks[2][0][2]
    meta = [[int(x.trace.shape[0]).bit_length() - 1, 0, []] for x in insts]
    if what == "short":
        meta = meta[:10]
    else:
        meta[scroll_apps.KECCAKF_IDX][0] = 4 if what == "keccak_below_5" else 21
    with pytest.raises(ValueError):
        _api(pkg)["get_app"]("chunk").airs_for_meta(meta)


# ---------------------------------------------------------------------------
# the in-circuit round trip; the paths that are not ported raise
# ---------------------------------------------------------------------------


def test_in_circuit_aggregation_raises(proven):
    """An in-circuit round trip (the name is the one the test had while the
    path raised `NotImplementedError`, kept so that its history follows
    it): with the default child verification, in-circuit, a fibonacci task
    over a fibonacci envelope (both at 2 queries and 2 PoW bits, which
    keeps the wire verifier small) proves with the verifier beside it,
    carries the aggregation claim and verifies after a JSON round trip; a
    forged child public value gives False."""
    tiny = StarkConfig(fri=FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2))
    prover = Prover.setup(ProverConfig(app_name="fibonacci", stark=tiny, device="cpu"))
    assert prover.config.child_verification == "in-circuit"
    witness = [json.dumps({"log_n": 3, "x0": 1, "x1": 1}).encode()]
    child = prover.gen_proof_stark(ProvingTask(serialized_witness=witness))
    env = prover.gen_proof_stark(ProvingTask(serialized_witness=witness,
                                             aggregated_proofs=[child]))
    assert [r.vk for r in env.agg_children] == [child.baseline]
    assert len(env.input_commits) == 1
    verifier = UniversalVerifier("fibonacci", tiny, device="cpu")
    carried = _carried("port", env)
    assert verifier.verify_stark_proof(carried)
    carried.agg_children[0].pvs[0] = (carried.agg_children[0].pvs[0] + 1) % 100
    assert verifier.verify_stark_proof(carried) is False


def test_with_snark_raises(monkeypatch, tmp_path):
    """`with_snark=True` goes through `gen_proof_snark`: the STARK envelope
    (proved and self-verified first) and the Prover's device reach the BN254
    wrapper, here a stand-in that raises with what it was given (the
    wrapper itself is held to the reference in tests/test_torch_snark.py)."""
    from zkvm_prover_tpu_torch.snark import wrapper

    class Reached(Exception):
        pass

    def stand_in(app_vk, proof_bytes, pi_hash, keys=None, device=None):
        raise Reached(app_vk, proof_bytes, pi_hash, device)

    monkeypatch.setattr(wrapper, "wrap_stark_proof", stand_in)
    prover = _prover("port", "fibonacci", cache_dir=str(tmp_path))
    task = _task("port", "fibonacci")
    with pytest.raises(Reached) as hit:
        prover.gen_proof_universal(task, with_snark=True)
    env = prover.gen_proof_stark(task)  # from the cache the first call filled
    assert hit.value.args == (prover.get_app_vk(), env.proof, env.user_pvs_proof, "cpu")


@pytest.mark.parametrize("what", ["agg_children", "deferral_discharge", "evm_proof"])
def test_unported_verifier_paths_raise(proven, what):
    """A malformed EvmProof gives False (before any key is built). A forged
    `AggChildRecord` on an envelope that aggregates nothing gives False,
    and so does a fibonacci envelope given a deferral discharge: it passes
    the fibonacci vk guard and goes to `verify_deferred`, which wants the
    deferred-agg vk (the name is the one the test had while these paths
    raised)."""
    env = _carried("port", proven["fibonacci", "port"][2])
    v = UniversalVerifier("fibonacci", fast_test_config(), device="cpu")
    if what == "agg_children":
        env.agg_children = [AggChildRecord(vk=env.baseline, log_ns=[4], pvs=[1])]
        assert v.verify_stark_proof(env) is False
    elif what == "deferral_discharge":
        env.deferral_discharge = b"\x01"
        assert v.verify_stark_proof(env) is False
        ref_env = _carried("reference", env)
        assert RefVerifier("fibonacci", ref_fast_config()).verify_stark_proof(ref_env) is False
    else:
        bad = EvmProof(proof=b"\x00", instances=b"\x00" * 32)
        assert v.verify_evm_proof(bad) is False


# ---------------------------------------------------------------------------
# no JAX, no cryptography
# ---------------------------------------------------------------------------

_BLOCKED_IMPORT = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cryptography", "zkvm_prover_tpu"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import zkvm_prover_tpu_torch.host, zkvm_prover_tpu_torch.integration
import zkvm_prover_tpu_torch.types.chunk, zkvm_prover_tpu_torch.circuits
import zkvm_prover_tpu_torch.recursion, zkvm_prover_tpu_torch.recursion.aggregation
import zkvm_prover_tpu_torch.stark.debug
import zkvm_prover_tpu_torch.models.bigint_air, zkvm_prover_tpu_torch.models.ec_air
import zkvm_prover_tpu_torch.models.ec_double, zkvm_prover_tpu_torch.models.vm_ext
import zkvm_prover_tpu_torch.models.fp2_vm, zkvm_prover_tpu_torch.models.sha256_air
import zkvm_prover_tpu_torch.models.sha256_vm, zkvm_prover_tpu_torch.models.deferral_vm
import zkvm_prover_tpu_torch.vm.guests, zkvm_prover_tpu_torch.host.deferred
import zkvm_prover_tpu_torch.models.rv32_continuations
import zkvm_prover_tpu_torch.snark.wrapper, zkvm_prover_tpu_torch.snark.verifier_contract
import zkvm_prover_tpu_torch.snark.evm, zkvm_prover_tpu_torch.ops.msm
import zkvm_prover_tpu_torch.fields.bn254_native
import zkvm_prover_tpu_torch.execution, zkvm_prover_tpu_torch.types.chunk.crypto
import zkvm_prover_tpu_torch.types.chunk.crypto.validium
import zkvm_prover_tpu_torch.parallel.mesh, zkvm_prover_tpu_torch.parallel.pool
import zkvm_prover_tpu_torch.parallel.ntt_sharded, zkvm_prover_tpu_torch.parallel.merkle_sharded
import zkvm_prover_tpu_torch.parallel.fri_sharded, zkvm_prover_tpu_torch.parallel.pipeline_sharded
import zkvm_prover_tpu_torch.bin.chunk_benchmark, zkvm_prover_tpu_torch.bin.chunk_scanner
import zkvm_prover_tpu_torch.bin.build_guest, zkvm_prover_tpu_torch.utils.tracing
import zkvm_prover_tpu_torch.stark.pipeline, zkvm_prover_tpu_torch.host.aggregation
import zkvm_prover_tpu_torch.models.rv32_v0
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "cryptography", "zkvm_prover_tpu")]
print("clean")
"""


def test_host_and_integration_import_without_jax_or_cryptography():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# ---------------------------------------------------------------------------
# the chunk envelope (slow: about 90 s of port proving and verifying here)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_chunk_envelope_equals_reference(tmp_path, monkeypatch):
    """ChunkTaskGenerator task 0 at TINY (2 queries, 2 PoW bits): the port's
    envelope equals the reference's in every field but `stat`, and each
    verifier accepts the other's."""
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path))
    tiny = StarkConfig(fri=FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2))
    ref_tiny = RefStarkConfig(fri=RefFriConfig(log_blowup=1, num_queries=2,
                                               proof_of_work_bits=2))
    ref_gen = RefChunkTaskGenerator(stark=ref_tiny)
    gen = ChunkTaskGenerator(stark=tiny, device="cpu")
    w = ref_gen.witness(0)
    ref_task = RefProvingTask(serialized_witness=[RefChunkCircuit.serialize_witness(w)],
                              fork_name=w.fork_name.value, identifier="chunk-0",
                              vk=ref_gen.prover.get_app_vk())
    ref = _with_reference_on_host(lambda: ref_gen.prover.gen_proof_stark(ref_task))
    port = gen.prover.gen_proof_stark(gen.task(0))
    for name in ("proof", "user_pvs_proof", "baseline", "deferral_merkle_proofs"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.stat.total_cycles == ref.stat.total_cycles
    verifier = UniversalVerifier("chunk", tiny, device="cpu")
    assert verifier.verify_stark_proof(_carried("port", ref)) is True
    assert RefVerifier("chunk", ref_tiny).verify_stark_proof(_carried("reference", port))
