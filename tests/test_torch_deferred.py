"""The port's deferred aggregation (`host/deferred.py`, the deferred-agg
guest in `vm/guests.py`) against the JAX package.

Tier 1, exact (no tolerance): the guest's words and hint streams; the
app's `execute` for 1, 2 and 5 synthetic children (each child a StarkProof
whose `baseline` and `user_pvs_proof` bytes come from a seed: `execute`
reads nothing else), every trace, public value and pi-hash, and the app's
vk; `airs_for_meta` against the executed machine and its rejections; the
AIR positions derived from the AIR list against the reference's constants;
`verify_deferred` on envelopes that fail before any proof is decoded; the
`UniversalVerifier` route (after the vk guard, with the verifier's device);
`device=None` needing a card.

Under `slow`: the deferred envelope over two fibonacci children at
fast_test_config() (8 queries), built once per package: equal to the
reference's in every field but `stat`, each `verify_deferred` accepting
the other's envelope, and five tampers (the reference test's four and a
flipped byte of the revealed hash) False in both."""

import copy
import json

import numpy as np
import pytest
import torch

from zkvm_prover_tpu.host import deferred as ref_deferred
from zkvm_prover_tpu.host.proof_types import AggChildRecord as RefAggChildRecord
from zkvm_prover_tpu.host.proof_types import ProofEnum as RefProofEnum
from zkvm_prover_tpu.host.proof_types import StarkProof as RefStarkProof
from zkvm_prover_tpu.host.prover import Prover as RefProver
from zkvm_prover_tpu.host.prover import ProverConfig as RefProverConfig
from zkvm_prover_tpu.host.task import ProvingTask as RefProvingTask
from zkvm_prover_tpu.host.verifier import UniversalVerifier as RefVerifier
from zkvm_prover_tpu.models import symbolic as ref_symbolic
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import fast_test_config as ref_fast_config
from zkvm_prover_tpu.vm import guests as ref_guests
from zkvm_prover_tpu_torch.host import ProofEnum, ProvingTask, StarkProof, UniversalVerifier
from zkvm_prover_tpu_torch.host import deferred
from zkvm_prover_tpu_torch.host.app import app_for_vk
from zkvm_prover_tpu_torch.host.proof_types import AggChildRecord
from zkvm_prover_tpu_torch.models import symbolic
from zkvm_prover_tpu_torch.stark.config import fast_test_config
from zkvm_prover_tpu_torch.vm import guests


def _children(n, seed, proof_cls):
    """n synthetic child envelopes: seeded vk (64) and pi-hash (32) bytes."""
    rng = np.random.default_rng(seed)
    return [proof_cls(proof=b"", user_pvs_proof=rng.bytes(32), baseline=rng.bytes(64))
            for _ in range(n)]


def _leaves(n, seed):
    return [deferred.leaf_bytes(c.baseline, c.user_pvs_proof)
            for c in _children(n, seed, StarkProof)]


# ---------------------------------------------------------------------------
# the guest
# ---------------------------------------------------------------------------


def test_deferred_agg_program_words_equal():
    assert guests.deferred_agg_program() == ref_guests.deferred_agg_program()
    assert deferred.DeferredAggApp().program() == guests.deferred_agg_program()


@pytest.mark.parametrize("n", [0, 1, 3])
def test_deferred_agg_hints_equal(n):
    leaves = _leaves(n, 10 + n)
    assert guests.deferred_agg_hints(leaves) == ref_guests.deferred_agg_hints(leaves)


def test_leaf_bytes_equal():
    vk, pi = np.random.default_rng(3).bytes(64), np.random.default_rng(4).bytes(32)
    assert deferred.leaf_bytes(vk, pi) == ref_deferred.leaf_bytes(vk, pi)
    with pytest.raises(ValueError):
        deferred.leaf_bytes(vk, pi[:31])


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


def test_app_vk_equal_and_registered():
    vk = deferred.DeferredAggApp().vk_bytes()
    assert vk == ref_deferred.DeferredAggApp().vk_bytes()
    assert isinstance(app_for_vk(vk), deferred.DeferredAggApp)


@pytest.fixture(scope="module")
def executed():
    """Per child count: (reference instances, pi-hash), (port ...)."""
    out = {}
    for n in (1, 2, 5):
        ref = ref_deferred.DeferredAggApp().execute(RefProvingTask(
            serialized_witness=[], aggregated_proofs=_children(n, n, RefStarkProof)))
        port = deferred.DeferredAggApp().execute(ProvingTask(
            serialized_witness=[], aggregated_proofs=_children(n, n, StarkProof)))
        out[n] = ref, port
    return out


@pytest.mark.parametrize("n", [1, 2, 5])
def test_execute_equals_reference(executed, n):
    (ref_insts, ref_pi), (insts, pi) = executed[n]
    assert pi == ref_pi
    assert pi == deferred.keccak256(b"".join(_leaves(n, n)))
    assert len(insts) == len(ref_insts) == len(deferred._MACHINE)
    for r, p in zip(ref_insts, insts):
        name = type(p.air).__name__
        assert name == type(r.air).__name__
        assert p.trace.dtype == np.uint32 and p.trace.shape == r.trace.shape, name
        np.testing.assert_array_equal(p.trace, np.asarray(r.trace), err_msg=name)
        assert [int(v) for v in p.public_values] == [int(v) for v in r.public_values], name


@pytest.mark.parametrize("n", [1, 2, 5])
def test_meta_readers_equal_reference(executed, n):
    """pi_hash_from_meta and deferral_digest_from_meta read the executed
    machine's public values as the reference reads them."""
    (ref_insts, _), (insts, pi) = executed[n]
    metas = [(int(i.trace.shape[0]).bit_length() - 1, i.air.width, list(i.public_values))
             for i in insts]
    app = deferred.DeferredAggApp()
    assert app.pi_hash_from_meta(metas) == pi
    assert app.pi_hash_from_meta(metas) == ref_deferred.DeferredAggApp().pi_hash_from_meta(metas)
    digest = app.deferral_digest_from_meta(metas)
    np.testing.assert_array_equal(digest, deferred.chain_digest_from_leaves(_leaves(n, n)))
    np.testing.assert_array_equal(
        digest, ref_deferred.DeferredAggApp.deferral_digest_from_meta(metas))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_airs_for_meta_matches_the_executed_machine(executed, n):
    """The verifier's AIR list has the executed instances' types, order,
    KeccakfAir height and constraint streams, as the reference's does."""
    (ref_insts, _), (insts, _) = executed[n]
    metas = [(int(i.trace.shape[0]).bit_length() - 1, i.air.width, list(i.public_values))
             for i in insts]
    airs = deferred.DeferredAggApp().airs_for_meta(metas)
    ref_airs = ref_deferred.DeferredAggApp().airs_for_meta(metas)
    assert [type(a) for a in airs] == [type(i.air) for i in insts]
    assert [type(a).__name__ for a in airs] == [type(a).__name__ for a in ref_airs]
    for a, i in zip(airs, insts):
        assert symbolic.serialize_air(a) == symbolic.serialize_air(i.air), type(a).__name__
    kf = airs[deferred.KECCAKF_IDX]
    assert symbolic.serialize_air(kf) == ref_symbolic.serialize_air(ref_airs[deferred.KECCAKF_IDX])


def test_air_positions_come_from_the_air_list():
    """The positions the port derives equal the reference's constants."""
    assert (deferred.KECCAKF_IDX, deferred.DEFER_IDX, deferred.PV_IDX) == (
        ref_deferred.KECCAKF_IDX, ref_deferred.DEFER_IDX, ref_deferred.PV_IDX)
    assert len(deferred._MACHINE) == ref_deferred.N_MACHINE_AIRS
    airs = deferred.DeferredAggApp().airs()
    assert type(airs[deferred.DEFER_IDX]).__name__ == "DeferralVmAir"
    assert type(airs[deferred.PV_IDX]).__name__ == "PublicValuesAir"


@pytest.mark.parametrize("how", ["short", "keccak_low", "keccak_high"])
def test_airs_for_meta_rejects(how):
    meta = [(5, 1, [])] * len(deferred._MACHINE)
    if how == "short":
        meta = meta[:-1]
    else:
        meta[deferred.KECCAKF_IDX] = (4 if how == "keccak_low" else 21, 1, [])
    for app in (deferred.DeferredAggApp(), ref_deferred.DeferredAggApp()):
        with pytest.raises(ValueError):
            app.airs_for_meta(meta)


def test_execute_without_children_raises():
    with pytest.raises(ValueError, match="needs children"):
        deferred.DeferredAggApp().execute(ProvingTask(serialized_witness=[]))


# ---------------------------------------------------------------------------
# the verifier on envelopes that fail before any proof is decoded
# ---------------------------------------------------------------------------


def _envelope(proof_cls, record_cls, how):
    vk = deferred.DeferredAggApp().vk_bytes()
    env = proof_cls(proof=b"\x00", user_pvs_proof=b"\x00" * 32, baseline=vk,
                    agg_children=[record_cls(vk=vk, log_ns=[5], pvs=[1])],
                    input_commits=[b"\x00" * 32], deferral_discharge=b"\x01")
    if how == "wrong_baseline":
        env.baseline = bytes(64)
    elif how == "no_children":
        env.agg_children, env.input_commits = [], []
    elif how == "no_discharge":
        env.deferral_discharge = b""
    return env


@pytest.mark.parametrize("how", ["wrong_baseline", "no_children", "no_discharge", "garbage"])
def test_verify_deferred_rejects(how):
    assert deferred.verify_deferred(_envelope(StarkProof, AggChildRecord, how),
                                    fast_test_config(), device="cpu") is False
    assert ref_deferred.verify_deferred(_envelope(RefStarkProof, RefAggChildRecord, how),
                                        ref_fast_config()) is False


def test_universal_verifier_routes_after_the_vk_guard(monkeypatch):
    """A discharge envelope reaches `verify_deferred` with the verifier's
    device only once its baseline passed the vk guard."""
    calls = []

    def recorder(proof, stark, device=None):
        calls.append(device)
        return True

    monkeypatch.setattr(deferred, "verify_deferred", recorder)
    vk = deferred.DeferredAggApp().vk_bytes()
    env = _envelope(StarkProof, AggChildRecord, "garbage")
    assert UniversalVerifier.verify_stark_proof_with_vk(
        bytes(64), env, fast_test_config(), device="cpu") is False
    assert calls == []
    assert UniversalVerifier.verify_stark_proof_with_vk(
        vk, env, fast_test_config(), device="cpu") is True
    assert calls == ["cpu"]


def test_universal_verifier_rejects_a_forged_discharge_envelope():
    vk = deferred.DeferredAggApp().vk_bytes()
    env = _envelope(StarkProof, AggChildRecord, "garbage")
    assert UniversalVerifier.verify_stark_proof_with_vk(
        vk, env, fast_test_config(), device="cpu") is False
    ref_env = _envelope(RefStarkProof, RefAggChildRecord, "garbage")
    assert RefVerifier.verify_stark_proof_with_vk(vk, ref_env, ref_fast_config()) is False


def test_default_device_needs_a_card(monkeypatch):
    """device=None means the card, in the prover and in the verifier."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deferred.DeferredProver(fast_test_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deferred.verify_deferred(_envelope(StarkProof, AggChildRecord, "garbage"),
                                 fast_test_config())


# ---------------------------------------------------------------------------
# the whole envelope (slow: both packages prove a parent machine and a
# discharge node over two fibonacci children)
# ---------------------------------------------------------------------------


def _on_host(fn):
    """Run a reference prove on its host numpy path (not JAX)."""
    saved = ref_machine._DEVICE_MIN_ELEMS
    ref_machine._DEVICE_MIN_ELEMS = 1 << 62
    try:
        return fn()
    finally:
        ref_machine._DEVICE_MIN_ELEMS = saved


def _carried(to_cls, env):
    return to_cls.from_dict(json.loads(json.dumps(env.to_dict())))


@pytest.fixture(scope="module")
def envelopes():
    """The reference's two fibonacci children (log_n 5) and its deferred
    envelope; the port's envelope over the same children; the reference's
    envelope over the first child alone (the wrong-children case)."""
    cfg = ref_fast_config()
    prover = RefProver.setup(RefProverConfig(app_name="fibonacci", stark=cfg))
    children = [_on_host(lambda: prover.gen_proof_stark(RefProvingTask(
        identifier=f"defer-child-{i}", serialized_witness=[b'{"log_n": 5}'])))
        for i in range(2)]
    ref_prover = ref_deferred.DeferredProver(cfg)
    ref = _on_host(lambda: ref_prover.prove(children, identifier="defer-e2e"))
    single = _on_host(lambda: ref_prover.prove(children[:1], identifier="defer-one"))
    port_children = [_carried(ProofEnum, c) for c in children]
    port = deferred.DeferredProver(fast_test_config(), device="cpu").prove(
        port_children, identifier="defer-e2e")
    return {"children": children, "ref": ref, "port": port, "single": single}


@pytest.mark.slow
def test_deferred_envelope_equals_reference(envelopes):
    ref, port = envelopes["ref"], envelopes["port"]
    for name in ("proof", "user_pvs_proof", "baseline", "deferral_merkle_proofs",
                 "input_commits", "deferral_discharge"):
        assert getattr(port, name) == getattr(ref, name), name
    assert [c.to_dict() for c in port.agg_children] == [c.to_dict() for c in ref.agg_children]
    assert port.stat.total_cycles == ref.stat.total_cycles
    carried = _carried(ProofEnum, ref)
    assert deferred.verify_deferred(carried, fast_test_config(), device="cpu") is True
    assert UniversalVerifier.verify_stark_proof_with_vk(
        deferred.DeferredAggApp().vk_bytes(), carried, fast_test_config(), device="cpu") is True
    assert _on_host(lambda: ref_deferred.verify_deferred(
        _carried(RefProofEnum, port), ref_fast_config())) is True


def _tampered(env, how, single):
    bad = copy.deepcopy(env)
    if how == "discharge":
        raw = bytearray(bad.deferral_discharge)
        raw[len(raw) // 2] ^= 1
        bad.deferral_discharge = bytes(raw)
    elif how == "child_record":
        bad.agg_children[0].pvs = list(bad.agg_children[0].pvs)
        bad.agg_children[0].pvs[0] ^= 1
    elif how == "parent":
        raw = bytearray(bad.proof)
        raw[len(raw) // 3] ^= 1
        bad.proof = bytes(raw)
    elif how == "wrong_children":
        for name in ("agg_children", "input_commits", "deferral_merkle_proofs",
                     "deferral_discharge"):
            setattr(bad, name, copy.deepcopy(getattr(single, name)))
    elif how == "revealed_hash":
        bad.user_pvs_proof = bytes([bad.user_pvs_proof[0] ^ 1]) + bad.user_pvs_proof[1:]
    return bad


@pytest.mark.slow
@pytest.mark.parametrize("how", ["discharge", "child_record", "parent", "wrong_children",
                                 "revealed_hash"])
def test_deferred_tampers_rejected(envelopes, how):
    """The reference test's four tamper cases and a flipped byte of the
    revealed hash (the parent's PVs bind it), False in both packages."""
    ref, single = envelopes["ref"], envelopes["single"]
    port_bad = _tampered(_carried(ProofEnum, ref), how, _carried(ProofEnum, single))
    ref_bad = _tampered(ref, how, single)
    assert deferred.verify_deferred(port_bad, fast_test_config(), device="cpu") is False
    assert _on_host(lambda: ref_deferred.verify_deferred(ref_bad, ref_fast_config())) is False
