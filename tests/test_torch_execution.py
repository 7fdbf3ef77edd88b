"""The port's stateless re-execution (`zkvm_prover_tpu_torch/execution/`,
the chunk witness's `execute_and_fold` and the block-witness codec of
`circuits/chunk_circuit.py`) against the JAX package's.

Every case of the reference's `tests/test_execution.py` runs through both
packages on the same inputs: the single sealed block of that file (a
transfer, a storage write, an L1 message), and a three-block chain from a
seed (`chip_smoke.build_chain` at a small size: a token contract, a
contract that calls every precompile 0x01-0x08, a contract creation, a
reverting call, an L1 message a block, the L1 data fee in its Curie form),
each built and sealed once per module in each package. Summaries, roots,
receipts, gas, block hashes, the serialized chunk witness, the ChunkInfo
and the PI hash are equal with no tolerance; tampered headers, missing
nodes and bad signatures are rejected by both. The one divergence is the
sender check: the reference runs a transaction under the sender its
witness claims, the port recovers it from the signature and refuses a
claim that differs."""

import copy
import dataclasses
import enum
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from zkvm_prover_tpu_torch import convert  # noqa: E402

PACKAGES = ("reference", "port")
NAMES = {"reference": "zkvm_prover_tpu", "port": "zkvm_prover_tpu_torch"}
SEED = 11

# the reference test's identities
ALICE_PRIV = 0xA11CE
BOB = b"\xB0" * 20
COINBASE = b"\xFE" * 20
L1_SENDER = b"\x11" * 20
SETTER_CODE = bytes.fromhex("60003560005500")     # SSTORE(0, CALLDATALOAD(0))
SETTER = b"\xC0\xDE" + b"\x00" * 18


def _api(pkg: str):
    api = chip_smoke.execution_api(NAMES[pkg])
    for key, name in {"interp": "execution.interpreter", "circuit": "circuits.chunk_circuit",
                      "witness": "types.chunk.witness", "version": "types.base.version",
                      "fork": "types.base.fork_name"}.items():
        setattr(api, key, importlib.import_module(f"{NAMES[pkg]}.{name}"))
    return api


API = {pkg: _api(pkg) for pkg in PACKAGES}


def _pkg(api) -> str:
    return next(p for p in PACKAGES if API[p] is api)


def plain(obj):
    """`obj` with every dataclass as (class name, fields) and every enum as
    its value, so the two packages' objects compare by content."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, plain(getattr(obj, f.name))) for f in dataclasses.fields(obj)))
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [plain(x) for x in obj]
    if isinstance(obj, dict):
        return [(plain(k), plain(v)) for k, v in obj.items()]
    if isinstance(obj, set):
        return sorted(plain(x) for x in obj)
    return obj


def both(fn):
    """fn(api) in each package; the two results, asserted equal."""
    ref, port = (fn(API[pkg]) for pkg in PACKAGES)
    assert plain(ref) == plain(port)
    return port


# ---------------------------------------------------------------------------
# the reference test's sealed block, built in each package
# ---------------------------------------------------------------------------


def _seal(api, trie_root, nodes, codes, txs, number=1, base_fee=1, parent=b"\x33" * 32):
    blk = api.blk
    state = api.state.WorldState(trie_root, dict(nodes), dict(codes))
    ctx = blk.BlockCtx(number=number, timestamp=1000 + number, coinbase=COINBASE,
                       gas_limit=30_000_000, base_fee=base_fee)
    receipts, gas = [], 0
    for tx in txs:
        r, g = blk.execute_tx(state, ctx, tx, gas)
        gas += g
        receipts.append(r)
    header = blk.Header(
        parent_hash=parent, coinbase=COINBASE, state_root=state.state_root(),
        transactions_root=blk._ordered_trie_root([t.encode() for t in txs]),
        receipts_root=blk._ordered_trie_root([r.encode() for r in receipts]),
        number=number, gas_limit=30_000_000, gas_used=gas, timestamp=1000 + number,
        base_fee_per_gas=base_fee)
    return header, state, receipts


def _collect(api, trie, touched, slots):
    mpt, keccak256 = api.mpt, api.keccak.keccak256
    nodes = {}
    for addr in touched:
        for n in trie.collect_path_nodes(mpt.secure_key(addr)):
            nodes[keccak256(n)] = n
    for addr, keys in slots.items():
        raw = trie.get(mpt.secure_key(addr))
        if raw is None:
            continue
        st = mpt.Mpt(api.state.Account.from_rlp(raw).storage_root, trie.nodes)
        for slot in keys:
            for n in st.collect_path_nodes(mpt.secure_key(slot.to_bytes(32, "big"))):
                nodes[keccak256(n)] = n
    return nodes


def _sealed_block(api, forge: bool = False):
    """The reference test's genesis (Alice funded, the setter contract, the
    withdraw predeploy with slot 0 = 0xAB..), its three transactions and
    the sealed block's witness. With `forge`, a funded account other than
    Alice is the claimed sender of Alice's signed transfer (the block is
    sealed so)."""
    blk, mpt, rlp, st = api.blk, api.mpt, api.rlp, api.state
    alice = chip_smoke.address_of(api, ALICE_PRIV)
    trie = mpt.Mpt(mpt.EMPTY_ROOT)
    codes = {api.keccak.keccak256(SETTER_CODE): SETTER_CODE}
    trie.update(mpt.secure_key(alice), st.Account(balance=10**18).rlp())
    trie.update(mpt.secure_key(SETTER),
                st.Account(code_hash=api.keccak.keccak256(SETTER_CODE)).rlp())
    storage = mpt.Mpt(mpt.EMPTY_ROOT, trie.nodes)
    storage.update(mpt.secure_key((0).to_bytes(32, "big")), rlp.encode_int(0xAB << 248))
    trie.update(mpt.secure_key(blk.WITHDRAW_QUEUE_ADDRESS),
                st.Account(storage_root=storage.root).rlp())
    victim = b"\x77" * 20
    if forge:
        trie.update(mpt.secure_key(victim), st.Account(balance=10**18).rlp())
    t1 = chip_smoke.sign_tx(api, blk.Tx(tx_type=0, nonce=0, gas_limit=21000, to=BOB, value=12345,
                                        data=b"", gas_price=10, chain_id=534352), ALICE_PRIV)
    t2 = chip_smoke.sign_tx(api, blk.Tx(tx_type=2, nonce=1, gas_limit=100000, to=SETTER, value=0,
                                        data=(77).to_bytes(32, "big"), max_fee=100,
                                        max_priority_fee=2, chain_id=534352), ALICE_PRIV)
    t3 = blk.Tx(tx_type=blk.L1_MSG_TX_TYPE, nonce=0, gas_limit=100000, to=BOB, value=0,
                data=b"", sender=L1_SENDER)
    txs = [t1, t2, t3]
    if forge:
        t1.sender = victim
        txs = [t1, t3]
    header, _, receipts = _seal(api, trie.root, trie.nodes, codes, txs)
    touched = [alice, BOB, SETTER, COINBASE, L1_SENDER, victim, blk.WITHDRAW_QUEUE_ADDRESS,
               blk.L1_GAS_PRICE_ORACLE_ADDRESS]
    nodes = _collect(api, trie, touched, {SETTER: [0], blk.WITHDRAW_QUEUE_ADDRESS: [0]})
    witness = blk.BlockWitness(header=header, txs=txs, state_nodes=nodes, codes=dict(codes))
    return {"root": trie.root, "witness": witness, "receipts": receipts, "alice": alice,
            "victim": victim}


def _small_chain(api):
    chain = chip_smoke.build_chain(api, SEED, accounts=16, signers=4, blocks=3, txs=8)
    return {"root": chain["genesis_root"], "witnesses": chain["witnesses"],
            "receipts": chain["receipts"], "precompiles": chip_smoke.precompile_results(api, chain)}


@pytest.fixture(scope="module")
def sealed():
    return {pkg: _sealed_block(API[pkg]) for pkg in PACKAGES}


@pytest.fixture(scope="module")
def chain():
    return {pkg: _small_chain(API[pkg]) for pkg in PACKAGES}


@pytest.fixture(scope="module")
def executed(sealed, chain):
    """execute_chunk_blocks of the sealed block and of the chain, per package."""
    out = {}
    for pkg in PACKAGES:
        blk = API[pkg].blk
        out["sealed", pkg] = blk.execute_chunk_blocks([sealed[pkg]["witness"]], sealed[pkg]["root"])
        out["chain", pkg] = blk.execute_chunk_blocks(chain[pkg]["witnesses"], chain[pkg]["root"])
    return out


def _witnesses(sealed, chain, which, pkg):
    if which == "sealed":
        return sealed[pkg]["root"], [sealed[pkg]["witness"]]
    return chain[pkg]["root"], chain[pkg]["witnesses"]


# ---------------------------------------------------------------------------
# equal outputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["sealed", "chain"])
def test_built_blocks_equal(sealed, chain, which):
    """Genesis, sealed headers (roots, gas, block hash) and witnesses agree."""
    (ref_root, ref_ws), (root, ws) = (_witnesses(sealed, chain, which, p) for p in PACKAGES)
    assert root == ref_root
    assert plain(ws) == plain(ref_ws)
    assert [w.header.block_hash() for w in ws] == [w.header.block_hash() for w in ref_ws]
    if which == "chain":
        assert [w.header.parent_hash for w in ws[1:]] == [w.header.block_hash() for w in ws[:-1]]
        assert all(chain["port"]["precompiles"].values())
        assert chain["port"]["precompiles"] == chain["reference"]["precompiles"]


@pytest.mark.parametrize("which", ["sealed", "chain"])
def test_execution_summaries_equal(sealed, chain, executed, which):
    ref, port = executed[which, "reference"], executed[which, "port"]
    summaries, pre, post, withdraw = port
    assert plain(summaries) == plain(ref[0])
    assert (pre, post, withdraw) == tuple(ref[1:])
    _, ws = _witnesses(sealed, chain, which, "port")
    assert post == ws[-1].header.state_root
    assert [s.gas_used for s in summaries] == [w.header.gas_used for w in ws]
    assert [s.block_hash for s in summaries] == [w.header.block_hash() for w in ws]
    if which == "sealed":     # the reference test's own checks
        assert withdraw[0] == 0xAB
        assert len(summaries[0].l1_msg_hashes) == 1 and len(summaries[0].encoded_l2_txs) == 2


@pytest.mark.parametrize("which", ["sealed", "chain"])
def test_receipts_equal(sealed, chain, which):
    """The sealing runs' receipts (status, cumulative gas, bloom, logs) and
    gas; re-execution holds them to each header's receipts root."""
    def receipts(pkg):
        blocks = [sealed[pkg]["receipts"]] if which == "sealed" else chain[pkg]["receipts"]
        return [[(r.encode(), r.success, r.cumulative_gas) for r in rs] for rs in blocks]

    got = receipts("port")
    assert got == receipts("reference")
    _, ws = _witnesses(sealed, chain, which, "port")
    assert [rs[-1][2] for rs in got] == [w.header.gas_used for w in ws]
    if which == "chain":
        assert [ok for rs in got for _, ok, _ in rs].count(False) == 1   # the reverting call


@pytest.mark.parametrize("which,version", [("sealed", "euclid_v2"), ("sealed", "galileo_v2"),
                                           ("chain", "galileo_v2")])
def test_chunk_witness_codec_and_info_equal(sealed, chain, which, version):
    """ChunkCircuit.serialize_witness is byte-equal; deserialize, validate
    (re-execution) and the PI hash agree; the JSON round trip is exact."""
    def fold(api):
        root, ws = _witnesses(sealed, chain, which, _pkg(api))
        v = getattr(api.version.Version, version)()
        w = api.witness.ChunkWitness(version=v.as_version_byte(), blocks=[],
                                     prev_msg_queue_hash=b"\x00" * 32, fork_name=v.fork,
                                     prev_state_root=root, block_witnesses=copy.deepcopy(ws))
        cc = api.circuit.ChunkCircuit
        raw = cc.serialize_witness(w)
        back = cc.deserialize_witness(raw)
        assert cc.serialize_witness(back) == raw
        info, got = cc.validate(back)
        return raw, info, info.pi_hash_by_version(got)

    raw, info, _ = both(fold)
    _, ws = _witnesses(sealed, chain, which, "port")
    assert info.post_state_root == ws[-1].header.state_root
    assert [c.num_txs for c in info.block_ctxs] == [len(w.txs) for w in ws]
    assert info.post_blockhash == ws[-1].header.block_hash()


def test_chunk_info_from_real_execution(sealed, executed):
    """The reference test's fold of the summaries into ChunkInfo."""
    def fold(api):
        pkg = _pkg(api)
        summaries, pre, post, wroot = executed["sealed", pkg]
        w = api.witness.ChunkWitness(
            version=8, blocks=summaries, prev_msg_queue_hash=b"\x00" * 32,
            fork_name=api.fork.ForkName.EUCLID_V2, prev_state_root=pre, post_state_root=post,
            withdraw_root=wroot, prev_blockhash=sealed[pkg]["witness"].header.parent_hash)
        return api.witness.chunk_info_from_execution(w)

    info = both(fold)
    assert info.tx_data_length > 0
    assert (info.block_ctxs[0].num_txs, info.block_ctxs[0].num_l1_msgs) == (3, 1)


def test_reference_witness_converts(sealed, chain):
    """`convert.witness_from_reference` carries a chunk witness with its
    block witnesses (dicts of nodes and codes) into the port's classes."""
    ref_api, api = API["reference"], API["port"]
    v = ref_api.version.Version.galileo_v2()
    ref_w = ref_api.witness.ChunkWitness(
        version=v.as_version_byte(), blocks=[], prev_msg_queue_hash=b"\x00" * 32,
        fork_name=v.fork, prev_state_root=chain["reference"]["root"],
        block_witnesses=chain["reference"]["witnesses"])
    w = convert.witness_from_reference(ref_w)
    assert type(w.block_witnesses[0]).__module__ == api.blk.__name__
    assert isinstance(w.block_witnesses[0].state_nodes, dict)
    assert (api.circuit.ChunkCircuit.serialize_witness(w)
            == ref_api.circuit.ChunkCircuit.serialize_witness(ref_w))


def test_execution_updates_balances_and_storage(sealed):
    def run(api):
        pkg = _pkg(api)
        s = sealed[pkg]
        _, post, state = api.blk.execute_block(copy.deepcopy(s["witness"]), s["root"])
        alice = s["alice"]
        return (post, state.get_balance(BOB), state.get_storage(SETTER, 0), state.get_nonce(alice),
                state.get_balance(alice), state.get_balance(COINBASE))

    post, bob, slot, nonce, alice, _ = both(run)
    assert (bob, slot, nonce) == (12345, 77, 2) and alice < 10**18 - 12345


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------


def _raises_in_both(fn, errors):
    for pkg in PACKAGES:
        with pytest.raises(errors(API[pkg])):
            fn(API[pkg], pkg)


@pytest.mark.parametrize("field", ["gas_used", "state_root", "transactions_root",
                                   "receipts_root"])
@pytest.mark.parametrize("which", ["sealed", "chain"])
def test_tampered_header_rejected(sealed, chain, which, field):
    def run(api, pkg):
        root, ws = _witnesses(sealed, chain, which, pkg)
        ws = copy.deepcopy(ws)
        h = ws[0].header
        if field == "gas_used":
            h.gas_used += 1
        else:
            v = bytearray(getattr(h, field))
            v[0] ^= 1
            setattr(h, field, bytes(v))
        api.blk.execute_chunk_blocks(ws, root)

    _raises_in_both(run, lambda api: api.blk.ExecutionError)


@pytest.mark.parametrize("how", ["gas_used", "post_state_root", "withdraw_root"])
def test_tampered_chunk_rejected(sealed, how):
    """Through ChunkCircuit.validate, as the reference test does: a header's
    gas_used, and claimed roots that re-execution contradicts (the
    reference asserts, the port raises ValueError)."""
    def run(api, pkg):
        v = api.version.Version.euclid_v2()
        w = api.witness.ChunkWitness(
            version=v.as_version_byte(), blocks=[], prev_msg_queue_hash=b"\x00" * 32,
            fork_name=v.fork, prev_state_root=sealed[pkg]["root"],
            block_witnesses=[copy.deepcopy(sealed[pkg]["witness"])])
        cc = api.circuit.ChunkCircuit
        w = cc.deserialize_witness(cc.serialize_witness(w))
        if how == "gas_used":
            w.block_witnesses[0].header.gas_used += 1
        else:
            setattr(w, how, b"\x01" * 32)
        cc.validate(w)

    _raises_in_both(run, lambda api: (api.blk.ExecutionError, AssertionError, ValueError))


@pytest.mark.parametrize("which", ["sealed", "chain"])
def test_missing_witness_node_detected(sealed, chain, which):
    def run(api, pkg):
        root, ws = _witnesses(sealed, chain, which, pkg)
        ws = copy.deepcopy(ws)
        ws[0].state_nodes = {}
        api.blk.execute_chunk_blocks(ws, root)

    _raises_in_both(run, lambda api: api.mpt.MissingNode)


@pytest.mark.parametrize("claimed", [True, False])
@pytest.mark.parametrize("which", ["sealed", "chain"])
def test_bad_signature_rejected(sealed, chain, which, claimed):
    """A flipped r: with the sealed sender still claimed (the reference's
    test: its transactions root no longer matches; the port's recovery
    disagrees with the claim first) and with no sender claimed."""
    def run(api, pkg):
        root, ws = _witnesses(sealed, chain, which, pkg)
        ws = copy.deepcopy(ws)
        tx = next(t for t in ws[0].txs if not t.is_l1_msg)
        tx.r ^= 1
        if not claimed:
            tx.sender = None
        api.blk.execute_chunk_blocks(ws, root)

    _raises_in_both(run, lambda api: (api.blk.ExecutionError, ValueError))


def test_forged_sender_reference_accepts_port_raises():
    """A transfer signed by Alice whose witness claims another funded
    account as sender, sealed so: the reference re-executes it through
    ChunkCircuit (the claimed account pays), the port raises ValueError in
    `recover_sender`."""
    ref_api, api = API["reference"], API["port"]
    forged = _sealed_block(ref_api, forge=True)
    v = ref_api.version.Version.euclid_v2()
    ref_w = ref_api.witness.ChunkWitness(
        version=v.as_version_byte(), blocks=[], prev_msg_queue_hash=b"\x00" * 32,
        fork_name=v.fork, prev_state_root=forged["root"], block_witnesses=[forged["witness"]])
    raw = ref_api.circuit.ChunkCircuit.serialize_witness(ref_w)
    info, _ = ref_api.circuit.ChunkCircuit.validate(
        ref_api.circuit.ChunkCircuit.deserialize_witness(raw))
    assert info.post_state_root == forged["witness"].header.state_root
    _, _, state = ref_api.blk.execute_block(copy.deepcopy(forged["witness"]), forged["root"])
    assert state.get_balance(forged["victim"]) < 10**18
    assert state.get_balance(forged["alice"]) == 10**18

    w = api.circuit.ChunkCircuit.deserialize_witness(raw)
    with pytest.raises(ValueError, match="claimed sender"):
        api.circuit.ChunkCircuit.validate(w)
    tx = api.circuit.ChunkCircuit.deserialize_witness(raw).block_witnesses[0].txs[0]
    with pytest.raises(ValueError, match="claimed sender"):
        tx.recover_sender()
    tx.sender = None
    assert tx.recover_sender() == forged["alice"]


def test_sender_recovery_roundtrip():
    def run(api):
        blk = api.blk
        tx = chip_smoke.sign_tx(api, blk.Tx(tx_type=0, nonce=0, gas_limit=21000, to=BOB, value=1,
                                            data=b"", gas_price=10, chain_id=534352), ALICE_PRIV)
        tx2 = chip_smoke.sign_tx(api, blk.Tx(tx_type=2, nonce=5, gas_limit=50000, to=None,
                                             value=0, data=b"\x00", max_fee=30,
                                             max_priority_fee=1, chain_id=534352), ALICE_PRIV)
        pre = chip_smoke.sign_tx(api, blk.Tx(tx_type=0, nonce=1, gas_limit=21000, to=BOB, value=1,
                                             data=b"", gas_price=10, chain_id=0), ALICE_PRIV)
        return [t.recover_sender() for t in (tx, tx2, pre)] + [tx.encode(), tx2.tx_hash()]

    got = both(run)
    assert got[:3] == [chip_smoke.address_of(API["port"], ALICE_PRIV)] * 3


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


def _deploy(api, state, addr, code):
    h = api.keccak.keccak256(code)
    state.codes[h] = code
    if addr not in state.accounts:
        state.create_account(addr)
    state.accounts[addr].code_hash = h


def _call(api, state, to, data=b"", gas=100000, tx=None, block=None):
    alice = chip_smoke.address_of(api, ALICE_PRIV)
    it = api.interp
    return it.execute_message(state, block or it.BlockCtx(), tx or it.TxCtx(origin=alice),
                              it.Message(caller=alice, to=to, value=0, data=data, gas=gas))


def test_evm_call_semantics():
    """CREATE, a call into the created code, and REVERT rolling a write back."""
    def run(api):
        it = api.interp
        alice = chip_smoke.address_of(api, ALICE_PRIV)
        state = api.state.WorldState(api.mpt.EMPTY_ROOT, {}, {})
        state.add_balance(alice, 10**18)
        init = bytes.fromhex("66") + SETTER_CODE + bytes.fromhex("5F5260076019F3")
        res = it.execute_message(state, it.BlockCtx(), it.TxCtx(origin=alice),
                                 it.Message(caller=alice, to=None, value=0, data=init,
                                            gas=200000))
        res2 = _call(api, state, res.created, (42).to_bytes(32, "big"))
        _deploy(api, state, b"\xEE" * 20, bytes.fromhex("600760005560006000FD"))
        res3 = _call(api, state, b"\xEE" * 20)
        return (res, res2, res3, state.get_code(res.created), state.get_storage(res.created, 0),
                state.get_storage(b"\xEE" * 20, 0), state.state_root())

    res, res2, res3, code, slot, reverted, _ = both(run)
    assert res.success and res2.success and not res3.success
    assert (code, slot, reverted) == (SETTER_CODE, 42, 0)


@pytest.fixture(scope="module")
def precompile_cases():
    return {pkg: chip_smoke.precompile_cases(API[pkg], np.random.default_rng(SEED), ALICE_PRIV)
            for pkg in PACKAGES}


@pytest.mark.parametrize("case", range(8))
def test_precompiles_equal(precompile_cases, case):
    """Each precompile 0x01-0x08 on `chip_smoke.precompile_cases`' inputs
    (outputs against the host there), and a failing input of each kind."""
    def run(api):
        addr, inp, want = precompile_cases[_pkg(api)][case]
        out = api.interp._run_precompile(addr, inp, 10**6)
        bad = api.interp._run_precompile(addr, inp[: len(inp) // 3] + b"\xff" * 7, 10**6)
        assert out[:2] == (True, want)
        return out, bad

    both(run)


def test_precompile_sha256_in_call():
    """The reference test's STATICCALL into 0x02 from bytecode."""
    import hashlib

    code = bytes.fromhex("7f" + b"abc".ljust(32, b"\x00").hex() + "5f52"
                         + "60205f60035f6002612710fa50" + "60205ff3")

    def run(api):
        state = api.state.WorldState(api.mpt.EMPTY_ROOT, {}, {})
        _deploy(api, state, b"\xDD" * 20, code)
        return _call(api, state, b"\xDD" * 20)

    res = both(run)
    assert res.success and res.output == hashlib.sha256(b"abc").digest()


def test_ripemd160_precompile_needs_no_hashlib(monkeypatch):
    """The port's 0x03 does not ask hashlib for RIPEMD-160: with
    `hashlib.new` gone it still returns the reference's output."""
    data = bytes(range(70))
    want = API["reference"].interp._run_precompile(3, data, 10**6)
    monkeypatch.setattr(API["port"].interp.hashlib, "new", None)
    assert API["port"].interp._run_precompile(3, data, 10**6) == want
    assert want[0] is True


EIP2929_CASES = {
    "cold then warm SLOAD": ("60005450600054500000", {}, 3 + 2100 + 2 + 3 + 100 + 2),
    "SSTORE 0 -> 1": ("600160005500", {}, 3 + 3 + 22100),
    "SSTORE 1 -> 0": ("600060005500", {0: 1}, 3 + 3 + 2100 + 2900),
    "SSTORE 1 -> 1": ("600160005500", {0: 1}, 3 + 3 + 2100 + 100),
    "cold then warm BALANCE": (("73" + BOB.hex() + "3150") * 2 + "00", {},
                               3 + 2600 + 2 + 3 + 100 + 2),
}


@pytest.mark.parametrize("name", list(EIP2929_CASES))
def test_eip2929_consensus_gas(name):
    code, storage, want = EIP2929_CASES[name]

    def run(api):
        state = api.state.WorldState(api.mpt.EMPTY_ROOT, {}, {})
        addr = b"\xAA" * 20
        _deploy(api, state, addr, bytes.fromhex(code))
        for k, v in storage.items():
            state.set_storage(addr, k, v)
        alice = chip_smoke.address_of(api, ALICE_PRIV)
        tx = api.interp.TxCtx(origin=alice)
        tx.warm_addresses.update({alice, addr})
        res = _call(api, state, addr, gas=1_000_000, tx=tx)
        return res.success, 1_000_000 - res.gas_left, res.gas_refund

    ok, used, refund = both(run)
    assert ok and used == want
    assert refund == (4800 if name == "SSTORE 1 -> 0" else 0)


def test_eip2929_revert_unwinds_warmth():
    def run(api):
        state = api.state.WorldState(api.mpt.EMPTY_ROOT, {}, {})
        addr = b"\xE1" * 20
        _deploy(api, state, addr, bytes.fromhex("600054506000" + "6000fd"))
        tx = api.interp.TxCtx(origin=chip_smoke.address_of(api, ALICE_PRIV))
        res = _call(api, state, addr, tx=tx)
        return res.success, (addr, 0) in tx.warm_slots, addr in tx.warm_addresses

    assert both(run) == (False, False, False)


def test_value_transfer_intrinsic_is_21000():
    def run(api):
        tx = api.blk.Tx(tx_type=0, nonce=0, gas_limit=21000, gas_price=1, to=BOB, value=1,
                        data=b"")
        out = [api.blk._intrinsic_gas(tx)]
        tx.data = b"\x00\x01"
        tx2 = api.blk.Tx(tx_type=2, nonce=0, gas_limit=60000, to=None, value=0,
                         data=bytes(40) + b"\x01")
        return out + [api.blk._intrinsic_gas(tx), api.blk._intrinsic_gas(tx2)]

    assert both(run)[:2] == [21000, 21020]


# ---------------------------------------------------------------------------
# the L1 data fee
# ---------------------------------------------------------------------------

FEE_SLOTS = {
    "curie": {1: 10**9, 5: 5 * 10**8, 6: 230_759_955_285, 7: 417_565_260},
    "pre-curie": {1: 10**9, 2: 2100, 3: 10**9},
    "absent": None,
}


@pytest.mark.parametrize("form", list(FEE_SLOTS))
def test_l1_data_fee(form):
    """The fee in its Curie, pre-Curie and absent-oracle forms, charged to
    the sender and credited to the coinbase; L1 messages pay none."""
    slots = FEE_SLOTS[form]

    def run(api):
        blk, mpt, rlp = api.blk, api.mpt, api.rlp
        alice = chip_smoke.address_of(api, ALICE_PRIV)
        trie = mpt.Mpt(mpt.EMPTY_ROOT)
        trie.update(mpt.secure_key(alice), api.state.Account(balance=10**18).rlp())
        if slots:
            st = mpt.Mpt(mpt.EMPTY_ROOT, trie.nodes)
            for k, v in slots.items():
                st.update(mpt.secure_key(k.to_bytes(32, "big")), rlp.encode_int(v))
            trie.update(mpt.secure_key(blk.L1_GAS_PRICE_ORACLE_ADDRESS),
                        api.state.Account(storage_root=st.root).rlp())
        tx = chip_smoke.sign_tx(api, blk.Tx(tx_type=0, nonce=0, gas_limit=21000, to=BOB,
                                            value=12345, data=b"", gas_price=10,
                                            chain_id=534352), ALICE_PRIV)
        state = api.state.WorldState(trie.root, dict(trie.nodes), {})
        fee = blk.l1_data_fee(state, tx)
        l1 = blk.Tx(tx_type=blk.L1_MSG_TX_TYPE, nonce=0, gas_limit=100000, to=BOB, value=0,
                    data=b"", sender=L1_SENDER)
        ctx = blk.BlockCtx(number=1, timestamp=1001, coinbase=COINBASE, gas_limit=30_000_000,
                           base_fee=1)
        blk.execute_tx(state, ctx, tx, 0)
        return (fee, blk.l1_data_fee(state, l1), state.get_balance(alice),
                state.get_balance(COINBASE), len(tx.encode()), state.state_root())

    fee, l1_fee, alice, coinbase, size, _ = both(run)
    if form == "curie":
        assert fee == (230_759_955_285 * 10**9 + size * 417_565_260 * 5 * 10**8) // 10**9
    elif form == "absent":
        assert fee == 0
    else:
        assert fee > 0
    assert l1_fee == 0
    assert alice == 10**18 - 12345 - 21000 * 10 - fee and coinbase == 21000 * 10 + fee
