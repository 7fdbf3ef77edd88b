"""Stateless block execution: witness -> verified execution summary.

The sbv_core::verifier::run analog (reference call site:
crates/types/chunk/src/scroll/execute.rs:44-48): given self-contained
block witnesses (headers, signed transactions, partial state trie nodes,
code preimages), re-execute every transaction, recompute the post state
root, transaction/receipt trie roots and the block hash, and fail if any
committed header field disagrees — then emit the per-block
`BlockExecutionSummary` rows the chunk circuit folds into ChunkInfo
(types/chunk/witness.py).

Transaction types: legacy (EIP-155), EIP-1559 dynamic fee (0x02), and
Scroll L1 message transactions (0x7E: no signature — the sender is the
bridge-attested L1 address; no gas payment). Sender recovery runs
through this repo's secp256k1 (types/chunk/crypto), and runs for every
signed transaction, whatever sender the witness claims.

L1 data-fee accounting (round 5): the revm-scroll `L1BlockInfo` analog —
the fee is computed from the L1GasPriceOracle predeploy's storage slots
(read from the witness state, so partial witnesses must carry the oracle
path nodes exactly as sbv requires), charged to the sender before
execution, never refunded, and credited to the coinbase/fee-vault.
Curie-and-later formula when the commit/blob scalars are set; the
pre-Curie calldata-gas formula otherwise. Remaining divergence: the gas
table approximates EIP-2929 (see interpreter.GAS_MODEL_NOTES).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..ops.keccak import keccak256
from . import rlp
from .interpreter import (
    BlockCtx,
    Message,
    TxCtx,
    execute_message,
)
from .mpt import EMPTY_ROOT, Mpt
from .state import WorldState

# Scroll predeploy holding the withdraw trie root (L2MessageQueue
# messageRoot storage slot). Address/slot are configurable per deployment.
WITHDRAW_QUEUE_ADDRESS = bytes.fromhex(
    "5300000000000000000000000000000000000000"
)
WITHDRAW_ROOT_SLOT = 0

L1_MSG_TX_TYPE = 0x7E

# Scroll L1GasPriceOracle predeploy + its storage layout (the slots
# revm-scroll's L1BlockInfo loads at block start; sbv therefore includes
# their trie paths in every witness). Pre-Curie: (calldata gas + overhead)
# * l1BaseFee * scalar / 1e9 over the signed-tx RLP; Curie+: commitScalar
# * l1BaseFee + txSize * blobScalar * l1BlobBaseFee, / 1e9.
L1_GAS_PRICE_ORACLE_ADDRESS = bytes.fromhex(
    "5300000000000000000000000000000000000002"
)
ORACLE_L1_BASE_FEE_SLOT = 1
ORACLE_OVERHEAD_SLOT = 2
ORACLE_SCALAR_SLOT = 3
ORACLE_L1_BLOB_BASE_FEE_SLOT = 5
ORACLE_COMMIT_SCALAR_SLOT = 6
ORACLE_BLOB_SCALAR_SLOT = 7
ORACLE_PRECISION = 10**9


def l1_data_fee(state: "WorldState", tx: "Tx") -> int:
    """L1 data fee for one L2 transaction (0 for L1 messages).

    Reads the oracle slots from the (witness-backed) state; an absent or
    unconfigured oracle account yields fee 0, matching a chain where the
    oracle was never initialized. Fork selection is data-driven: the
    Curie formula applies whenever either Curie scalar is nonzero (the
    upgrade sets both), so no fork flag needs threading through here.
    """
    if tx.is_l1_msg:
        return 0
    o = L1_GAS_PRICE_ORACLE_ADDRESS
    l1_base_fee = state.get_storage(o, ORACLE_L1_BASE_FEE_SLOT)
    commit_scalar = state.get_storage(o, ORACLE_COMMIT_SCALAR_SLOT)
    blob_scalar = state.get_storage(o, ORACLE_BLOB_SCALAR_SLOT)
    raw = tx.encode()
    if commit_scalar or blob_scalar:
        blob_base_fee = state.get_storage(o, ORACLE_L1_BLOB_BASE_FEE_SLOT)
        return (commit_scalar * l1_base_fee
                + blob_scalar * len(raw) * blob_base_fee) // ORACLE_PRECISION
    overhead = state.get_storage(o, ORACLE_OVERHEAD_SLOT)
    scalar = state.get_storage(o, ORACLE_SCALAR_SLOT)
    calldata_gas = sum(4 if b == 0 else 16 for b in raw)
    return (calldata_gas + overhead) * l1_base_fee * scalar // ORACLE_PRECISION


@dataclass
class Tx:
    """Decoded transaction. For signed types (legacy/1559) the signature
    fields are set; L1 messages carry the sender directly."""

    tx_type: int                 # 0 legacy, 2 eip-1559, 0x7E l1 msg
    nonce: int
    gas_limit: int
    to: Optional[bytes]          # None = create
    value: int
    data: bytes
    gas_price: int = 0           # legacy
    max_fee: int = 0             # 1559
    max_priority_fee: int = 0
    chain_id: int = 0
    v: int = 0
    r: int = 0
    s: int = 0
    sender: Optional[bytes] = None   # L1 msgs / post-recovery cache

    # -- encoding -----------------------------------------------------------
    def encode(self) -> bytes:
        """Network encoding (the bytes hashed into tx_data_digest and
        keyed into the transaction trie)."""
        if self.tx_type == 0:
            return rlp.encode([
                rlp.int_to_bytes(self.nonce),
                rlp.int_to_bytes(self.gas_price),
                rlp.int_to_bytes(self.gas_limit),
                self.to or b"",
                rlp.int_to_bytes(self.value),
                self.data,
                rlp.int_to_bytes(self.v),
                rlp.int_to_bytes(self.r),
                rlp.int_to_bytes(self.s),
            ])
        if self.tx_type == 2:
            return b"\x02" + rlp.encode([
                rlp.int_to_bytes(self.chain_id),
                rlp.int_to_bytes(self.nonce),
                rlp.int_to_bytes(self.max_priority_fee),
                rlp.int_to_bytes(self.max_fee),
                rlp.int_to_bytes(self.gas_limit),
                self.to or b"",
                rlp.int_to_bytes(self.value),
                self.data,
                [],  # access list (unused)
                rlp.int_to_bytes(self.v),
                rlp.int_to_bytes(self.r),
                rlp.int_to_bytes(self.s),
            ])
        if self.tx_type == L1_MSG_TX_TYPE:
            return bytes([L1_MSG_TX_TYPE]) + rlp.encode([
                rlp.int_to_bytes(self.nonce),      # queue index
                rlp.int_to_bytes(self.gas_limit),
                self.to or b"",
                rlp.int_to_bytes(self.value),
                self.data,
                self.sender,
            ])
        raise ValueError(f"unknown tx type {self.tx_type}")

    def tx_hash(self) -> bytes:
        return keccak256(self.encode())

    def sign_hash(self) -> bytes:
        if self.tx_type == 0:
            if self.chain_id:
                payload = [
                    rlp.int_to_bytes(self.nonce),
                    rlp.int_to_bytes(self.gas_price),
                    rlp.int_to_bytes(self.gas_limit),
                    self.to or b"",
                    rlp.int_to_bytes(self.value),
                    self.data,
                    rlp.int_to_bytes(self.chain_id),
                    b"",
                    b"",
                ]
            else:
                payload = [
                    rlp.int_to_bytes(self.nonce),
                    rlp.int_to_bytes(self.gas_price),
                    rlp.int_to_bytes(self.gas_limit),
                    self.to or b"",
                    rlp.int_to_bytes(self.value),
                    self.data,
                ]
            return keccak256(rlp.encode(payload))
        if self.tx_type == 2:
            return keccak256(b"\x02" + rlp.encode([
                rlp.int_to_bytes(self.chain_id),
                rlp.int_to_bytes(self.nonce),
                rlp.int_to_bytes(self.max_priority_fee),
                rlp.int_to_bytes(self.max_fee),
                rlp.int_to_bytes(self.gas_limit),
                self.to or b"",
                rlp.int_to_bytes(self.value),
                self.data,
                [],
            ]))
        raise ValueError("L1 messages are not signed")

    def recover_sender(self) -> bytes:
        """The sender: an L1 message's claimed one; for a signed
        transaction the address its signature recovers, which a claimed
        `sender` must equal (`ValueError` otherwise). The reference returns
        a claimed sender unchecked (its `execution/block.py:198-200`), so a
        witness could spend from an account whose key signed nothing."""
        if self.is_l1_msg and self.sender is not None:
            return self.sender
        from ..types.chunk.crypto.secp256k1 import ecrecover

        if self.tx_type == 0:
            rec = (self.v - 35 - 2 * self.chain_id if self.chain_id
                   else self.v - 27)
        else:
            rec = self.v
        addr = ecrecover(self.sign_hash(), rec, self.r, self.s)
        if addr is None:
            raise ValueError("invalid transaction signature")
        if self.sender is not None and self.sender != addr:
            raise ValueError("claimed sender is not the signer of the transaction")
        self.sender = addr  # ecrecover returns the 20-byte address
        return self.sender

    @property
    def is_l1_msg(self) -> bool:
        return self.tx_type == L1_MSG_TX_TYPE

    def l1_msg_hash(self) -> bytes:
        assert self.is_l1_msg
        return keccak256(self.encode())


@dataclass
class Header:
    parent_hash: bytes
    coinbase: bytes
    state_root: bytes
    transactions_root: bytes
    receipts_root: bytes
    number: int
    gas_limit: int
    gas_used: int
    timestamp: int
    base_fee_per_gas: int
    extra_data: bytes = b""
    ommers_hash: bytes = keccak256(rlp.encode([]))
    logs_bloom: bytes = b"\x00" * 256
    difficulty: int = 0
    mix_hash: bytes = b"\x00" * 32
    nonce: bytes = b"\x00" * 8

    def rlp(self) -> bytes:
        return rlp.encode([
            self.parent_hash,
            self.ommers_hash,
            self.coinbase,
            self.state_root,
            self.transactions_root,
            self.receipts_root,
            self.logs_bloom,
            rlp.int_to_bytes(self.difficulty),
            rlp.int_to_bytes(self.number),
            rlp.int_to_bytes(self.gas_limit),
            rlp.int_to_bytes(self.gas_used),
            rlp.int_to_bytes(self.timestamp),
            self.extra_data,
            self.mix_hash,
            self.nonce,
            rlp.int_to_bytes(self.base_fee_per_gas),
        ])

    def block_hash(self) -> bytes:
        return keccak256(self.rlp())


@dataclass
class BlockWitness:
    header: Header
    txs: List[Tx]
    # state witness shared across the chunk: trie nodes + code preimages
    state_nodes: Dict[bytes, bytes] = field(default_factory=dict)
    codes: Dict[bytes, bytes] = field(default_factory=dict)
    chain_id: int = 534352


class ExecutionError(Exception):
    pass


@dataclass
class Receipt:
    tx_type: int
    success: bool
    cumulative_gas: int
    logs: list

    def encode(self) -> bytes:
        bloom = _logs_bloom(self.logs)
        body = rlp.encode([
            rlp.int_to_bytes(1 if self.success else 0),
            rlp.int_to_bytes(self.cumulative_gas),
            bloom,
            [
                [lg.address,
                 [t.to_bytes(32, "big") for t in lg.topics],
                 lg.data]
                for lg in self.logs
            ],
        ])
        if self.tx_type == 0:
            return body
        return bytes([self.tx_type]) + body


def _logs_bloom(logs) -> bytes:
    bloom = bytearray(256)
    for lg in logs:
        items = [lg.address] + [t.to_bytes(32, "big") for t in lg.topics]
        for it in items:
            h = keccak256(it)
            for i in (0, 2, 4):
                bit = ((h[i] << 8) | h[i + 1]) & 0x7FF
                bloom[255 - bit // 8] |= 1 << (bit % 8)
    return bytes(bloom)


def _ordered_trie_root(items: List[bytes]) -> bytes:
    """Index-keyed (non-secure) trie root: tx/receipt tries."""
    t = Mpt(EMPTY_ROOT)
    for i, raw in enumerate(items):
        t.update(rlp.encode_int(i) if i else rlp.encode(b""), raw)
    return t.root


def _intrinsic_gas(tx: Tx) -> int:
    g = 21000 if tx.to is not None else 53000
    for b in tx.data:
        g += 4 if b == 0 else 16
    if tx.to is None:
        g += 2 * ((len(tx.data) + 31) // 32)  # EIP-3860
    return g


def execute_tx(state: WorldState, block: BlockCtx, tx: Tx,
               cumulative_gas: int) -> Tuple[Receipt, int]:
    """Returns (receipt, gas_used)."""
    if tx.is_l1_msg:
        sender = tx.sender
        gas_price = 0
    else:
        sender = tx.recover_sender()
        if tx.tx_type == 2:
            if tx.max_fee < block.base_fee:
                raise ExecutionError("max fee below base fee")
            gas_price = min(tx.max_fee,
                            block.base_fee + tx.max_priority_fee)
        else:
            gas_price = tx.gas_price
            if gas_price < block.base_fee:
                raise ExecutionError("gas price below base fee")

    nonce = state.get_nonce(sender)
    if not tx.is_l1_msg and nonce != tx.nonce:
        raise ExecutionError(
            f"nonce mismatch: account {nonce} != tx {tx.nonce}")

    intrinsic = _intrinsic_gas(tx)
    if intrinsic > tx.gas_limit:
        raise ExecutionError("intrinsic gas exceeds limit")

    l1_fee = l1_data_fee(state, tx)
    upfront = tx.gas_limit * gas_price + tx.value + l1_fee
    if state.get_balance(sender) < upfront:
        raise ExecutionError("insufficient balance for upfront cost")
    if tx.gas_limit * gas_price + l1_fee:
        state.sub_balance(sender, tx.gas_limit * gas_price + l1_fee)
    state.inc_nonce(sender)

    txctx = TxCtx(origin=sender, gas_price=gas_price)
    # EIP-2929 tx prewarming: origin, target, precompiles; coinbase per
    # EIP-3651 (Shanghai)
    txctx.warm_addresses.add(sender)
    if tx.to is not None:
        txctx.warm_addresses.add(tx.to)
    txctx.warm_addresses.add(block.coinbase)
    for p in range(1, 0x0B):
        txctx.warm_addresses.add(p.to_bytes(20, "big"))
    msg = Message(
        caller=sender,
        to=tx.to,
        value=tx.value,
        data=tx.data,
        gas=tx.gas_limit - intrinsic,
    )
    res = execute_message(state, block, txctx, msg)
    state.clear_transient()

    gas_used = tx.gas_limit - res.gas_left
    refund = min(res.gas_refund, gas_used // 5) if res.success else 0
    gas_used -= refund
    if gas_price:
        state.add_balance(sender, (tx.gas_limit - gas_used) * gas_price)
    if gas_used * gas_price + l1_fee:
        # fees to coinbase (Scroll: no base-fee burn — the full effective
        # price AND the L1 data fee accrue to the fee vault/coinbase; the
        # L1 fee is charged even when the tx reverts and never refunded)
        state.add_balance(block.coinbase, gas_used * gas_price + l1_fee)

    receipt = Receipt(
        tx_type=tx.tx_type,
        success=res.success,
        cumulative_gas=cumulative_gas + gas_used,
        logs=res.logs,
    )
    return receipt, gas_used


def execute_block(witness: BlockWitness, pre_state_root: bytes,
                  state: Optional[WorldState] = None,
                  block_hashes: Optional[dict] = None):
    """Execute one block. Returns (summary, post_state_root, state).

    Validates: pre-root continuity, per-tx execution, recomputed
    tx/receipt roots, gas_used, post state root and the block hash —
    any mismatch with the committed header raises ExecutionError."""
    from ..types.chunk.witness import BlockExecutionSummary

    hdr = witness.header
    if state is None:
        state = WorldState(pre_state_root, witness.state_nodes,
                           witness.codes)
    elif state.trie.root != pre_state_root:
        raise ExecutionError("state root discontinuity between blocks")

    block = BlockCtx(
        number=hdr.number,
        timestamp=hdr.timestamp,
        coinbase=hdr.coinbase,
        gas_limit=hdr.gas_limit,
        base_fee=hdr.base_fee_per_gas,
        chain_id=witness.chain_id,
        block_hashes=dict(block_hashes or {}),
    )
    block.block_hashes[hdr.number - 1] = hdr.parent_hash

    receipts: List[Receipt] = []
    gas_used = 0
    for tx in witness.txs:
        receipt, g = execute_tx(state, block, tx, gas_used)
        gas_used += g
        receipts.append(receipt)

    post_root = state.state_root()

    tx_root = _ordered_trie_root([t.encode() for t in witness.txs])
    receipt_root = _ordered_trie_root([r.encode() for r in receipts])
    if tx_root != hdr.transactions_root:
        raise ExecutionError("transactions root mismatch")
    if receipt_root != hdr.receipts_root:
        raise ExecutionError("receipts root mismatch")
    if gas_used != hdr.gas_used:
        raise ExecutionError(
            f"gas_used mismatch: computed {gas_used} != header "
            f"{hdr.gas_used}")
    if post_root != hdr.state_root:
        raise ExecutionError("post state root mismatch")

    summary = BlockExecutionSummary(
        number=hdr.number,
        timestamp=hdr.timestamp,
        base_fee_per_gas=hdr.base_fee_per_gas,
        gas_limit=hdr.gas_limit,
        gas_used=gas_used,
        state_root_after=post_root,
        block_hash=hdr.block_hash(),
        encoded_l2_txs=[t.encode() for t in witness.txs
                        if not t.is_l1_msg],
        l1_msg_hashes=[t.l1_msg_hash() for t in witness.txs
                       if t.is_l1_msg],
        num_txs=len(witness.txs),
    )
    return summary, post_root, state


def read_withdraw_root(state: WorldState) -> bytes:
    """The withdraw trie root from the message-queue predeploy storage
    (reference: VerifyResult.withdraw_root)."""
    v = state.get_storage(WITHDRAW_QUEUE_ADDRESS, WITHDRAW_ROOT_SLOT)
    return v.to_bytes(32, "big")


def execute_chunk_blocks(witnesses: List[BlockWitness],
                         pre_state_root: bytes):
    """Execute a chunk's blocks back-to-back over one shared state.

    Returns (summaries, pre_state_root, post_state_root, withdraw_root)
    — the VerifyResult analog feeding chunk_info_from_execution."""
    assert witnesses, "chunk must contain at least one block"
    state: Optional[WorldState] = None
    root = pre_state_root
    summaries = []
    hashes: dict = {}
    for w in witnesses:
        if state is not None:
            # later blocks share the accumulated state; merge witness nodes
            state.trie.nodes.update(w.state_nodes)
            state.codes.update(w.codes)
        summary, root, state = execute_block(w, root, state, hashes)
        hashes[w.header.number] = summary.block_hash
        summaries.append(summary)
    withdraw_root = read_withdraw_root(state)
    return summaries, pre_state_root, root, withdraw_root
