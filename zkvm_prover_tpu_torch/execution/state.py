"""Journaled world state over a partial Merkle-Patricia trie.

The sbv EvmDatabase analog: accounts and storage resolve through the
witness-supplied trie nodes (execution/mpt.py); writes are journaled for
revert scopes and flushed back into the tries to recompute the post
state root (reference: sbv's partial-trie update path feeding
VerifyResult.post_state_root).

Account RLP: [nonce, balance, storage_root, code_hash] under
secure key keccak(address). Storage values RLP-encode as minimal ints
under keccak(slot_be32).

A copy of the reference's `zkvm_prover_tpu/execution/state.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..ops.keccak import keccak256
from . import rlp
from .mpt import EMPTY_ROOT, Mpt, secure_key

EMPTY_CODE_HASH = keccak256(b"")


@dataclass
class Account:
    nonce: int = 0
    balance: int = 0
    storage_root: bytes = EMPTY_ROOT
    code_hash: bytes = EMPTY_CODE_HASH

    def rlp(self) -> bytes:
        return rlp.encode([
            rlp.int_to_bytes(self.nonce),
            rlp.int_to_bytes(self.balance),
            self.storage_root,
            self.code_hash,
        ])

    @classmethod
    def from_rlp(cls, raw: bytes) -> "Account":
        n, b, sr, ch = rlp.decode(raw)
        return cls(rlp.bytes_to_int(n), rlp.bytes_to_int(b),
                   bytes(sr), bytes(ch))

    @property
    def is_empty(self) -> bool:
        return (self.nonce == 0 and self.balance == 0
                and self.code_hash == EMPTY_CODE_HASH)


class WorldState:
    """State interface consumed by execution/interpreter.py."""

    def __init__(self, state_root: bytes, nodes: Dict[bytes, bytes],
                 codes: Dict[bytes, bytes]):
        self.trie = Mpt(state_root, nodes)
        self.codes = dict(codes)          # code_hash -> code
        self.accounts: Dict[bytes, Optional[Account]] = {}
        self.storage: Dict[Tuple[bytes, int], int] = {}
        self.transient: Dict[Tuple[bytes, int], int] = {}
        self.journal: list = []
        # per-address storage tries share the witness node store
        self._storage_tries: Dict[bytes, Mpt] = {}

    # -- journaling ---------------------------------------------------------
    def snapshot(self) -> int:
        return len(self.journal)

    def revert(self, snap: int) -> None:
        while len(self.journal) > snap:
            kind, key, old = self.journal.pop()
            if kind == "acct":
                self.accounts[key] = old
            elif kind == "stor":
                self.storage[key] = old
            elif kind == "tstor":
                self.transient[key] = old
            elif kind == "code":
                self.codes.pop(key, None)

    # -- accounts -----------------------------------------------------------
    def _load_account(self, addr: bytes) -> Optional[Account]:
        if addr in self.accounts:
            return self.accounts[addr]
        raw = self.trie.get(secure_key(addr))
        acct = Account.from_rlp(raw) if raw is not None else None
        self.accounts[addr] = acct
        return acct

    def _mut_account(self, addr: bytes) -> Account:
        acct = self._load_account(addr)
        self.journal.append(
            ("acct", addr,
             None if acct is None else Account(**vars(acct)))
        )
        if acct is None:
            acct = Account()
            self.accounts[addr] = acct
        return acct

    def account_exists(self, addr: bytes) -> bool:
        a = self._load_account(addr)
        return a is not None and not a.is_empty

    def create_account(self, addr: bytes) -> None:
        old = self._load_account(addr)
        bal = old.balance if old else 0
        self.journal.append(
            ("acct", addr, None if old is None else Account(**vars(old)))
        )
        self.accounts[addr] = Account(balance=bal)

    def get_nonce(self, addr: bytes) -> int:
        a = self._load_account(addr)
        return a.nonce if a else 0

    def inc_nonce(self, addr: bytes) -> None:
        self._mut_account(addr).nonce += 1

    def get_balance(self, addr: bytes) -> int:
        a = self._load_account(addr)
        return a.balance if a else 0

    def add_balance(self, addr: bytes, v: int) -> None:
        if v == 0 and self._load_account(addr) is None:
            return
        self._mut_account(addr).balance += v

    def sub_balance(self, addr: bytes, v: int) -> None:
        a = self._mut_account(addr)
        assert a.balance >= v, "balance underflow"
        a.balance -= v

    # -- code ---------------------------------------------------------------
    def get_code(self, addr: bytes) -> bytes:
        a = self._load_account(addr)
        if a is None or a.code_hash == EMPTY_CODE_HASH:
            return b""
        code = self.codes.get(a.code_hash)
        if code is None:
            raise KeyError(
                f"code preimage missing from witness: "
                f"{a.code_hash.hex()}"
            )
        return code

    def set_code(self, addr: bytes, code: bytes) -> None:
        h = keccak256(code)
        self.journal.append(("code", h, None))
        self.codes[h] = code
        self._mut_account(addr).code_hash = h

    # -- storage ------------------------------------------------------------
    def _storage_trie(self, addr: bytes) -> Mpt:
        t = self._storage_tries.get(addr)
        if t is None:
            a = self._load_account(addr)
            root = a.storage_root if a else EMPTY_ROOT
            t = Mpt(root, self.trie.nodes)  # shared node store
            self._storage_tries[addr] = t
        return t

    def get_storage(self, addr: bytes, key: int) -> int:
        ck = (addr, key)
        if ck in self.storage:
            return self.storage[ck]
        raw = self._storage_trie(addr).get(
            secure_key(key.to_bytes(32, "big"))
        )
        val = rlp.bytes_to_int(rlp.decode(raw)) if raw is not None else 0
        self.storage[ck] = val
        return val

    def set_storage(self, addr: bytes, key: int, val: int) -> None:
        ck = (addr, key)
        old = self.get_storage(addr, key)
        self.journal.append(("stor", ck, old))
        self.storage[ck] = val

    def get_transient(self, addr: bytes, key: int) -> int:
        return self.transient.get((addr, key), 0)

    def set_transient(self, addr: bytes, key: int, val: int) -> None:
        ck = (addr, key)
        self.journal.append(("tstor", ck, self.transient.get(ck, 0)))
        self.transient[ck] = val

    def clear_transient(self) -> None:
        self.transient.clear()

    # -- commit -------------------------------------------------------------
    def state_root(self) -> bytes:
        """Flush all cached writes into the tries and return the root."""
        # storage first (account bodies embed the storage roots)
        touched_storage: Dict[bytes, list] = {}
        for (addr, key), val in self.storage.items():
            touched_storage.setdefault(addr, []).append((key, val))
        for addr, kvs in touched_storage.items():
            trie = self._storage_trie(addr)
            for key, val in kvs:
                sk = secure_key(key.to_bytes(32, "big"))
                if val == 0:
                    trie.update(sk, b"")
                else:
                    trie.update(sk, rlp.encode_int(val))
            if addr not in self.accounts or self.accounts[addr] is None:
                # storage write to a non-existent account: materialize
                self.accounts[addr] = Account()
            self.accounts[addr].storage_root = trie.root
        for addr, acct in self.accounts.items():
            sk = secure_key(addr)
            if acct is None or acct.is_empty:
                if self.trie.get(sk) is not None:
                    self.trie.update(sk, b"")
                continue
            self.trie.update(sk, acct.rlp())
        return self.trie.root
