"""EVM interpreter for stateless block re-execution — the revm analog.

Full message-call semantics over a journaled world state: every opcode
through Shanghai (PUSH0), sub-calls (CALL/DELEGATECALL/STATICCALL/
CALLCODE), CREATE/CREATE2 with EIP-170 code-size limits, LOGs, REVERT
with state rollback, and the 0x01-0x08 precompiles backed by this repo's
own crypto (secp256k1 ecrecover, bn254 pairing ops).

Gas model: the static cost table + quadratic memory expansion + EIP-3860
initcode costs + EIP-2929 warm/cold access accounting (transaction-scoped
address/slot sets journaled across revert scopes, tx-prewarming of
origin/to/coinbase/precompiles) + EIP-2200/3529 SSTORE net metering with
the original-value journal and the post-London refund ladder. Remaining
divergences recorded in `GAS_MODEL_NOTES`.

Reference analog: sbv_core::verifier::run's inner revm execution
(crates/types/chunk/src/scroll/execute.rs:44-48).

A copy of the reference's `zkvm_prover_tpu/execution/interpreter.py`,
but for precompile 0x03, which hashes with the port's own RIPEMD-160
(`types/chunk/crypto/ripemd160.py`), never `hashlib`'s.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..ops.keccak import keccak256

U256 = 1 << 256
MASK = U256 - 1
MAX_CODE_SIZE = 0x6000
MAX_INITCODE_SIZE = 2 * MAX_CODE_SIZE

GAS_MODEL_NOTES = (
    "EIP-2930 typed-tx access lists are not pre-warmed (witness txs carry "
    "none); Scroll L1 data fee not modeled (fee accounting only)"
)

# EIP-2929 constants
WARM_ACCESS_COST = 100
COLD_ACCOUNT_COST = 2600
COLD_SLOAD_COST = 2100
# EIP-3529
SSTORE_CLEARS_REFUND = 4800
GAS_NEW_ACCOUNT = 25000


@dataclass
class BlockCtx:
    number: int = 0
    timestamp: int = 0
    coinbase: bytes = b"\x00" * 20
    gas_limit: int = 30_000_000
    base_fee: int = 0
    chain_id: int = 534352
    prevrandao: int = 0
    block_hashes: dict = field(default_factory=dict)  # number -> 32B hash


@dataclass
class TxCtx:
    origin: bytes = b"\x00" * 20
    gas_price: int = 0
    # EIP-2929 transaction-scoped access sets (journaled across revert
    # scopes by execute_message) + the EIP-2200 original-value journal
    warm_addresses: set = field(default_factory=set)
    warm_slots: set = field(default_factory=set)
    original_storage: dict = field(default_factory=dict)


@dataclass
class Log:
    address: bytes
    topics: List[int]
    data: bytes


@dataclass
class Message:
    caller: bytes
    to: Optional[bytes]          # None => create
    value: int
    data: bytes
    gas: int
    depth: int = 0
    is_static: bool = False
    code_address: Optional[bytes] = None  # for delegatecall/callcode
    salt: Optional[int] = None            # CREATE2


@dataclass
class ExecResult:
    success: bool
    gas_left: int
    output: bytes
    logs: List[Log] = field(default_factory=list)
    gas_refund: int = 0
    created: Optional[bytes] = None


class VmError(Exception):
    pass


def _sx(v: int) -> int:
    return v - U256 if v >> 255 else v


def _addr_int(b: bytes) -> int:
    return int.from_bytes(b, "big")


def _int_addr(v: int) -> bytes:
    return (v & ((1 << 160) - 1)).to_bytes(20, "big")


def _mem_cost(words: int) -> int:
    return 3 * words + words * words // 512


class Interpreter:
    """One call frame. `state` implements the WorldState interface
    (execution/state.py)."""

    def __init__(self, state, block: BlockCtx, tx: TxCtx, msg: Message,
                 code: bytes):
        self.state = state
        self.block = block
        self.tx = tx
        self.msg = msg
        self.code = code
        self.stack: List[int] = []
        self.memory = bytearray()
        self.pc = 0
        self.gas = msg.gas
        self.logs: List[Log] = []
        self.refund = 0
        self.returndata = b""
        self.jumpdests = _valid_jumpdests(code)

    # -- primitives --------------------------------------------------------
    def use_gas(self, g: int) -> None:
        if g > self.gas:
            self.gas = 0
            raise VmError("out of gas")
        self.gas -= g

    def push(self, v: int) -> None:
        if len(self.stack) >= 1024:
            raise VmError("stack overflow")
        self.stack.append(v & MASK)

    def pop(self) -> int:
        if not self.stack:
            raise VmError("stack underflow")
        return self.stack.pop()

    def mem_expand(self, off: int, size: int) -> None:
        if size == 0:
            return
        end = off + size
        if end > (1 << 32):
            raise VmError("memory too large")
        new_words = (end + 31) // 32
        old_words = len(self.memory) // 32
        if new_words > old_words:
            self.use_gas(_mem_cost(new_words) - _mem_cost(old_words))
            self.memory.extend(b"\x00" * (new_words * 32 - len(self.memory)))

    def mread(self, off: int, size: int) -> bytes:
        if size == 0:
            return b""
        self.mem_expand(off, size)
        return bytes(self.memory[off : off + size])

    def mwrite(self, off: int, data: bytes) -> None:
        if not data:
            return
        self.mem_expand(off, len(data))
        self.memory[off : off + len(data)] = data

    # -- EIP-2929 access accounting ----------------------------------------
    def charge_account_access(self, addr: bytes) -> None:
        if addr in self.tx.warm_addresses:
            self.use_gas(WARM_ACCESS_COST)
        else:
            self.tx.warm_addresses.add(addr)
            self.use_gas(COLD_ACCOUNT_COST)

    def charge_slot_access(self, addr: bytes, key: int) -> None:
        sk = (addr, key)
        if sk in self.tx.warm_slots:
            self.use_gas(WARM_ACCESS_COST)
        else:
            self.tx.warm_slots.add(sk)
            self.use_gas(COLD_SLOAD_COST)

    # -- main loop ---------------------------------------------------------
    def run(self) -> ExecResult:
        try:
            out = self._loop()
            return ExecResult(True, self.gas, out, self.logs,
                              self.refund)
        except Revert as r:
            return ExecResult(False, self.gas, r.data)
        except VmError:
            return ExecResult(False, 0, b"")

    def _loop(self) -> bytes:
        code = self.code
        while True:
            if self.pc >= len(code):
                return b""
            op = code[self.pc]
            self.pc += 1
            handler = _HANDLERS.get(op)
            if handler is None:
                raise VmError(f"invalid opcode 0x{op:02x}")
            out = handler(self)
            if out is not None:
                return out


class Revert(Exception):
    def __init__(self, data: bytes):
        self.data = data


# ---------------------------------------------------------------------------
# opcode handlers
# ---------------------------------------------------------------------------
_HANDLERS = {}


def _op(code: int, gas: int = 3):
    def deco(fn):
        def wrapped(vm: Interpreter):
            vm.use_gas(gas)
            return fn(vm)

        _HANDLERS[code] = wrapped
        return fn

    return deco


def _valid_jumpdests(code: bytes) -> set:
    out = set()
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            out.add(i)
        if 0x60 <= op <= 0x7F:
            i += op - 0x5F
        i += 1
    return out


# arithmetic
_op(0x00, 0)(lambda vm: b"")  # STOP
@_op(0x01)
def _add(vm):
    vm.push(vm.pop() + vm.pop())

@_op(0x02, 5)
def _mul(vm):
    vm.push(vm.pop() * vm.pop())

@_op(0x03)
def _sub(vm):
    a, b = vm.pop(), vm.pop()
    vm.push(a - b)

@_op(0x04, 5)
def _div(vm):
    a, b = vm.pop(), vm.pop()
    vm.push(a // b if b else 0)

@_op(0x05, 5)
def _sdiv(vm):
    a, b = _sx(vm.pop()), _sx(vm.pop())
    if b == 0:
        vm.push(0)
    else:
        q = abs(a) // abs(b)
        vm.push(-q if (a < 0) != (b < 0) else q)

@_op(0x06, 5)
def _mod(vm):
    a, b = vm.pop(), vm.pop()
    vm.push(a % b if b else 0)

@_op(0x07, 5)
def _smod(vm):
    a, b = _sx(vm.pop()), _sx(vm.pop())
    if b == 0:
        vm.push(0)
    else:
        r = abs(a) % abs(b)
        vm.push(-r if a < 0 else r)

@_op(0x08, 8)
def _addmod(vm):
    a, b, n = vm.pop(), vm.pop(), vm.pop()
    vm.push((a + b) % n if n else 0)

@_op(0x09, 8)
def _mulmod(vm):
    a, b, n = vm.pop(), vm.pop(), vm.pop()
    vm.push(a * b % n if n else 0)

@_op(0x0A, 10)
def _exp(vm):
    a, e = vm.pop(), vm.pop()
    vm.use_gas(50 * ((e.bit_length() + 7) // 8))
    vm.push(pow(a, e, U256))

@_op(0x0B, 5)
def _signextend(vm):
    k, v = vm.pop(), vm.pop()
    if k < 31:
        bit = 8 * k + 7
        if (v >> bit) & 1:
            v |= MASK << bit
        else:
            v &= (1 << bit) - 1
    vm.push(v)

# comparison / bitwise
@_op(0x10)
def _lt(vm):
    vm.push(1 if vm.pop() < vm.pop() else 0)

@_op(0x11)
def _gt(vm):
    vm.push(1 if vm.pop() > vm.pop() else 0)

@_op(0x12)
def _slt(vm):
    vm.push(1 if _sx(vm.pop()) < _sx(vm.pop()) else 0)

@_op(0x13)
def _sgt(vm):
    vm.push(1 if _sx(vm.pop()) > _sx(vm.pop()) else 0)

@_op(0x14)
def _eq(vm):
    vm.push(1 if vm.pop() == vm.pop() else 0)

@_op(0x15)
def _iszero(vm):
    vm.push(1 if vm.pop() == 0 else 0)

@_op(0x16)
def _and(vm):
    vm.push(vm.pop() & vm.pop())

@_op(0x17)
def _or(vm):
    vm.push(vm.pop() | vm.pop())

@_op(0x18)
def _xor(vm):
    vm.push(vm.pop() ^ vm.pop())

@_op(0x19)
def _not(vm):
    vm.push(~vm.pop())

@_op(0x1A)
def _byte(vm):
    i, x = vm.pop(), vm.pop()
    vm.push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)

@_op(0x1B)
def _shl(vm):
    s, v = vm.pop(), vm.pop()
    vm.push(v << s if s < 256 else 0)

@_op(0x1C)
def _shr(vm):
    s, v = vm.pop(), vm.pop()
    vm.push(v >> s if s < 256 else 0)

@_op(0x1D)
def _sar(vm):
    s, v = vm.pop(), _sx(vm.pop())
    vm.push((v >> s) if s < 256 else (0 if v >= 0 else MASK))

@_op(0x20, 30)
def _sha3(vm):
    off, size = vm.pop(), vm.pop()
    vm.use_gas(6 * ((size + 31) // 32))
    vm.push(int.from_bytes(keccak256(vm.mread(off, size)), "big"))

# environment
@_op(0x30, 2)
def _address(vm):
    vm.push(_addr_int(vm.msg.to))

@_op(0x31, 0)
def _balance(vm):
    addr = _int_addr(vm.pop())
    vm.charge_account_access(addr)
    vm.push(vm.state.get_balance(addr))

@_op(0x32, 2)
def _origin(vm):
    vm.push(_addr_int(vm.tx.origin))

@_op(0x33, 2)
def _caller(vm):
    vm.push(_addr_int(vm.msg.caller))

@_op(0x34, 2)
def _callvalue(vm):
    vm.push(vm.msg.value)

@_op(0x35)
def _calldataload(vm):
    off = vm.pop()
    d = vm.msg.data[off : off + 32]
    vm.push(int.from_bytes(d + b"\x00" * (32 - len(d)), "big"))

@_op(0x36, 2)
def _calldatasize(vm):
    vm.push(len(vm.msg.data))

@_op(0x37)
def _calldatacopy(vm):
    dst, src, size = vm.pop(), vm.pop(), vm.pop()
    vm.use_gas(3 * ((size + 31) // 32))
    d = vm.msg.data[src : src + size]
    vm.mwrite(dst, d + b"\x00" * (size - len(d)))

@_op(0x38, 2)
def _codesize(vm):
    vm.push(len(vm.code))

@_op(0x39)
def _codecopy(vm):
    dst, src, size = vm.pop(), vm.pop(), vm.pop()
    vm.use_gas(3 * ((size + 31) // 32))
    d = vm.code[src : src + size]
    vm.mwrite(dst, d + b"\x00" * (size - len(d)))

@_op(0x3A, 2)
def _gasprice(vm):
    vm.push(vm.tx.gas_price)

@_op(0x3B, 0)
def _extcodesize(vm):
    addr = _int_addr(vm.pop())
    vm.charge_account_access(addr)
    vm.push(len(vm.state.get_code(addr)))

@_op(0x3C, 0)
def _extcodecopy(vm):
    addr = _int_addr(vm.pop())
    vm.charge_account_access(addr)
    dst, src, size = vm.pop(), vm.pop(), vm.pop()
    vm.use_gas(3 * ((size + 31) // 32))
    d = vm.state.get_code(addr)[src : src + size]
    vm.mwrite(dst, d + b"\x00" * (size - len(d)))

@_op(0x3D, 2)
def _returndatasize(vm):
    vm.push(len(vm.returndata))

@_op(0x3E)
def _returndatacopy(vm):
    dst, src, size = vm.pop(), vm.pop(), vm.pop()
    vm.use_gas(3 * ((size + 31) // 32))
    if src + size > len(vm.returndata):
        raise VmError("returndata out of bounds")
    vm.mwrite(dst, vm.returndata[src : src + size])

@_op(0x3F, 0)
def _extcodehash(vm):
    addr = _int_addr(vm.pop())
    vm.charge_account_access(addr)
    if not vm.state.account_exists(addr):
        vm.push(0)
    else:
        vm.push(int.from_bytes(
            keccak256(vm.state.get_code(addr)), "big"))

@_op(0x40, 20)
def _blockhash(vm):
    n = vm.pop()
    h = vm.block.block_hashes.get(n, b"\x00" * 32)
    vm.push(int.from_bytes(h, "big"))

@_op(0x41, 2)
def _coinbase(vm):
    vm.push(_addr_int(vm.block.coinbase))

@_op(0x42, 2)
def _timestamp(vm):
    vm.push(vm.block.timestamp)

@_op(0x43, 2)
def _number(vm):
    vm.push(vm.block.number)

@_op(0x44, 2)
def _prevrandao(vm):
    vm.push(vm.block.prevrandao)

@_op(0x45, 2)
def _gaslimit(vm):
    vm.push(vm.block.gas_limit)

@_op(0x46, 2)
def _chainid(vm):
    vm.push(vm.block.chain_id)

@_op(0x47, 5)
def _selfbalance(vm):
    vm.push(vm.state.get_balance(vm.msg.to))

@_op(0x48, 2)
def _basefee(vm):
    vm.push(vm.block.base_fee)

# stack / memory / storage / flow
@_op(0x50, 2)
def _pop_(vm):
    vm.pop()

@_op(0x51)
def _mload(vm):
    off = vm.pop()
    vm.push(int.from_bytes(vm.mread(off, 32), "big"))

@_op(0x52)
def _mstore(vm):
    off, v = vm.pop(), vm.pop()
    vm.mwrite(off, v.to_bytes(32, "big"))

@_op(0x53)
def _mstore8(vm):
    off, v = vm.pop(), vm.pop()
    vm.mwrite(off, bytes([v & 0xFF]))

@_op(0x54, 0)
def _sload(vm):
    key = vm.pop()
    vm.charge_slot_access(vm.msg.to, key)
    vm.push(vm.state.get_storage(vm.msg.to, key))

@_op(0x55, 0)
def _sstore(vm):
    """EIP-2200 net metering + EIP-2929 cold surcharge + EIP-3529 refund
    ladder, against the transaction-start original value."""
    if vm.msg.is_static:
        raise VmError("SSTORE in static context")
    if vm.gas <= 2300:
        raise VmError("SSTORE gas sentry (EIP-2200)")
    key, val = vm.pop(), vm.pop()
    addr = vm.msg.to
    sk = (addr, key)
    cost = 0
    if sk not in vm.tx.warm_slots:
        vm.tx.warm_slots.add(sk)
        cost += COLD_SLOAD_COST
    cur = vm.state.get_storage(addr, key)
    # first touch this tx records the tx-start value (all later writes go
    # through this journal, so the first SSTORE sees the original)
    orig = vm.tx.original_storage.setdefault(sk, cur)
    if cur == val:
        cost += WARM_ACCESS_COST
    elif cur == orig:
        cost += 20000 if orig == 0 else 5000 - COLD_SLOAD_COST
    else:
        cost += WARM_ACCESS_COST
    vm.use_gas(cost)
    if cur != val:
        if cur == orig:
            if orig != 0 and val == 0:
                vm.refund += SSTORE_CLEARS_REFUND
        else:
            if orig != 0:
                if cur == 0:
                    vm.refund -= SSTORE_CLEARS_REFUND
                elif val == 0:
                    vm.refund += SSTORE_CLEARS_REFUND
            if val == orig:
                if orig == 0:
                    vm.refund += 20000 - WARM_ACCESS_COST
                else:
                    vm.refund += (5000 - COLD_SLOAD_COST
                                  - WARM_ACCESS_COST)
    vm.state.set_storage(addr, key, val)

@_op(0x56, 8)
def _jump(vm):
    dst = vm.pop()
    if dst not in vm.jumpdests:
        raise VmError("invalid jump")
    vm.pc = dst

@_op(0x57, 10)
def _jumpi(vm):
    dst, cond = vm.pop(), vm.pop()
    if cond:
        if dst not in vm.jumpdests:
            raise VmError("invalid jump")
        vm.pc = dst

@_op(0x58, 2)
def _pc(vm):
    vm.push(vm.pc - 1)

@_op(0x59, 2)
def _msize(vm):
    vm.push(len(vm.memory))

@_op(0x5A, 2)
def _gas(vm):
    vm.push(vm.gas)

_op(0x5B, 1)(lambda vm: None)  # JUMPDEST

@_op(0x5C, 100)
def _tload(vm):
    vm.push(vm.state.get_transient(vm.msg.to, vm.pop()))

@_op(0x5D, 100)
def _tstore(vm):
    if vm.msg.is_static:
        raise VmError("TSTORE in static context")
    key, val = vm.pop(), vm.pop()
    vm.state.set_transient(vm.msg.to, key, val)

@_op(0x5E)
def _mcopy(vm):
    dst, src, size = vm.pop(), vm.pop(), vm.pop()
    vm.use_gas(3 * ((size + 31) // 32))
    data = vm.mread(src, size)
    vm.mwrite(dst, data)

@_op(0x5F, 2)
def _push0(vm):
    vm.push(0)


def _make_push(n):
    def fn(vm: Interpreter):
        v = int.from_bytes(vm.code[vm.pc : vm.pc + n], "big")
        vm.pc += n
        vm.push(v)

    return fn


for _n in range(1, 33):
    _op(0x5F + _n)(_make_push(_n))


def _make_dup(n):
    def fn(vm: Interpreter):
        if len(vm.stack) < n:
            raise VmError("stack underflow")
        vm.push(vm.stack[-n])

    return fn


for _n in range(1, 17):
    _op(0x7F + _n)(_make_dup(_n))


def _make_swap(n):
    def fn(vm: Interpreter):
        s = vm.stack
        if len(s) < n + 1:
            raise VmError("stack underflow")
        s[-1], s[-n - 1] = s[-n - 1], s[-1]

    return fn


for _n in range(1, 17):
    _op(0x8F + _n)(_make_swap(_n))


def _make_log(n):
    def fn(vm: Interpreter):
        if vm.msg.is_static:
            raise VmError("LOG in static context")
        off, size = vm.pop(), vm.pop()
        topics = [vm.pop() for _ in range(n)]
        vm.use_gas(375 * n + 8 * size)
        vm.logs.append(Log(vm.msg.to, topics, vm.mread(off, size)))

    return fn


for _n in range(5):
    _op(0xA0 + _n, 375)(_make_log(_n))


# calls / creates / halts
@_op(0xF3, 0)
def _return(vm):
    off, size = vm.pop(), vm.pop()
    return vm.mread(off, size)

@_op(0xFD, 0)
def _revert(vm):
    off, size = vm.pop(), vm.pop()
    raise Revert(vm.mread(off, size))

@_op(0xFE, 0)
def _invalid(vm):
    raise VmError("INVALID opcode")

@_op(0xFF, 5000)
def _selfdestruct(vm):
    if vm.msg.is_static:
        raise VmError("SELFDESTRUCT in static context")
    to = _int_addr(vm.pop())
    # EIP-2929: cold beneficiary surcharge (no warm discount on the base)
    if to not in vm.tx.warm_addresses:
        vm.tx.warm_addresses.add(to)
        vm.use_gas(COLD_ACCOUNT_COST)
    bal = vm.state.get_balance(vm.msg.to)
    if bal and not (vm.state.get_code(to) or vm.state.get_nonce(to)
                    or vm.state.get_balance(to)):
        vm.use_gas(GAS_NEW_ACCOUNT)
    vm.state.sub_balance(vm.msg.to, bal)
    vm.state.add_balance(to, bal)
    # EIP-6780 semantics: only destroy if created in this tx (not tracked;
    # balance sweep only) — matches Scroll's Cancun-era behavior closely
    return b""


def _call_common(vm: Interpreter, op: int):
    gas_req = vm.pop()
    addr = _int_addr(vm.pop())
    value = vm.pop() if op in (0xF1, 0xF2) else 0
    in_off, in_size = vm.pop(), vm.pop()
    out_off, out_size = vm.pop(), vm.pop()
    data = vm.mread(in_off, in_size)
    vm.mem_expand(out_off, out_size)
    vm.charge_account_access(addr)
    if value and vm.msg.is_static and op == 0xF1:
        raise VmError("value transfer in static context")
    if value:
        vm.use_gas(9000)
        # EIP-161/2929: creating a dead account by value transfer
        if op == 0xF1 and not (vm.state.get_code(addr)
                               or vm.state.get_nonce(addr)
                               or vm.state.get_balance(addr)):
            vm.use_gas(GAS_NEW_ACCOUNT)
    # 63/64 rule
    gas = min(gas_req, vm.gas - vm.gas // 64)
    vm.use_gas(gas)
    stipend = 2300 if value else 0

    if op == 0xF1:      # CALL
        sub = Message(caller=vm.msg.to, to=addr, value=value, data=data,
                      gas=gas + stipend, depth=vm.msg.depth + 1,
                      is_static=vm.msg.is_static)
    elif op == 0xF2:    # CALLCODE
        sub = Message(caller=vm.msg.to, to=vm.msg.to, value=value,
                      data=data, gas=gas + stipend,
                      depth=vm.msg.depth + 1,
                      is_static=vm.msg.is_static, code_address=addr)
    elif op == 0xF4:    # DELEGATECALL
        sub = Message(caller=vm.msg.caller, to=vm.msg.to,
                      value=vm.msg.value, data=data, gas=gas,
                      depth=vm.msg.depth + 1,
                      is_static=vm.msg.is_static, code_address=addr)
    else:               # STATICCALL
        sub = Message(caller=vm.msg.to, to=addr, value=0, data=data,
                      gas=gas, depth=vm.msg.depth + 1, is_static=True)

    res = execute_message(vm.state, vm.block, vm.tx, sub)
    vm.returndata = res.output
    vm.gas += res.gas_left
    vm.refund += res.gas_refund
    vm.logs.extend(res.logs)
    n = min(out_size, len(res.output))
    if n:
        vm.mwrite(out_off, res.output[:n])
    vm.push(1 if res.success else 0)


for _opc in (0xF1, 0xF2, 0xF4, 0xFA):
    _op(_opc, 0)(lambda vm, _o=_opc: _call_common(vm, _o))


def _create_common(vm: Interpreter, op: int):
    if vm.msg.is_static:
        raise VmError("CREATE in static context")
    value = vm.pop()
    off, size = vm.pop(), vm.pop()
    salt = vm.pop() if op == 0xF5 else None
    if size > MAX_INITCODE_SIZE:
        raise VmError("initcode too large")
    vm.use_gas(2 * ((size + 31) // 32))  # EIP-3860
    initcode = vm.mread(off, size)
    if op == 0xF5:
        vm.use_gas(6 * ((size + 31) // 32))  # hashing cost
    gas = vm.gas - vm.gas // 64
    vm.use_gas(gas)
    sub = Message(caller=vm.msg.to, to=None, value=value, data=initcode,
                  gas=gas, depth=vm.msg.depth + 1, salt=salt)
    res = execute_message(vm.state, vm.block, vm.tx, sub)
    vm.returndata = b"" if res.success else res.output
    vm.gas += res.gas_left
    vm.refund += res.gas_refund
    vm.logs.extend(res.logs)
    vm.push(_addr_int(res.created) if res.success else 0)


_op(0xF0, 32000)(lambda vm: _create_common(vm, 0xF0))
_op(0xF5, 32000)(lambda vm: _create_common(vm, 0xF5))


# ---------------------------------------------------------------------------
# message execution (top of the call stack)
# ---------------------------------------------------------------------------

def compute_create_address(caller: bytes, nonce: int) -> bytes:
    from . import rlp

    return keccak256(rlp.encode([caller, rlp.int_to_bytes(nonce)]))[12:]


def compute_create2_address(caller: bytes, salt: int,
                            initcode: bytes) -> bytes:
    return keccak256(
        b"\xff" + caller + salt.to_bytes(32, "big") + keccak256(initcode)
    )[12:]


def execute_message(state, block: BlockCtx, tx: TxCtx,
                    msg: Message) -> ExecResult:
    """Run one message; on failure the EIP-2929 access sets revert with
    the state (per the spec: a reverted scope's additions are undone)."""
    warm_a = set(tx.warm_addresses)
    warm_s = set(tx.warm_slots)
    res = _execute_message_inner(state, block, tx, msg)
    if not res.success:
        tx.warm_addresses = warm_a
        tx.warm_slots = warm_s
    return res


def _execute_message_inner(state, block: BlockCtx, tx: TxCtx,
                           msg: Message) -> ExecResult:
    if msg.depth > 1024:
        return ExecResult(False, msg.gas, b"")
    snap = state.snapshot()

    # value transfer
    if msg.value:
        if state.get_balance(msg.caller) < msg.value:
            state.revert(snap)
            return ExecResult(False, msg.gas, b"")

    if msg.to is None:
        # CREATE
        nonce = state.get_nonce(msg.caller)
        if msg.salt is not None:
            created = compute_create2_address(msg.caller, msg.salt,
                                              msg.data)
        else:
            created = compute_create_address(msg.caller, nonce)
        state.inc_nonce(msg.caller)
        if (state.get_code(created) or
                state.get_nonce(created) > 0):
            state.revert(snap)
            return ExecResult(False, 0, b"")
        state.create_account(created)
        tx.warm_addresses.add(created)  # EIP-2929
        state.inc_nonce(created)  # EIP-161
        if msg.value:
            state.sub_balance(msg.caller, msg.value)
            state.add_balance(created, msg.value)
        frame_msg = Message(caller=msg.caller, to=created, value=msg.value,
                            data=b"", gas=msg.gas, depth=msg.depth)
        vm = Interpreter(state, block, tx, frame_msg, msg.data)
        res = vm.run()
        if res.success:
            code = res.output
            if len(code) > MAX_CODE_SIZE or (code and code[0] == 0xEF):
                state.revert(snap)
                return ExecResult(False, 0, b"")
            deposit = 200 * len(code)
            if deposit > res.gas_left:
                state.revert(snap)
                return ExecResult(False, 0, b"")
            state.set_code(created, code)
            return ExecResult(True, res.gas_left - deposit, b"",
                              res.logs, res.gas_refund, created=created)
        state.revert(snap)
        return ExecResult(False, res.gas_left, res.output)

    # plain call
    if msg.value:
        state.sub_balance(msg.caller, msg.value)
        state.add_balance(msg.to, msg.value)

    code_addr = msg.code_address or msg.to
    pre_addr = _addr_int(code_addr)
    if 1 <= pre_addr <= 0x0A:
        ok, out, gas_used = _run_precompile(pre_addr, msg.data, msg.gas)
        if not ok:
            state.revert(snap)
            return ExecResult(False, 0, b"")
        return ExecResult(True, msg.gas - gas_used, out)

    code = state.get_code(code_addr)
    if not code:
        return ExecResult(True, msg.gas, b"")
    vm = Interpreter(state, block, tx, msg, code)
    res = vm.run()
    if not res.success:
        state.revert(snap)
    return res


# ---------------------------------------------------------------------------
# precompiles (reference provider set: crates/types/chunk/src/crypto.rs)
# ---------------------------------------------------------------------------

def _run_precompile(addr: int, data: bytes,
                    gas: int) -> Tuple[bool, bytes, int]:
    try:
        if addr == 0x01:  # ecrecover
            from ..types.chunk.crypto.secp256k1 import ecrecover

            h = data[0:32]
            v = int.from_bytes(data[32:64], "big")
            r = int.from_bytes(data[64:96], "big")
            s = int.from_bytes(data[96:128].ljust(32, b"\x00"), "big")
            if v not in (27, 28):
                return True, b"", 3000
            addr = ecrecover(h, v - 27, r, s)  # returns 20-byte address
            if addr is None:
                return True, b"", 3000
            return True, b"\x00" * 12 + addr, 3000
        if addr == 0x02:  # sha256
            g = 60 + 12 * ((len(data) + 31) // 32)
            return True, hashlib.sha256(data).digest(), g
        if addr == 0x03:  # ripemd160
            g = 600 + 120 * ((len(data) + 31) // 32)
            from ..types.chunk.crypto.ripemd160 import ripemd160

            d = ripemd160(data)
            return True, b"\x00" * 12 + d, g
        if addr == 0x04:  # identity
            return True, data, 15 + 3 * ((len(data) + 31) // 32)
        if addr == 0x05:  # modexp
            lb = int.from_bytes(data[0:32], "big")
            le = int.from_bytes(data[32:64], "big")
            lm = int.from_bytes(data[64:96], "big")
            if lb > 4096 or le > 4096 or lm > 4096:
                return False, b"", gas
            rest = data[96:].ljust(lb + le + lm, b"\x00")
            b = int.from_bytes(rest[:lb], "big")
            e = int.from_bytes(rest[lb : lb + le], "big")
            m = int.from_bytes(rest[lb + le : lb + le + lm], "big")
            out = pow(b, e, m) if m else 0
            return True, out.to_bytes(lm, "big"), 200
        if addr in (0x06, 0x07, 0x08):
            from ..snark.evm import Evm

            ok, out = Evm(b"")._precompile(addr, data)
            g = {6: 150, 7: 6000}.get(addr,
                                      45000 + 34000 * (len(data) // 192))
            return ok, out, g
        if addr == 0x09:  # blake2f — not in the Scroll provider set
            return False, b"", gas
        return True, b"", 0
    except Exception:
        return False, b"", gas
