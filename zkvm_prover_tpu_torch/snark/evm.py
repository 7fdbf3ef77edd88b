"""Minimal EVM interpreter for verifier-contract simulation.

The analog of the reference's revm-based simulation of verifier.bin
(crates/verifier/src/evm.rs:38-43): executes the generated PLONK verifier
bytecode against calldata = instances || proof. Supports the opcode subset
a pairing-based verifier needs (stack ops, 256-bit modular arithmetic,
memory, keccak, staticcall) and the EIP-196/197/198 precompiles
(ecAdd 0x06, ecMul 0x07, ecPairing 0x08, modexp 0x05) backed by the
fields.bn254 host library.

Gas is metered loosely (constant per op + precompile base costs) so
callers can report a gas figure; exact Berlin/Shanghai gas parity is not
the goal — execution semantics are.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..fields import bn254 as bn

U256 = 1 << 256
MASK = U256 - 1


class EvmRevert(Exception):
    def __init__(self, data: bytes = b""):
        self.data = data
        super().__init__(f"revert: {data.hex()}")


class EvmError(Exception):
    pass


def _sx(v: int) -> int:
    """signed interpretation"""
    return v - U256 if v >> 255 else v


class Evm:
    def __init__(self, code: bytes, calldata: bytes = b"",
                 gas: int = 1 << 32):
        self.code = code
        self.calldata = calldata
        self.stack: List[int] = []
        self.memory = bytearray()
        self.pc = 0
        self.gas = gas
        self.returndata = b""

    # -- helpers -----------------------------------------------------------
    def _use(self, g: int) -> None:
        self.gas -= g
        if self.gas < 0:
            raise EvmError("out of gas")

    def _push(self, v: int) -> None:
        if len(self.stack) >= 1024:
            raise EvmError("stack overflow")
        self.stack.append(v & MASK)

    def _pop(self) -> int:
        if not self.stack:
            raise EvmError("stack underflow")
        return self.stack.pop()

    def _mem_expand(self, end: int) -> None:
        if end > len(self.memory):
            grow = (end + 31) // 32 * 32 - len(self.memory)
            self.memory.extend(b"\x00" * grow)

    def _mload(self, off: int) -> int:
        self._mem_expand(off + 32)
        return int.from_bytes(self.memory[off : off + 32], "big")

    def _mstore(self, off: int, v: int) -> None:
        self._mem_expand(off + 32)
        self.memory[off : off + 32] = (v & MASK).to_bytes(32, "big")

    def _mslice(self, off: int, size: int) -> bytes:
        if size == 0:
            return b""
        self._mem_expand(off + size)
        return bytes(self.memory[off : off + size])

    # -- run ---------------------------------------------------------------
    def run(self) -> bytes:
        code = self.code
        while True:
            if self.pc >= len(code):
                return b""  # implicit STOP
            op = code[self.pc]
            self.pc += 1
            self._use(3)

            if 0x60 <= op <= 0x7F:  # PUSH1..PUSH32
                n = op - 0x5F
                v = int.from_bytes(code[self.pc : self.pc + n], "big")
                self.pc += n
                self._push(v)
            elif op == 0x5F:  # PUSH0
                self._push(0)
            elif 0x80 <= op <= 0x8F:  # DUP1..16
                n = op - 0x7F
                if len(self.stack) < n:
                    raise EvmError("stack underflow")
                self._push(self.stack[-n])
            elif 0x90 <= op <= 0x9F:  # SWAP1..16
                n = op - 0x8F
                if len(self.stack) < n + 1:
                    raise EvmError("stack underflow")
                s = self.stack
                s[-1], s[-n - 1] = s[-n - 1], s[-1]
            elif op == 0x50:  # POP
                self._pop()
            elif op == 0x01:  # ADD
                self._push(self._pop() + self._pop())
            elif op == 0x02:  # MUL
                self._push(self._pop() * self._pop())
            elif op == 0x03:  # SUB
                a = self._pop(); b = self._pop()
                self._push(a - b)
            elif op == 0x04:  # DIV
                a = self._pop(); b = self._pop()
                self._push(a // b if b else 0)
            elif op == 0x06:  # MOD
                a = self._pop(); b = self._pop()
                self._push(a % b if b else 0)
            elif op == 0x08:  # ADDMOD
                a = self._pop(); b = self._pop(); m = self._pop()
                self._push((a + b) % m if m else 0)
            elif op == 0x09:  # MULMOD
                a = self._pop(); b = self._pop(); m = self._pop()
                self._push(a * b % m if m else 0)
            elif op == 0x0A:  # EXP
                a = self._pop(); e = self._pop()
                self._push(pow(a, e, U256))
            elif op == 0x10:  # LT
                a = self._pop(); b = self._pop()
                self._push(1 if a < b else 0)
            elif op == 0x11:  # GT
                a = self._pop(); b = self._pop()
                self._push(1 if a > b else 0)
            elif op == 0x12:  # SLT
                a = self._pop(); b = self._pop()
                self._push(1 if _sx(a) < _sx(b) else 0)
            elif op == 0x14:  # EQ
                a = self._pop(); b = self._pop()
                self._push(1 if a == b else 0)
            elif op == 0x15:  # ISZERO
                self._push(1 if self._pop() == 0 else 0)
            elif op == 0x16:  # AND
                self._push(self._pop() & self._pop())
            elif op == 0x17:  # OR
                self._push(self._pop() | self._pop())
            elif op == 0x18:  # XOR
                self._push(self._pop() ^ self._pop())
            elif op == 0x19:  # NOT
                self._push(~self._pop())
            elif op == 0x1A:  # BYTE
                i = self._pop(); x = self._pop()
                self._push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
            elif op == 0x1B:  # SHL
                s = self._pop(); v = self._pop()
                self._push(v << s if s < 256 else 0)
            elif op == 0x1C:  # SHR
                s = self._pop(); v = self._pop()
                self._push(v >> s if s < 256 else 0)
            elif op == 0x20:  # SHA3 (KECCAK256)
                off = self._pop(); size = self._pop()
                from ..ops.keccak import keccak256

                self._use(30 + 6 * ((size + 31) // 32))
                self._push(int.from_bytes(
                    keccak256(self._mslice(off, size)), "big"))
            elif op == 0x34:  # CALLVALUE
                self._push(0)
            elif op == 0x35:  # CALLDATALOAD
                off = self._pop()
                data = self.calldata[off : off + 32]
                self._push(int.from_bytes(
                    data + b"\x00" * (32 - len(data)), "big"))
            elif op == 0x36:  # CALLDATASIZE
                self._push(len(self.calldata))
            elif op == 0x37:  # CALLDATACOPY
                dst = self._pop(); src = self._pop(); size = self._pop()
                data = self.calldata[src : src + size]
                data = data + b"\x00" * (size - len(data))
                self._mem_expand(dst + size)
                self.memory[dst : dst + size] = data
            elif op == 0x3D:  # RETURNDATASIZE
                self._push(len(self.returndata))
            elif op == 0x3E:  # RETURNDATACOPY
                dst = self._pop(); src = self._pop(); size = self._pop()
                if src + size > len(self.returndata):
                    raise EvmError("returndata out of bounds")
                self._mem_expand(dst + size)
                self.memory[dst : dst + size] = \
                    self.returndata[src : src + size]
            elif op == 0x51:  # MLOAD
                self._push(self._mload(self._pop()))
            elif op == 0x52:  # MSTORE
                off = self._pop(); v = self._pop()
                self._mstore(off, v)
            elif op == 0x53:  # MSTORE8
                off = self._pop(); v = self._pop()
                self._mem_expand(off + 1)
                self.memory[off] = v & 0xFF
            elif op == 0x56:  # JUMP
                dst = self._pop()
                self._jump(dst)
            elif op == 0x57:  # JUMPI
                dst = self._pop(); cond = self._pop()
                if cond:
                    self._jump(dst)
            elif op == 0x58:  # PC
                self._push(self.pc - 1)
            elif op == 0x59:  # MSIZE
                self._push(len(self.memory))
            elif op == 0x5A:  # GAS
                self._push(max(self.gas, 0))
            elif op == 0x5B:  # JUMPDEST
                pass
            elif op == 0xF3:  # RETURN
                off = self._pop(); size = self._pop()
                return self._mslice(off, size)
            elif op == 0xFD:  # REVERT
                off = self._pop(); size = self._pop()
                raise EvmRevert(self._mslice(off, size))
            elif op == 0x00:  # STOP
                return b""
            elif op == 0xFA:  # STATICCALL
                gas = self._pop(); addr = self._pop()
                in_off = self._pop(); in_size = self._pop()
                out_off = self._pop(); out_size = self._pop()
                ok, out = self._precompile(addr,
                                           self._mslice(in_off, in_size))
                self.returndata = out
                if ok:
                    n = min(out_size, len(out))
                    self._mem_expand(out_off + out_size)
                    self.memory[out_off : out_off + n] = out[:n]
                self._push(1 if ok else 0)
            else:
                raise EvmError(f"unsupported opcode 0x{op:02x}")

    def _jump(self, dst: int) -> None:
        if dst >= len(self.code) or self.code[dst] != 0x5B:
            raise EvmError(f"invalid jump dest {dst}")
        self.pc = dst

    # -- precompiles -------------------------------------------------------
    def _precompile(self, addr: int, data: bytes) -> Tuple[bool, bytes]:
        try:
            if addr == 0x05:  # MODEXP (EIP-198)
                self._use(200)
                lb = int.from_bytes(data[0:32], "big")
                le = int.from_bytes(data[32:64], "big")
                lm = int.from_bytes(data[64:96], "big")
                b = int.from_bytes(data[96 : 96 + lb], "big")
                e = int.from_bytes(data[96 + lb : 96 + lb + le], "big")
                m = int.from_bytes(
                    data[96 + lb + le : 96 + lb + le + lm], "big")
                out = pow(b, e, m) if m else 0
                return True, out.to_bytes(lm, "big")
            if addr == 0x06:  # ecAdd
                self._use(150)
                p1 = _read_g1(data, 0)
                p2 = _read_g1(data, 64)
                return True, _write_g1(bn.g1_add(p1, p2))
            if addr == 0x07:  # ecMul
                self._use(6000)
                p = _read_g1(data, 0)
                k = int.from_bytes(data[64:96].ljust(32, b"\x00"), "big")
                return True, _write_g1(bn.g1_mul_jac(p, k))
            if addr == 0x08:  # ecPairing
                n = len(data) // 192
                self._use(45000 + 34000 * n)
                if len(data) % 192:
                    return False, b""
                pairs = []
                for i in range(n):
                    off = i * 192
                    g1 = _read_g1(data, off)
                    # EIP-197 G2 encoding: x_im, x_re, y_im, y_re
                    xi = int.from_bytes(data[off + 64 : off + 96], "big")
                    xr = int.from_bytes(data[off + 96 : off + 128], "big")
                    yi = int.from_bytes(data[off + 128 : off + 160], "big")
                    yr = int.from_bytes(data[off + 160 : off + 192], "big")
                    if xi == xr == yi == yr == 0:
                        g2 = None
                    else:
                        g2 = ((xr, xi), (yr, yi))
                        if not bn.g2_is_on_curve(g2):
                            return False, b""
                    if g1 is not None and g2 is not None:
                        pairs.append((g2, g1))
                ok = bn.pairing_check(pairs)
                return True, (1 if ok else 0).to_bytes(32, "big")
            return False, b""
        except Exception:
            return False, b""


def _read_g1(data: bytes, off: int) -> bn.G1:
    x = int.from_bytes(data[off : off + 32].ljust(32, b"\x00"), "big")
    y = int.from_bytes(data[off + 32 : off + 64].ljust(32, b"\x00"), "big")
    if x == 0 and y == 0:
        return None
    p = (x, y)
    if not bn.g1_is_on_curve(p):
        raise EvmError("ec point not on curve")
    return p


def _write_g1(p: bn.G1) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")
