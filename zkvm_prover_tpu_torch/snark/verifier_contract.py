"""PLONK verifier as generated EVM bytecode — the verifier.bin analog.

The reference ships a snark-verifier-generated Yul/EVM contract and
simulates it with revm (crates/verifier/src/evm.rs:38-43; release asset
`verifier.bin`). This module generates equivalent bytecode for the
fully-opened PLONK verifier (snark/plonk.py): keccak Fiat-Shamir replay,
the numeric quotient-identity check with MODEXP inversions, the batched
KZG MSM via ecAdd/ecMul precompiles, and the final ecPairing call.

Calldata layout:  [46 * 32-byte instances][proof: 9 * 64B comms ||
16 * 32B evals].  Returns 32-byte word 1 on success, REVERTs otherwise.

All loops are unrolled at generation time (the circuit is fixed), so the
bytecode is straight-line with a single failure label.
"""

from __future__ import annotations

from typing import List, Sequence

from ..fields import bn254 as bn
from ..ops.keccak import keccak256
from . import fr, plonk
from .fr import R
from .plonk import _COMM_ORDER, _EVAL_ORDER, _ZETA_OPEN_ORDER, K1, K2

# ---------------------------------------------------------------------------
# memory map
# ---------------------------------------------------------------------------
M_STATE = 0x00      # transcript state
M_SCR1 = 0x20       # keccak scratch
M_SCR2 = 0x40
BETA, GAMMA, ALPHA, ZETA, VCH, UCH = 0x200, 0x220, 0x240, 0x260, 0x280, 0x2A0
ZH, PI_EVAL, VC, Y_COMB = 0x2C0, 0x2E0, 0x300, 0x320
ACC_X, ACC_Y = 0x340, 0x360        # running F accumulator
LHS_X, LHS_Y = 0x380, 0x3A0
RHS_X, RHS_Y = 0x3C0, 0x3E0
ECADD_IN = 0x400                    # 128B in, 64B out (reused)
ECMUL_IN = 0x480                    # 96B in
MODEXP_IN = 0x500                   # 0x500 lens, 0x560 base, 0x580 exp,
MODEXP_OUT = 0x5C0                  # 0x5A0 mod
PAIR_IN = 0x600                     # 384B
TMP = 0x7A0


class Asm:
    OPS = {
        "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
        "MOD": 0x06, "ADDMOD": 0x08, "MULMOD": 0x09, "EXP": 0x0A,
        "LT": 0x10, "GT": 0x11, "EQ": 0x14, "ISZERO": 0x15, "AND": 0x16,
        "OR": 0x17, "XOR": 0x18, "NOT": 0x19, "BYTE": 0x1A, "SHL": 0x1B,
        "SHR": 0x1C, "SHA3": 0x20, "CALLDATALOAD": 0x35,
        "CALLDATASIZE": 0x36, "CALLDATACOPY": 0x37, "POP": 0x50,
        "MLOAD": 0x51, "MSTORE": 0x52, "MSTORE8": 0x53, "JUMP": 0x56,
        "JUMPI": 0x57, "JUMPDEST": 0x5B, "RETURN": 0xF3, "REVERT": 0xFD,
        "STATICCALL": 0xFA, "DUP1": 0x80, "DUP2": 0x81, "DUP3": 0x82,
        "SWAP1": 0x90, "SWAP2": 0x91, "GAS": 0x5A,
    }

    def __init__(self) -> None:
        self.items: List = []  # ints (opcodes) | ("push", int) |
        # ("pushlabel", name) | ("label", name)

    def op(self, name: str) -> "Asm":
        self.items.append(self.OPS[name])
        return self

    def push(self, v: int) -> "Asm":
        self.items.append(("push", int(v) % (1 << 256)))
        return self

    def push_label(self, name: str) -> "Asm":
        self.items.append(("pushlabel", name))
        return self

    def label(self, name: str) -> "Asm":
        self.items.append(("label", name))
        return self

    def assemble(self) -> bytes:
        # labels use fixed 2-byte PUSH2 targets; two-pass
        sizes = []
        for it in self.items:
            if isinstance(it, int):
                sizes.append(1)
            elif it[0] == "push":
                n = max(1, (it[1].bit_length() + 7) // 8)
                sizes.append(1 + n)
            elif it[0] == "pushlabel":
                sizes.append(3)
            else:  # label -> JUMPDEST
                sizes.append(1)
        offsets = {}
        pos = 0
        for it, sz in zip(self.items, sizes):
            if isinstance(it, tuple) and it[0] == "label":
                offsets[it[1]] = pos
            pos += sz
        out = bytearray()
        for it in self.items:
            if isinstance(it, int):
                out.append(it)
            elif it[0] == "push":
                v = it[1]
                n = max(1, (v.bit_length() + 7) // 8)
                out.append(0x5F + n)  # PUSHn
                out += v.to_bytes(n, "big")
            elif it[0] == "pushlabel":
                out.append(0x61)  # PUSH2
                out += offsets[it[1]].to_bytes(2, "big")
            else:
                out.append(0x5B)  # JUMPDEST
        return bytes(out)

    # -- composite helpers -------------------------------------------------
    def mstore(self, off: int) -> "Asm":
        """value on stack -> mem[off]"""
        return self.push(off).op("MSTORE")

    def mload(self, off: int) -> "Asm":
        return self.push(off).op("MLOAD")

    def cdload(self, off: int) -> "Asm":
        return self.push(off).op("CALLDATALOAD")

    def sha3(self, off: int, size: int) -> "Asm":
        return self.push(size).push(off).op("SHA3")

    def mulmod_r(self) -> "Asm":
        """[.., b, a] -> [.., a*b % R]"""
        # MULMOD pops a, b, N
        return self.push(R).op("SWAP2").op("SWAP1").op("MULMOD")

    def addmod_r(self) -> "Asm":
        return self.push(R).op("SWAP2").op("SWAP1").op("ADDMOD")

    def fail_if_zero(self) -> "Asm":
        return self.op("ISZERO").push_label("fail").op("JUMPI")

    def fail_if_nonzero(self) -> "Asm":
        return self.push_label("fail").op("JUMPI")


def _g2_words(p: bn.G2pt) -> List[int]:
    """EIP-197 order: x_im, x_re, y_im, y_re."""
    (xr, xi), (yr, yi) = p
    return [xi, xr, yi, yr]


def generate_verifier(vk: plonk.PlonkVk) -> bytes:
    n = 1 << vk.log_n
    omega = fr.root_of_unity(vk.log_n)
    n_inv = pow(n, R - 2, R)
    n_pub = vk.n_public
    INST = 0
    COMM_BASE = n_pub * 32
    EVAL_BASE = COMM_BASE + len(_COMM_ORDER) * 64
    comm_off = {k: COMM_BASE + i * 64 for i, k in enumerate(_COMM_ORDER)}
    eval_off = {k: EVAL_BASE + i * 32 for i, k in enumerate(_EVAL_ORDER)}

    # transcript state after the generation-time-constant vk digest absorb
    s0 = keccak256(b"plonk-bn254")
    s1 = keccak256(s0 + vk.digest())

    a = Asm()

    # ---- transcript ---------------------------------------------------
    a.push(int.from_bytes(s1, "big")).mstore(M_STATE)

    def absorb_word_from(getter) -> None:
        getter()                       # value on stack
        a.mstore(M_SCR1)
        a.sha3(0x00, 0x40).mstore(M_STATE)

    def absorb_point(off: int) -> None:
        a.cdload(off).mstore(M_SCR1)
        a.cdload(off + 32).mstore(M_SCR2)
        a.sha3(0x00, 0x60).mstore(M_STATE)

    def challenge(slot: int) -> None:
        a.push(1).push(M_SCR1).op("MSTORE8")
        a.sha3(0x00, 0x21)
        a.op("DUP1").mstore(M_STATE)
        a.push(R).op("SWAP1").op("MOD").mstore(slot)

    for i in range(n_pub):
        absorb_word_from(lambda i=i: a.cdload(INST + i * 32))
    for k in ("a", "b", "c"):
        absorb_point(comm_off[k])
    challenge(BETA)
    challenge(GAMMA)
    absorb_point(comm_off["z"])
    challenge(ALPHA)
    for k in ("t_lo", "t_mid", "t_hi"):
        absorb_point(comm_off[k])
    challenge(ZETA)
    for k in _EVAL_ORDER:
        absorb_word_from(lambda k=k: a.cdload(eval_off[k]))
    challenge(VCH)
    absorb_point(comm_off["w_zeta"])
    absorb_point(comm_off["w_zeta_omega"])
    challenge(UCH)

    # ---- MODEXP scaffolding (lens/exp/mod written once) ---------------
    a.push(32).mstore(MODEXP_IN)
    a.push(32).mstore(MODEXP_IN + 0x20)
    a.push(32).mstore(MODEXP_IN + 0x40)
    a.push(R - 2).mstore(MODEXP_IN + 0x80)
    a.push(R).mstore(MODEXP_IN + 0xA0)

    def inverse() -> None:
        """stack top x -> x^{-1} mod R on stack"""
        a.mstore(MODEXP_IN + 0x60)
        a.push(32).push(MODEXP_OUT).push(0xC0).push(MODEXP_IN)
        a.push(5).op("GAS").op("STATICCALL")
        a.fail_if_zero()
        a.mload(MODEXP_OUT)

    # ---- zh = zeta^n - 1 ----------------------------------------------
    a.mload(ZETA)
    for _ in range(vk.log_n):
        a.op("DUP1").mulmod_r()
    a.op("DUP1").mstore(TMP)  # zeta^n saved for t_eval
    a.push(R - 1).addmod_r().op("DUP1").mstore(ZH)
    a.fail_if_zero()          # zeta in H would divide by zero

    # ---- pi_eval ------------------------------------------------------
    # li = zh * n_inv * w_i * inv(zeta - w_i);  pi -= x_i * li
    a.push(0).mstore(PI_EVAL)
    w = omega
    for i in range(n_pub):
        a.mload(ZETA).push(R - w).addmod_r()  # zeta - w_i
        inverse()
        a.mload(ZH).mulmod_r()
        a.push(n_inv).mulmod_r()
        a.push(w).mulmod_r()                  # li
        a.cdload(INST + i * 32).mulmod_r()    # x_i * li
        # pi_eval -= : add R - v
        a.push(R).op("SUB")                    # R - (x_i*li)  (x<R so ok)
        a.mload(PI_EVAL).addmod_r().mstore(PI_EVAL)
        w = w * omega % R

    # ---- gate identity -------------------------------------------------
    def e(k: str) -> None:
        a.cdload(eval_off[k])

    # gate = ql*a + qr*b + qo*c + qm*a*b + qc + pi_eval
    e("ql"); e("a"); a.mulmod_r()
    e("qr"); e("b"); a.mulmod_r(); a.addmod_r()
    e("qo"); e("c"); a.mulmod_r(); a.addmod_r()
    e("qm"); e("a"); a.mulmod_r(); e("b"); a.mulmod_r(); a.addmod_r()
    e("qc"); a.addmod_r()
    a.mload(PI_EVAL); a.addmod_r()
    a.mstore(TMP + 0x20)  # gate

    def lin_factor(ek: str, mult_slot_const, sk: str = "") -> None:
        """(e[ek] + beta * m + gamma) where m = K*zeta or e[sk]"""
        a.mload(BETA)
        if sk:
            e(sk)
        else:
            a.push(mult_slot_const).mload(ZETA).mulmod_r()
        a.mulmod_r()
        e(ek); a.addmod_r()
        a.mload(GAMMA); a.addmod_r()

    # p1 = z * (a+b*zeta+g)(b+b*k1*zeta+g)(c+b*k2*zeta+g)
    e("z")
    lin_factor("a", 1); a.mulmod_r()
    lin_factor("b", K1); a.mulmod_r()
    lin_factor("c", K2); a.mulmod_r()
    a.mstore(TMP + 0x40)
    # p2 = z_omega * (a+b*s1+g)(b+b*s2+g)(c+b*s3+g)
    e("z_omega")
    lin_factor("a", 0, "s1"); a.mulmod_r()
    lin_factor("b", 0, "s2"); a.mulmod_r()
    lin_factor("c", 0, "s3"); a.mulmod_r()
    a.mstore(TMP + 0x60)
    # p3 = (z - 1) * l1 ; l1 = zh * n_inv * inv(zeta - 1)
    a.mload(ZETA).push(R - 1).addmod_r()
    inverse()
    a.mload(ZH).mulmod_r().push(n_inv).mulmod_r()
    e("z"); a.push(R - 1); a.addmod_r(); a.mulmod_r()
    a.mstore(TMP + 0x80)

    # lhs = gate + alpha*(p1 - p2) + alpha^2 * p3
    a.mload(TMP + 0x60).push(R).op("SUB")       # -p2  (p2 < R)
    a.mload(TMP + 0x40).addmod_r()              # p1 - p2
    a.mload(ALPHA).mulmod_r()
    a.mload(TMP + 0x20).addmod_r()
    a.mload(ALPHA).op("DUP1").mulmod_r()
    a.mload(TMP + 0x80).mulmod_r()
    a.addmod_r()                                 # lhs

    # rhs = (t_lo + zn*t_mid + zn^2*t_hi) * zh
    a.mload(TMP)                                 # zn
    e("t_mid"); a.mulmod_r()
    e("t_lo"); a.addmod_r()
    a.mload(TMP).op("DUP1").mulmod_r()
    e("t_hi"); a.mulmod_r()
    a.addmod_r()
    a.mload(ZH).mulmod_r()

    # compare
    a.op("EQ").fail_if_zero()

    # ---- batched KZG ---------------------------------------------------
    # F accumulation with running vc; ec precompile helpers
    def ecmul_into_addin(load_point, load_scalar) -> None:
        """ecMul(point, scalar) -> ECADD_IN+64"""
        load_point()   # writes x,y into ECMUL_IN, ECMUL_IN+32
        load_scalar()
        a.mstore(ECMUL_IN + 0x40)
        a.push(64).push(ECADD_IN + 0x40).push(0x60).push(ECMUL_IN)
        a.push(7).op("GAS").op("STATICCALL")
        a.fail_if_zero()

    def ecadd_acc() -> None:
        """ECADD_IN(acc) + ECADD_IN+64 -> acc slots; acc already at
        ECADD_IN via caller"""
        a.push(64).push(ECADD_IN).push(0x80).push(ECADD_IN)
        a.push(6).op("GAS").op("STATICCALL")
        a.fail_if_zero()
        a.mload(ECADD_IN).mstore(ACC_X)
        a.mload(ECADD_IN + 0x20).mstore(ACC_Y)

    def load_comm_const(p: bn.G1) -> None:
        x, y = (0, 0) if p is None else p
        a.push(x).mstore(ECMUL_IN)
        a.push(y).mstore(ECMUL_IN + 0x20)

    def load_comm_cd(off: int) -> None:
        a.cdload(off).mstore(ECMUL_IN)
        a.cdload(off + 32).mstore(ECMUL_IN + 0x20)

    vk_comm = {
        "ql": vk.q_comms[0], "qr": vk.q_comms[1], "qo": vk.q_comms[2],
        "qm": vk.q_comms[3], "qc": vk.q_comms[4],
        "s1": vk.sigma_comms[0], "s2": vk.sigma_comms[1],
        "s3": vk.sigma_comms[2],
    }
    proof_comm_names = {"a", "b", "c", "z", "t_lo", "t_mid", "t_hi"}

    a.push(1).mstore(VC)
    a.push(0).mstore(Y_COMB)
    a.push(0).mstore(ACC_X)
    a.push(0).mstore(ACC_Y)
    for k in _ZETA_OPEN_ORDER:
        # y_comb += vc * e_k
        a.mload(VC)
        e(k); a.mulmod_r()
        a.mload(Y_COMB); a.addmod_r(); a.mstore(Y_COMB)
        # acc += vc * C_k
        a.mload(ACC_X).mstore(ECADD_IN)
        a.mload(ACC_Y).mstore(ECADD_IN + 0x20)
        if k in proof_comm_names:
            ecmul_into_addin(lambda k=k: load_comm_cd(comm_off[k]),
                             lambda: a.mload(VC))
        else:
            ecmul_into_addin(lambda k=k: load_comm_const(vk_comm[k]),
                             lambda: a.mload(VC))
        ecadd_acc()
        # vc *= v
        a.mload(VC).mload(VCH).mulmod_r().mstore(VC)
    # F += u * C_z ; y_total = y_comb + u * z_omega
    a.mload(ACC_X).mstore(ECADD_IN)
    a.mload(ACC_Y).mstore(ECADD_IN + 0x20)
    ecmul_into_addin(lambda: load_comm_cd(comm_off["z"]),
                     lambda: a.mload(UCH))
    ecadd_acc()
    a.mload(UCH)
    e("z_omega"); a.mulmod_r()
    a.mload(Y_COMB); a.addmod_r(); a.mstore(Y_COMB)  # now y_total

    # lhs_pt = W_z + u*W_zw
    load_comm_cd(comm_off["w_zeta"])
    a.mload(ECMUL_IN).mstore(ECADD_IN)
    a.mload(ECMUL_IN + 0x20).mstore(ECADD_IN + 0x20)
    ecmul_into_addin(lambda: load_comm_cd(comm_off["w_zeta_omega"]),
                     lambda: a.mload(UCH))
    a.push(64).push(ECADD_IN).push(0x80).push(ECADD_IN)
    a.push(6).op("GAS").op("STATICCALL")
    a.fail_if_zero()
    a.mload(ECADD_IN).mstore(LHS_X)
    a.mload(ECADD_IN + 0x20).mstore(LHS_Y)

    # rhs_pt = F + zeta*W_z + (u*zeta*omega)*W_zw + ((R - y_total) % R)*G
    # (the negated G term uses scalar R - y, valid since G has order R).
    # F is still live in the ACC slots (the lhs computation only touched
    # the precompile scratch); keep accumulating into ACC.
    def acc_term(load_point, load_scalar) -> None:
        a.mload(ACC_X).mstore(ECADD_IN)
        a.mload(ACC_Y).mstore(ECADD_IN + 0x20)
        ecmul_into_addin(load_point, load_scalar)
        ecadd_acc()

    acc_term(lambda: load_comm_cd(comm_off["w_zeta"]),
             lambda: a.mload(ZETA))

    def uzw_scalar() -> None:
        a.mload(UCH).mload(ZETA).mulmod_r().push(omega).mulmod_r()

    acc_term(lambda: load_comm_cd(comm_off["w_zeta_omega"]), uzw_scalar)

    def neg_y_scalar() -> None:
        a.mload(Y_COMB).push(R).op("SUB")  # R - y_total (y_total < R)
        a.push(R).op("SWAP1").op("MOD")    # reduce R -> 0 when y == 0

    acc_term(lambda: load_comm_const(bn.G1_GEN), neg_y_scalar)

    # ---- pairing: e(lhs, tau2) * e(rhs, -G2) == 1 ---------------------
    a.mload(LHS_X).mstore(PAIR_IN)
    a.mload(LHS_Y).mstore(PAIR_IN + 0x20)
    for i, wrd in enumerate(_g2_words(vk.tau_g2)):
        a.push(wrd).mstore(PAIR_IN + 0x40 + i * 0x20)
    a.mload(ACC_X).mstore(PAIR_IN + 0xC0)
    a.mload(ACC_Y).mstore(PAIR_IN + 0xE0)
    for i, wrd in enumerate(_g2_words(bn.g2_neg(bn.G2_GEN))):
        a.push(wrd).mstore(PAIR_IN + 0x100 + i * 0x20)
    a.push(32).push(MODEXP_OUT).push(0x180).push(PAIR_IN)
    a.push(8).op("GAS").op("STATICCALL")
    a.fail_if_zero()
    a.mload(MODEXP_OUT).fail_if_zero()

    # ---- success: return the word 1 -----------------------------------
    a.push(1).mstore(0x00)
    a.push(0x20).push(0x00).op("RETURN")

    a.label("fail")
    a.push(0).push(0).op("REVERT")

    return a.assemble()


def calldata_for(proof: plonk.PlonkProof,
                 public: Sequence[int]) -> bytes:
    inst = b"".join(int(x % R).to_bytes(32, "big") for x in public)
    return inst + proof.to_bytes()


_CODE_CACHE = {}


def evm_verify(vk: plonk.PlonkVk, proof: plonk.PlonkProof,
               public: Sequence[int]) -> bool:
    """Run the generated verifier bytecode under the mini-EVM
    (revm-simulation analog). Returns True iff the contract returns 1."""
    from .evm import Evm, EvmError, EvmRevert

    key = vk.digest()
    code = _CODE_CACHE.get(key)
    if code is None:
        code = generate_verifier(vk)
        _CODE_CACHE[key] = code
    try:
        out = Evm(code, calldata_for(proof, public)).run()
    except (EvmRevert, EvmError):
        return False
    return len(out) == 32 and int.from_bytes(out, "big") == 1
