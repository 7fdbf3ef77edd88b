"""Minimal RV32IM assembler — instruction encoders + a tiny label-resolving
assembler for writing guest test programs (no RISC-V toolchain in the image).
"""

from __future__ import annotations

from typing import Dict, List, Union

REGS = {f"x{i}": i for i in range(32)}
REGS.update(
    {
        "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4,
        "t0": 5, "t1": 6, "t2": 7, "s0": 8, "fp": 8, "s1": 9,
        "a0": 10, "a1": 11, "a2": 12, "a3": 13, "a4": 14, "a5": 15,
        "a6": 16, "a7": 17,
        **{f"s{i}": 16 + i for i in range(2, 12)},
        **{f"t{i}": 25 + i for i in range(3, 7)},
    }
)


def _r(x: Union[str, int]) -> int:
    return REGS[x] if isinstance(x, str) else int(x)


def _imm(v: int, bits: int) -> int:
    lo = -(1 << (bits - 1))
    hi = (1 << bits) - 1
    assert lo <= v <= hi, f"imm {v} out of {bits}-bit range"
    return v & ((1 << bits) - 1)


def r_type(funct7, rs2, rs1, funct3, rd, opcode):
    return (
        (funct7 << 25) | (_r(rs2) << 20) | (_r(rs1) << 15) | (funct3 << 12)
        | (_r(rd) << 7) | opcode
    )


def i_type(imm, rs1, funct3, rd, opcode):
    return (
        (_imm(imm, 12) << 20) | (_r(rs1) << 15) | (funct3 << 12)
        | (_r(rd) << 7) | opcode
    )


def s_type(imm, rs2, rs1, funct3, opcode):
    imm = _imm(imm, 12)
    return (
        ((imm >> 5) << 25) | (_r(rs2) << 20) | (_r(rs1) << 15)
        | (funct3 << 12) | ((imm & 0x1F) << 7) | opcode
    )


def b_type(imm, rs2, rs1, funct3):
    imm = _imm(imm, 13)
    return (
        ((imm >> 12) << 31) | (((imm >> 5) & 0x3F) << 25) | (_r(rs2) << 20)
        | (_r(rs1) << 15) | (funct3 << 12) | (((imm >> 1) & 0xF) << 8)
        | (((imm >> 11) & 1) << 7) | 0x63
    )


def j_type(imm, rd):
    imm = _imm(imm, 21)
    return (
        ((imm >> 20) << 31) | (((imm >> 1) & 0x3FF) << 21)
        | (((imm >> 11) & 1) << 20) | (((imm >> 12) & 0xFF) << 12)
        | (_r(rd) << 7) | 0x6F
    )


# --- mnemonics -------------------------------------------------------------

def addi(rd, rs1, imm):
    return i_type(imm, rs1, 0, rd, 0x13)

def slti(rd, rs1, imm):
    return i_type(imm, rs1, 2, rd, 0x13)

def sltiu(rd, rs1, imm):
    return i_type(imm, rs1, 3, rd, 0x13)

def xori(rd, rs1, imm):
    return i_type(imm, rs1, 4, rd, 0x13)

def ori(rd, rs1, imm):
    return i_type(imm, rs1, 6, rd, 0x13)

def andi(rd, rs1, imm):
    return i_type(imm, rs1, 7, rd, 0x13)

def slli(rd, rs1, sh):
    return i_type(sh, rs1, 1, rd, 0x13)

def srli(rd, rs1, sh):
    return i_type(sh, rs1, 5, rd, 0x13)

def srai(rd, rs1, sh):
    return i_type(sh | 0x400, rs1, 5, rd, 0x13)

def add(rd, rs1, rs2):
    return r_type(0, rs2, rs1, 0, rd, 0x33)

def sub(rd, rs1, rs2):
    return r_type(0x20, rs2, rs1, 0, rd, 0x33)

def sll(rd, rs1, rs2):
    return r_type(0, rs2, rs1, 1, rd, 0x33)

def slt(rd, rs1, rs2):
    return r_type(0, rs2, rs1, 2, rd, 0x33)

def sltu(rd, rs1, rs2):
    return r_type(0, rs2, rs1, 3, rd, 0x33)

def xor(rd, rs1, rs2):
    return r_type(0, rs2, rs1, 4, rd, 0x33)

def srl(rd, rs1, rs2):
    return r_type(0, rs2, rs1, 5, rd, 0x33)

def sra(rd, rs1, rs2):
    return r_type(0x20, rs2, rs1, 5, rd, 0x33)

def or_(rd, rs1, rs2):
    return r_type(0, rs2, rs1, 6, rd, 0x33)

def and_(rd, rs1, rs2):
    return r_type(0, rs2, rs1, 7, rd, 0x33)

def mul(rd, rs1, rs2):
    return r_type(1, rs2, rs1, 0, rd, 0x33)

def mulh(rd, rs1, rs2):
    return r_type(1, rs2, rs1, 1, rd, 0x33)

def mulhsu(rd, rs1, rs2):
    return r_type(1, rs2, rs1, 2, rd, 0x33)

def mulhu(rd, rs1, rs2):
    return r_type(1, rs2, rs1, 3, rd, 0x33)

def div(rd, rs1, rs2):
    return r_type(1, rs2, rs1, 4, rd, 0x33)

def divu(rd, rs1, rs2):
    return r_type(1, rs2, rs1, 5, rd, 0x33)

def rem(rd, rs1, rs2):
    return r_type(1, rs2, rs1, 6, rd, 0x33)

def remu(rd, rs1, rs2):
    return r_type(1, rs2, rs1, 7, rd, 0x33)

def lui(rd, imm20):
    return ((imm20 & 0xFFFFF) << 12) | (_r(rd) << 7) | 0x37

def auipc(rd, imm20):
    return ((imm20 & 0xFFFFF) << 12) | (_r(rd) << 7) | 0x17

def lb(rd, rs1, imm):
    return i_type(imm, rs1, 0, rd, 0x03)

def lh(rd, rs1, imm):
    return i_type(imm, rs1, 1, rd, 0x03)

def lw(rd, rs1, imm):
    return i_type(imm, rs1, 2, rd, 0x03)

def lbu(rd, rs1, imm):
    return i_type(imm, rs1, 4, rd, 0x03)

def lhu(rd, rs1, imm):
    return i_type(imm, rs1, 5, rd, 0x03)

def sb(rs2, rs1, imm):
    return s_type(imm, rs2, rs1, 0, 0x23)

def sh(rs2, rs1, imm):
    return s_type(imm, rs2, rs1, 1, 0x23)

def sw(rs2, rs1, imm):
    return s_type(imm, rs2, rs1, 2, 0x23)

def jal(rd, imm):
    return j_type(imm, rd)

def jalr(rd, rs1, imm):
    return i_type(imm, rs1, 0, rd, 0x67)

def beq(rs1, rs2, imm):
    return b_type(imm, rs2, rs1, 0)

def bne(rs1, rs2, imm):
    return b_type(imm, rs2, rs1, 1)

def blt(rs1, rs2, imm):
    return b_type(imm, rs2, rs1, 4)

def bge(rs1, rs2, imm):
    return b_type(imm, rs2, rs1, 5)

def bltu(rs1, rs2, imm):
    return b_type(imm, rs2, rs1, 6)

def bgeu(rs1, rs2, imm):
    return b_type(imm, rs2, rs1, 7)

def ecall():
    return 0x73

def nop():
    return addi("zero", "zero", 0)


def li(rd, value):
    """Load 32-bit immediate (1-2 instructions)."""
    value &= 0xFFFFFFFF
    lo = value & 0xFFF
    if lo >= 0x800:
        lo -= 0x1000
    hi = ((value - lo) >> 12) & 0xFFFFF
    out = []
    if hi:
        out.append(lui(rd, hi))
        if lo:
            out.append(addi(rd, rd, lo))
    else:
        out.append(addi(rd, "zero", lo))
    return out


def halt(code_reg_or_imm=0):
    """a7=0; ecall."""
    out = []
    if isinstance(code_reg_or_imm, int):
        out += li("a0", code_reg_or_imm)
    elif code_reg_or_imm != "a0":
        out.append(add("a0", code_reg_or_imm, "zero"))
    out += li("a7", 0)
    out.append(ecall())
    return out


def reveal(reg, idx=0):
    """Reveal reg as public-value word idx: a0=reg; a1=idx; a7=2; ecall."""
    out = []
    if reg != "a0":
        out.append(add("a0", reg, "zero"))
    out += li("a1", idx)
    out += li("a7", 2)
    out.append(ecall())
    return out


def hint_read(rd="a0"):
    """Read the next hint-stream word into rd: a7=1; ecall; mv rd, a0."""
    out = li("a7", 1)
    out.append(ecall())
    if rd != "a0":
        out.append(add(rd, "a0", "zero"))
    return out


def keccak256(ptr: int, length: int, out_ptr: int):
    """keccak256(mem[ptr..ptr+length)) -> mem[out_ptr..out_ptr+32):
    a0=ptr; a1=len; a2=out; a7=3; ecall. Buffers must be word-aligned."""
    out = []
    out += li("a0", ptr)
    out += li("a1", length)
    out += li("a2", out_ptr)
    out += li("a7", 3)
    out.append(ecall())
    return out


def sha256(ptr: int, length: int, out_ptr: int):
    """sha256(mem[ptr..ptr+length)) -> mem[out_ptr..out_ptr+32):
    a0=ptr; a1=len; a2=out; a7=6; ecall. Buffers must be word-aligned."""
    out = []
    out += li("a0", ptr)
    out += li("a1", length)
    out += li("a2", out_ptr)
    out += li("a7", 6)
    out.append(ecall())
    return out


FP2_MUL, FP2_ADD, FP2_SUB = 0, 1, 2


def fp2op(rd_ptr: int, x_ptr: int, y_ptr: int, op: int, modulus_idx: int):
    """mem[rd_ptr..+64) = mem[x_ptr..+64) (op) mem[y_ptr..+64) over
    Fp[u]/(u^2+1): a0=rd; a1=x; a2=y; a3=op*16+idx; a7=9; ecall.
    Elements are c0||c1, two 256-bit LE coordinates, word-aligned."""
    out = []
    out += li("a0", rd_ptr)
    out += li("a1", x_ptr)
    out += li("a2", y_ptr)
    out += li("a3", op * 16 + modulus_idx)
    out += li("a7", 9)
    out.append(ecall())
    return out


def defer_verify(ptr: int):
    """Defer verification of a child proof: mem[ptr..ptr+64) holds
    keccak(child vk) (32 bytes) || child pi-hash (32 bytes). a0=ptr;
    a7=8; ecall. The parent proof binds the ordered digest of all
    deferred pairs (DeferralVmAir public values); the host attaches a
    discharge proof (reference analog: verify_stark::<0>,
    crates/types/circuit/src/lib.rs:147-153)."""
    out = []
    out += li("a0", ptr)
    out += li("a7", 8)
    out.append(ecall())
    return out


MODOP_MUL, MODOP_ADD, MODOP_SUB, MODOP_DIV = 0, 1, 2, 3


def modop(rd_ptr: int, x_ptr: int, y_ptr: int, op: int, modulus_idx: int):
    """mem[rd_ptr..+32) = mem[x_ptr..+32) (op) mem[y_ptr..+32) mod M[idx]:
    a0=rd; a1=x; a2=y; a3=op*16+idx; a7=4; ecall. 256-bit LE operands,
    word-aligned. Moduli: BigIntModMulAir.SUPPORTED_MODULI order."""
    out = []
    out += li("a0", rd_ptr)
    out += li("a1", x_ptr)
    out += li("a2", y_ptr)
    out += li("a3", op * 16 + modulus_idx)
    out += li("a7", 4)
    out.append(ecall())
    return out


def ec_add(rd_ptr: int, p_ptr: int, q_ptr: int, modulus_idx: int):
    """mem[rd_ptr..+64) = affine P+Q (x||y, 256-bit LE coords each):
    a0=rd; a1=P; a2=Q; a3=base-field modulus idx; a7=5; ecall.
    Distinct-x adds only (x1 == x2 traps — EcAddAir soundness domain)."""
    out = []
    out += li("a0", rd_ptr)
    out += li("a1", p_ptr)
    out += li("a2", q_ptr)
    out += li("a3", modulus_idx)
    out += li("a7", 5)
    out.append(ecall())
    return out


def ec_double(rd_ptr: int, p_ptr: int, modulus_idx: int):
    """mem[rd_ptr..+64) = affine 2*P (a = 0 tangent law):
    a0=rd; a1=P; a2=0; a3=base-field modulus idx; a7=7; ecall.
    P-256 (idx 4) rejected (a != 0); y == 0 traps."""
    out = []
    out += li("a0", rd_ptr)
    out += li("a1", p_ptr)
    out += li("a2", 0)
    out += li("a3", modulus_idx)
    out += li("a7", 7)
    out.append(ecall())
    return out


def assemble(items: List, base: int = 0) -> List[int]:
    """Two-pass assembly: items are ints (words), lists of ints, or
    ('label', name) / ('branch', fn, rs1, rs2, name) / ('jal', rd, name)."""
    # pass 1: layout
    pos = base
    labels: Dict[str, int] = {}
    flat = []
    for it in items:
        if isinstance(it, tuple) and it[0] == "label":
            labels[it[1]] = pos
            continue
        if isinstance(it, list):
            flat.extend(("w", w) for w in it)
            pos += 4 * len(it)
        elif isinstance(it, int):
            flat.append(("w", it))
            pos += 4
        else:
            flat.append(it)  # deferred branch/jal
            pos += 4
    # pass 2: resolve
    out = []
    pos = base
    for it in flat:
        if it[0] == "w":
            out.append(it[1])
        elif it[0] == "branch":
            _, fn, rs1, rs2, name = it
            out.append(fn(rs1, rs2, labels[name] - pos))
        elif it[0] == "jal":
            _, rd, name = it
            out.append(jal(rd, labels[name] - pos))
        else:
            raise ValueError(it)
        pos += 4
    return out
