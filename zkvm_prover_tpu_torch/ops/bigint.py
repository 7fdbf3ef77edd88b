"""Multi-limb Montgomery arithmetic for BN254 Fq in plain torch: the
reference's `zkvm_prover_tpu/ops/bigint.py` (`Field`), the plain version of
K4's field core (`csrc/bn254.cuh`).

An element is (..., K) int64 with each limb in [0, 2^16), little-endian, in
Montgomery form x * R mod q with R = 2^(16K) = 2^256: the reference's limbs
bit for bit (it keeps them in uint32). The kernel keeps the same residue in
8 limbs of 32 bits (`to_words` / `from_words`).

int64 leaves room: a schoolbook product sums 16 partial products of 32 bits
per cell (< 2^36) in one `index_add_`, and each of the K reduction rounds
adds m * q into the cells before a carry pass. Carries are resolved by
parallel passes until none is left (`_carry`), and comparisons with q by
the sign of sum_i sign(a_i - q_i) 2^i, the top differing limb's sign.
"""

from __future__ import annotations

import numpy as np
import torch

MASK16 = 0xFFFF


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Limbs with signed or oversized values -> limbs in [0, 2^16) (the top
    limb takes what is left), by parallel carry passes."""
    t = t.clone()
    while True:
        c = t[..., :-1] >> 16  # floor division: a negative limb borrows
        if not bool(c.any()):
            return t
        t[..., :-1] &= MASK16
        t[..., 1:] += c


class Field:
    """A multi-limb Montgomery field context (host-precomputed constants)."""

    def __init__(self, modulus: int, n_limbs: int):
        self.q = modulus
        self.K = n_limbs
        assert modulus < 1 << (16 * n_limbs)
        self.R = (1 << (16 * n_limbs)) % modulus
        self.R2 = (self.R * self.R) % modulus
        # -q^{-1} mod 2^16 (per-limb Montgomery factor)
        self.np0 = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        self.q_limbs = np.array([(modulus >> (16 * i)) & MASK16 for i in range(n_limbs)],
                                dtype=np.int64)
        self._consts = {}  # device -> (q limbs, limb weights 2^i, product cell of each limb pair)

    # -- host int <-> limb conversions ------------------------------------
    def to_limbs(self, x: int) -> np.ndarray:
        return np.array([(x >> (16 * i)) & MASK16 for i in range(self.K)], dtype=np.int64)

    def from_limbs(self, limbs) -> int:
        limbs = np.asarray(limbs, dtype=np.int64).reshape(-1)
        return sum(int(v) << (16 * i) for i, v in enumerate(limbs))

    def to_monty_int(self, x: int) -> np.ndarray:
        return self.to_limbs((x % self.q) * self.R % self.q)

    def from_monty(self, limbs) -> int:
        r_inv = pow(self.R, -1, self.q)
        return self.from_limbs(limbs) * r_inv % self.q

    def to_monty(self, xs, device="cpu") -> torch.Tensor:
        """Ints -> (n, K) Montgomery limbs on `device`."""
        return torch.from_numpy(np.stack([self.to_monty_int(int(x)) for x in xs])).to(device)

    def from_monty_batch(self, a: torch.Tensor) -> list:
        """(n, K) Montgomery limbs -> ints."""
        return [self.from_monty(row) for row in a.cpu().numpy()]

    # -- constants on a device --------------------------------------------
    def _on(self, device):
        """(q's K + 1 limbs, the weights 2^i of K + 1 limbs, the product cell
        i + j of each limb pair) on `device`."""
        if device not in self._consts:
            i = torch.arange(self.K)
            self._consts[device] = (
                torch.from_numpy(np.append(self.q_limbs, 0)).to(device),
                (2 ** torch.arange(self.K + 1, dtype=torch.int64)).to(device),
                (i[:, None] + i[None, :]).reshape(-1).to(device))
        return self._consts[device]

    def _less(self, a, b) -> torch.Tensor:
        """a < b for limbs of one width: the sign of the top differing limb,
        that of sum_i sign(a_i - b_i) 2^i."""
        w = self._on(a.device)[1][:a.shape[-1]]
        return (torch.sign(a - b) * w).sum(-1) < 0

    def _cond_sub_q(self, t: torch.Tensor) -> torch.Tensor:
        """(..., K + 1) canonical limbs of a value < 2q -> (..., K) mod q."""
        q = self._on(t.device)[0]
        return torch.where(self._less(t, q)[..., None], t, _carry(t - q))[..., :self.K]

    # -- arithmetic (Montgomery in and out) --------------------------------
    def add(self, a, b):
        """(a + b) mod q."""
        return self._cond_sub_q(_carry(torch.nn.functional.pad(a + b, (0, 1))))

    def sub(self, a, b):
        """(a - b) mod q."""
        q = self._on(a.device)[0]
        d = torch.nn.functional.pad(a - b, (0, 1))
        d = d + torch.where(self._less(a, b)[..., None], q, torch.zeros_like(q))
        return _carry(d)[..., :self.K]

    def neg(self, a):
        """(-a) mod q."""
        return self.sub(torch.zeros_like(a), a)

    def is_zero(self, a):
        return (a == 0).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1)

    def mul(self, a, b):
        """Montgomery product a * b * R^-1 mod q: the schoolbook product in
        2K + 1 cells, K reduction rounds, one carry pass and one
        conditional subtraction."""
        K = self.K
        a, b = torch.broadcast_tensors(a, b)
        lead = a.shape[:-1]
        prod = (a[..., :, None] * b[..., None, :]).reshape(*lead, K * K)
        q, _, cell = self._on(a.device)
        q = q[:K]
        t = torch.zeros(*lead, 2 * K + 1, dtype=torch.int64, device=a.device)
        t.index_add_(-1, cell, prod)
        for i in range(K):
            m = ((t[..., i] & MASK16) * self.np0) & MASK16
            t[..., i:i + K] += m[..., None] * q
            t[..., i + 1] += t[..., i] >> 16  # the low limb is 0 mod 2^16 now
        return self._cond_sub_q(_carry(t[..., K:]))

    def square(self, a):
        return self.mul(a, a)


# BN254 base field context (coordinates)
BN254_FQ = Field(
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
    16,
)


def to_words(a: torch.Tensor) -> torch.Tensor:
    """(..., 16) 16-bit limbs -> (..., 8) 32-bit words (int32 bit patterns),
    the kernel's layout."""
    w = a[..., 0::2] | (a[..., 1::2] << 16)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) 32-bit words (int32 bit patterns) -> (..., 16) 16-bit limbs."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & MASK16, u >> 16], dim=-1).reshape(*w.shape[:-1], 2 * w.shape[-1])
