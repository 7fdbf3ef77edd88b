"""Kernel K3: exact base-by-extension products over BabyBear.

    out[r, e] = sum_c A[r, c] * B[c, e] * R^-1 mod p        (A @ B)
    out[c, e] = sum_r A[r, c] * B[r, e] * R^-1 mod p        (A^T @ B)

for A base (int32, Montgomery) and B holding k extension elements a row side
by side, (.., 4k) with k in {1, 2}: the sum of the Montgomery products the
reference forms term by term. With k = 2 one read of A serves two opened
points. It serves the out-of-domain openings (`ntt.eval_poly_at_points_ext`,
transposed) and the DEEP combination's column sums (`stark/prover.py`). The
kernel is `csrc/mont_matmul.cu`; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from .. import _build
from ..fields import babybear as bb

# Kernel launches; one transposed call launches two kernels (partial sums
# over chunks of rows, then their sum), so it counts 2.
launches = {"mont_matmul_rows": 0, "mont_matmul_cols": 0}

KS = (1, 2)  # right-hand sides the kernel takes side by side
_PLAIN_ELEMS = 1 << 27  # int64 products materialised per step of the plain version
_COLS_THREADS = 256     # MC_THREADS in csrc/mont_matmul.cu
_COLS_CTAS = 2048       # CTAs the transposed kernel aims for


def mont_matmul_plain(a, b, transpose_a: bool = False):
    """Plain torch: products reduced mod p one by one and summed in int64,
    a slab of columns at a time (a slab's sum stays far below 2^63)."""
    if transpose_a:
        a = a.t()
    acc = None
    step = max(1, _PLAIN_ELEMS // max(1, a.shape[0] * b.shape[1]))
    for c0 in range(0, a.shape[1], step):
        a_c = a[:, c0:c0 + step].to(torch.int64)
        b_c = b[c0:c0 + step].to(torch.int64)
        part = ((a_c[:, :, None] * b_c[None, :, :]) % bb.P).sum(dim=1) % bb.P
        acc = part if acc is None else (acc + part) % bb.P
    if acc is None:
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64, device=a.device)
    return (acc * bb.R_INV % bb.P).to(bb.DTYPE)


def _check(a, b, transpose_a):
    for t in (a, b):
        if not isinstance(t, torch.Tensor) or t.dtype != bb.DTYPE:
            raise TypeError("mont_matmul takes int32 tensors")
    if a.dim() != 2 or b.dim() != 2 or b.shape[1] not in tuple(4 * k for k in KS):
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    k = a.shape[0] if transpose_a else a.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"inner sizes differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError("operands must share one cpu or cuda device")


def cols_chunk_rows(r: int, c: int) -> int:
    """Rows per partial sum of the transposed kernel: about _COLS_CTAS CTAs,
    each thread summing at least 64 rows (fewer partials for the finishing
    sums to add). The kernel takes 32 columns a CTA, or 16 when c <= 16."""
    cp = 32 if c > 16 else 16
    stride = _COLS_THREADS // cp
    chunks = min(-(-_COLS_CTAS // -(-c // cp)), max(1, r // (64 * stride)), 65535)
    return -(-r // chunks)


def mont_matmul(a, b, transpose_a: bool = False):
    """A @ B (A (R, C), B (C, 4k)) or, with transpose_a, A^T @ B
    (A (R, C), B (R, 4k)), k in {1, 2}; Montgomery in and out."""
    _check(a, b, transpose_a)
    if a.device.type == "cpu":
        return mont_matmul_plain(a, b, transpose_a)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mont_matmul needs contiguous tensors")
    if b.data_ptr() % 16:
        raise ValueError("mont_matmul reads B's rows as 16-byte vectors: "
                         "B must be 16-byte aligned")
    r, c = a.shape
    bw = b.shape[1]
    lib = _build.lib()
    stream = _build.stream(a.device)
    shape = (c if transpose_a else r, bw)
    if r == 0 or c == 0:
        return torch.zeros(shape, dtype=bb.DTYPE, device=a.device)  # empty sums
    out = torch.empty(shape, dtype=bb.DTYPE, device=a.device)
    if not transpose_a:
        _build.check(lib.mont_matmul_rows(a.data_ptr(), b.data_ptr(), r, c, bw // 4,
                                          out.data_ptr(), stream), "mont_matmul_rows")
        launches["mont_matmul_rows"] += 1
        return out
    chunk_rows = cols_chunk_rows(r, c)
    partial = torch.empty((-(-r // chunk_rows), c, bw), dtype=bb.DTYPE, device=a.device)
    _build.check(lib.mont_matmul_cols(a.data_ptr(), b.data_ptr(), r, c, bw // 4,
                                      chunk_rows, partial.data_ptr(), out.data_ptr(),
                                      stream), "mont_matmul_cols")
    launches["mont_matmul_cols"] += 2
    return out
