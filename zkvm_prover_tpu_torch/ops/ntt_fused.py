"""Kernel K1: the NTT butterfly stages over an (n, W) int32 matrix.

The counterpart of the reference's Pallas kernel
(`zkvm_prover_tpu/ops/ntt_pallas.py`, `fused_final_stages` and `dif_fused`),
re-thought for Hopper in `csrc/ntt.cu`:

- `ntt_pass` runs any L <= K_MAX consecutive stages in one pass over the
  matrix, with optional per-row multipliers at its load (`pre`) and its
  store (`post`); its input and output may be row-strided views.
- `block_stages` is the pass of the lowest k stages (the Pallas kernel's
  block-local stages).
- `dif` / `dit` chain ceil(log_n / k) passes into a whole transform (two at
  log_n = 18), the multipliers riding on its first load and last store.

Each wrapper has its plain torch version beside it. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. `launches`
counts kernel launches; `transforms` counts the whole transforms run on the
card, so a caller can check the passes each one took.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..fields import babybear as bb

K_MAX = 10  # 2^10 rows x 32 words = 128 KB of shared memory per tile

launches = {"ntt_pass": 0}
transforms = {"dif": 0, "dit": 0}


@functools.lru_cache(maxsize=None)
def stage_twiddles_np(log_n: int, inverse: bool) -> np.ndarray:
    """Per-stage twiddle tables, concatenated: the stage with half-size h
    starts at offset h - 1 and holds w_{2h}^j (Montgomery), j < h. Every
    stage table is the top stage's table taken with a stride, since
    w_{2h} = w_n^(n / 2h)."""
    if log_n == 0:
        return np.zeros(0, dtype=np.uint32)
    w = bb.two_adic_generator_int(log_n)
    if inverse:
        w = pow(w, bb.P - 2, bb.P)
    top = bb.to_monty_np(bb.powers_np(w, 1 << (log_n - 1)))
    return np.concatenate([top[:: 1 << (log_n - s)] for s in range(1, log_n + 1)])


_TW_CACHE = {}


def stage_twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    key = (log_n, inverse, str(device))
    if key not in _TW_CACHE:
        _TW_CACHE[key] = bb.as_tensor(stage_twiddles_np(log_n, inverse), device)
    return _TW_CACHE[key]


def _log2(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"row count {n} is not a power of two")
    return n.bit_length() - 1


def _check(x: torch.Tensor, what: str = "input") -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != bb.DTYPE or x.dim() != 2:
        raise TypeError(f"{what}: expected a 2-D int32 tensor")
    _log2(x.shape[0])
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _butterflies(x, s: int, tw, dit: bool):
    """Plain torch: one radix-2 stage with half-size 2^(s-1) down axis 0."""
    n, w = x.shape
    h = 1 << (s - 1)
    t = tw[h - 1 : 2 * h - 1].reshape(1, h, 1)
    v = x.reshape(n // (2 * h), 2, h, w)
    lo, hi = v[:, 0], v[:, 1]
    if dit:
        hi = bb.mul(hi, t)
        return torch.stack([bb.add(lo, hi), bb.sub(lo, hi)], dim=1).reshape(n, w)
    return torch.stack([bb.add(lo, hi), bb.mul(bb.sub(lo, hi), t)],
                       dim=1).reshape(n, w)


def ntt_pass_plain(x, a: int, L: int, inverse: bool = False, dit: bool = False,
                   pre=None, post=None):
    """Plain torch: `pre` per row, the stages with half-sizes
    2^a .. 2^(a+L-1) (DIF top down, DIT bottom up), then `post` per row."""
    tw = stage_twiddles(_log2(x.shape[0]), inverse, x.device)
    if pre is not None:
        x = bb.mul(x, pre.reshape(-1, 1))
    stages = range(a + 1, a + L + 1) if dit else range(a + L, a, -1)
    for s in stages:
        x = _butterflies(x, s, tw, dit)
    if post is not None:
        x = bb.mul(x, post.reshape(-1, 1))
    return x


def _row_pitch(t: torch.Tensor, what: str) -> int:
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{what}: rows must be contiguous (stride(1) == 1)")
    return max(t.stride(0), t.shape[1])


def ntt_pass(x, a: int, L: int, inverse: bool = False, dit: bool = False,
             pre=None, post=None, out=None):
    """The stages with half-sizes 2^a .. 2^(a+L-1) of the transform down
    axis 0 of x, in one pass: `pre` (n,) multiplies input row i at the load,
    `post` (n,) output row i at the store (Montgomery). x and out may be
    views whose rows are contiguous at any pitch; out may be x (in place).
    Returns out (a new tensor if None)."""
    _check(x)
    n, w = x.shape
    if not 1 <= L <= K_MAX or a < 0 or a + L > _log2(n):
        raise ValueError(f"stages 2^{a}..2^{a + L - 1} out of range for {n} rows")
    for t, what in ((pre, "pre"), (post, "post")):
        if t is not None and (t.dtype != bb.DTYPE or t.numel() != n
                              or t.device != x.device):
            raise ValueError(f"{what}: expected ({n},) int32 on {x.device}")
    if out is not None:
        _check(out, "out")
        if out.shape != x.shape or out.device != x.device:
            raise ValueError("out must match x in shape and device")
    if x.device.type == "cpu":
        res = ntt_pass_plain(x, a, L, inverse, dit, pre, post)
        if out is None:
            return res
        out.copy_(res)
        return out
    ld_x = _row_pitch(x, "x")
    out = torch.empty_like(x, memory_format=torch.contiguous_format) \
        if out is None else out
    ld_y = _row_pitch(out, "out")
    if w == 0:
        return out
    pre = None if pre is None else pre.contiguous()
    post = None if post is None else post.contiguous()
    tw = stage_twiddles(_log2(n), inverse, x.device)
    _build.check(_build.lib().ntt_pass(
        x.data_ptr(), ld_x, out.data_ptr(), ld_y, n, w, a, L, int(dit),
        tw.data_ptr(), None if pre is None else pre.data_ptr(),
        None if post is None else post.data_ptr(),
        _build.stream(x.device)), "ntt_pass")
    launches["ntt_pass"] += 1
    return out


def block_stages(x, k: int, inverse: bool = False, dit: bool = False,
                 out=None):
    """Stages k..1 (DIF) or 1..k (DIT) inside each 2^k-row block of x: the
    pass with a = 0."""
    return ntt_pass(x, 0, k, inverse, dit, out=out)


def dif_plain(x, log_n: int, inverse: bool):
    """Plain torch: all DIF stages log_n..1."""
    tw = stage_twiddles(log_n, inverse, x.device)
    for s in range(log_n, 0, -1):
        x = _butterflies(x, s, tw, False)
    return x


def dit_plain(x, log_n: int, inverse: bool):
    """Plain torch: all DIT stages 1..log_n."""
    tw = stage_twiddles(log_n, inverse, x.device)
    for s in range(1, log_n + 1):
        x = _butterflies(x, s, tw, True)
    return x


def pass_sizes(log_n: int, k: int = None) -> list:
    """Stages per pass of a whole transform: ceil(log_n / k) passes (k:
    K_MAX if None), their sizes as even as can be (9 + 9 at log_n = 18)."""
    k = K_MAX if k is None else k
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k={k} out of range 1..{K_MAX}")
    passes = -(-log_n // k)
    return [log_n // passes + (i < log_n % passes) for i in range(passes)]


def _transform(x, log_n: int, inverse: bool, k: int, dit: bool, pre, post, out):
    _check(x)
    if x.shape[0] != 1 << log_n:
        raise ValueError(f"{x.shape[0]} rows for log_n={log_n}")
    if log_n == 0 or x.shape[1] == 0:  # no butterflies: only the multipliers
        y = x.clone()
        for t in (pre, post):
            if t is not None:
                y = bb.mul(y, t.reshape(-1, 1))
        if out is None:
            return y
        out.copy_(y)
        return out
    sizes = pass_sizes(log_n, k)
    if x.device.type == "cuda":
        transforms["dit" if dit else "dif"] += 1
    a = 0 if dit else log_n
    y = out
    for p, L in enumerate(sizes):
        if not dit:
            a -= L
        y = ntt_pass(x if p == 0 else y, a, L, inverse, dit,
                     pre=pre if p == 0 else None,
                     post=post if p == len(sizes) - 1 else None, out=y)
        if dit:
            a += L
    return y


def dif(x, log_n: int, inverse: bool, k: int = None, pre=None, post=None,
        out=None):
    """Natural -> bit-reversed butterflies (the reference's `_dif`): the
    stages from the top down, at most k per pass (K_MAX if None). `pre` /
    `post` multiply input / output rows at the first load / last store; out
    may be a row-strided view."""
    return _transform(x, log_n, inverse, k, False, pre, post, out)


def dit(x, log_n: int, inverse: bool, k: int = None, pre=None, post=None,
        out=None):
    """Bit-reversed -> natural butterflies (the reference's `_dit`): the
    stages from the bottom up, at most k per pass (see `dif`)."""
    return _transform(x, log_n, inverse, k, True, pre, post, out)
