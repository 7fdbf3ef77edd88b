"""logUp permutation argument: cross-AIR bus interactions.

The reference's `zkvm_prover_tpu/stark/interactions.py` on tensors. Per AIR
with k interactions, the permutation trace has k extension columns
c_j = signed_mult_j / (z - fp_j) and one running-sum column S, each stored
as 4 base columns, with

  fp_j  = bus_j + sum_k beta^(k+1) * field_{j,k}
  sign  = +1 for sends, -1 for receives

Constraints (extension-valued, degree <= main degree + 1):
  c_j * (z - fp_j) - signed_mult_j               (every row)
  first:      S - sum_j c_j
  transition: S_next - S - sum_j c_j_next
  last:       S - claimed_sum

Soundness: the claimed sums of all AIRs add up to 0 (a verifier check).

Two modes. On tensors (the prover: the trace or the LDE domain), values are
Montgomery int32 tensors, (n,) base or (n, 4) extension, and builder
constants are Montgomery python ints. In point mode (the verifier at zeta)
every value is a canonical extension element, 4 python ints, as the port's
`PointBuilder` gives it. The prover's work is plain torch on the tensors'
device: the powers of beta once a pass, one batched extension inverse for
a group of interactions and an exact int64 running sum.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..models.air import Interaction, base_col
from ..utils import ext_np


def beta_powers(beta, n: int) -> List:
    """[beta, beta^2, ..., beta^n] as (4,) tensors, by the fingerprint's
    own product order, so that a prover pass computes them once."""
    out = [beta]
    while len(out) < n:
        out.append(ext4.mul(out[-1], beta))
    return out[:n]


def fingerprint(inter: Interaction, beta, point_mode: bool = False, bpows=None):
    """fp = bus + sum_k beta^(k+1) * field_k, broadcast over rows. On
    tensors each base field scales the power of beta: (n, 4), or (4,) when
    every field is a constant; `bpows` may hold those powers
    (`beta_powers`)."""
    if point_mode:
        acc = ext_np.from_base(inter.bus)
        bpow = beta
        for f in inter.fields:
            acc = ext_np.add(acc, ext_np.mul(bpow, f))
            bpow = ext_np.mul(bpow, beta)
        return acc
    if bpows is None:
        bpows = beta_powers(beta, len(inter.fields))
    acc = ext4.from_ints([inter.bus, 0, 0, 0], beta.device)
    for f, bpow in zip(inter.fields, bpows):
        acc = ext4.add(acc, bb.mul(base_col(f), bpow))
    return acc


def signed_mult(inter: Interaction, point_mode: bool = False):
    """The multiplicity, negated for a receive. On tensors it stays a base
    value ((n,) tensor or Montgomery int; the reference embeds it in the
    extension, coefficient 0); in point mode an extension element."""
    m = inter.mult
    if point_mode:
        return m if inter.is_send else ext_np.sub([0, 0, 0, 0], m)
    if inter.is_send:
        return m
    return bb.neg(m) if isinstance(m, torch.Tensor) else (-int(m)) % bb.P


def _sub_base(e, s):
    """Extension e (.., 4) minus base s (coefficient 0 only)."""
    head = bb.sub(e[..., :1], base_col(s))
    return torch.cat([head, e[..., 1:].expand(head.shape[:-1] + (3,))], dim=-1)


# extension elements a batched inverse takes at a time (its int64
# temporaries stay near those of one interaction at 2^22 rows)
INV_BATCH_ELEMS = 1 << 22


def build_perm_trace(interactions: Sequence[Interaction], z, beta):
    """Prover side: (perm (n, 4k + 4) Montgomery, claimed_sum (4,)).

    interactions carry (n,) field/multiplicity tensors from a TraceBuilder
    pass; z, beta are (4,) tensors on their device. The denominators of
    several interactions invert as one batch (an inverse is elementwise, so
    the batch does not change a value). The running sum is an exact int64
    cumsum, then one reduction: entries are below p and n is at most 2^27,
    so no partial sum reaches 2^63."""
    bpows = beta_powers(beta, max(len(i.fields) for i in interactions))
    dens = torch.broadcast_tensors(
        *[ext4.sub(z, fingerprint(inter, beta, bpows=bpows)) for inter in interactions])
    step = max(1, INV_BATCH_ELEMS // max(1, dens[0][..., 0].numel()))
    cols = []
    for j0 in range(0, len(dens), step):
        inv_d = ext4.inv(torch.stack(dens[j0:j0 + step]))
        # the multiplicity is a base value: a scale, not an extension product
        cols += [bb.mul(d, base_col(signed_mult(inter)))
                 for d, inter in zip(inv_d, interactions[j0:j0 + step])]
    del dens
    cols = torch.broadcast_tensors(*cols)
    total = cols[0]
    for c in cols[1:]:
        total = ext4.add(total, c)
    run_sum = (torch.cumsum(total.to(torch.int64), dim=0) % bb.P).to(bb.DTYPE)
    perm = torch.cat([*cols, run_sum], dim=1)
    return perm, run_sum[-1].clone()


def perm_constraints(
    interactions: Sequence[Interaction],
    perm_local: List,       # k + 1 extension values (the c_j, then S)
    perm_next: List,
    sels,                   # dict with first / last / transition
    z,
    beta,
    claimed_sum,
    point_mode: bool = False,
) -> List:
    """The k + 3 extension constraints, in the reference's order. On
    tensors the selectors are (m,) base tensors and z, beta, claimed_sum
    (4,) tensors; in point mode everything is canonical extension values."""
    k = len(interactions)
    assert len(perm_local) == k + 1
    if point_mode:
        add, sub, mul = ext_np.add, ext_np.sub, ext_np.mul
        sel_mul = ext_np.mul
    else:
        add, sub, mul = ext4.add, ext4.sub, ext4.mul

        def sel_mul(c, s):
            return bb.mul(c, s[:, None])

    out = []
    bpows = None if point_mode or not k else beta_powers(
        beta, max(len(i.fields) for i in interactions))
    for j, inter in enumerate(interactions):
        fp = fingerprint(inter, beta, point_mode, bpows)
        sm = signed_mult(inter, point_mode)
        lhs = mul(perm_local[j], sub(z, fp))
        out.append(sub(lhs, sm) if point_mode else _sub_base(lhs, sm))

    s_local, s_next = perm_local[k], perm_next[k]
    csum, csum_next = perm_local[0], perm_next[0]
    for j in range(1, k):
        csum = add(csum, perm_local[j])
        csum_next = add(csum_next, perm_next[j])
    out.append(sel_mul(sub(s_local, csum), sels["first"]))
    out.append(sel_mul(sub(sub(s_next, s_local), csum_next), sels["transition"]))
    out.append(sel_mul(sub(s_local, claimed_sum), sels["last"]))
    return out
