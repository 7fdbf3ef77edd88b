"""The prover's device core (the reference's `stark/pipeline.py`).

`make_prover_core` is the transcript-free part of `stark.prover.prove`, the
compute between the Fiat-Shamir interactions, with the challenges given:

    trace -> interpolate -> coset LDE -> Merkle root (trace)
          -> constraint eval folded by alpha -> quotient -> chunk split and
          re-extension -> Merkle root (quotient) -> out-of-domain openings
          -> DEEP combination -> first FRI fold (beta = zeta)

It is a plain function (the reference jits it) over the prover's own stage
functions, so it computes what `prove` computes; kernels K1, K2 and K3 carry
it on the card. It is the oracle the sharded core
(`parallel/pipeline_sharded.py`) is held to bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import babybear as bb
from ..models.air import Air
from . import domain, fri, merkle
from .config import StarkConfig, resolve_device
from .prover import _deep_combine, ood_openings, quotient_chunks, trace_lde_of


def ext_np_of(v) -> np.ndarray:
    """An ext value (tensor or numpy / sequence, Montgomery) as (4,) uint32."""
    if isinstance(v, torch.Tensor):
        return bb.to_numpy(v.reshape(4))
    return np.asarray(v, dtype=np.uint32).reshape(4)


def monty_ints(pvs_m) -> list:
    """Montgomery public values (tensor, numpy or ints) as python ints."""
    if isinstance(pvs_m, torch.Tensor):
        return [int(v) for v in bb.to_numpy(pvs_m.reshape(-1))]
    return [int(v) for v in np.asarray(pvs_m, dtype=np.uint64).reshape(-1)]


def make_prover_core(air: Air, log_n: int, config=None, device=None):
    """The core for a fixed AIR and trace height on `device` (None: the
    card). core(trace_m, pvs_m, alpha, zeta, gamma): trace_m the (n, w)
    Montgomery trace (tensor), pvs_m the Montgomery public values, the
    challenges (4,) ext Montgomery. Returns (trace_root, quotient_root,
    codeword, folded) as tensors on the device."""
    dev = resolve_device(device)
    config = config or StarkConfig()
    log_blowup = config.log_blowup
    g = config.coset_shift % bb.P
    sels = domain.selectors_on_coset(log_n, log_blowup, g, dev)

    def core(trace_m, pvs_m, alpha, zeta, gamma):
        alpha, zeta, gamma = (ext_np_of(v) for v in (alpha, zeta, gamma))
        c_rev, trace_lde = trace_lde_of(torch.as_tensor(trace_m).to(dev), log_blowup, g)
        trace_root = merkle.commit([trace_lde]).root
        chunk_crevs, chunk_lde = quotient_chunks(air, trace_lde, sels, monty_ints(pvs_m),
                                                 alpha, log_n, log_blowup, g)
        q_root = merkle.commit([chunk_lde]).root
        zeta_next, t_at_z, t_at_zn, q_at_z = ood_openings(c_rev, chunk_crevs, zeta, log_n)
        del c_rev, chunk_crevs
        codeword = _deep_combine(trace_lde, chunk_lde, sels["x"], zeta, zeta_next,
                                 t_at_z, t_at_zn, q_at_z, gamma)
        folded = fri.fold_round(codeword, log_n + log_blowup, g, bb.as_tensor(zeta, dev))
        return trace_root, q_root, codeword, folded

    return core
