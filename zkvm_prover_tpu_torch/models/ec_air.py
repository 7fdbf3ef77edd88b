"""Short-Weierstrass affine point-addition chip: the openvm ecc extension
analog (`ecc.supported_curves`: secp256k1, P-256, BN254 G1). The port's
copy of the reference's `zkvm_prover_tpu/models/ec_air.py`.

One affine ADD per row, P3 = P1 + P2 with x1 != x2 (distinct-x adds —
the curve coefficients cancel out of the chord formula, so one chip
serves every supported curve; doubling needs the tangent formula and is
a follow-up chip). All 256-bit arithmetic is DELEGATED to the
bigint/modular chip over MODMUL_BUS: this chip witnesses the
intermediates (lambda, differences, sums) as 32x8-bit-limb columns and
emits one modular-arithmetic request per relation:

    1. dx + x1       == x2   (mod m)      dx = x2 - x1
    2. dx * dx_inv   == 1    (mod m)      excludes x1 == x2 (soundness:
                                          doubling/invalid pairs cannot
                                          satisfy an invertible dx)
    3. dy + y1       == y2   (mod m)
    4. lambda * dx   == dy   (mod m)
    5. s  = x1 + x2  (mod m)   via  x1*1 + x2 == s
    6. lambda^2      == t    (mod m),  t = x3 + s  via  x3*1 + s == t
    7. dx2 + x3      == x1   (mod m)      dx2 = x1 - x3
    8. lambda * dx2  == u    (mod m),  u = y3 + y1 via  y3*1 + y1 == u

Every witnessed value rides in at least one bus message, and the modular
chip byte-range-checks all its received operands — so this chip needs no
range checks of its own (bus tuple equality transfers them).

Consumers request adds on EC_ADD_BUS: (x1,y1,x2,y2,x3,y3,m) limbs."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .air import Air, AirBuilder
from .bigint_air import MODMUL_BUS, N_LIMBS, _limbs

EC_ADD_BUS = 45

# --- layout: 15 values x 32 limbs ------------------------------------------
IS_REAL = 0
_FIELDS = ["x1", "y1", "x2", "y2", "x3", "y3", "m",
           "lam", "dx", "dx_inv", "dy", "s", "t", "dx2", "u"]
_OFF = {name: 1 + i * N_LIMBS for i, name in enumerate(_FIELDS)}
NUM_COLS = 1 + len(_FIELDS) * N_LIMBS


class EcAddAir(Air):
    width = NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        is_real = b.local(IS_REAL)
        b.assert_bool(is_real)

        L = {name: [b.local(_OFF[name] + i) for i in range(N_LIMBS)]
             for name in _FIELDS}
        zero = [b.constant(0)] * N_LIMBS
        one = [b.constant(1)] + [b.constant(0)] * (N_LIMBS - 1)

        def req(a, bv, c, r):
            """send (a*b + c == r mod m) to the modular chip"""
            b.push_send(MODMUL_BUS, a + bv + c + r + L["m"], is_real)

        req(L["dx"], one, L["x1"], L["x2"])          # 1
        req(L["dx"], L["dx_inv"], zero, one)         # 2
        req(L["dy"], one, L["y1"], L["y2"])          # 3
        req(L["lam"], L["dx"], zero, L["dy"])        # 4
        req(L["x1"], one, L["x2"], L["s"])           # 5
        req(L["lam"], L["lam"], zero, L["t"])        # 6a
        req(L["x3"], one, L["s"], L["t"])            # 6b
        req(L["dx2"], one, L["x3"], L["x1"])         # 7
        req(L["lam"], L["dx2"], zero, L["u"])        # 8a
        req(L["y3"], one, L["y1"], L["u"])           # 8b

        msg = (L["x1"] + L["y1"] + L["x2"] + L["y2"]
               + L["x3"] + L["y3"] + L["m"])
        b.push_receive(EC_ADD_BUS, msg, is_real)

    # -- trace ---------------------------------------------------------------
    @staticmethod
    def generate_trace(adds: Sequence[Tuple], n_rows: int = 0
                       ) -> Tuple[np.ndarray, List[Tuple]]:
        """adds: list of ((x1,y1), (x2,y2), m). Returns (trace,
        modular_requests) — the (a,b,c,m) tuples the modular chip must
        serve for bus balance."""
        n = max(4, n_rows or (1 << max(2, (len(adds) - 1).bit_length())))
        trace = np.zeros((n, NUM_COLS), dtype=np.uint32)
        requests: List[Tuple] = []
        for row, ((x1, y1), (x2, y2), m) in enumerate(adds):
            assert x1 != x2 % m, "distinct-x adds only (no doubling)"
            dx = (x2 - x1) % m
            dx_inv = pow(dx, -1, m)
            dy = (y2 - y1) % m
            lam = dy * dx_inv % m
            s = (x1 + x2) % m
            t = lam * lam % m
            x3 = (t - s) % m
            dx2 = (x1 - x3) % m
            u = lam * dx2 % m
            y3 = (u - y1) % m
            vals = {
                "x1": x1, "y1": y1, "x2": x2, "y2": y2,
                "x3": x3, "y3": y3, "m": m, "lam": lam, "dx": dx,
                "dx_inv": dx_inv, "dy": dy, "s": s, "t": t,
                "dx2": dx2, "u": u,
            }
            tr = trace[row]
            tr[IS_REAL] = 1
            for name, v in vals.items():
                tr[_OFF[name] : _OFF[name] + N_LIMBS] = _limbs(v)
            requests += [
                (dx, 1, x1, m),
                (dx, dx_inv, 0, m),
                (dy, 1, y1, m),
                (lam, dx, 0, m),
                (x1, 1, x2, m),
                (lam, lam, 0, m),
                (x3, 1, s, m),
                (dx2, 1, x3, m),
                (lam, dx2, 0, m),
                (y3, 1, y1, m),
            ]
        return trace, requests


def ec_add_message(p1, p2, m: int) -> List[int]:
    """EC_ADD_BUS request limbs for P3 = P1 + P2."""
    (x1, y1), (x2, y2) = p1, p2
    dx = (x2 - x1) % m
    lam = (y2 - y1) * pow(dx, -1, m) % m
    x3 = (lam * lam - x1 - x2) % m
    y3 = (lam * (x1 - x3) - y1) % m
    out: List[int] = []
    for v in (x1, y1, x2, y2, x3, y3, m):
        out.extend(int(x) for x in _limbs(v))
    return out
