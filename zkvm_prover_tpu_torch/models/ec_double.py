"""Short-Weierstrass affine point-doubling chip: the tangent-law
companion to EcAddAir (openvm ecc extension analog). The port's copy of
the reference's `zkvm_prover_tpu/models/ec_double.py`.

One affine DOUBLE per row, P3 = 2*P1 with y1 != 0 (the only affine
doubling exclusion: order-2 points have y = 0 and double to infinity).
The supported curves all have a = 0 (secp256k1, BN254) or the caller's
curve coefficient folds into the witnessed tangent slope via the bus
consumer — this chip implements the a = 0 tangent law

    lambda = 3*x1^2 / (2*y1)
    x3     = lambda^2 - 2*x1
    y3     = lambda*(x1 - x3) - y1

with a = 0 verified for the curves wired through the VM syscall (P-256
has a != 0; its doubling must go through scalar-mul decompositions that
avoid this chip, matching the add-chip's distinct-x contract). All
256-bit arithmetic is DELEGATED to the bigint/modular chip over
MODMUL_BUS; witnessed intermediates ride in at least one bus message
each, so the modular chip's byte checks transfer here by tuple equality:

    1. x1 * x1     == t   (mod m)
    2. t  * 3      == u   (mod m)      u = 3*x1^2
    3. y1 * 2      == v   (mod m)      v = 2*y1
    4. v  * v_inv  == 1   (mod m)      excludes y1 == 0 (soundness)
    5. lam * v     == u   (mod m)      tangent slope
    6. x1 * 2      == s   (mod m)      s = 2*x1
    7. lam * lam   == w   (mod m)
    8. x3 + s      == w   (mod m)      via  x3*1 + s == w
    9. dx2 + x3    == x1  (mod m)      dx2 = x1 - x3
   10. lam * dx2   == z   (mod m)
   11. y3 + y1     == z   (mod m)      via  y3*1 + y1 == z

Consumers request doublings on EC_DBL_BUS: (x1,y1,x3,y3,m) limbs."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .air import Air, AirBuilder
from .bigint_air import MODMUL_BUS, N_LIMBS, _limbs

EC_DBL_BUS = 49

# --- layout: 14 values x 32 limbs ------------------------------------------
IS_REAL = 0
_FIELDS = ["x1", "y1", "x3", "y3", "m",
           "lam", "t", "u", "v", "v_inv", "w", "s", "dx2", "z"]
_OFF = {name: 1 + i * N_LIMBS for i, name in enumerate(_FIELDS)}
NUM_COLS = 1 + len(_FIELDS) * N_LIMBS


class EcDoubleAir(Air):
    width = NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        is_real = b.local(IS_REAL)
        b.assert_bool(is_real)

        L = {name: [b.local(_OFF[name] + i) for i in range(N_LIMBS)]
             for name in _FIELDS}
        zero = [b.constant(0)] * N_LIMBS
        one = [b.constant(1)] + [b.constant(0)] * (N_LIMBS - 1)
        two = [b.constant(2)] + [b.constant(0)] * (N_LIMBS - 1)
        three = [b.constant(3)] + [b.constant(0)] * (N_LIMBS - 1)

        def req(a, bv, c, r):
            """send (a*b + c == r mod m) to the modular chip"""
            b.push_send(MODMUL_BUS, a + bv + c + r + L["m"], is_real)

        req(L["x1"], L["x1"], zero, L["t"])          # 1
        req(L["t"], three, zero, L["u"])             # 2
        req(L["y1"], two, zero, L["v"])              # 3
        req(L["v"], L["v_inv"], zero, one)           # 4
        req(L["lam"], L["v"], zero, L["u"])          # 5
        req(L["x1"], two, zero, L["s"])              # 6
        req(L["lam"], L["lam"], zero, L["w"])        # 7
        req(L["x3"], one, L["s"], L["w"])            # 8
        req(L["dx2"], one, L["x3"], L["x1"])         # 9
        req(L["lam"], L["dx2"], zero, L["z"])        # 10
        req(L["y3"], one, L["y1"], L["z"])           # 11

        msg = L["x1"] + L["y1"] + L["x3"] + L["y3"] + L["m"]
        b.push_receive(EC_DBL_BUS, msg, is_real)

    # -- trace ---------------------------------------------------------------
    @staticmethod
    def generate_trace(doubles: Sequence[Tuple], n_rows: int = 0
                       ) -> Tuple[np.ndarray, List[Tuple]]:
        """doubles: list of ((x1, y1), m). Returns (trace,
        modular_requests) — the (a,b,c,m) tuples the modular chip must
        serve for bus balance."""
        n = max(4, n_rows or (1 << max(2, (len(doubles) - 1).bit_length())))
        trace = np.zeros((n, NUM_COLS), dtype=np.uint32)
        requests: List[Tuple] = []
        for row, ((x1, y1), m) in enumerate(doubles):
            assert y1 % m != 0, "doubling an order-2 point (y == 0)"
            t = x1 * x1 % m
            u = 3 * t % m
            v = 2 * y1 % m
            v_inv = pow(v, -1, m)
            lam = u * v_inv % m
            s = 2 * x1 % m
            w = lam * lam % m
            x3 = (w - s) % m
            dx2 = (x1 - x3) % m
            z = lam * dx2 % m
            y3 = (z - y1) % m
            vals = {"x1": x1, "y1": y1, "x3": x3, "y3": y3, "m": m,
                    "lam": lam, "t": t, "u": u, "v": v, "v_inv": v_inv,
                    "w": w, "s": s, "dx2": dx2, "z": z}
            tr = trace[row]
            tr[IS_REAL] = 1
            for name, val in vals.items():
                tr[_OFF[name] : _OFF[name] + N_LIMBS] = _limbs(val)
            requests += [
                (x1, x1, 0, m),
                (t, 3, 0, m),
                (y1, 2, 0, m),
                (v, v_inv, 0, m),
                (lam, v, 0, m),
                (x1, 2, 0, m),
                (lam, lam, 0, m),
                (x3, 1, s, m),
                (dx2, 1, x3, m),
                (lam, dx2, 0, m),
                (y3, 1, y1, m),
            ]
        return trace, requests


def ec_double_message(p1, m: int) -> List[int]:
    """EC_DBL_BUS request limbs for P3 = 2*P1 (a = 0 tangent law)."""
    x1, y1 = p1
    lam = 3 * x1 * x1 * pow(2 * y1, -1, m) % m
    x3 = (lam * lam - 2 * x1) % m
    y3 = (lam * (x1 - x3) - y1) % m
    out: List[int] = []
    for v in (x1, y1, x3, y3, m):
        out.extend(int(x) for x in _limbs(v))
    return out
