"""Duplex-sponge Fiat-Shamir challenger over BabyBear (Poseidon2 width 16).

The reference's `zkvm_prover_tpu/stark/challenger.py`: observe absorbs field
elements into an input buffer, flushing through the permutation at rate
boundaries; sample duplexes and drains an output buffer. The transcript is
host state (python ints); each duplex is one numpy permutation.
Proof-of-work grinding permutes a batch of candidate nonces at once, through
kernel K2 on the card when given a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import babybear as bb
from ..ops import poseidon2 as p2
from .config import resolve_device

WIDTH = p2.WIDTH
RATE = p2.RATE


class Challenger:
    def __init__(self):
        self.state = [0] * WIDTH            # Montgomery form
        self.input_buffer: list[int] = []   # Montgomery values
        self.output_buffer: list[int] = []

    # -- absorb ----------------------------------------------------------
    def observe(self, value):
        """Observe one Montgomery-form field element."""
        self.output_buffer.clear()
        self.input_buffer.append(int(value))
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_slice(self, values):
        for v in np.asarray(values, dtype=np.uint32).reshape(-1).tolist():
            self.observe(v)

    def observe_canonical_u32(self, value: int):
        self.observe(bb.to_monty_int(int(value) % bb.P))

    # -- squeeze ---------------------------------------------------------
    def _duplex(self):
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        self.state = p2.permute_np(np.array(self.state)[None])[0].tolist()
        self.output_buffer = list(self.state[:RATE])

    def sample(self) -> int:
        """One Montgomery-form field element."""
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def sample_ext(self) -> np.ndarray:
        """One extension element, (4,) Montgomery uint32."""
        return np.array([self.sample() for _ in range(4)], dtype=np.uint32)

    def sample_bits(self, bits: int) -> int:
        v = bb.from_monty_int(self.sample())
        return v & ((1 << bits) - 1)

    # -- proof of work ---------------------------------------------------
    def grind(self, bits: int, device=None, batch: int = None) -> int:
        """Smallest nonce n (canonical) with clone().observe(n).sample_bits
        == 0. Each batch of candidates is one batched permutation on
        `device` (None: the card, raising without one; "cpu" for the host);
        the first hit in nonce order is the answer, whatever the batch
        size."""
        if bits == 0:
            return 0
        device = resolve_device(device)
        if batch is None:
            batch = 1 << (18 if device.type == "cuda" else 14)
        prefix = list(self.input_buffer)
        k = len(prefix)
        base = torch.tensor(self.state, dtype=torch.int64)
        base[:k] = torch.tensor(prefix, dtype=torch.int64)
        base = base.to(device=device, dtype=bb.DTYPE)
        mask = (1 << bits) - 1
        start = 0
        while True:
            stop = min(start + batch, bb.P)
            nonces = torch.arange(start, stop, dtype=torch.int64, device=device)
            states = base.expand(len(nonces), WIDTH).clone()
            states[:, k] = bb.to_monty(nonces)
            out = p2.permute(states)
            # sample() pops from the END of the first RATE outputs
            v = bb.from_monty(out[:, RATE - 1])
            hit = torch.nonzero((v & mask) == 0)
            if hit.numel():
                nonce = start + int(hit[0, 0])
                self.observe_canonical_u32(nonce)
                if self.sample_bits(bits) != 0:
                    raise RuntimeError("grind bookkeeping diverged")
                return nonce
            start = stop

    def check_witness(self, bits: int, nonce: int) -> bool:
        self.observe_canonical_u32(nonce)
        return self.sample_bits(bits) == 0
