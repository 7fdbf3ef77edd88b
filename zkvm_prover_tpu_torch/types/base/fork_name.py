"""Hardfork names (parity with reference crates/types/base/src/fork_name.rs)."""

from __future__ import annotations

import enum


class ForkName(enum.Enum):
    EUCLID_V1 = "euclidv1"
    EUCLID_V2 = "euclidv2"
    FEYNMAN = "feynman"
    GALILEO = "galileo"
    GALILEO_V2 = "galileov2"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_str(cls, s: str | None) -> "ForkName":
        if s is None:
            return cls.EUCLID_V1  # reference default (fork_name.rs:16-23)
        for f in cls:
            if f.value == s:
                return f
        raise ValueError(f"hardfork not accepted: {s}")
