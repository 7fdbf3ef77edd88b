"""Protocol versioning: (domain, stf_version) -> (fork, codec) with a packed
version byte (parity with reference crates/types/base/src/version.rs:29-219).

version byte layout: bits 0..=1 domain, bits 2..=7 stf_version
(domain << 6 | stf_version).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from .fork_name import ForkName

N_BITS_STF_VERSION = 6
MASK_STF_VERSION = 0b00111111


class Domain(enum.IntEnum):
    SCROLL = 0
    VALIDIUM = 1


class STFVersion(enum.IntEnum):
    V1 = 1
    V6 = 6
    V7 = 7
    V8 = 8
    V9 = 9
    V10 = 10


class Codec(enum.IntEnum):
    V6 = 6
    V7 = 7


@dataclass(frozen=True)
class Version:
    domain: Domain
    stf_version: STFVersion
    fork: ForkName
    codec: Codec

    def as_version_byte(self) -> int:
        return (int(self.domain) << N_BITS_STF_VERSION) + int(self.stf_version)

    @property
    def is_validium(self) -> bool:
        return self.domain == Domain.VALIDIUM

    # -- canonical versions (version.rs:120-186) ---------------------------
    @classmethod
    def euclid_v1(cls):
        return cls(Domain.SCROLL, STFVersion.V6, ForkName.EUCLID_V1, Codec.V6)

    @classmethod
    def euclid_v2(cls):
        return cls(Domain.SCROLL, STFVersion.V7, ForkName.EUCLID_V2, Codec.V7)

    @classmethod
    def feynman(cls):
        return cls(Domain.SCROLL, STFVersion.V8, ForkName.FEYNMAN, Codec.V7)

    @classmethod
    def galileo(cls):
        return cls(Domain.SCROLL, STFVersion.V9, ForkName.GALILEO, Codec.V7)

    @classmethod
    def galileo_v2(cls):
        return cls(Domain.SCROLL, STFVersion.V10, ForkName.GALILEO_V2, Codec.V7)

    @classmethod
    def validium_v1(cls):
        return cls(Domain.VALIDIUM, STFVersion.V1, ForkName.GALILEO_V2, Codec.V7)

    @classmethod
    def default(cls):
        return cls.galileo()  # version.rs:189-193

    @classmethod
    def from_version_byte(cls, value: int) -> "Version":
        domain = Domain(value >> N_BITS_STF_VERSION)
        stf = STFVersion(value & MASK_STF_VERSION)
        table = {
            (Domain.SCROLL, STFVersion.V6): cls.euclid_v1,
            (Domain.SCROLL, STFVersion.V7): cls.euclid_v2,
            (Domain.SCROLL, STFVersion.V8): cls.feynman,
            (Domain.SCROLL, STFVersion.V9): cls.galileo,
            (Domain.SCROLL, STFVersion.V10): cls.galileo_v2,
            (Domain.VALIDIUM, STFVersion.V1): cls.validium_v1,
        }
        try:
            return table[(domain, stf)]()
        except KeyError:
            raise ValueError(f"unsupported version=({domain}, {stf})")

    @classmethod
    def from_fork(cls, fork: ForkName, validium: bool = False) -> "Version":
        if validium:
            return cls.validium_v1()
        return {
            ForkName.EUCLID_V1: cls.euclid_v1,
            ForkName.EUCLID_V2: cls.euclid_v2,
            ForkName.FEYNMAN: cls.feynman,
            ForkName.GALILEO: cls.galileo,
            ForkName.GALILEO_V2: cls.galileo_v2,
        }[fork]()


VALIDIUM_V1 = Version.validium_v1().as_version_byte()
SCROLL_GALILEO = Version.galileo().as_version_byte()
SCROLL_GALILEO_V2 = Version.galileo_v2().as_version_byte()
