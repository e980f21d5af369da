"""GNSS system descriptors (port of `gpuacceleratedtracking_tpu.models.system`).

A system is a frozen descriptor holding the host-side numpy code table and the
scalar constants. Callers move the table to a device with
``torch.as_tensor(system.codes, device=...)``. The registry holds the JAX
package's six names: GPS L1 C/A, GPS L5, GLONASS L1OF, Galileo E1-B/E1-C and
BeiDou B1I.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import beidou_b1i, galileo_e1, glonass_l1, gpsl1, gpsl5


@dataclasses.dataclass(frozen=True)
class GNSSSystem:
    """Immutable GNSS signal description.

    Attributes:
      name: registry name, e.g. ``"GPSL1"``.
      codes: ``[code_length, num_prns]`` float32 matrix of +/-1 chips.
      code_frequency: chipping rate in chips/s.
      center_frequency: nominal carrier in Hz.
      code_length: chips per primary code period.
      codes_per_ms: primary code periods per millisecond (1 for L1 C/A and L5).
      secondary_code: optional +/-1 overlay, one sign per primary period.
    """

    name: str
    codes: np.ndarray
    code_frequency: float
    center_frequency: float
    code_length: int
    codes_per_ms: int = 1
    secondary_code: np.ndarray | None = None

    @property
    def num_prns(self) -> int:
        return self.codes.shape[1]

    def code_period(self) -> float:
        return self.code_length / self.code_frequency


@functools.lru_cache(maxsize=None)
def GPSL1() -> GNSSSystem:
    return GNSSSystem(
        name="GPSL1",
        codes=gpsl1.code_table(),
        code_frequency=gpsl1.CODE_FREQUENCY,
        center_frequency=gpsl1.CENTER_FREQUENCY,
        code_length=gpsl1.CODE_LENGTH,
    )


@functools.lru_cache(maxsize=None)
def GPSL5(quadrature: bool = False, with_secondary: bool = True) -> GNSSSystem:
    """GPS L5: I5 (data, NH10 overlay) or, with ``quadrature``, Q5 (pilot, NH20)."""
    return GNSSSystem(
        name="GPSL5",
        codes=gpsl5.code_table(quadrature),
        code_frequency=gpsl5.CODE_FREQUENCY,
        center_frequency=gpsl5.CENTER_FREQUENCY,
        code_length=gpsl5.CODE_LENGTH,
        secondary_code=gpsl5.neuman_hofman(quadrature) if with_secondary else None,
    )


@functools.lru_cache(maxsize=None)
def GLONASSL1() -> GNSSSystem:
    """GLONASS L1OF: FDMA, one shared 511-chip m-sequence, 1 ms period.

    The ``prn`` column index is the FDMA frequency-channel slot (``k + 7`` for
    channel ``k``); `glonass_l1.carrier_frequency(k)` gives its carrier. The
    columns are identical: satellites are separated in frequency.
    """
    return GNSSSystem(
        name="GLONASSL1",
        codes=glonass_l1.code_table(),
        code_frequency=glonass_l1.CODE_FREQUENCY,
        center_frequency=glonass_l1.CENTER_FREQUENCY,
        code_length=glonass_l1.CODE_LENGTH,
    )


@functools.lru_cache(maxsize=None)
def GalileoE1(pilot: bool = False, with_secondary: bool = True) -> GNSSSystem:
    """Galileo E1 OS, BOC(1,1) folded into the code table: 8184 half-chips at
    2.046 Mcps, a 4 ms primary period, phases in half-chips.

    ``pilot=True`` is E1-C (dataless, CS25 overlay; track it with the atan2
    PLL discriminator), else E1-B (data). The primary codes are stand-ins for
    the ICD memory tables (see `models.galileo_e1`).
    """
    return GNSSSystem(
        name="GALILEOE1C" if pilot else "GALILEOE1B",
        codes=galileo_e1.code_table(pilot),
        code_frequency=galileo_e1.CODE_FREQUENCY,
        center_frequency=galileo_e1.CENTER_FREQUENCY,
        code_length=galileo_e1.CODE_LENGTH,
        secondary_code=(
            galileo_e1.secondary_code() if pilot and with_secondary else None
        ),
    )


@functools.lru_cache(maxsize=None)
def BeiDouB1I(with_secondary: bool = True) -> GNSSSystem:
    """BeiDou B1I: 2046-chip register-generated codes, 1 ms period.

    D1 satellites (PRN >= 6) carry the NH20 overlay; ``with_secondary=False``
    for the GEO (D2, PRN 1..5) satellites, which have none.
    """
    return GNSSSystem(
        name="BEIDOUB1I",
        codes=beidou_b1i.code_table(),
        code_frequency=beidou_b1i.CODE_FREQUENCY,
        center_frequency=beidou_b1i.CENTER_FREQUENCY,
        code_length=beidou_b1i.CODE_LENGTH,
        secondary_code=beidou_b1i.secondary_code() if with_secondary else None,
    )


# Name -> constructor registry.
GNSS_REGISTRY = {
    "GPSL1": GPSL1,
    "GPSL5": GPSL5,
    "GLONASSL1": GLONASSL1,
    "GALILEOE1B": GalileoE1,
    "GALILEOE1C": functools.partial(GalileoE1, pilot=True),
    "BEIDOUB1I": BeiDouB1I,
}


def get_system(name: str) -> GNSSSystem:
    try:
        return GNSS_REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"Unknown GNSS system {name!r}; known: {sorted(GNSS_REGISTRY)}"
        ) from None
