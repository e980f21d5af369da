"""GNSS system descriptors (port of `gpuacceleratedtracking_tpu.models.system`).

A system is a frozen descriptor holding the host-side numpy code table and the
scalar constants. Callers move the table to a device with
``torch.as_tensor(system.codes, device=...)``. GPS L1 C/A and GPS L5 are
registered so far; the other families follow the JAX package's registry in
later slices.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import gpsl1, gpsl5


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


# Name -> constructor registry.
GNSS_REGISTRY = {
    "GPSL1": GPSL1,
    "GPSL5": GPSL5,
}


def get_system(name: str) -> GNSSSystem:
    try:
        return GNSS_REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"Unknown GNSS system {name!r}; known: {sorted(GNSS_REGISTRY)}"
        ) from None
