"""Correlator-algorithm registry (port of `gpuacceleratedtracking_tpu.ops.registry`).

Every implementation is a callable with one uniform signature::

    fn(signal_re, signal_im, codes, prn,
       carrier_frequency, sampling_frequency, carrier_phase,
       code_frequency, code_phase,
       sample_shifts, code_length) -> (accum_re, accum_im)

Only what is ported is registered. A name that the JAX package registers but
this package has not ported yet raises `NotImplementedError`.
"""

from __future__ import annotations

from typing import Callable, Dict

from . import correlate

ALGORITHMS: Dict[str, Callable] = {}

# Registered by the JAX package, not ported yet (ROADMAP.md, Queue 2).
NOT_PORTED = {
    "unfused_xla", "pallas_taps", "pallas_fused", "pallas_bank_onehot",
}


def register(name: str, fn: Callable) -> None:
    ALGORITHMS[name] = fn


def get(name: str) -> Callable:
    # The kernel modules register themselves; import them on first use.
    if name not in ALGORITHMS and name.startswith("pallas"):
        from . import bank_comp, epl_kernels  # noqa: F401
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"correlator {name!r} is not ported to the PyTorch package yet "
            "(ROADMAP.md, Queue 2)"
        )
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise KeyError(
            f"Unknown correlator algorithm {name!r}; known: {sorted(ALGORITHMS)}"
        ) from None


def names() -> list[str]:
    from . import bank_comp, epl_kernels  # noqa: F401

    return sorted(ALGORITHMS)


register("fused_xla", correlate.correlate_fused)
register("xla_bank", correlate.correlate_xla_bank)

# Algorithms with the bank signature ([K]-array channel parameters and a
# shared front-end signal).
BANK_ALGORITHMS = {
    "xla_bank", "pallas_bank", "pallas_bank_onehot", "pallas_bank_rows",
    "pallas_bank_comp", "pallas_bank_auto",
}
