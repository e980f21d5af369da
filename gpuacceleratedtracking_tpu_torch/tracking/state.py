"""Tracking state and configuration (port of `gpuacceleratedtracking_tpu.tracking.state`).

`TrackConfig` is a frozen dataclass with the JAX fields, less the TPU launch
shapes (``tile_rows``, ``chans_per_step``). `TrackState` and `TrackOutput` are
NamedTuples of tensors with the JAX field names, so a JAX state converts with
`state_from_numpy` / `state_to_numpy`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import device as _device
from ..models.correlator import EPLCorrelator, correlator_sample_shifts
from ..models.system import GNSSSystem
from . import cn0 as cn0_mod
from .loop_filter import LoopFilterState


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Static (hashable) per-channel-bank tracking configuration."""

    code_frequency: float
    code_length: int
    center_frequency: float
    sampling_frequency: float
    num_samples: int                    # samples per integration block
    intermediate_frequency: float = 0.0
    sample_shifts: tuple = (-1, 0, 1)
    pll_bandwidth: float = 18.0
    pll_order: int = 3
    dll_bandwidth: float = 1.0
    dll_order: int = 2
    fll_bandwidth: float = 4.0   # 0 disables the FLL assist
    cn0_window: int = 20
    algorithm: str = "fused_xla"
    # Secondary (overlay) code wipe-off: +/-1 signs, one per integration
    # block, indexed by the channel's ms_elapsed.
    secondary_code: tuple = ()
    # PLL discriminator: "costas" (data-tolerant) or "atan2" (pilot).
    pll_discriminator: str = "costas"
    # Accumulator z-plane dtype of the composite bank kernel: "f32" or
    # "bf16" (the tracking-grade mode; bank algorithms other than
    # pallas_bank_comp / pallas_bank_auto warn and run in f32).
    z_dtype: str = "f32"
    # Coherent post-integration window in blocks (loop closes once per window).
    coherent_blocks: int = 1

    @classmethod
    def for_system(
        cls,
        system: GNSSSystem,
        sampling_frequency: float,
        num_samples: Optional[int] = None,
        num_correlators: int = 3,
        preferred_code_shift: float = 0.5,
        use_secondary: bool = True,
        **kwargs,
    ) -> "TrackConfig":
        if num_samples is None:
            num_samples = round(sampling_frequency * 1e-3)
        shifts = correlator_sample_shifts(
            system, EPLCorrelator(num_correlators), sampling_frequency,
            preferred_code_shift,
        )
        # One overlay sign per primary period, repeated per block, when the
        # period is an integer number of blocks.
        if (
            use_secondary
            and system.secondary_code is not None
            and "secondary_code" not in kwargs
        ):
            period = system.code_length / system.code_frequency
            block = num_samples / sampling_frequency
            m = period / block
            if abs(m - round(m)) < 1e-6 and round(m) >= 1:
                kwargs["secondary_code"] = tuple(
                    float(s)
                    for s in np.repeat(np.asarray(system.secondary_code), round(m))
                )
        return cls(
            code_frequency=system.code_frequency,
            code_length=system.code_length,
            center_frequency=system.center_frequency,
            sampling_frequency=sampling_frequency,
            num_samples=int(num_samples),
            sample_shifts=tuple(int(s) for s in shifts),
            **kwargs,
        )

    @property
    def integration_time(self) -> float:
        return self.num_samples / self.sampling_frequency

    @property
    def prompt_index(self) -> int:
        return (len(self.sample_shifts) - 1) // 2

    @property
    def spacing_chips(self) -> float:
        """Realized early-late spacing in chips (for DLL gain normalization)."""
        return (
            (self.sample_shifts[-1] - self.sample_shifts[0])
            * self.code_frequency
            / self.sampling_frequency
        )


# JAX TrackConfig fields that only shape TPU kernel launches.
_TPU_LAUNCH_FIELDS = ("tile_rows", "chans_per_step")


def config_from_jax_fields(fields: dict) -> TrackConfig:
    """Build a `TrackConfig` from a JAX config's fields
    (``dataclasses.asdict(jax_config)``), dropping the TPU launch fields."""
    names = {f.name for f in dataclasses.fields(TrackConfig)}
    unknown = set(fields) - names - set(_TPU_LAUNCH_FIELDS)
    if unknown:
        raise ValueError(f"unknown TrackConfig fields: {sorted(unknown)}")
    return TrackConfig(**{k: v for k, v in fields.items() if k in names})


class TrackState(NamedTuple):
    """Per-channel dynamic state (leading axes may be batched over channels)."""

    prn: torch.Tensor              # int32, 0-based
    carrier_doppler: torch.Tensor  # Hz
    carrier_phase: torch.Tensor    # rad, in [0, 2 pi)
    code_doppler: torch.Tensor     # chips/s offset from nominal
    code_phase: torch.Tensor       # chips, in [0, code_length)
    pll_filter: LoopFilterState
    dll_filter: LoopFilterState
    cn0: cn0_mod.CN0State
    ms_elapsed: torch.Tensor       # int32
    prev_prompt_re: torch.Tensor   # previous block's prompt (FLL discriminator)
    prev_prompt_im: torch.Tensor
    coh_re: torch.Tensor           # [..., L] running coherent window sums
    coh_im: torch.Tensor


class TrackOutput(NamedTuple):
    """Per-block observables."""

    accum_re: torch.Tensor         # [..., L] (or [..., A, L] multi-antenna)
    accum_im: torch.Tensor
    prompt_re: torch.Tensor
    prompt_im: torch.Tensor
    carrier_doppler: torch.Tensor
    code_doppler: torch.Tensor
    carrier_phase: torch.Tensor
    code_phase: torch.Tensor
    pll_error: torch.Tensor        # cycles
    dll_error: torch.Tensor        # chips
    cn0_dbhz: torch.Tensor


def init_state(
    prn,
    carrier_doppler=0.0,
    carrier_phase=0.0,
    code_phase=0.0,
    cn0_window: int = 20,
    ms_elapsed=0,
    num_taps: int = 3,
    device=_device.DEFAULT,
) -> TrackState:
    """Build an initial state on ``device`` (the card unless the caller asks
    for the CPU); array arguments make a channel bank.

    The PLL velocity integrator is seeded with ``carrier_doppler`` (the
    acquisition handoff), and ``ms_elapsed`` seeds the block counter for
    secondary-code alignment.
    """
    device = _device.resolve(device)
    prn = torch.as_tensor(np.asarray(prn), dtype=torch.int32, device=device)
    batch = prn.shape

    def full(v):
        t = torch.as_tensor(np.asarray(v, np.float32), device=device)
        return t.expand(batch).clone()

    def lf(v=0.0):
        return LoopFilterState(full(v), full(0.0))

    zeros = torch.zeros(batch + (cn0_window,), dtype=torch.float32, device=device)
    return TrackState(
        prn=prn,
        carrier_doppler=full(carrier_doppler),
        carrier_phase=full(carrier_phase),
        code_doppler=full(0.0),
        code_phase=full(code_phase),
        pll_filter=lf(carrier_doppler),
        dll_filter=lf(),
        cn0=cn0_mod.CN0State(zeros, zeros.clone(),
                             torch.zeros(batch, dtype=torch.int32, device=device)),
        ms_elapsed=torch.as_tensor(np.asarray(ms_elapsed), dtype=torch.int32,
                                   device=device).expand(batch).clone(),
        prev_prompt_re=full(0.0),
        prev_prompt_im=full(0.0),
        coh_re=torch.zeros(batch + (num_taps,), dtype=torch.float32, device=device),
        coh_im=torch.zeros(batch + (num_taps,), dtype=torch.float32, device=device),
    )


_NESTED = {"pll_filter": LoopFilterState, "dll_filter": LoopFilterState,
           "cn0": cn0_mod.CN0State}


def state_from_numpy(tree, device=_device.DEFAULT) -> TrackState:
    """A `TrackState` on ``device`` from a tree of numpy arrays with the JAX
    field names (``jax.tree.map(np.asarray, jax_state)``). Dtypes are kept;
    ``device`` defaults to the card."""
    device = _device.resolve(device)

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    fields = {}
    for name in TrackState._fields:
        value = getattr(tree, name)
        if name in _NESTED:
            cls = _NESTED[name]
            value = cls(*(conv(getattr(value, f)) for f in cls._fields))
        else:
            value = conv(value)
        fields[name] = value
    return TrackState(**fields)


def state_to_numpy(state: TrackState) -> TrackState:
    """The same NamedTuple tree with every tensor copied to a numpy array."""

    def conv(x):
        return x.detach().cpu().numpy()

    fields = {}
    for name in TrackState._fields:
        value = getattr(state, name)
        if name in _NESTED:
            value = type(value)(*(conv(v) for v in value))
        else:
            value = conv(value)
        fields[name] = value
    return TrackState(**fields)
