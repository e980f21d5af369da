"""The bank correlator kernels' wrappers, their plain versions, and bank routing.

Port of `gpuacceleratedtracking_tpu.ops.pallas_epl`'s bank routes:
`correlate_pallas_bank_rows` (the per-row bank kernel's wrapper),
`correlate_pallas_bank` (the transition kernel's wrapper), `bank_algorithm_for`
and `correlate_pallas_bank_auto`. The composite route, `pallas_bank_comp`,
lives in `bank_comp`.

The rows and transition routes compute one contract and share one kernel,
``csrc/bank_rows.cu``: its per-sample chip lookup from shared memory has no
chip-rate ceiling, so it serves the transition kernel's regime (below one chip
per sample: GPS L5, GPS L1 below ~6 MHz) as it is. The routes differ only in
the envelope each enforces, as the JAX kernels do, and in the launch count
each keeps.

Each wrapper dispatches on where its tensors lie. CUDA tensors launch the
hand-written kernel (built at first use by `_build`) or raise; CPU tensors run
`correlate_bank_rows_reference`, the plain PyTorch version of the same formula
with the same f32 phase arithmetic. Every launch adds one to the route's
wrapper's ``launches``.

Phase arithmetic shared by the kernels and the plain versions: the block is cut
into tiles of `TILE` samples; per tile a nominal base (carrier cycles and code
chips at the tile start, for the nominal rates) is computed exactly in float64
on the host, and each channel adds an f32 residual:

    ph_car = (phi_cyc + base_car) + (f_cyc - f_nom) * n0
    p_code = (phi_code + base_code) + (rho - rho_nom) * n0,  wrapped to [0, Lc)
             = c0 + frac,  c0 = floor(p_code)
    carrier cycles at tile sample j: j * f_cyc + ph_car   (wrapped to [0, 1))
    chip of tap l at tile sample j:  (floor((j + delta_l) * rho + frac) + c0) mod Lc

each product and sum rounded to f32 on its own (no fused multiply-add).
"""

from __future__ import annotations

import ctypes
import functools
import math
import warnings
from typing import Sequence

import numpy as np
import torch

from . import _build, registry
from .replica import rate

TILE = 4096                  # samples per CTA of the CUDA kernel (and per phase base)
MAX_CODE_LENGTH = 12288      # the code column must fit 48 KB of shared memory (GPS L5: 10230)
KERNEL_ANTENNAS = (1, 2, 3, 4)
KERNEL_TAPS = (3, 5, 7)
_LANES = 128
_TWO_PI = 2.0 * math.pi
# Elements of one [channels, N] intermediate per chunk of the plain version.
_CHUNK_ELEMENTS = 1 << 24


def _max_chips_per_sample(sampling_frequency, nominal_code_frequency,
                          max_chips_per_sample) -> float:
    if max_chips_per_sample is not None:
        return max_chips_per_sample
    if nominal_code_frequency is None:
        return 0.65
    return float(nominal_code_frequency) / float(sampling_frequency) * 1.001


def _check_rows_geometry(
    sampling_frequency: float,
    nominal_code_frequency: float | None,
    max_chips_per_sample: float | None,
) -> None:
    """The JAX rows kernel's chip-rate rule (`pallas_epl._rows_geometry`).

    A 128-sample row may touch at most 23 chips (< ~0.17 chips/sample). The
    CUDA kernel has no such limit; the rule is kept on the rows and composite
    routes so that routing and errors match the JAX package.
    """
    max_chips_per_sample = _max_chips_per_sample(
        sampling_frequency, nominal_code_frequency, max_chips_per_sample)
    if max_chips_per_sample >= 1.0:
        raise ValueError("rows kernel requires < 1 chip per sample")
    num_j = int(math.floor(max_chips_per_sample * (_LANES - 1))) + 2
    if num_j > 24:
        raise ValueError(
            f"rows kernel needs num_j={num_j} chips/row; use pallas_bank for"
            " chip rates above ~0.17 chips/sample"
        )


def _check_transition_geometry(
    span: int,
    sampling_frequency: float,
    nominal_code_frequency: float | None,
    max_chips_per_sample: float | None,
) -> None:
    """The JAX transition kernel's envelope (`pallas_epl.correlate_pallas_bank`,
    `_transition_geometry`): tap span < 128 samples, < 1 chip per sample."""
    if span >= _LANES:
        raise ValueError(
            f"tap span {span} >= {_LANES}; use the XLA bank path for wide spans"
        )
    if _max_chips_per_sample(sampling_frequency, nominal_code_frequency,
                             max_chips_per_sample) >= 1.0:
        raise ValueError("transition kernel requires < 1 chip per sample")


def _is_bf16(z_dtype) -> bool:
    return z_dtype in ("bf16", torch.bfloat16)


def bank_algorithm_for(
    num_samples: int,
    sampling_frequency: float,
    code_length: int,
    nominal_code_frequency: float | None = None,
    max_chips_per_sample: float | None = None,
    num_ants: int = 1,
    z_dtype=torch.float32,
) -> str:
    """Resolve the bank kernel for a scenario, by the JAX package's rules.

    The rows kernel for single-antenna f32 banks at high sample rates, the
    composite kernel for multi-antenna banks or bf16 z-planes, the transition
    kernel at low rates (above ~0.17 chips/sample).
    """
    try:
        _check_rows_geometry(
            float(sampling_frequency), nominal_code_frequency,
            max_chips_per_sample,
        )
    except ValueError:
        return "pallas_bank"
    if num_ants > 1 or _is_bf16(z_dtype):
        return "pallas_bank_comp"
    return "pallas_bank_rows"


def prepare_bank_code_tiles_rows(codes: torch.Tensor, prn: torch.Tensor) -> torch.Tensor:
    """Per-channel code columns ``[K, Lc]`` f32, contiguous: the code table
    of all three bank routes.

    Hoist out of tracking loops: PRNs are loop constants.
    """
    return codes.T[prn.long()].contiguous()


@functools.lru_cache(maxsize=64)
def _tile_base(num_tiles: int, tile: int, fcar_nom_cyc: float, rho_nom: float,
               code_length: int, device: torch.device) -> torch.Tensor:
    """``[tiles, 2]`` f32 nominal carrier cycles and code chips at each tile start,
    computed exactly in float64. Cached per device, so a tracking loop does not
    copy it to the card every block."""
    t_idx = np.arange(num_tiles, dtype=np.float64) * tile
    base = np.stack(
        [np.mod(fcar_nom_cyc * t_idx, 1.0),
         np.mod(rho_nom * t_idx, float(code_length))],
        axis=-1,
    ).astype(np.float32)
    return torch.as_tensor(base, device=device)


@functools.lru_cache(maxsize=16)
def _deltas(deltas: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(deltas, dtype=torch.int32, device=device)


def _channel_params(carrier_frequency, sampling_frequency, carrier_phase,
                   code_frequency, code_phase, d_min: int, device) -> torch.Tensor:
    """``[K, 4]`` f32 ``(f_cyc, phi_cyc, rho, phi_code)``; ``phi_code`` is the
    code phase at the earliest tap, ``code_phase + rho * d_min``."""
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=device)
    rho = rate(code_frequency, sampling_frequency, device)
    return torch.stack(
        [
            rate(carrier_frequency, sampling_frequency, device),
            f32(carrier_phase) / float(np.float32(_TWO_PI)),
            rho,
            f32(code_phase) + rho * float(d_min),
        ],
        dim=-1,
    ).contiguous()


class BankRowsCall:
    """Everything a bank kernel and its plain version take, computed once per
    call from the registry signature's arguments.

    ``route`` names the wrapper the call is for, ``pallas_bank_rows``,
    ``pallas_bank`` or ``pallas_bank_comp``: it picks the envelope that is
    enforced and the launch count that a launch adds to. The composite route
    evaluates its phases over ``N + span`` samples (`bank_comp`), so its tile
    base covers those.
    """

    def __init__(self, signal_re, signal_im, codes, prn, carrier_frequency,
                 sampling_frequency, carrier_phase, code_frequency, code_phase,
                 sample_shifts, code_length, nominal_code_frequency=None,
                 nominal_carrier_frequency=0.0, max_chips_per_sample=None,
                 code_tiles=None, route="pallas_bank_rows"):
        fs = float(sampling_frequency)
        span = int(max(sample_shifts)) - int(min(sample_shifts))
        if route == "pallas_bank":
            _check_transition_geometry(span, fs, nominal_code_frequency,
                                       max_chips_per_sample)
        elif route in ("pallas_bank_rows", "pallas_bank_comp"):
            _check_rows_geometry(fs, nominal_code_frequency, max_chips_per_sample)
        else:
            raise ValueError(f"unknown bank route {route!r}")
        self.route = route
        self.span = span
        self.squeeze = signal_re.ndim == 1
        if self.squeeze:
            signal_re, signal_im = signal_re[None], signal_im[None]
        self.sre, self.sim = signal_re, signal_im
        self.device = signal_re.device
        self.num_ants, self.num_samples = signal_re.shape
        d_min = int(min(sample_shifts))
        self.deltas = tuple(int(d) - d_min for d in sample_shifts)
        self.code_length = int(code_length)
        prn = torch.as_tensor(prn, device=self.device)
        self.code_tiles = (prepare_bank_code_tiles_rows(codes, prn)
                           if code_tiles is None else code_tiles)
        self.params = _channel_params(carrier_frequency, fs, carrier_phase,
                                     code_frequency, code_phase, d_min,
                                     self.device)
        self.num_k = self.params.shape[0]
        phase_samples = self.num_samples + (span if route == "pallas_bank_comp" else 0)
        self.num_tiles = -(-phase_samples // TILE)
        self.rho_nom = (float(nominal_code_frequency) / fs
                        if nominal_code_frequency is not None else 0.0)
        self.fcar_nom_cyc = float(nominal_carrier_frequency) / fs
        self.base = _tile_base(self.num_tiles, TILE, self.fcar_nom_cyc,
                               self.rho_nom, self.code_length, self.device)

    def finish(self, acc_re, acc_im):
        if self.squeeze:
            return acc_re[:, 0], acc_im[:, 0]
        return acc_re, acc_im


def _bank_rows_plain(bank: BankRowsCall) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample PyTorch evaluation of the kernel's formula, chunked over channels."""
    dev, tile, nt = bank.device, TILE, bank.num_tiles
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    pad = nt * tile - bank.num_samples
    s_re = torch.nn.functional.pad(bank.sre, (0, pad)).view(bank.num_ants, nt, tile)
    s_im = torch.nn.functional.pad(bank.sim, (0, pad)).view(bank.num_ants, nt, tile)
    j = torch.arange(tile, dtype=torch.float32, device=dev)
    n0 = torch.arange(nt, dtype=torch.float32, device=dev) * tile
    lc = f32(float(bank.code_length))
    f_nom, rho_nom = f32(bank.fcar_nom_cyc), f32(bank.rho_nom)
    num_taps = len(bank.deltas)
    out_re = torch.empty(bank.num_k, bank.num_ants, num_taps, dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    per_chunk = max(1, _CHUNK_ELEMENTS // (nt * tile * bank.num_ants))
    for k0 in range(0, bank.num_k, per_chunk):
        k1 = min(k0 + per_chunk, bank.num_k)
        f_cyc, phi_cyc, rho, phi_code = bank.params[k0:k1].unbind(-1)
        ph_car = ((phi_cyc[:, None] + bank.base[None, :, 0])
                  + (f_cyc - f_nom)[:, None] * n0[None, :])            # [kc, nt]
        pc = ((phi_code[:, None] + bank.base[None, :, 1])
              + (rho - rho_nom)[:, None] * n0[None, :])
        pc = pc - lc * torch.floor(pc / lc)
        pc_whole = torch.floor(pc)
        pc_frac = pc - pc_whole
        cyc = j * f_cyc[:, None, None] + ph_car[:, :, None]             # [kc, nt, T]
        cyc = cyc - torch.floor(cyc)
        theta = f32(_TWO_PI) * cyc
        cos, sin = torch.cos(theta).unsqueeze(1), torch.sin(theta).unsqueeze(1)
        dw_re = s_re * cos + s_im * sin                                  # [kc, A, nt, T]
        dw_im = s_im * cos - s_re * sin
        cols = bank.code_tiles[k0:k1]
        for l, delta in enumerate(bank.deltas):
            x = (j + float(delta)) * rho[:, None, None] + pc_frac[:, :, None]
            chip = torch.floor(x).long() + pc_whole.long()[:, :, None]
            chip = torch.remainder(chip, bank.code_length)
            rep = torch.gather(cols, 1, chip.view(k1 - k0, -1)).view(k1 - k0, 1, nt, tile)
            out_re[k0:k1, :, l] = (dw_re * rep).sum(dim=(-2, -1))
            out_im[k0:k1, :, l] = (dw_im * rep).sum(dim=(-2, -1))
    return out_re, out_im


def _check_kernel_inputs(bank: BankRowsCall, kernel: str = "bank_rows") -> None:
    tensors = {"signal_re": bank.sre, "signal_im": bank.sim,
               "code_tiles": bank.code_tiles, "params": bank.params}
    for name, t in tensors.items():
        if t.device != bank.device:
            raise ValueError(f"{name} is on {t.device}, the signal on {bank.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bank.sim.shape != bank.sre.shape:
        raise ValueError(f"signal planes differ: {tuple(bank.sre.shape)} vs "
                         f"{tuple(bank.sim.shape)}")
    if bank.num_ants not in KERNEL_ANTENNAS or len(bank.deltas) not in KERNEL_TAPS:
        raise ValueError(
            f"{kernel} kernel takes A in {KERNEL_ANTENNAS} and L in "
            f"{KERNEL_TAPS}, got A={bank.num_ants}, L={len(bank.deltas)}"
        )
    if bank.code_tiles.shape != (bank.num_k, bank.code_length):
        raise ValueError(
            f"code_tiles shape {tuple(bank.code_tiles.shape)} != "
            f"{(bank.num_k, bank.code_length)}"
        )
    if bank.code_length > MAX_CODE_LENGTH:
        raise ValueError(f"code_length {bank.code_length} > {MAX_CODE_LENGTH}")
    if bank.num_samples >= 1 << 24 or bank.num_k > 65535:
        raise ValueError(f"{kernel} kernel takes N < 2^24 and K <= 65535")


def correlate_bank_rows_reference(
    signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
    carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
    nominal_code_frequency=None, nominal_carrier_frequency=0.0,
    max_chips_per_sample=None, code_tiles=None, route="pallas_bank_rows",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `correlate_pallas_bank_rows`, on any device.

    It is the plain version of `correlate_pallas_bank` too, on that route's
    envelope: ``route="pallas_bank"``.
    """
    bank = BankRowsCall(signal_re, signal_im, codes, prn, carrier_frequency,
                        sampling_frequency, carrier_phase, code_frequency,
                        code_phase, sample_shifts, code_length,
                        nominal_code_frequency, nominal_carrier_frequency,
                        max_chips_per_sample, code_tiles, route)
    return bank.finish(*_bank_rows_plain(bank))


def correlate_pallas_bank_rows(
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    codes: torch.Tensor,
    prn: torch.Tensor,
    carrier_frequency: torch.Tensor,
    sampling_frequency,
    carrier_phase: torch.Tensor,
    code_frequency: torch.Tensor,
    code_phase: torch.Tensor,
    sample_shifts: Sequence[int],
    code_length: int,
    nominal_code_frequency: float | None = None,
    nominal_carrier_frequency: float = 0.0,
    max_chips_per_sample: float | None = None,
    code_tiles: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K-channel EPL bank against one shared ``[N]`` / ``[A, N]`` block.

    Returns ``[K, L]`` / ``[K, A, L]`` f32 accumulators. CPU tensors run the
    plain version; CUDA tensors launch ``csrc/bank_rows.cu`` or raise.
    ``code_tiles``: `prepare_bank_code_tiles_rows` output, hoisted by loops.
    """
    return _run_bank_rows(BankRowsCall(
        signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
        carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
        nominal_code_frequency, nominal_carrier_frequency, max_chips_per_sample,
        code_tiles, route="pallas_bank_rows"))


def _run_bank_rows(bank: BankRowsCall) -> tuple[torch.Tensor, torch.Tensor]:
    if bank.device.type == "cpu":
        return bank.finish(*_bank_rows_plain(bank))
    if bank.device.type != "cuda":
        raise ValueError(f"{bank.route} runs on CPU or CUDA tensors, not {bank.device}")
    return bank.finish(*launch_bank_rows(bank))


def launch_bank_rows(bank: "BankRowsCall") -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bank_rows.cu`` for a prepared call on CUDA tensors.

    Returns ``[K, A, L]`` accumulators and adds one to the launch count of the
    call's route (``correlate_pallas_bank_rows.launches`` or
    ``correlate_pallas_bank.launches``). Raises on anything the kernel does
    not take, and if the launch fails.
    """
    if bank.device.type != "cuda":
        raise ValueError(f"the bank_rows kernel takes CUDA tensors, not {bank.device}")
    wrapper = _ROWS_KERNEL_ROUTES.get(bank.route)
    if wrapper is None:
        raise ValueError(f"the bank_rows kernel does not serve route {bank.route!r}")
    _check_kernel_inputs(bank)
    lib = _build.load_library("bank_rows")
    shape = (bank.num_k, bank.num_ants, len(bank.deltas))
    out_re = torch.empty(shape, dtype=torch.float32, device=bank.device)
    out_im = torch.empty(shape, dtype=torch.float32, device=bank.device)
    partial = torch.empty(shape[:1] + (bank.num_tiles,) + shape[1:] + (2,),
                          dtype=torch.float32, device=bank.device)
    deltas = _deltas(bank.deltas, bank.device)
    stream = torch.cuda.current_stream(bank.device).cuda_stream
    err = lib.bank_rows_launch(
        bank.sre.data_ptr(), bank.sim.data_ptr(), bank.code_tiles.data_ptr(),
        bank.params.data_ptr(), bank.base.data_ptr(), deltas.data_ptr(),
        partial.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        bank.num_ants, len(bank.deltas), bank.num_samples, bank.num_k,
        bank.code_length, TILE, ctypes.c_float(bank.rho_nom),
        ctypes.c_float(bank.fcar_nom_cyc), stream,
    )
    if err != 0:
        raise RuntimeError(f"bank_rows_launch failed with CUDA error {err}")
    wrapper.launches += 1
    return out_re, out_im


correlate_pallas_bank_rows.launches = 0


def correlate_pallas_bank(
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    codes: torch.Tensor,
    prn: torch.Tensor,
    carrier_frequency: torch.Tensor,
    sampling_frequency,
    carrier_phase: torch.Tensor,
    code_frequency: torch.Tensor,
    code_phase: torch.Tensor,
    sample_shifts: Sequence[int],
    code_length: int,
    nominal_code_frequency: float | None = None,
    nominal_carrier_frequency: float = 0.0,
    max_chips_per_sample: float | None = None,
    code_tiles: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K-channel EPL bank in the transition kernel's regime (< 1 chip/sample).

    The contract and envelope of the JAX `correlate_pallas_bank`: tap span
    < 128 samples and < 1 chip per sample, else `ValueError`. CPU tensors run
    the plain version; CUDA tensors launch ``csrc/bank_rows.cu`` (whose
    per-sample chip lookup covers any chip rate below one per sample) and add
    one to ``correlate_pallas_bank.launches``, or raise.
    """
    return _run_bank_rows(BankRowsCall(
        signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
        carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
        nominal_code_frequency, nominal_carrier_frequency, max_chips_per_sample,
        code_tiles, route="pallas_bank"))


correlate_pallas_bank.launches = 0

# The routes the bank_rows kernel serves, and whose launch count it adds to.
_ROWS_KERNEL_ROUTES = {
    "pallas_bank_rows": correlate_pallas_bank_rows,
    "pallas_bank": correlate_pallas_bank,
}


def correlate_pallas_bank_auto(
    signal_re: torch.Tensor,
    signal_im: torch.Tensor,
    codes: torch.Tensor,
    prn: torch.Tensor,
    carrier_frequency: torch.Tensor,
    sampling_frequency,
    carrier_phase: torch.Tensor,
    code_frequency: torch.Tensor,
    code_phase: torch.Tensor,
    sample_shifts: Sequence[int],
    code_length: int,
    nominal_code_frequency: float | None = None,
    nominal_carrier_frequency: float = 0.0,
    max_chips_per_sample: float | None = None,
    code_tiles: torch.Tensor | None = None,
    z_dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bank correlator with per-scenario kernel selection (`bank_algorithm_for`).

    ``z_dtype`` (``torch.bfloat16`` or ``"bf16"``) asks for the composite
    kernel's bf16 planes; where the scenario resolves to another kernel, that
    is said with a `UserWarning` and the bank runs in f32.
    """
    algo = bank_algorithm_for(
        signal_re.shape[-1], float(sampling_frequency), code_length,
        nominal_code_frequency, max_chips_per_sample,
        num_ants=signal_re.shape[0] if signal_re.ndim == 2 else 1,
        z_dtype=z_dtype,
    )
    extra = {}
    if algo == "pallas_bank_comp":
        from .bank_comp import correlate_pallas_bank_comp as fn

        extra = {"z_dtype": z_dtype}
    else:
        fn = correlate_pallas_bank_rows if algo == "pallas_bank_rows" else correlate_pallas_bank
        if _is_bf16(z_dtype):
            warnings.warn(
                f"z_dtype=bfloat16 requested but the resolved kernel {algo!r} "
                "does not support bf16 accumulator planes; running in f32",
                stacklevel=2,
            )
    return fn(
        signal_re, signal_im, codes, prn, carrier_frequency,
        sampling_frequency, carrier_phase, code_frequency, code_phase,
        sample_shifts, code_length,
        nominal_code_frequency=nominal_code_frequency,
        nominal_carrier_frequency=nominal_carrier_frequency,
        max_chips_per_sample=max_chips_per_sample, code_tiles=code_tiles,
        **extra,
    )


registry.register("pallas_bank", correlate_pallas_bank)
registry.register("pallas_bank_rows", correlate_pallas_bank_rows)
registry.register("pallas_bank_auto", correlate_pallas_bank_auto)
