"""The composite-plane bank correlator: its kernel's wrapper and plain version.

Port of `gpuacceleratedtracking_tpu.ops.pallas_epl.correlate_pallas_bank_comp`,
the route that `bank_algorithm_for` takes for multi-antenna banks and for bf16
z-planes. The tone identity ``carrier[u - d] = carrier[u] e^{-2 pi i f d}``
moves the tap shifts off the per-channel replica onto the shared signal:

    Z_k[u]     = conj(carrier_k[u]) * code_k[u]      (earliest tap, one plane per channel)
    S_{a,l}[u] = sig_a[u - delta_l]                  (0 outside [0, N))
    acc[k,a,l] = e^{+2 pi i f_k delta_l} * sum_u S_{a,l}[u] * Z_k[u],   0 <= u < N + span

with ``f_k`` in cycles per sample and ``delta_l = d_l - d_min``. It is the rows
contract (`epl_kernels`), rounded in another order. The sum is kept as the
four real products of ``[zc, zs] x [S_re, S_im]`` (``zc = cos * code``,
``zs = sin * code``), recombined as ``m_re = zc.S_re + zs.S_im``,
``m_im = zc.S_im - zs.S_re``, then rotated. Z's phases use the rows route's
tile base and f32 arithmetic over ``u``, so Z's chip boundaries fall on the
samples where the rows route puts those of its earliest tap.

``z_dtype`` bf16 rounds Z and S to bf16 before the products and accumulates in
f32: the JAX tracking-grade mode (``z_dtype=bf16``, default-precision MACs).

CUDA tensors launch ``csrc/bank_comp.cu`` and add one to
``correlate_pallas_bank_comp.launches``, or raise; CPU tensors run
`correlate_bank_comp_reference`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build, registry
from .epl_kernels import TILE, BankRowsCall, _check_kernel_inputs, _deltas, _is_bf16
from .replica import _TWO_PI_F32

COMP_TILE = 1024             # composite samples per CTA of the CUDA kernel; divides TILE
MAX_SPAN = 4096              # the signal tile's halo must fit shared memory
# Elements of one [channels, N + span] intermediate per chunk of the plain version.
_CHUNK_ELEMENTS = 1 << 24


class BankCompCall(BankRowsCall):
    """A `BankRowsCall` on the composite route, with its z-plane dtype."""

    def __init__(self, *args, z_dtype=torch.float32, **kwargs):
        super().__init__(*args, route="pallas_bank_comp", **kwargs)
        self.bf16 = _is_bf16(z_dtype)


def _to_z(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


def _rotate(bank: BankCompCall, m_re, m_im):
    """``e^{+2 pi i f_k delta_l} * m``: ``[K, A, L]`` accumulators."""
    delta = torch.tensor(bank.deltas, dtype=torch.float32, device=bank.device)
    omega = (_TWO_PI_F32 * bank.params[:, 0])[:, None, None] * delta     # [K, 1, L]
    cw, sw = torch.cos(omega), torch.sin(omega)
    return cw * m_re - sw * m_im, cw * m_im + sw * m_re


def _shifted_planes(bank: BankCompCall) -> torch.Tensor:
    """``[2AL, U]`` planes ``S_re`` then ``S_im``, (a, l)-major, over the
    padded composite range ``U = tiles * TILE``."""
    num_u = bank.num_tiles * TILE
    span = bank.span
    rows = []
    for sig in (bank.sre, bank.sim):
        padded = torch.nn.functional.pad(sig, (span, num_u - bank.num_samples))
        for a in range(bank.num_ants):
            for delta in bank.deltas:
                rows.append(padded[a, span - delta: span - delta + num_u])
    return _to_z(torch.stack(rows), bank.bf16)


def _bank_comp_plain(bank: BankCompCall) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample PyTorch evaluation of the composite formula, chunked over
    channels: Z planes, one ``[2Kc, U] x [U, 2AL]`` product, the recombination
    and the rotation."""
    dev, tile, nt = bank.device, TILE, bank.num_tiles
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    s_planes = _shifted_planes(bank)                                  # [2AL, U]
    j = torch.arange(tile, dtype=torch.float32, device=dev)
    n0 = torch.arange(nt, dtype=torch.float32, device=dev) * tile
    lc = f32(float(bank.code_length))
    f_nom, rho_nom = f32(bank.fcar_nom_cyc), f32(bank.rho_nom)
    al = bank.num_ants * len(bank.deltas)
    raw = torch.empty(bank.num_k, 2, 2 * al, dtype=torch.float32, device=dev)
    per_chunk = max(1, _CHUNK_ELEMENTS // (nt * tile))
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
        theta = cyc * _TWO_PI_F32
        x = j * rho[:, None, None] + pc_frac[:, :, None]
        chip = torch.floor(x).long() + pc_whole.long()[:, :, None]
        chip = torch.remainder(chip, bank.code_length).view(k1 - k0, -1)
        rep = torch.gather(bank.code_tiles[k0:k1], 1, chip)            # [kc, U]
        z = torch.cat([_to_z(torch.cos(theta).view(k1 - k0, -1) * rep, bank.bf16),
                       _to_z(torch.sin(theta).view(k1 - k0, -1) * rep, bank.bf16)])
        raw[k0:k1] = (z @ s_planes.T).view(2, k1 - k0, 2 * al).transpose(0, 1)
    shape = (bank.num_k, bank.num_ants, len(bank.deltas))
    zc_sre, zc_sim = raw[:, 0, :al].view(shape), raw[:, 0, al:].view(shape)
    zs_sre, zs_sim = raw[:, 1, :al].view(shape), raw[:, 1, al:].view(shape)
    return _rotate(bank, zc_sre + zs_sim, zc_sim - zs_sre)


def correlate_bank_comp_reference(
    signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
    carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
    nominal_code_frequency=None, nominal_carrier_frequency=0.0,
    max_chips_per_sample=None, code_tiles=None, z_dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `correlate_pallas_bank_comp`, on any device."""
    bank = BankCompCall(signal_re, signal_im, codes, prn, carrier_frequency,
                        sampling_frequency, carrier_phase, code_frequency,
                        code_phase, sample_shifts, code_length,
                        nominal_code_frequency, nominal_carrier_frequency,
                        max_chips_per_sample, code_tiles, z_dtype=z_dtype)
    return bank.finish(*_bank_comp_plain(bank))


def correlate_pallas_bank_comp(
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
    """Composite-plane K-channel EPL bank against one shared ``[N]`` / ``[A, N]`` block.

    The contract and chip-rate envelope of `correlate_pallas_bank_rows` (any
    tap span up to `MAX_SPAN` samples, < ~0.17 chips/sample, else
    `ValueError`), rounded in the composite order. ``z_dtype``:
    ``torch.float32`` or ``"f32"``, ``torch.bfloat16`` or ``"bf16"``.
    ``code_tiles``: `epl_kernels.prepare_bank_code_tiles_rows` output.
    """
    bank = BankCompCall(signal_re, signal_im, codes, prn, carrier_frequency,
                        sampling_frequency, carrier_phase, code_frequency,
                        code_phase, sample_shifts, code_length,
                        nominal_code_frequency, nominal_carrier_frequency,
                        max_chips_per_sample, code_tiles, z_dtype=z_dtype)
    if bank.device.type == "cpu":
        return bank.finish(*_bank_comp_plain(bank))
    if bank.device.type != "cuda":
        raise ValueError(f"bank_comp runs on CPU or CUDA tensors, not {bank.device}")
    return bank.finish(*launch_bank_comp(bank))


def launch_bank_comp(bank: BankCompCall) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bank_comp.cu`` for a prepared call on CUDA tensors.

    Returns ``[K, A, L]`` accumulators and adds one to
    ``correlate_pallas_bank_comp.launches``. Raises on anything the kernel
    does not take, and if the launch fails.
    """
    if bank.device.type != "cuda":
        raise ValueError(f"the bank_comp kernel takes CUDA tensors, not {bank.device}")
    _check_kernel_inputs(bank, kernel="bank_comp")
    if bank.span > MAX_SPAN:
        raise ValueError(f"bank_comp kernel takes a tap span <= {MAX_SPAN}, got {bank.span}")
    lib = _build.load_library("bank_comp")
    shape = (bank.num_k, bank.num_ants, len(bank.deltas))
    num_ctiles = -(-(bank.num_samples + bank.span) // COMP_TILE)
    out_re = torch.empty(shape, dtype=torch.float32, device=bank.device)
    out_im = torch.empty(shape, dtype=torch.float32, device=bank.device)
    partial = torch.empty(shape[:1] + (num_ctiles,) + shape[1:] + (4,),
                          dtype=torch.float32, device=bank.device)
    deltas = _deltas(bank.deltas, bank.device)
    stream = torch.cuda.current_stream(bank.device).cuda_stream
    err = lib.bank_comp_launch(
        bank.sre.data_ptr(), bank.sim.data_ptr(), bank.code_tiles.data_ptr(),
        bank.params.data_ptr(), bank.base.data_ptr(), deltas.data_ptr(),
        partial.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        bank.num_ants, len(bank.deltas), bank.num_samples, bank.num_k,
        bank.code_length, TILE, bank.span, int(bank.bf16),
        ctypes.c_float(bank.rho_nom), ctypes.c_float(bank.fcar_nom_cyc), stream,
    )
    if err != 0:
        raise RuntimeError(f"bank_comp_launch failed with CUDA error {err}")
    correlate_pallas_bank_comp.launches += 1
    return out_re, out_im


correlate_pallas_bank_comp.launches = 0

registry.register("pallas_bank_comp", correlate_pallas_bank_comp)
