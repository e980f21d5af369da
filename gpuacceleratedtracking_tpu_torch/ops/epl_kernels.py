"""The bank correlator kernels' wrappers, their plain versions, and bank routing.

Port of `gpuacceleratedtracking_tpu.ops.pallas_epl`'s bank routes:
`correlate_pallas_bank_rows` (the per-row bank kernel's wrapper),
`correlate_pallas_bank` (the transition kernel's wrapper),
`correlate_pallas_bank_onehot` (the one-hot bank kernel's wrapper),
`bank_algorithm_for` and `correlate_pallas_bank_auto`. The composite route,
`pallas_bank_comp`, lives in `bank_comp`.

The rows, transition and one-hot routes compute one contract and share one
kernel, ``csrc/bank_rows.cu``: its per-sample chip lookup from shared memory
has no chip-rate ceiling and no tap-span limit, so it serves the transition
kernel's regime (below one chip per sample: GPS L5, GPS L1 below ~6 MHz) and
the one-hot kernel's (any span, any rate) as it is. The routes differ only in
the envelope each enforces, as the JAX kernels do, in whether they take
nominal rates, and in the launch count each keeps.

Each wrapper dispatches on where its tensors lie. CUDA tensors launch the
hand-written kernel (built at first use by `_build`) or raise; CPU tensors run
`correlate_bank_rows_reference`, the plain PyTorch version of the same formula
with the same f32 phase arithmetic. Every launch adds one to the route's
wrapper's ``launches``. The bank kernels are instantiated for A <= 4
antennas and L in {3, 5, 7} taps; a call outside them is split into
launches that are (`launch_groups`, `split_launches`), each with the call's
phase origin, so every A and L that the JAX kernels take runs on the card.

Phase arithmetic shared by the kernels and the plain versions: the block is cut
into tiles of `TILE` samples; per tile a nominal base (carrier cycles and code
chips at the tile start, for the nominal rates) is computed exactly in float64
on the host, and each channel adds an f32 residual:

    ph_car = (phi_cyc + base_car) + (f_cyc - f_nom) * n0
    p_code = (phi_code + base_code) + (rho - rho_nom) * n0,  wrapped to [0, Lc)
             = c0 + frac,  c0 = floor(p_code)
    carrier at tile sample j = 128 r + i, the JAX kernels' row x lane product
    (`pallas_epl._group_row_phasors`, `_group_lane_phasors`):
        row  = e^{2 pi i frac(128 r * f_cyc + ph_car)},  lane = e^{2 pi i frac(f_cyc * i)}
        cos  = row_c * lane_c - row_s * lane_s,  sin = row_s * lane_c + row_c * lane_s
    replica row: chip(m) = (floor(m * rho + frac) + c0) mod Lc, m >= 0
    tap l at tile sample j reads chip(j + delta_l)

each product and sum rounded to f32 on its own (no fused multiply-add). The
replica row is the per-tap formula ``floor((j + delta_l) * rho + frac)``
evaluated once per position: ``j + delta_l`` is an exact small integer, so
both round alike, bit for bit.

The code tables of all bank routes are packed, one bit per chip
(`prepare_bank_code_tiles_rows`), and checked to hold only +/-1 chips when
they are prepared; `pack_code_tiles` packs them in one launch of
``csrc/code_tiles.cu`` on the card, the tracking loops' prologue.

Besides the registry signature, every bank wrapper takes the two forms a
tracking loop's block body uses, so that on the card no torch op runs
between the loop's carry and the launch: ``channels=`` (a `BankChannels`,
the tracking state's leaves and the config's nominal rates, from which the
kernels derive each channel's parameters with `_channel_params`' roundings)
in place of the four channel parameters, and ``block_index=`` (an int64 0-d
tensor) with a ``[chunk, (A,) N]`` signal, whose row ``block_index`` the
kernels read at the index on the device. The plain versions evaluate the
same expressions in torch ops, and select the row by `index_select`.

A time shard of a mesh (`parallel.track_bank_sharded`) is a `BankShard` in
the state form: the call reads the shard's piece of each antenna's row of
the block in place (nothing outside it) as its block, advances the state's
phases to the piece's first sample (`shard_phases`, the JAX
`advance_phases` arithmetic) before it derives the channel parameters, and,
given a `ShardSum` (``shard_sum=``), leaves its result there: one finish
per channel shard then adds the time shards' results in shard order.
"""

from __future__ import annotations

import ctypes
import functools
import math
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import _build, registry
from .replica import _TWO_PI_F32, rate

TILE = 4096                  # samples per phase base
ROWS_TILE = 1024             # samples per tile of the bank_rows kernel; divides TILE
MAX_CODE_LENGTH = 12288      # longest code the kernels take (GPS L5: 10230)
MAX_SPAN = 4096              # widest tap span: the kernels' replica rows fit shared memory
# Samples a chip lasts, at the nominal rate, from which the bank_rows kernel
# builds its replica rows from the chip boundaries (`rows_min_run`): on the
# H100 at K=1024 that build is no faster than the per-position one at 12
# samples a chip and faster from 16 (bank_kernel_ab.py's `rows_builds`).
MIN_CHIP_RUN = 16
KERNEL_ANTENNAS = 4          # antennas per launch at most: the kernels' instantiations
KERNEL_TAPS = (3, 5, 7)      # taps per launch: the kernels' instantiations
_LANES = 128                 # samples per carrier row
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


def _check_chips(valid: torch.Tensor) -> None:
    """Raise unless the bool 0-d ``valid`` holds: `ValueError` on the CPU, a
    device-side assert on the card, so that a tracking run that packs its
    table per call (inside a captured program too) never waits on the card."""
    if valid.is_cuda:
        torch._assert_async(valid, "bank code tables hold +/-1 chips only")
    elif not bool(valid):
        raise ValueError("bank code tables hold +/-1 chips only")


@functools.lru_cache(maxsize=None)       # never evicted, as `_tile_base`
def _bit_weights(device: torch.device) -> torch.Tensor:
    """int64 ``2^b`` for bits 0..30 and ``-2^31`` for bit 31: a word's bits
    times these sum to the word's two's-complement int32 value."""
    weights = [1 << b for b in range(31)] + [-(1 << 31)]
    return torch.tensor(weights, dtype=torch.int64, device=device)


def _pack_bits(cols: torch.Tensor) -> torch.Tensor:
    """``[K, Lc]`` chips as ``[K, ceil(Lc / 32)]`` int32 words, bit ``b`` of
    word ``w`` set where chip ``32 w + b`` is negative."""
    num_k, code_length = cols.shape
    words = -(-code_length // 32)
    bits = torch.nn.functional.pad((cols < 0).to(torch.int64), (0, 32 * words - code_length))
    packed = (bits.view(num_k, words, 32) * _bit_weights(cols.device)).sum(-1)
    return packed.to(torch.int32)


def unpack_code_columns(words: torch.Tensor, code_length: int) -> torch.Tensor:
    """The ``[K, Lc]`` f32 +/-1 chips of `prepare_bank_code_tiles_rows` words."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return (1 - 2 * bits.flatten(-2)[..., :code_length]).to(torch.float32)


def prepare_bank_code_tiles_rows(codes: torch.Tensor, prn: torch.Tensor,
                                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Per-channel code columns, packed one bit per chip: ``[K, ceil(Lc /
    32)]`` int32, bit ``b`` of word ``w`` set where chip ``32 w + b`` is -1,
    the code table of all four bank routes, for the ``[K]`` PRNs ``prn``
    (into ``out``, if given).

    The ``[Lc, P]`` table's P columns are packed, then each channel's words
    gathered by its PRN: the words of the K gathered columns, for P columns'
    work where a bank has K >= P channels. A chip of a gathered column other
    than +/-1 raises `ValueError` on the CPU and fails a device-side assert
    on the card, where nothing is read on the host: `tracking.track_bank`
    runs this once per call, inside the captured program.
    """
    prn = torch.as_tensor(prn, device=codes.device).reshape(-1).long()
    valid = (codes.abs() == 1.0).all(0)
    _check_chips(torch.index_select(valid, 0, prn).all())
    return torch.index_select(_pack_bits(codes.T), 0, prn, out=out)


def pack_code_tiles_plain(codes: torch.Tensor, prn, pilot_codes=None,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of `pack_code_tiles`, on any device (into
    ``out``, if given)."""
    if pilot_codes is None:
        return prepare_bank_code_tiles_rows(codes, prn, out)
    num_k0 = torch.as_tensor(prn).numel()
    halves = (None, None) if out is None else (out[:num_k0], out[num_k0:])
    tiles = [prepare_bank_code_tiles_rows(table, prn, half)
             for table, half in zip((codes, pilot_codes), halves)]
    return torch.cat(tiles) if out is None else out


TILES_THREADS = 256       # threads of a ``csrc/code_tiles.cu`` CTA
TILES_MAX_SHARED = 48 << 10   # bytes of shared memory a CTA of it takes at most


class TilesSplit(NamedTuple):
    """``csrc/code_tiles.cu``'s work split: ``vec`` words per store (4, a
    16-byte vector, or 1), ``chunk`` words of every column packed per CTA
    (a multiple of ``vec``), ``channels`` channels copied per CTA, and the
    grid: ``(word chunks, channel chunks, tables)``."""

    vec: int
    chunk: int
    channels: int
    grid: tuple


def tiles_shared(num_prns: int, chunk: int) -> int:
    """Bytes of shared memory a packing CTA takes: the chunk's ``32 chunk``
    rows of f32 chips (a multiple of 16 bytes), its packed words and a byte
    per word."""
    return 4 * (-(-32 * chunk * num_prns // 4) * 4) + 5 * num_prns * chunk


def tiles_split(num_prns: int, words: int, num_k0: int, tables: int = 1,
                vec: int = 4) -> TilesSplit:
    """The packing kernel's work split for ``tables`` tables of at most
    ``num_prns`` columns of ``words`` words and ``num_k0`` channels per
    table: each CTA stages and packs as many words of every column as its
    threads take one (word, column) pair each and its shared memory holds
    (at least one store's), and copies as many channels as its threads take
    one store each (each channel chunk stages its rows anew: more chunks,
    as many CTAs again, measured no faster at GPS L1 K=1024, and slower on
    the larger GPS L5 table, `bank_kernel_ab.py`); 1-word stores where a
    16-byte one's chunk would not fit. For GPS L1 at K=1024: 4 words and
    256 channels per CTA, 8 x 4 CTAs."""
    if min(num_prns, words, num_k0) < 1 or tables not in (1, 2) or vec not in (1, 4):
        raise ValueError(f"no packing split for {num_prns} PRNs, {words} words, {num_k0} "
                         f"channels, {tables} tables, {vec} words per store")
    if vec == 4 and tiles_shared(num_prns, 4) > TILES_MAX_SHARED:
        vec = 1
    if tiles_shared(num_prns, vec) > TILES_MAX_SHARED:
        raise ValueError(f"pack_code_tiles takes tables of at most "
                         f"{TILES_MAX_SHARED // tiles_shared(1, 1)} PRNs, got {num_prns}")
    top = -(-words // vec) * vec
    chunk = vec
    while chunk + vec <= top and num_prns * (chunk + vec) <= TILES_THREADS \
            and tiles_shared(num_prns, chunk + vec) <= TILES_MAX_SHARED:
        chunk += vec
    channels = TILES_THREADS // (chunk // vec)
    return TilesSplit(vec, chunk, channels, (-(-words // chunk), -(-num_k0 // channels), tables))


def _check_tiles_out(out, num_k: int, words: int, device: torch.device) -> None:
    if not isinstance(out, torch.Tensor) or out.device != device or out.dtype != torch.int32 \
            or tuple(out.shape) != (num_k, words) or not out.is_contiguous():
        got = (f"{out.dtype} {tuple(out.shape)} on {out.device}" if isinstance(out, torch.Tensor)
               else type(out).__name__)
        raise ValueError(f"out must be a contiguous int32 [{num_k}, {words}] tensor on "
                         f"{device}, not {got}")


def _check_tiles_index(index, device: torch.device) -> None:
    if not isinstance(index, torch.Tensor) or index.device != device \
            or index.dtype != torch.int64 or index.ndim != 0:
        got = (f"{index.dtype} {tuple(index.shape)} on {index.device}"
               if isinstance(index, torch.Tensor) else type(index).__name__)
        raise ValueError(f"index must be an int64 0-d tensor on {device}, not {got}")


def pack_code_tiles(codes: torch.Tensor, prn, pilot_codes=None, *,
                    out: torch.Tensor | None = None,
                    index: torch.Tensor | None = None) -> torch.Tensor:
    """`prepare_bank_code_tiles_rows`' words of the ``[K]`` PRNs ``prn`` in
    the ``[Lc, P]`` table ``codes``; with ``pilot_codes`` (the GPS L5 dual
    bank's ``[Lc, P']`` pilot table) ``[2K, words]``, the data channels'
    words, then the pilot channels': those of the joined table and PRNs
    (``torch.cat([codes, pilot_codes], 1)``, ``torch.cat([prn, prn + P])``),
    without either join.

    ``out`` (a contiguous int32 ``[K or 2K, words]`` tensor on the tables'
    device) takes the words in place of a new tensor, and ``index`` (an
    int64 0-d tensor there, a tracking call's block index) is set to 0 in
    the same launch: a call's captured prologue is then this one launch
    (`tracking.graphs.writes_prepared`). Returns the words (``out``, if
    given).

    CPU tensors run `pack_code_tiles_plain`, which raises `ValueError` on a
    chip other than +/-1, and zero ``index`` with a torch op. CUDA tensors
    launch ``csrc/code_tiles.cu`` once (`tiles_split`'s work split) and add
    one to ``pack_code_tiles.launches``, or raise; there such a chip fails a
    device-side assert, and nothing is read on the host.
    """
    device = codes.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_code_tiles runs on CPU or CUDA tensors, not {device}")
    prn = torch.as_tensor(prn, device=device).reshape(-1)
    tables = (codes,) if pilot_codes is None else (codes, pilot_codes)
    words = -(-codes.shape[0] // 32)
    num_k = prn.numel() * len(tables)
    if out is not None:
        _check_tiles_out(out, num_k, words, device)
    if index is not None:
        _check_tiles_index(index, device)
    if device.type == "cpu":
        tiles = pack_code_tiles_plain(codes, prn, pilot_codes, out)
        if index is not None:
            index.zero_()
        return tiles
    if prn.dtype not in (torch.int32, torch.int64):
        prn = prn.long()
    for name, table in zip(("codes", "pilot_codes"), tables):
        if table.device != device or table.dtype != torch.float32 or table.ndim != 2 \
                or not table.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [Lc, P] f32 table on {device}")
    code_length = codes.shape[0]
    if pilot_codes is not None and pilot_codes.shape[0] != code_length:
        raise ValueError(f"the pilot table's {pilot_codes.shape[0]} chips != {code_length}")
    if prn.numel() == 0 or num_k * words >= 1 << 31:
        raise ValueError(f"pack_code_tiles takes 1 to 2^31 words, got {prn.numel()} PRNs")
    if out is None:
        out = torch.empty((num_k, words), dtype=torch.int32, device=device)
    vec = 4 if words % 4 == 0 and out.data_ptr() % 16 == 0 else 1
    split = tiles_split(max(table.shape[1] for table in tables), words, prn.numel(),
                        len(tables), vec)
    err = _build.load_library("code_tiles").code_tiles_launch(
        codes.data_ptr(), tables[-1].data_ptr(), prn.data_ptr(), out.data_ptr(),
        0 if index is None else index.data_ptr(), int(prn.dtype == torch.int64), prn.numel(),
        len(tables), code_length, codes.shape[1], tables[-1].shape[1], split.vec, split.chunk,
        split.channels, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"code_tiles_launch failed with CUDA error {err}")
    pack_code_tiles.launches += 1
    return out


pack_code_tiles.launches = 0


@functools.lru_cache(maxsize=None)
def _tile_base(num_tiles: int, tile: int, fcar_nom_cyc: float, rho_nom: float,
               code_length: int, device: torch.device) -> torch.Tensor:
    """``[tiles, 2]`` f32 nominal carrier cycles and code chips at each tile start,
    computed exactly in float64. Cached per device, so a tracking loop does not
    copy it to the card every block. Never evicted: a captured CUDA graph
    (`tracking.graphs`) reads it at a baked address; its keys are static
    configuration values, so the cache stays small."""
    t_idx = np.arange(num_tiles, dtype=np.float64) * tile
    base = np.stack(
        [np.mod(fcar_nom_cyc * t_idx, 1.0),
         np.mod(rho_nom * t_idx, float(code_length))],
        axis=-1,
    ).astype(np.float32)
    return torch.as_tensor(base, device=device)


@functools.lru_cache(maxsize=None)       # never evicted, as `_tile_base`
def _deltas(deltas: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(deltas, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def launch_groups(num_ants: int, num_taps: int) -> tuple:
    """The kernel launches that cover ``num_ants`` antennas and ``num_taps``
    taps with the kernels' instantiations: ``(a0, a1, taps)`` per launch,
    antennas ``a0:a1`` (at most `KERNEL_ANTENNAS`) against the taps whose
    indices ``taps`` lists, a count in `KERNEL_TAPS`. Taps go in groups of 7
    and a last group of the next count up, padded by repeating its last tap,
    whose extra columns are dropped. ``out[k, a, l]`` depends on antenna a's
    plane and tap l's shift alone, so every group launched with the call's
    phase origin ``d_min`` and its taps' ``delta_l`` gives the unsplit
    call's values. Inside the instantiations: one launch, every tap in order.
    Cached: it takes a call's static shape.
    """
    if num_ants < 1 or num_taps < 1:
        raise ValueError(f"a correlator takes A >= 1 and L >= 1, got A={num_ants}, L={num_taps}")
    tap_groups, l0 = [], 0
    while l0 < num_taps:
        take = min(max(KERNEL_TAPS), num_taps - l0)
        size = min(s for s in KERNEL_TAPS if s >= take)
        tap_groups.append(tuple(range(l0, l0 + take)) + (l0 + take - 1,) * (size - take))
        l0 += take
    return tuple((a0, min(a0 + KERNEL_ANTENNAS, num_ants), taps)
                 for a0 in range(0, num_ants, KERNEL_ANTENNAS) for taps in tap_groups)


def split_launches(launch, num_ants: int, num_taps: int, lead: tuple, device: torch.device):
    """``(out_re, out_im)`` ``[*lead, A, L]`` of a correlator call through the
    launches of `launch_groups`: ``launch(a0, a1, taps)`` launches one group,
    antennas ``a0:a1`` against the taps whose indices ``taps`` lists, and
    returns its ``[*lead, a1 - a0, len(taps)]`` planes. A call inside the
    instantiations is that one launch, unchanged; else each group's columns
    are written into the call's result."""
    groups = launch_groups(num_ants, num_taps)
    if len(groups) == 1 and groups[0][2] == tuple(range(num_taps)):
        return launch(0, num_ants, groups[0][2])
    shape = tuple(lead) + (num_ants, num_taps)
    out_re = torch.empty(shape, dtype=torch.float32, device=device)
    out_im = torch.empty(shape, dtype=torch.float32, device=device)
    for a0, a1, taps in groups:
        g_re, g_im = launch(a0, a1, taps)
        l0, take = taps[0], taps[-1] - taps[0] + 1
        out_re[..., a0:a1, l0:l0 + take] = g_re[..., :take]
        out_im[..., a0:a1, l0:l0 + take] = g_im[..., :take]
    return out_re, out_im


def _channel_params(carrier_frequency, sampling_frequency, carrier_phase,
                   code_frequency, code_phase, d_min: int, device) -> torch.Tensor:
    """``[K, 4]`` f32 ``(f_cyc, phi_cyc, rho, phi_code)``; ``phi_code`` is the
    code phase at the earliest tap, ``code_phase + rho * d_min``."""
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=device)
    rho = rate(code_frequency, sampling_frequency, device)
    return torch.stack(
        [
            rate(carrier_frequency, sampling_frequency, device),
            f32(carrier_phase) / _TWO_PI_F32,
            rho,
            f32(code_phase) + rho * float(d_min),
        ],
        dim=-1,
    ).contiguous()


class BankShard(NamedTuple):
    """Time shard ``index`` of a mesh's sample axis, as a bank call in the
    state form takes it: the call's block is the piece ``[offset, offset +
    num_samples)`` of each antenna's row of the signal it is given, and its
    channels' phases are first advanced to the piece's first sample
    (`shard_phases`). ``n0`` is ``f32(index * num_samples)``,
    ``carrier_cycles`` and ``code_chips`` the f32 entries of
    `parallel.nominal_advance_tables` for this shard, ``inv_fs`` is
    ``f32(1 / fs)`` and ``code_length`` ``f32(Lc)``: Python floats, which a
    captured graph bakes (`parallel.time_shard` makes one)."""

    index: int
    num_samples: int
    offset: int
    n0: float
    carrier_cycles: float
    code_chips: float
    inv_fs: float
    code_length: float


def shard_phases(shard: BankShard, carrier_phase, code_phase, carrier_frequency,
                 code_frequency, nominal_carrier_frequency: float,
                 nominal_code_frequency: float):
    """Carrier phase (rad) and code phase (chips) advanced to ``shard``'s
    first sample: the nominal advance from its table entries, and only the
    Doppler residual ``(f - f_nom) / fs * n0`` in f32, in the JAX
    `advance_phases` operation order, then wrapped by `torch.remainder`.
    The channel values are f32 tensors of any shape; the constants enter as
    f32-valued Python floats, so nothing is copied to the device."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    dcar_cyc = (carrier_frequency - f32(nominal_carrier_frequency)) * shard.inv_fs * shard.n0
    cyc = shard.carrier_cycles + dcar_cyc
    cyc = cyc - torch.floor(cyc)
    carrier = torch.remainder(carrier_phase + _TWO_PI_F32 * cyc, _TWO_PI_F32)
    dcode = (code_frequency - f32(nominal_code_frequency)) * shard.inv_fs * shard.n0
    code = torch.remainder(code_phase + shard.code_chips + dcode, shard.code_length)
    return carrier, code


class BankChannels(NamedTuple):
    """A bank call's channels as a tracking state holds them: the state form
    of the registry signature's ``carrier_frequency``, ``carrier_phase``,
    ``code_frequency`` and ``code_phase``. Channel ``k`` of a ``K``-channel
    call takes ``intermediate_frequency + carrier_doppler[k mod K0]`` (the
    f32 add of the f32 nominal rate), ``carrier_phase[k mod K0]``,
    ``code_frequency + code_doppler[k mod K0]`` and ``code_phase[k mod
    K0]``, ``K0`` being the leaves' length: the dual bank's data and pilot
    channels read one state. Leaves: ``[K0]`` contiguous f32 tensors on the
    signal's device, which the kernels read where they lie (in a capture,
    the entry's carry). With a ``shard`` (a `BankShard`) the call is that
    time shard's: its piece of the block, its phases advanced to the
    piece."""

    intermediate_frequency: float
    carrier_doppler: torch.Tensor
    carrier_phase: torch.Tensor
    code_frequency: float
    code_doppler: torch.Tensor
    code_phase: torch.Tensor
    shard: BankShard | None = None


class _Source(ctypes.Structure):
    """csrc/bank.cuh's ``bank::Source``: where a launch reads its block and
    its channels' parameters."""

    _fields_ = [("params", ctypes.c_void_p), ("carrier_doppler", ctypes.c_void_p),
                ("carrier_phase", ctypes.c_void_p), ("code_doppler", ctypes.c_void_p),
                ("code_phase", ctypes.c_void_p), ("block_index", ctypes.c_void_p),
                ("block_stride", ctypes.c_longlong), ("sample_offset", ctypes.c_longlong),
                ("plane_stride", ctypes.c_longlong), ("inv_fs", ctypes.c_double),
                ("intermediate_frequency", ctypes.c_float), ("code_frequency", ctypes.c_float),
                ("inv_two_pi", ctypes.c_float), ("d_min", ctypes.c_float),
                ("modulus", ctypes.c_int), ("shard", ctypes.c_int),
                ("shard_n0", ctypes.c_float), ("shard_carrier", ctypes.c_float),
                ("shard_code", ctypes.c_float), ("shard_inv_fs", ctypes.c_float),
                ("shard_code_length", ctypes.c_float)]


# What `x / _TWO_PI_F32` multiplies an f32 tensor by on the card: the double
# reciprocal rounded to f32 (ops/loop_kernel._recip).
_INV_TWO_PI_F32 = float(np.float32(1.0 / _TWO_PI_F32))


class BankRowsCall:
    """Everything a bank kernel and its plain version take, computed once per
    call from the registry signature's arguments, or from its state form
    (``channels``, a `BankChannels`) and index form (``block_index``).

    ``route`` names the wrapper the call is for, ``pallas_bank_rows``,
    ``pallas_bank``, ``pallas_bank_onehot`` (no envelope) or
    ``pallas_bank_comp``: it picks the envelope that is enforced and the
    launch count that a launch adds to. The composite route
    evaluates its phases over ``N + span`` samples (`bank_comp`), so its tile
    base covers those. In the state form the channel parameters' positional
    arguments are ignored, the channel count is ``code_tiles``' (or the
    PRNs'), and ``params`` is computed only where a plain version asks for
    it. In the index form the signal is ``[chunk, (A,) N]`` and the block is
    its row ``block_index`` (an int64 0-d tensor on its device). With a
    `BankShard` in ``channels``, the block is the shard's piece of each
    antenna's row: ``num_samples`` is the piece's, ``plane_stride`` the
    row's and ``offset`` where the piece starts in it.
    """

    def __init__(self, signal_re, signal_im, codes, prn, carrier_frequency,
                 sampling_frequency, carrier_phase, code_frequency, code_phase,
                 sample_shifts, code_length, nominal_code_frequency=None,
                 nominal_carrier_frequency=0.0, max_chips_per_sample=None,
                 code_tiles=None, route="pallas_bank_rows", channels=None,
                 block_index=None):
        fs = float(sampling_frequency)
        span = int(max(sample_shifts)) - int(min(sample_shifts))
        if route == "pallas_bank":
            _check_transition_geometry(span, fs, nominal_code_frequency,
                                       max_chips_per_sample)
        elif route in ("pallas_bank_rows", "pallas_bank_comp"):
            _check_rows_geometry(fs, nominal_code_frequency, max_chips_per_sample)
        elif route != "pallas_bank_onehot":
            raise ValueError(f"unknown bank route {route!r}")
        self.route = route
        self.span = span
        self.fs = fs
        self.block_index = block_index
        self.squeeze = signal_re.ndim == (1 if block_index is None else 2)
        if self.squeeze:
            signal_re, signal_im = signal_re.unsqueeze(-2), signal_im.unsqueeze(-2)
        self.sre, self.sim = signal_re, signal_im       # [A, N], or the chunk [chunk, A, N]
        self.device = signal_re.device
        self.num_ants, self.plane_stride = signal_re.shape[-2:]
        self.num_samples, self.offset = self.plane_stride, 0
        shard = None if channels is None else channels.shard
        if shard is not None:
            self.num_samples, self.offset = int(shard.num_samples), int(shard.offset)
            if self.num_samples < 1 or self.offset < 0 \
                    or self.offset + self.num_samples > self.plane_stride:
                raise ValueError(f"time shard {shard.index}'s piece [{self.offset}, "
                                 f"{self.offset + self.num_samples}) is not inside the "
                                 f"block's {self.plane_stride} samples")
        self.d_min = int(min(sample_shifts))
        self.deltas = tuple(int(d) - self.d_min for d in sample_shifts)
        self.code_length = int(code_length)
        prn = torch.as_tensor(prn, device=self.device)
        self.code_tiles = (prepare_bank_code_tiles_rows(codes, prn)
                           if code_tiles is None else code_tiles)
        self.channels = channels
        if channels is None:
            self.params = _channel_params(carrier_frequency, fs, carrier_phase,
                                         code_frequency, code_phase, self.d_min,
                                         self.device)
            self.num_k = self.params.shape[0]
        else:
            self.num_k = self.code_tiles.shape[0]
        phase_samples = self.num_samples + (span if route == "pallas_bank_comp" else 0)
        self.num_tiles = -(-phase_samples // TILE)
        self.rho_nom = (float(nominal_code_frequency) / fs
                        if nominal_code_frequency is not None else 0.0)
        self.fcar_nom_cyc = float(nominal_carrier_frequency) / fs
        self.base = _tile_base(self.num_tiles, TILE, self.fcar_nom_cyc,
                               self.rho_nom, self.code_length, self.device)

    @functools.cached_property
    def params(self) -> torch.Tensor:
        """``[K, 4]`` `_channel_params` of the state form's expressions (the
        registry signature's call sets its own in ``__init__``)."""
        ch = self.channels
        f_car = ch.intermediate_frequency + ch.carrier_doppler
        f_code = ch.code_frequency + ch.code_doppler
        phi_car, phi_code = ch.carrier_phase, ch.code_phase
        if ch.shard is not None:
            phi_car, phi_code = shard_phases(ch.shard, phi_car, phi_code, f_car, f_code,
                                             ch.intermediate_frequency, ch.code_frequency)
        params = _channel_params(f_car, self.fs, phi_car, f_code, phi_code, self.d_min,
                                 self.device)
        return params.repeat(self.num_k // params.shape[0], 1)

    def planes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The block's ``[A, N]`` planes; in the index form the chunk's row
        at ``block_index``, by `index_select` (the plain versions' read); a
        time shard's piece of it, by a slice."""
        planes = (self.sre, self.sim)
        if self.block_index is not None:
            index = self.block_index.view(1)
            planes = tuple(torch.index_select(x, 0, index)[0] for x in planes)
        if self.num_samples != self.plane_stride:
            planes = tuple(x[..., self.offset:self.offset + self.num_samples] for x in planes)
        return planes

    def source(self) -> _Source:
        """The kernels' `_Source`: the block's row in the chunk, the
        parameter table or the state leaves and the constants that the
        kernels derive each channel's parameters with."""
        src = _Source()
        if self.block_index is not None:
            src.block_index = self.block_index.data_ptr()
            src.block_stride = self.num_ants * self.plane_stride
        src.sample_offset = self.offset
        src.plane_stride = self.plane_stride
        ch = self.channels
        if ch is None:
            src.params = self.params.data_ptr()
            return src
        if ch.shard is not None:
            src.shard = 1
            src.shard_n0 = ch.shard.n0
            src.shard_carrier = ch.shard.carrier_cycles
            src.shard_code = ch.shard.code_chips
            src.shard_inv_fs = ch.shard.inv_fs
            src.shard_code_length = ch.shard.code_length
        src.carrier_doppler = ch.carrier_doppler.data_ptr()
        src.carrier_phase = ch.carrier_phase.data_ptr()
        src.code_doppler = ch.code_doppler.data_ptr()
        src.code_phase = ch.code_phase.data_ptr()
        src.inv_fs = 1.0 / self.fs
        src.intermediate_frequency = ch.intermediate_frequency
        src.code_frequency = ch.code_frequency
        src.inv_two_pi = _INV_TWO_PI_F32
        src.d_min = float(self.d_min)
        src.modulus = ch.carrier_doppler.shape[0]
        return src

    def finish(self, acc_re, acc_im):
        if self.squeeze:
            return acc_re[:, 0], acc_im[:, 0]
        return acc_re, acc_im


def sum_in_order(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` on ``device``, in that order (the port's
    ``psum``): each part is copied there first, a no-op where it lies."""
    total = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        total = total + p.to(device, non_blocking=True)
    return total


class ShardSum:
    """Where the time shards of one channel shard's bank call meet (the
    port's ``psum`` over ``time``): the call of each shard ``t`` (a
    `BankShard` in its ``channels``) given this as ``shard_sum=`` leaves its
    result here, and `finish` returns ``(r_0 + r_1) + r_2 ...``, the time
    shards' results added in shard order (`sum_in_order`'s order).

    ``device`` is each time shard's device (a list), or one device that
    runs every shard. Every one of them holds every shard's result, and
    ``finish(device)`` runs on the device given, as the JAX package's
    ``psum`` leaves the sum on every time shard (on distinct cards each
    closes its channel shard's loop on its own replica of the carry: the
    same kernels on the same slots, so the same result, bit for bit).

    CPU calls leave their plain versions' results, which `finish` adds with
    torch ops. CUDA calls launch their bank kernel alone, which writes its
    partials into shard t's slot of one ``[T, ...]`` buffer per launch group
    on its device; the first `finish` copies each shard's partials into its
    slot on every other device, after every shard's launch, so no card's
    launch waits for another's. `finish` is one finish kernel per launch
    group, which sums each shard's partials as a call's own finish does and
    adds the shards' results in shard order, with no atomics, through the
    call of the device's first shard. Shard t's call runs on its device,
    and every shard's call comes before `finish`."""

    def __init__(self, num_shards: int, device):
        self.num_shards = int(num_shards)
        if not isinstance(device, (list, tuple)):
            device = [device] * self.num_shards
        self.shard_devices = [self._device(d) for d in device]
        if len(self.shard_devices) != self.num_shards:
            raise ValueError(f"{len(self.shard_devices)} devices for {self.num_shards} "
                             "time shards")
        self.holders = list(dict.fromkeys(self.shard_devices))   # each holds every result
        self.device = self.holders[0]
        self.added: set = set()      # the shards whose calls came
        self.results: dict = {}      # CPU: shard -> its (re, im)
        self.partials: dict = {}     # CUDA: (holder, launch group) -> [T, ...] partials
        self.finishers: dict = {}    # CUDA: (holder, launch group) -> finish of its buffer
        self.leads: dict = {}        # holder -> its first shard's call (its finish and shape)
        self.pending: list = []      # CUDA: (shard, group, partial) still to copy

    @staticmethod
    def _device(device) -> torch.device:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu") if device.type == "cpu" else device

    def _shard(self, bank: "BankRowsCall") -> int:
        shard = None if bank.channels is None else bank.channels.shard
        if shard is None:
            raise ValueError("a call with a shard_sum is a time shard's: channels=BankChannels("
                             "..., shard=BankShard(...))")
        t = int(shard.index)
        if not 0 <= t < self.num_shards:
            raise ValueError(f"time shard {t} of {self.num_shards}")
        if bank.device != self.shard_devices[t]:
            raise ValueError(f"time shard {t} runs on {self.shard_devices[t]}, "
                             f"not {bank.device}")
        lead = self.leads.get(bank.device)
        if lead is None or t < int(lead.channels.shard.index):
            self.leads[bank.device] = bank
        self.added.add(t)
        return t

    def add(self, bank: "BankRowsCall", result: tuple) -> None:
        """A plain version's finished result of a time shard's call."""
        self.results[self._shard(bank)] = result

    def slot(self, bank: "BankRowsCall", group, shape: tuple, finisher=None) -> torch.Tensor:
        """Where the bank kernel of the call ``bank`` writes the ``shape``
        partials of launch group ``group``: its shard's slot of the group's
        buffer on its device. The call a device takes its finish from gives
        the group's ``finisher(buffer) -> (re, im)`` there."""
        t = self._shard(bank)
        for holder in self.holders:
            if (holder, group) not in self.partials:
                self.partials[holder, group] = torch.empty(
                    (self.num_shards,) + tuple(shape), dtype=torch.float32, device=holder)
        if self.leads[bank.device] is bank:
            self.finishers[bank.device, group] = finisher
        return self.partials[bank.device, group][t]

    def copy_in(self, bank: "BankRowsCall", group, partial: torch.Tensor) -> None:
        """``partial``, shard t's, into its slot on every other device, at
        the first `finish`."""
        self.pending.append((self._shard(bank), group, partial))

    def _share(self) -> None:
        """Each pending shard's partials into its slot on every other
        device (a peer copy on its card), after every shard's launch."""
        for t, group, partial in self.pending:
            for holder in self.holders:
                dst = self.partials[holder, group][t]
                if partial.data_ptr() != dst.data_ptr():
                    dst.copy_(partial, non_blocking=True)
        self.pending = []

    def finish(self, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The time shards' results added in shard order, on ``device`` (a
        time shard's device; the first by default)."""
        if len(self.added) != self.num_shards:
            raise ValueError(f"{len(self.added)} of {self.num_shards} time shards have "
                             "their results in the sum")
        device = self.device if device is None else self._device(device)
        if device not in self.holders:
            raise ValueError(f"{device} holds no time shard's results: {self.holders}")
        if not self.partials:
            parts = [self.results[t] for t in range(self.num_shards)]
            return tuple(sum_in_order([p[i] for p in parts], device) for i in range(2))
        self._share()
        bank = self.leads[device]
        return bank.finish(*split_launches(
            lambda a0, a1, taps: self.finishers[device, (a0, a1, taps)](
                self.partials[device, (a0, a1, taps)]),
            bank.num_ants, len(bank.deltas), (bank.num_k,), device))


def _tile_phases(bank: BankRowsCall, k0: int, k1: int):
    """Channels ``k0:k1``'s f32 phases at each phase-tile start: the carrier
    cycles ``ph_car`` and the code phase's whole chips ``c0`` and fraction,
    each ``[kc, nt]``."""
    dev = bank.device
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    n0 = torch.arange(bank.num_tiles, dtype=torch.float32, device=dev) * TILE
    lc = f32(float(bank.code_length))
    f_cyc, phi_cyc, rho, phi_code = bank.params[k0:k1].unbind(-1)
    ph_car = ((phi_cyc[:, None] + bank.base[None, :, 0])
              + (f_cyc - f32(bank.fcar_nom_cyc))[:, None] * n0[None, :])
    pc = ((phi_code[:, None] + bank.base[None, :, 1])
          + (rho - f32(bank.rho_nom))[:, None] * n0[None, :])
    pc = pc - lc * torch.floor(pc / lc)
    pc_whole = torch.floor(pc)
    return ph_car, pc_whole, pc - pc_whole


def _row_lane_carrier(f_cyc: torch.Tensor, ph_car: torch.Tensor):
    """``(cos, sin)`` ``[kc, nt, TILE]`` of the carrier at each tile sample
    ``j = 128 r + i``: the row phasor ``e^{2 pi i frac(128 r f + ph_car)}``
    times the lane phasor ``e^{2 pi i frac(f i)}``, one transcendental per row
    and per lane, as the JAX bank kernels build it."""
    dev = f_cyc.device
    n_row = torch.arange(0, TILE, _LANES, dtype=torch.float32, device=dev)
    cyc = n_row * f_cyc[:, None, None] + ph_car[:, :, None]                  # [kc, nt, R]
    theta = (cyc - torch.floor(cyc)) * _TWO_PI_F32
    row_c, row_s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    cyc = f_cyc[:, None] * torch.arange(_LANES, dtype=torch.float32, device=dev)
    theta = (cyc - torch.floor(cyc)) * _TWO_PI_F32                           # [kc, 128]
    lane_c, lane_s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    cos = row_c * lane_c - row_s * lane_s
    sin = row_s * lane_c + row_c * lane_s
    return cos.flatten(-2), sin.flatten(-2)


def _replica_chips(rho: torch.Tensor, pc_whole: torch.Tensor, pc_frac: torch.Tensor,
                   length: int, code_length: int) -> torch.Tensor:
    """The replica row: chip index ``(floor(m * rho + frac) + c0) mod Lc`` of
    every phase-tile position ``m`` in ``[0, length)``, ``[kc, nt, length]``."""
    m = torch.arange(length, dtype=torch.float32, device=rho.device)
    x = m * rho[:, None, None] + pc_frac[:, :, None]
    chip = torch.floor(x).long() + pc_whole.long()[:, :, None]
    return torch.remainder(chip, code_length)


def _replica_chips_from_runs(rho: torch.Tensor, pc_whole: torch.Tensor,
                             pc_frac: torch.Tensor, span: int,
                             code_length: int) -> torch.Tensor:
    """`_replica_chips` as ``csrc/bank_rows.cu`` builds them from the chips'
    boundaries, ``[kc, nt, TILE // ROWS_TILE, ROWS_TILE + span]``: the row
    of each kernel tile (``j0 = 0, ROWS_TILE, ...`` of each phase tile). Per
    group of 32 positions, the chips at its ends; each chip ``c`` that
    starts inside it starts at the first position whose chip reaches ``c``,
    found from the estimate ``ceil((c - c0 - frac) / rho) - j0`` and then
    moved by the formula itself. A plain version of the kernel's search, on
    no path of its own."""
    dev = rho.device
    width = ROWS_TILE + span
    j0 = torch.arange(0, TILE, ROWS_TILE, device=dev)[:, None]             # [R, 1]
    rho4, frac4 = rho[:, None, None, None], pc_frac[:, :, None, None]
    whole4 = pc_whole.long()[:, :, None, None]

    def chip(m: torch.Tensor) -> torch.Tensor:
        return torch.floor((j0 + m).float() * rho4 + frac4).long() + whole4

    p0 = torch.arange(0, width, 32, device=dev)                              # [G]
    last = torch.clamp(p0 + 31, max=width - 1)
    c_lo, c_hi = chip(p0), chip(last)                                        # [kc, nt, R, G]
    inv_rho = torch.reciprocal(rho4)
    lo, hi = (p0 + 1).expand_as(c_lo), last.expand_as(c_lo)
    m = torch.arange(width, device=dev)
    row = c_lo[..., m // 32]
    starts = int((c_hi - c_lo).max()) if c_lo.numel() else 0    # chips starting in a group
    for i in range(1, starts + 1):
        c = c_lo + i
        live = c <= c_hi
        x = ((c - whole4).float() - frac4) * inv_rho
        b = torch.ceil(x - j0.float()).clamp(-1.0, float(width)).long()
        b = torch.minimum(torch.maximum(b, lo), hi)
        while True:
            down = live & (b > lo) & (chip(b - 1) >= c)
            if not down.any():
                break
            b = b - down.long()
        while True:
            up = live & (chip(b) < c)
            if not up.any():
                break
            b = b + up.long()
        start = torch.where(live, b, width)
        row = row + (start[..., m // 32] <= m).long()
    return torch.remainder(row, code_length)


def rows_min_run(rho_nom: float) -> int:
    """The ``min_run`` a ``csrc/bank_rows.cu`` launch passes at the nominal
    rate ``rho_nom`` (chips a sample): `MIN_CHIP_RUN` where a chip lasts at
    least that many samples, and the kernel builds each channel's rows from
    the chip boundaries (where its own rate gives chips that long);
    else 0, the per-position build (high chip rates, and a launch without a
    nominal rate)."""
    return MIN_CHIP_RUN if 0.0 < rho_nom * MIN_CHIP_RUN <= 1.0 else 0


def _bank_rows_plain(bank: BankRowsCall) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample PyTorch evaluation of the kernel's formula, chunked over
    channels: the row x lane carrier and one replica row of ``TILE + span``
    chips per tile, which tap l reads at offset ``delta_l``."""
    dev, tile, nt, span = bank.device, TILE, bank.num_tiles, bank.span
    pad = nt * tile - bank.num_samples
    sre, sim = bank.planes()
    s_re = torch.nn.functional.pad(sre, (0, pad)).view(bank.num_ants, nt, tile)
    s_im = torch.nn.functional.pad(sim, (0, pad)).view(bank.num_ants, nt, tile)
    num_taps = len(bank.deltas)
    out_re = torch.empty(bank.num_k, bank.num_ants, num_taps, dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    cols = unpack_code_columns(bank.code_tiles, bank.code_length)
    per_chunk = max(1, _CHUNK_ELEMENTS // (nt * (tile + span) * bank.num_ants))
    for k0 in range(0, bank.num_k, per_chunk):
        k1 = min(k0 + per_chunk, bank.num_k)
        ph_car, pc_whole, pc_frac = _tile_phases(bank, k0, k1)
        cos, sin = _row_lane_carrier(bank.params[k0:k1, 0], ph_car)
        cos, sin = cos.unsqueeze(1), sin.unsqueeze(1)
        dw_re = s_re * cos + s_im * sin                                  # [kc, A, nt, T]
        dw_im = s_im * cos - s_re * sin
        chip = _replica_chips(bank.params[k0:k1, 2], pc_whole, pc_frac, tile + span,
                              bank.code_length)
        rep = torch.gather(cols[k0:k1], 1, chip.view(k1 - k0, -1))
        rep = rep.view(k1 - k0, 1, nt, tile + span)
        for l, delta in enumerate(bank.deltas):
            tap = rep[..., delta:delta + tile]
            out_re[k0:k1, :, l] = (dw_re * tap).sum(dim=(-2, -1))
            out_im[k0:k1, :, l] = (dw_im * tap).sum(dim=(-2, -1))
    return out_re, out_im


def _check_kernel_inputs(bank: BankRowsCall, kernel: str = "bank_rows") -> None:
    words = -(-bank.code_length // 32)
    if bank.code_tiles.shape != (bank.num_k, words):
        raise ValueError(
            f"code_tiles shape {tuple(bank.code_tiles.shape)} != {(bank.num_k, words)}: "
            "pass prepare_bank_code_tiles_rows output"
        )
    tensors = {"signal_re": (bank.sre, torch.float32), "signal_im": (bank.sim, torch.float32),
               "code_tiles": (bank.code_tiles, torch.int32)}
    if bank.channels is None:
        tensors["params"] = (bank.params, torch.float32)
    else:
        leaves = {name: getattr(bank.channels, name) for name in
                  ("carrier_doppler", "carrier_phase", "code_doppler", "code_phase")}
        tensors.update((name, (x, torch.float32)) for name, x in leaves.items())
        shapes = {tuple(x.shape) for x in leaves.values()}
        num_k0 = next(iter(shapes))
        if len(shapes) != 1 or len(num_k0) != 1 or num_k0[0] == 0 or bank.num_k % num_k0[0]:
            raise ValueError(f"the state form's leaves are [K0] with K0 dividing "
                             f"K={bank.num_k}, got shapes {sorted(shapes)}")
    if bank.block_index is not None:
        tensors["block_index"] = (bank.block_index, torch.int64)
        if bank.block_index.ndim != 0:
            raise ValueError("block_index is an int64 0-d tensor")
    for name, (t, dtype) in tensors.items():
        if t.device != bank.device:
            raise ValueError(f"{name} is on {t.device}, the signal on {bank.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {str(dtype).split('.')[-1]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bank.sim.shape != bank.sre.shape:
        raise ValueError(f"signal planes differ: {tuple(bank.sre.shape)} vs "
                         f"{tuple(bank.sim.shape)}")
    if bank.code_length > MAX_CODE_LENGTH:
        raise ValueError(f"code_length {bank.code_length} > {MAX_CODE_LENGTH}")
    if bank.span > MAX_SPAN:
        raise ValueError(f"{kernel} kernel takes a tap span <= {MAX_SPAN}, got {bank.span}")
    if bank.plane_stride >= 1 << 24 or bank.num_k > 65535:
        raise ValueError(f"{kernel} kernel takes N < 2^24 and K <= 65535")


def correlate_bank_rows_reference(
    signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
    carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
    nominal_code_frequency=None, nominal_carrier_frequency=0.0,
    max_chips_per_sample=None, code_tiles=None, route="pallas_bank_rows",
    channels=None, block_index=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `correlate_pallas_bank_rows`, on any device.

    It is the plain version of `correlate_pallas_bank` and
    `correlate_pallas_bank_onehot` too, on those routes' envelopes:
    ``route="pallas_bank"`` or ``route="pallas_bank_onehot"`` (the latter
    without nominal rates).
    """
    bank = BankRowsCall(signal_re, signal_im, codes, prn, carrier_frequency,
                        sampling_frequency, carrier_phase, code_frequency,
                        code_phase, sample_shifts, code_length,
                        nominal_code_frequency, nominal_carrier_frequency,
                        max_chips_per_sample, code_tiles, route, channels, block_index)
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
    channels: BankChannels | None = None,
    block_index: torch.Tensor | None = None,
    shard_sum: ShardSum | None = None,
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """K-channel EPL bank against one shared ``[N]`` / ``[A, N]`` block.

    Returns ``[K, L]`` / ``[K, A, L]`` f32 accumulators. CPU tensors run the
    plain version; CUDA tensors launch ``csrc/bank_rows.cu`` or raise.
    ``code_tiles``: `prepare_bank_code_tiles_rows` output, hoisted by loops.
    ``channels`` (the state form, a `BankChannels`) replaces the four channel
    parameters, which may then be None; with ``block_index`` the signal is
    ``[chunk, (A,) N]`` and the block its row at that index (see the module).
    A time shard's call (a `BankShard` in ``channels``) given a ``shard_sum``
    (a `ShardSum`) leaves its result there and returns None.
    """
    return _run_bank_rows(BankRowsCall(
        signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
        carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
        nominal_code_frequency, nominal_carrier_frequency, max_chips_per_sample,
        code_tiles, "pallas_bank_rows", channels, block_index), shard_sum)


def _run_bank_rows(bank: BankRowsCall, shard_sum: ShardSum | None = None):
    if bank.device.type == "cpu":
        return deliver(bank, bank.finish(*_bank_rows_plain(bank)), shard_sum)
    if bank.device.type != "cuda":
        raise ValueError(f"{bank.route} runs on CPU or CUDA tensors, not {bank.device}")
    if shard_sum is not None:
        launch_bank_rows(bank, shard_sum)
        return None
    return bank.finish(*launch_bank_rows(bank))


def deliver(bank: BankRowsCall, result: tuple, shard_sum: ShardSum | None):
    """A plain version's ``result``: returned, or left in ``shard_sum``."""
    if shard_sum is None:
        return result
    shard_sum.add(bank, result)
    return None


def launch_bank_rows(bank: "BankRowsCall", shard_sum: ShardSum | None = None):
    """Launch ``csrc/bank_rows.cu`` for a prepared call on CUDA tensors.

    Returns ``[K, A, L]`` accumulators and adds one to the launch count of the
    call's route (``correlate_pallas_bank_rows.launches``,
    ``correlate_pallas_bank.launches`` or
    ``correlate_pallas_bank_onehot.launches``) per launch: one inside the
    kernel's instantiations, else one per group of `launch_groups`; and one
    to ``boundary_rows.launches`` or ``position_rows.launches``, the row
    build the launch asks for (`rows_min_run`). With a
    ``shard_sum`` (a time shard's call) each launch writes only its partials
    there and nothing is returned: `ShardSum.finish` sums them. Raises on
    anything the kernel does not take, and if a launch fails.
    """
    if bank.device.type != "cuda":
        raise ValueError(f"the bank_rows kernel takes CUDA tensors, not {bank.device}")
    wrapper = _ROWS_KERNEL_ROUTES.get(bank.route)
    if wrapper is None:
        raise ValueError(f"the bank_rows kernel does not serve route {bank.route!r}")
    _check_kernel_inputs(bank)
    lib = _build.load_library("bank_rows")
    source = bank.source()
    num_ctiles = -(-bank.num_samples // ROWS_TILE)     # partials: at most one per tile
    min_run = rows_min_run(bank.rho_nom)
    build = boundary_rows if min_run else position_rows
    stream = torch.cuda.current_stream(bank.device).cuda_stream

    def finisher(a0, a1, taps):
        # The finish of launch group (a0, a1, taps) over the partials
        # `partial` ([T, ...], shard t's at t * partial.stride(0)).
        def run(partial):
            shape = (bank.num_k, a1 - a0, len(taps))
            out_re = torch.empty(shape, dtype=torch.float32, device=bank.device)
            out_im = torch.empty(shape, dtype=torch.float32, device=bank.device)
            err = lib.bank_rows_finish_launch(
                partial.data_ptr(), partial.stride(0), partial.shape[0], out_re.data_ptr(),
                out_im.data_ptr(), a1 - a0, len(taps), bank.num_samples, bank.num_k, TILE,
                torch.cuda.current_stream(bank.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"bank_rows_finish_launch failed with CUDA error {err}")
            return out_re, out_im

        return run

    def launch(a0, a1, taps):
        # Antennas a0:a1 against the taps indexed by `taps`, with the call's
        # span and phase origin (params, base): the unsplit call's chips.
        deltas = tuple(bank.deltas[i] for i in taps)
        shape = (bank.num_k, a1 - a0, len(deltas))
        part_shape = shape[:1] + (num_ctiles,) + shape[1:] + (2,)
        if shard_sum is None:
            out_re = torch.empty(shape, dtype=torch.float32, device=bank.device)
            out_im = torch.empty(shape, dtype=torch.float32, device=bank.device)
            partial = torch.empty(part_shape, dtype=torch.float32, device=bank.device)
        else:
            out_re = out_im = None
            partial = shard_sum.slot(bank, (a0, a1, taps), part_shape, finisher(a0, a1, taps))
        row = 4 * a0 * bank.plane_stride                 # bytes to antenna a0's plane
        err = lib.bank_rows_launch(
            bank.sre.data_ptr() + row, bank.sim.data_ptr() + row, bank.code_tiles.data_ptr(),
            ctypes.addressof(source), bank.base.data_ptr(),
            _deltas(deltas, bank.device).data_ptr(), partial.data_ptr(),
            None if out_re is None else out_re.data_ptr(),
            None if out_im is None else out_im.data_ptr(), a1 - a0, len(deltas),
            bank.num_samples, bank.num_k, bank.code_length, TILE, bank.span,
            ctypes.c_float(bank.rho_nom), ctypes.c_float(bank.fcar_nom_cyc), min_run, stream,
        )
        if err != 0:
            raise RuntimeError(f"bank_rows_launch failed with CUDA error {err}")
        wrapper.launches += 1
        build.launches += 1
        if shard_sum is not None:
            shard_sum.copy_in(bank, (a0, a1, taps), partial)
        return out_re, out_im

    if shard_sum is not None:
        for a0, a1, taps in launch_groups(bank.num_ants, len(bank.deltas)):
            launch(a0, a1, taps)
        return None
    return split_launches(launch, bank.num_ants, len(bank.deltas), (bank.num_k,), bank.device)


def launch_channel_params(bank: "BankRowsCall") -> torch.Tensor:
    """``[K, 4]`` f32 channel parameters ``(f_cyc, phi_cyc, rho, phi_code)``
    as the bank kernels derive them on the card from the call's `_Source`
    (a time shard's advance included): one launch of ``csrc/bank_rows.cu``'s
    parameter kernel, a check of the kernels' arithmetic against
    ``bank.params``, on no path of its own and counted nowhere."""
    if bank.device.type != "cuda":
        raise ValueError(f"the parameter kernel takes CUDA tensors, not {bank.device}")
    _check_kernel_inputs(bank)
    out = torch.empty((bank.num_k, 4), dtype=torch.float32, device=bank.device)
    source = bank.source()
    err = _build.load_library("bank_rows").bank_params_launch(
        ctypes.addressof(source), out.data_ptr(), bank.num_k,
        torch.cuda.current_stream(bank.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bank_params_launch failed with CUDA error {err}")
    return out


correlate_pallas_bank_rows.launches = 0


class LaunchCount:
    """A count of launches kept as the wrappers keep theirs (``launches``),
    which a replayed graph moves as it moves theirs
    (`tracking.graphs._counters`)."""

    def __init__(self):
        self.launches = 0


# bank_rows launches that build the replica rows from the chip boundaries,
# and those that keep the per-position build (`rows_min_run`).
boundary_rows = LaunchCount()
position_rows = LaunchCount()


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
    channels: BankChannels | None = None,
    block_index: torch.Tensor | None = None,
    shard_sum: ShardSum | None = None,
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """K-channel EPL bank in the transition kernel's regime (< 1 chip/sample).

    The contract and envelope of the JAX `correlate_pallas_bank`: tap span
    < 128 samples and < 1 chip per sample, else `ValueError`. CPU tensors run
    the plain version; CUDA tensors launch ``csrc/bank_rows.cu`` (whose
    per-sample chip lookup covers any chip rate below one per sample) and add
    one to ``correlate_pallas_bank.launches``, or raise. ``channels``,
    ``block_index`` and ``shard_sum``: as in `correlate_pallas_bank_rows`.
    """
    return _run_bank_rows(BankRowsCall(
        signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
        carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
        nominal_code_frequency, nominal_carrier_frequency, max_chips_per_sample,
        code_tiles, "pallas_bank", channels, block_index), shard_sum)


correlate_pallas_bank.launches = 0


def correlate_pallas_bank_onehot(
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
    code_tiles: torch.Tensor | None = None,
    channels: BankChannels | None = None,
    block_index: torch.Tensor | None = None,
    shard_sum: ShardSum | None = None,
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """K-channel EPL bank with a per-sample chip lookup, at any tap span and
    chip rate.

    The contract of the JAX `correlate_pallas_bank_onehot`: no envelope and
    no nominal rates, so every phase is the channel's f32 phase from the
    block start. CPU tensors run the plain version; CUDA tensors launch
    ``csrc/bank_rows.cu`` (whose shared-memory lookup is the one-hot gather's
    counterpart) and add one to ``correlate_pallas_bank_onehot.launches``, or
    raise. ``code_tiles``: `prepare_bank_code_tiles_rows` output;
    ``channels``, ``block_index`` and ``shard_sum``: as in
    `correlate_pallas_bank_rows`.
    """
    return _run_bank_rows(BankRowsCall(
        signal_re, signal_im, codes, prn, carrier_frequency, sampling_frequency,
        carrier_phase, code_frequency, code_phase, sample_shifts, code_length,
        code_tiles=code_tiles, route="pallas_bank_onehot", channels=channels,
        block_index=block_index), shard_sum)


correlate_pallas_bank_onehot.launches = 0

# The routes the bank_rows kernel serves, and whose launch count it adds to.
_ROWS_KERNEL_ROUTES = {
    "pallas_bank_rows": correlate_pallas_bank_rows,
    "pallas_bank": correlate_pallas_bank,
    "pallas_bank_onehot": correlate_pallas_bank_onehot,
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
    channels: BankChannels | None = None,
    block_index: torch.Tensor | None = None,
    shard_sum: ShardSum | None = None,
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """Bank correlator with per-scenario kernel selection (`bank_algorithm_for`).

    ``z_dtype`` (``torch.bfloat16`` or ``"bf16"``) asks for the composite
    kernel's bf16 planes; where the scenario resolves to another kernel, that
    is said with a `UserWarning` and the bank runs in f32. ``channels``,
    ``block_index`` and ``shard_sum``: as in `correlate_pallas_bank_rows`.
    """
    block_ndim = signal_re.ndim - (block_index is not None)
    algo = bank_algorithm_for(
        signal_re.shape[-1], float(sampling_frequency), code_length,
        nominal_code_frequency, max_chips_per_sample,
        num_ants=signal_re.shape[-2] if block_ndim == 2 else 1,
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
        channels=channels, block_index=block_index, shard_sum=shard_sum, **extra,
    )


registry.register("pallas_bank", correlate_pallas_bank)
registry.register("pallas_bank_onehot", correlate_pallas_bank_onehot)
registry.register("pallas_bank_rows", correlate_pallas_bank_rows)
registry.register("pallas_bank_auto", correlate_pallas_bank_auto)
