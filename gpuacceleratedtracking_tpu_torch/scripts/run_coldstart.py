"""Cold-start receiver end to end: int8 IQ captures -> native C++ decode ->
PCPS acquisition -> secondary-code sync -> closed-loop tracking ->
observables. The port's ``scripts/run_coldstart.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.run_coldstart [--cpu] [--capture-dir DIR]

No knowledge enters beyond the PRN search list:

1. synthesize deterministic int8 captures (seeded AWGN, quantized like an RF
   front end): GPS L1 C/A at 8.192 MHz with 4 satellites; GPS L5 at
   32.768 MHz with 2 satellites (I5 data x NH10 x 100 sps nav symbols, and
   the Q5 pilot x NH20 in quadrature); BeiDou B1I D1 at 8.192 MHz with 2
   satellites (primary x NH20 x 50 bps nav bits, bit edges on the NH cycle);
2. decode blocks through `runtime.IQFile` (native ``libiqstream``);
3. PCPS-acquire (`acquire.acquire`, noncoherent rounds) over every PRN,
   accepted by deflection metric;
4. L1: `runtime.StreamTracker` on the rows route, with a checkpoint mid-run
   and a cold resume from it in a new tracker;
5. L5: pilot pull-in -> `tracking.detect_secondary_offset` (NH20 sync) ->
   dual-component track (`tracking.track_bank_dual`) and nav symbols;
6. B1I: Costas pull-in -> NH20 sync over bit-aligned windows
   (`tracking.detect_secondary_offset_windowed`) -> NH-wiped track and nav
   bits;
7. write ``data/torch/coldstart/observables.json``, the curves beside it
   (``curves.npz``) and ``img/torch/coldstart_pipeline.png`` (where
   matplotlib is installed; ``--figure`` draws it later from the curves).

Runs on the card; ``--cpu`` asks for the CPU. Captures are written to
``--capture-dir`` (default ``data/torch/coldstart/captures/``, not
committed) unless they are there already.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import time

import numpy as np
import torch

from ..acquire import acquire, to_track_states
from ..bench.harness import add_metadata
from ..models import BeiDouB1I, GPSL1, GPSL5, gen_signal
from ..runtime import IQFile, StreamTracker, blocks, native_available
from ..tracking import (
    TrackConfig,
    detect_secondary_offset,
    detect_secondary_offset_windowed,
    dual_config,
    init_state,
    track_bank,
    track_bank_dual,
)
from . import DATA, IMG

OUT_DATA = DATA / "coldstart"
CAPTURES = OUT_DATA / "captures"
CAPTURE_NAMES = {"l1": "gpsl1_8192kHz.int8", "l5": "gpsl5_32768kHz.int8",
                 "b1i": "bdsb1i_8192kHz.int8"}

# --- capture truth (planted by the synthesis; reported for the reader, never
# fed to acquisition or tracking) ---
L1 = dict(
    fs=8.192e6, n=8192, ms=600, prns=[2, 7, 13, 21],
    dops=[-2400.0, -700.0, 850.0, 3100.0],
    phases=[120.0, 512.3, 41.7, 987.2],
    sigma=11.4,          # ~45 dB-Hz per satellite at 8.192 MHz
    scale=3.7,           # int8 LSBs per unit amplitude (clips at ~3 sigma)
)
L5 = dict(
    fs=32.768e6, n=32768, ms=280, prns=[4, 11],
    dops=[-1600.0, 2200.0],
    phases=[2048.0, 7777.5],
    nh_phase=[3, 7],     # planted NH overlay offsets (blocks)
    sigma=22.8,          # ~45 dB-Hz per component at 32.768 MHz
    scale=1.8,
)
B1I = dict(
    fs=8.192e6, n=8192, ms=400, prns=[8, 25],
    dops=[-1800.0, 950.0],
    phases=[333.4, 1402.1],
    nh_phase=[5, 12],
    sigma=11.4,          # ~45 dB-Hz per satellite at 8.192 MHz
    scale=3.7,
)
# Seeds of the front-end noise per capture, and of the planted nav data.
NOISE_SEEDS = {"l1": 11, "l5": 56, "b1i": 78}
NAV_SEED = 55
BITS_SEED = 77
ACCEPT = 20.0        # deflection metric: noise-only maxima ~5, C/A impostors ~10


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"cold start: {what}")


def l5_nav() -> np.ndarray:
    """The L5 leg's nav symbol per millisecond (100 sps)."""
    rng = np.random.default_rng(NAV_SEED)
    return np.repeat(rng.choice([-1.0, 1.0], L5["ms"] // 10), 10)


def b1i_bits() -> list:
    """The B1I leg's 50 bps nav bits, one array per satellite, bit ``j``
    covering blocks ``p`` with ``(p + nh0) // 20 == j``."""
    rng = np.random.default_rng(BITS_SEED)
    return [rng.choice([-1.0, 1.0], B1I["ms"] // 20 + 2) for _ in B1I["prns"]]


def signal_l1(ms: int | None = None, device="cuda") -> np.ndarray:
    """The first ``ms`` milliseconds (all by default) of the L1 capture's
    noiseless complex signal."""
    ms = L1["ms"] if ms is None else ms
    system = GPSL1()
    total = None
    for prn, dop, phi in zip(L1["prns"], L1["dops"], L1["phases"]):
        s, _ = gen_signal(system, prn, dop, L1["n"] * ms, duration=ms * 1e-3,
                          start_code_phase=phi, device=device,
                          code_frequency=system.code_frequency
                          * (1.0 + dop / system.center_frequency))
        total = s if total is None else total + s
    return total.cpu().numpy()


def signal_l5(ms: int | None = None, device="cuda") -> np.ndarray:
    """I5 (primary x NH10 x nav symbols, as one overlay sign per period) plus
    Q5 (pilot x NH20 at the same planted offset, in quadrature)."""
    ms = L5["ms"] if ms is None else ms
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    nav = l5_nav()[:ms]
    nh10 = np.asarray(sys_i.secondary_code, np.float32)
    total = None
    for prn, dop, phi, nh0 in zip(L5["prns"], L5["dops"], L5["phases"], L5["nh_phase"]):
        common = dict(duration=ms * 1e-3, start_code_phase=phi, device=device,
                      code_frequency=sys_i.code_frequency
                      * (1.0 + dop / sys_i.center_frequency))
        overlay = nh10[(np.arange(ms) + nh0) % 10] * nav
        s_i, _ = gen_signal(sys_i, prn, dop, L5["n"] * ms, secondary_code=overlay, **common)
        s_q, _ = gen_signal(sys_q, prn, dop, L5["n"] * ms, secondary_code=sys_q.secondary_code,
                            secondary_phase=nh0, start_carrier_phase=np.pi / 2, **common)
        s = s_i.cpu().numpy() + s_q.cpu().numpy()
        total = s if total is None else total + s
    return total


def signal_b1i(ms: int | None = None, device="cuda") -> np.ndarray:
    """B1I D1: primary x NH20 x nav bit, block ``p`` carrying
    ``NH20[(p + nh0) % 20] * bit[(p + nh0) // 20]``."""
    ms = B1I["ms"] if ms is None else ms
    system = BeiDouB1I(with_secondary=False)
    nh20 = np.asarray(BeiDouB1I().secondary_code, np.float32)
    total = None
    for prn, dop, phi, nh0, bits in zip(B1I["prns"], B1I["dops"], B1I["phases"],
                                        B1I["nh_phase"], b1i_bits()):
        p = np.arange(ms)
        overlay = nh20[(p + nh0) % 20] * bits[(p + nh0) // 20]
        s, _ = gen_signal(system, prn, dop, B1I["n"] * ms, duration=ms * 1e-3,
                          start_code_phase=phi, secondary_code=overlay, device=device,
                          code_frequency=system.code_frequency
                          * (1.0 + dop / system.center_frequency))
        total = s if total is None else total + s
    return total.cpu().numpy()


def quantize(signal: np.ndarray, sigma: float, scale: float, seed: int) -> np.ndarray:
    """Complex signal + AWGN (numpy, from ``seed``) as interleaved int8: the
    front-end model."""
    rng = np.random.default_rng(seed)
    re = np.real(signal) + sigma * rng.standard_normal(signal.shape)
    im = np.imag(signal) + sigma * rng.standard_normal(signal.shape)
    inter = np.empty(2 * signal.size, np.float32)
    inter[0::2] = re * scale
    inter[1::2] = im * scale
    return np.clip(np.rint(inter), -127, 127).astype(np.int8)


LEGS = {"l1": (L1, signal_l1), "l5": (L5, signal_l5), "b1i": (B1I, signal_b1i)}


def synthesize(leg: str, path: pathlib.Path, device="cuda", ms: int | None = None) -> None:
    """Write leg ``leg``'s int8 capture (its first ``ms`` milliseconds)."""
    truth, signal = LEGS[leg]
    quantize(signal(ms, device), truth["sigma"], truth["scale"], NOISE_SEEDS[leg]).tofile(path)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def read_blocks(path, n, count, start_block=0, scale=1.0, device="cuda"):
    """``count`` blocks of ``n`` samples from ``start_block``, decoded by
    `runtime.IQFile`, as ``[count, n]`` planes on ``device``."""
    with IQFile(path, "int8", scale) as f:
        f.read(start_block * n)
        out = [f.read(n) for _ in range(count)]
    return tuple(torch.as_tensor(np.stack([o[i] for o in out]), device=device) for i in (0, 1))


def _cat(outs):
    """Concatenate a list of output trees (NamedTuples of tensors) by block."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs)
    return type(first)(*(_cat(list(xs)) for xs in zip(*outs)))


def track_chunked(step, states, path, n, count, start_block, scale, device, chunk=40):
    """Run a block tracker over file blocks, ``chunk`` blocks per call, the
    state carried between calls. Returns the final state, the stacked
    outputs and the median per-block time of a call (the steady streaming
    rate; the first call carries the graph capture)."""
    outs, per_block = [], []
    done = 0
    while done < count:
        b = min(chunk, count - done)
        sre, sim = read_blocks(path, n, b, start_block + done, scale, device)
        _sync(device)
        t0 = time.perf_counter()
        states, out = step(states, sre, sim)
        _sync(device)
        per_block.append((time.perf_counter() - t0) / b)
        outs.append(out)
        done += b
    return states, _cat(outs), statistics.median(per_block)


def acquire_band(system, path, n, fs, device, rounds=6, doppler_step=150.0):
    """Noncoherent PCPS over every PRN of ``system`` from the capture's first
    ``rounds`` blocks, accepted above `ACCEPT`. 150 Hz bins: the default
    2/(3T) grid leaves up to ~333 Hz of Doppler error for the loops."""
    sre, sim = read_blocks(path, n, rounds, device=device)
    res = acquire(system, sre, sim, np.arange(system.num_prns), fs, doppler_step=doppler_step)
    hits = np.flatnonzero(res.peak_metric.cpu().numpy() > ACCEPT)
    return res, hits


def _subset(res, hits):
    idx = torch.as_tensor(hits, device=res.prn.device)
    return type(res)(*(x[idx] for x in res))


def _accepted(res, hits, code_phase=False) -> list:
    rows = []
    for p in hits:
        row = {"prn": int(p), "doppler_hz": float(res.carrier_doppler[p])}
        if code_phase:
            row["code_phase_chips"] = float(res.code_phase[p])
        row["metric"] = float(res.peak_metric[p])
        rows.append(row)
    return rows


def _planted(truth) -> list:
    return [{"prn": p, "doppler_hz": d} for p, d in zip(truth["prns"], truth["dops"])]


def _by_prn(truth, key) -> list:
    return [v for _, v in sorted(zip(truth["prns"], truth[key]))]


def _block_dominant(truth, code_length) -> list:
    """The overlay offset a block-aligned tracker sees per channel (PRN
    order): a channel whose code phase is past half a period has its NH
    boundary mid-block, so the block's dominant sign is the next period's."""
    return [(o + (1 if ph > code_length / 2 else 0)) % 20
            for o, ph in zip(_by_prn(truth, "nh_phase"), _by_prn(truth, "phases"))]


def symbols_match(decided, planted) -> bool:
    """Whether the decided signs are a run of the planted ones, up to one
    global sign (the carrier loop's 180-degree ambiguity)."""
    decided = np.asarray(decided)
    m = len(decided)
    return any(np.array_equal(decided, s * planted[o:o + m])
               for o in range(len(planted) - m + 1) for s in (1.0, -1.0))


def _rate(blocks_done, wall, steady) -> dict:
    return {"track_wall_s": wall, "blocks_per_s": blocks_done / wall,
            "realtime_factor": blocks_done * 1e-3 / wall, "steady_block_s": steady,
            "steady_realtime_factor": 1e-3 / steady if steady else None}


def run_l1(capture: pathlib.Path, report: dict, device="cuda",
           work_dir: pathlib.Path = OUT_DATA) -> dict:
    """Acquisition over 32 PRNs, then `StreamTracker` on ``pallas_bank_auto``
    with a checkpoint (in ``work_dir``) and a cold resume halfway."""
    system = GPSL1()
    res, hits = acquire_band(system, capture, L1["n"], L1["fs"], device)
    report["l1_acquisition"] = {
        "engine": "fft", "searched_prns": int(system.num_prns),
        "accepted": _accepted(res, hits, code_phase=True), "planted": _planted(L1)}
    _require(hits.tolist() == sorted(L1["prns"]),
             f"L1 acquisition found {hits.tolist()}, planted {L1['prns']}")
    states = to_track_states(_subset(res, hits), device=device)
    config = TrackConfig.for_system(system, L1["fs"], L1["n"], algorithm="pallas_bank_auto")
    ckpt = pathlib.Path(work_dir) / "l1_checkpoint.npz"
    scale = 1.0 / L1["scale"]
    tracker = StreamTracker(config, system.codes, states, blocks_per_dispatch=60,
                            checkpoint_path=ckpt, checkpoint_every=100, measure_dispatch=True)
    # First leg: half the capture, checkpointing along the way ...
    t_track = time.perf_counter()
    with IQFile(capture, "int8", scale) as f:
        first = tracker.run(blocks(f, L1["n"]), max_blocks=L1["ms"] // 2)
    tracker.save_checkpoint(first.blocks_processed)
    # ... then a cold resume: a new tracker restores the state from the file.
    resumed = StreamTracker(config, system.codes, init_state(hits, device=device),
                            blocks_per_dispatch=60, checkpoint_path=ckpt, measure_dispatch=True)
    done = resumed.load_checkpoint()
    with IQFile(capture, "int8", scale) as f:
        f.read(done * L1["n"])
        second = resumed.run(blocks(f, L1["n"]))
    _sync(device)
    wall = time.perf_counter() - t_track
    out1, out2 = first.stacked(), second.stacked()
    dop = np.concatenate([np.asarray(out1.carrier_doppler), np.asarray(out2.carrier_doppler)])
    cn0 = np.concatenate([np.asarray(out1.cn0_dbhz), np.asarray(out2.cn0_dbhz)])
    dop_err = dop[-20:].mean(axis=0) - np.asarray(_by_prn(L1, "dops"))
    n_blocks = int(first.blocks_processed + second.blocks_processed)
    steady = [t for r in (first, second) for t in r.dispatch_block_s]
    report["l1_track"] = {
        "blocks": n_blocks,
        **_rate(n_blocks, wall, statistics.median(steady) if steady else None),
        "resume_at_block": int(done),
        "final_doppler_hz": [float(x) for x in dop[-20:].mean(axis=0)],
        "doppler_error_hz": [float(x) for x in dop_err],
        "final_cn0_dbhz": [float(x) for x in cn0[-20:].mean(axis=0)],
    }
    _require(bool(np.all(np.abs(dop_err) < 10.0)), f"L1 Doppler errors {dop_err.tolist()}")
    return {"doppler": dop, "cn0": cn0}


def run_l5(capture: pathlib.Path, report: dict, device="cuda") -> dict:
    """Pilot acquisition, pilot pull-in, NH20 sync, dual-component track."""
    sys_i, sys_q = GPSL5(), GPSL5(quadrature=True)
    scale = 1.0 / L5["scale"]
    # Acquire on the dataless pilot; 50 Hz bins and 16 noncoherent rounds
    # keep the Doppler error within what the 160-block pull-in absorbs.
    res, hits = acquire_band(sys_q, capture, L5["n"], L5["fs"], device, rounds=16,
                             doppler_step=50.0)
    report["l5_acquisition"] = {"engine": "fft", "accepted": _accepted(res, hits),
                                "planted": _planted(L5)}
    _require(hits.tolist() == sorted(L5["prns"]), f"L5 acquisition found {hits.tolist()}")
    states = to_track_states(_subset(res, hits), device=device)
    codes_i = torch.as_tensor(sys_i.codes, device=device)
    codes_q = torch.as_tensor(sys_q.codes, device=device)
    # Stage 1: pilot pull-in, overlay-agnostic (Costas tolerates the NH flips).
    sync_blocks, settle = 160, 100
    cfg_sync = TrackConfig.for_system(sys_q, L5["fs"], L5["n"], algorithm="pallas_bank",
                                      use_secondary=False)
    st1, out1, _ = track_chunked(lambda st, a, b: track_bank(cfg_sync, codes_q, st, a, b),
                                 states, capture, L5["n"], sync_blocks, 0, scale, device)
    # Stage 2: NH20 sync from the locked prompts, past the pull-in transient.
    offset, conf = detect_secondary_offset(out1.prompt_re[settle:], sys_q.secondary_code)
    offset = ((offset.long() - settle) % len(sys_q.secondary_code)).cpu().numpy()
    conf = conf.cpu().numpy()
    report["l5_secondary_sync"] = {
        "nh20_offset_blocks": [int(o) for o in offset],
        "planted_offset": _by_prn(L5, "nh_phase"),
        "expected_offset_block_dominant": _block_dominant(L5, sys_q.code_length),
        "confidence": [float(c) for c in conf],
    }
    _require(bool(np.all(conf > 0.75)), f"L5 NH20 sync not confident: {conf.tolist()}")
    st_dual = st1._replace(ms_elapsed=torch.as_tensor(sync_blocks + offset, dtype=torch.int32,
                                                      device=device))
    # Stage 3: pilot-driven atan2 loop, data-component nav symbols.
    cfg_dual = dual_config(cfg_sync)
    rest = L5["ms"] - sync_blocks
    t_track = time.perf_counter()
    _, out2, steady = track_chunked(
        lambda st, a, b: track_bank_dual(cfg_dual, codes_i, codes_q, st, a, b),
        st_dual, capture, L5["n"], rest, sync_blocks, scale, device)
    wall = time.perf_counter() - t_track
    dop = out2.pilot.carrier_doppler.cpu().numpy()
    dop_err = dop[-20:].mean(axis=0) - np.asarray(_by_prn(L5, "dops"))
    # Nav symbols: 10 blocks per symbol, from sums of the wiped data prompts.
    d = out2.data_prompt_re.cpu().numpy()
    nav = l5_nav()
    s0 = (10 - sync_blocks % 10) % 10
    symbols, recovered = {}, []
    for ch in range(d.shape[1]):
        dd = d[s0:, ch]
        decided = np.sign(dd[: len(dd) // 10 * 10].reshape(-1, 10).sum(axis=1))
        symbols[ch] = decided.astype(int).tolist()
        recovered.append(symbols_match(decided, nav[::10]))
    pilot = out2.pilot.prompt_re.cpu().numpy()
    report["l5_dual_track"] = {
        "blocks": int(rest),
        **_rate(rest, wall, steady),
        "final_doppler_hz": [float(x) for x in dop[-20:].mean(axis=0)],
        "doppler_error_hz": [float(x) for x in dop_err],
        "final_cn0_dbhz": [float(x) for x in out2.pilot.cn0_dbhz.cpu().numpy()[-20:].mean(axis=0)],
        "nav_symbols_last10": {ch: v[-10:] for ch, v in symbols.items()},
        "nav_symbols_recovered": recovered,
        "pilot_prompt_final": [float(x) for x in pilot[-1]],
    }
    _require(bool(np.all(np.abs(dop_err) < 10.0)), f"L5 Doppler errors {dop_err.tolist()}")
    return {"doppler": dop, "pilot_prompt": pilot, "data_prompt": d}


def run_b1i(capture: pathlib.Path, report: dict, device="cuda") -> dict:
    """Costas pull-in, NH20 sync without a pilot, NH-wiped track, nav bits."""
    system, sys_nh = BeiDouB1I(with_secondary=False), BeiDouB1I()
    scale = 1.0 / B1I["scale"]
    # 16 noncoherent rounds are immune to the NH20 sign flips.
    res, hits = acquire_band(system, capture, B1I["n"], B1I["fs"], device, rounds=16,
                             doppler_step=50.0)
    report["b1i_acquisition"] = {
        "engine": "fft", "searched_prns": int(system.num_prns),
        "accepted": _accepted(res, hits), "planted": _planted(B1I)}
    _require(hits.tolist() == sorted(B1I["prns"]), f"B1I acquisition found {hits.tolist()}")
    states = to_track_states(_subset(res, hits), device=device)
    codes = torch.as_tensor(system.codes, device=device)
    # Stage 1: Costas pull-in (the NH20 x nav flips are invisible to it).
    sync_blocks, settle = 180, 120
    cfg_sync = TrackConfig.for_system(system, B1I["fs"], B1I["n"], algorithm="pallas_bank",
                                      use_secondary=False)
    st1, out1, _ = track_chunked(lambda st, a, b: track_bank(cfg_sync, codes, st, a, b),
                                 states, capture, B1I["n"], sync_blocks, 0, scale, device)
    # Stage 2: NH20 sync without a pilot. Nav bits flip whole NH cycles, and
    # D1 aligns bit edges to them, so one of 20 window phases is bit-clean.
    off, conf = detect_secondary_offset_windowed(out1.prompt_re[settle:], sys_nh.secondary_code)
    best_off = ((off.long() - settle) % 20).cpu().numpy()
    conf = conf.cpu().numpy()
    expected = _block_dominant(B1I, system.code_length)
    report["b1i_secondary_sync"] = {
        "nh20_offset_blocks": [int(o) for o in best_off],
        "planted_offset": _by_prn(B1I, "nh_phase"),
        "expected_offset_block_dominant": expected,
        "confidence": [float(c) for c in conf],
    }
    _require(best_off.tolist() == expected, f"B1I NH20 offsets {best_off.tolist()}, "
             f"expected {expected}")
    _require(bool(np.all(conf > 0.75)), f"B1I NH20 sync not confident: {conf.tolist()}")
    # Stage 3: NH-wiped track; the prompt's residual sign is the nav bit.
    st2 = st1._replace(ms_elapsed=torch.as_tensor(sync_blocks + best_off, dtype=torch.int32,
                                                  device=device))
    cfg_track = TrackConfig.for_system(sys_nh, B1I["fs"], B1I["n"], algorithm="pallas_bank")
    rest = B1I["ms"] - sync_blocks
    t_track = time.perf_counter()
    _, out2, steady = track_chunked(lambda st, a, b: track_bank(cfg_track, codes, st, a, b),
                                    st2, capture, B1I["n"], rest, sync_blocks, scale, device)
    wall = time.perf_counter() - t_track
    dop = out2.carrier_doppler.cpu().numpy()
    dop_err = dop[-20:].mean(axis=0) - np.asarray(_by_prn(B1I, "dops"))
    # Nav bits: 20 blocks per bit, edges where (block + nh0) % 20 == 0.
    z = torch.complex(out2.prompt_re, out2.prompt_im).cpu().numpy()
    bits = [b for _, b in sorted(zip(B1I["prns"], b1i_bits()), key=lambda pb: pb[0])]
    symbols, coherent, differential = {}, [], []
    for ch in range(z.shape[1]):
        s0 = int((20 - (sync_blocks + best_off[ch]) % 20) % 20)
        zz = z[s0:, ch]
        zz = zz[: len(zz) // 20 * 20].reshape(-1, 20).sum(axis=1)   # one sum per bit
        symbols[ch] = np.sign(zz.real).astype(int).tolist()
        coherent.append(symbols_match(np.sign(zz.real), bits[ch]))
        # Differential decisions: bit j times bit j-1 is the sign of
        # Re(z_j conj z_{j-1}), which holds on a channel that is frequency
        # locked but still rotating.
        flips = np.sign((zz[1:] * np.conj(zz[:-1])).real)
        planted = bits[ch][1:] * bits[ch][:-1]
        m = len(flips)
        differential.append(any(np.array_equal(flips, planted[o:o + m])
                                for o in range(len(planted) - m + 1)))
    prompt = out2.prompt_re.cpu().numpy()
    report["b1i_track"] = {
        "blocks": int(rest),
        **_rate(rest, wall, steady),
        "final_doppler_hz": [float(x) for x in dop[-20:].mean(axis=0)],
        "doppler_error_hz": [float(x) for x in dop_err],
        "final_cn0_dbhz": [float(x) for x in out2.cn0_dbhz.cpu().numpy()[-20:].mean(axis=0)],
        "nav_bits_last10": {ch: v[-10:] for ch, v in symbols.items()},
        "nav_bits_recovered_coherent": coherent,
        "nav_bits_recovered_differential": differential,
    }
    _require(bool(np.all(np.abs(dop_err) < 10.0)), f"B1I Doppler errors {dop_err.tolist()}")
    return {"doppler": dop, "prompt": prompt}


def make_figure(curves: dict, out_path: pathlib.Path) -> pathlib.Path:
    """The four-panel pipeline figure from the legs' curves."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    l1, l5, b1i = curves["l1"], curves["l5"], curves["b1i"]
    fig, axes = plt.subplots(1, 4, figsize=(17, 3.6))
    t1 = np.arange(l1["doppler"].shape[0])
    for ch in range(l1["doppler"].shape[1]):
        axes[0].plot(t1, l1["doppler"][:, ch], lw=0.8,
                     label=f"PRN {sorted(L1['prns'])[ch] + 1}")
    for d in L1["dops"]:
        axes[0].axhline(d, color="k", lw=0.4, ls=":")
    axes[0].set(title="L1 bank: Doppler pull-in (int8 capture)", xlabel="block (ms)",
                ylabel="Doppler (Hz)")
    axes[0].legend(fontsize=7)
    axes[1].plot(t1, l1["cn0"], lw=0.8)
    axes[1].axhline(45.0, color="k", lw=0.4, ls=":")
    axes[1].set(title="L1 C/N0 estimate", xlabel="block (ms)", ylabel="C/N0 (dB-Hz)")
    t5 = np.arange(l5["data_prompt"].shape[0])
    axes[2].plot(t5, l5["pilot_prompt"][:, 0], lw=0.8, label="pilot I")
    axes[2].plot(t5, l5["data_prompt"][:, 0], lw=0.8, label="data I (nav)")
    axes[2].set(title="L5 dual: pilot lock + nav symbols", xlabel="block (ms)", ylabel="prompt")
    axes[2].legend(fontsize=7)
    tb = np.arange(b1i["prompt"].shape[0])
    for ch in range(b1i["prompt"].shape[1]):
        axes[3].plot(tb, b1i["prompt"][:, ch], lw=0.8,
                     label=f"PRN {sorted(B1I['prns'])[ch] + 1}")
    axes[3].set(title="B1I: NH20-wiped prompts (50 bps nav bits)", xlabel="block (ms)",
                ylabel="prompt")
    axes[3].legend(fontsize=7)
    fig.suptitle("PyTorch port on " + curves.get("device", ""), fontsize=8)
    fig.tight_layout()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def save_curves(curves: dict, path: pathlib.Path) -> None:
    np.savez_compressed(path, device=curves["device"],
                        **{f"{leg}/{name}": value for leg in ("l1", "l5", "b1i")
                           for name, value in curves[leg].items()})


def load_curves(path: pathlib.Path) -> dict:
    with np.load(path) as data:
        curves = {"device": str(data["device"])}
        for key in data.files:
            if "/" in key:
                leg, name = key.split("/")
                curves.setdefault(leg, {})[name] = data[key]
    return curves


def run(capture_dir: pathlib.Path, device="cuda", out_data: pathlib.Path = OUT_DATA) -> tuple:
    """Synthesize the captures that ``capture_dir`` lacks and run the three
    legs on ``device``; returns the report and the curves."""
    capture_dir = pathlib.Path(capture_dir)
    capture_dir.mkdir(parents=True, exist_ok=True)
    out_data = pathlib.Path(out_data)
    out_data.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    paths = {leg: capture_dir / name for leg, name in CAPTURE_NAMES.items()}
    for leg, path in paths.items():
        if not path.exists():
            synthesize(leg, path, device)
    processor = "GPU" if torch.device(device).type == "cuda" else "CPU"
    report = add_metadata({}, processor, "coldstart")
    report.update(native_iq_decoder=native_available(), captures={
        leg: {"path": path.name, "bytes": path.stat().st_size, "fs_hz": LEGS[leg][0]["fs"],
              "ms": LEGS[leg][0]["ms"]} for leg, path in paths.items()})
    curves = {"device": report["gpu_name"] or report["device_kind"],
              "l1": run_l1(paths["l1"], report, device, out_data),
              "l5": run_l5(paths["l5"], report, device),
              "b1i": run_b1i(paths["b1i"], report, device)}
    report["wall_s"] = time.time() - t0
    return report, curves


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--capture-dir", default=str(CAPTURES))
    parser.add_argument("--figure", action="store_true",
                        help="only draw the figure from the saved curves")
    args = parser.parse_args(argv)
    figure = IMG / "coldstart_pipeline.png"
    if not args.figure:
        report, curves = run(pathlib.Path(args.capture_dir), "cpu" if args.cpu else "cuda")
        (OUT_DATA / "observables.json").write_text(json.dumps(report, indent=1))
        save_curves(curves, OUT_DATA / "curves.npz")
        print(json.dumps(report, indent=1))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib is not installed: {figure} not drawn; draw it where it is with "
              "--figure")
        return 0
    print(make_figure(load_curves(OUT_DATA / "curves.npz"), figure))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
