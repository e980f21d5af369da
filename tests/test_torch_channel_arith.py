"""PyTorch port: the per-channel kernels' in-kernel arithmetic, on the CPU.

``csrc/fused.cu`` and ``csrc/taps.cu`` take the registry signature's raw
channel parameters and derive ``(f_cyc, phi_cyc, rho, phi_code)`` themselves
(``csrc/channel.cuh::derive``); the fused kernel computes each chip once into
a replica row; each CTA takes one 1024-sample tile of the wrapper's work
split. These tests hold a plain mirror of the derivation to
`_channel_params`, the replica row to the per-tap chips, and the work split
to the tiles. The kernels themselves are held to the plain versions on the
card (tests/test_torch_cuda.py, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch.ops import channel_kernels
from gpuacceleratedtracking_tpu_torch.ops.epl_kernels import _channel_params

torch.set_num_threads(1)

TWO_PI_F32 = np.float32(2 * math.pi)


def _derive(fcar, fs, phicar, fcode, phicode, d_min):
    """``channel.cuh::derive`` in numpy: ``f32(f64(f32(x)) / fs)`` for the
    rates, an IEEE f32 divide by f32(2 pi), then a product and a sum."""
    f32 = np.float32

    def rate(x):
        return f32(np.float64(f32(x)) / np.float64(fs))

    rho = rate(fcode)
    return np.array([rate(fcar), f32(phicar) / TWO_PI_F32, rho,
                     f32(phicode) + rho * f32(d_min)], dtype=np.float32)


@pytest.mark.parametrize("form", ["scalar", "0-d", "[1]"])
@pytest.mark.parametrize("d_min", [-384, -3, 0, 5])
def test_in_kernel_parameters_equal_channel_params(form, d_min):
    rng = np.random.default_rng(abs(d_min) + len(form))
    for _ in range(200):
        fs = float(rng.choice([2.048e6, 2.5e6, 32.768e6, 262.144e6, rng.uniform(1e6, 3e8)]))
        values = (rng.uniform(-6000.0, 6000.0), rng.uniform(-7.0, 7.0),
                  1.023e6 + rng.uniform(-8.0, 8.0), rng.uniform(-3.0, 1026.0))
        if form == "scalar":
            args = values
        else:
            shape = () if form == "0-d" else (1,)
            args = tuple(torch.tensor(v, dtype=torch.float32).reshape(shape) for v in values)
        fcar, phicar, fcode, phicode = args
        want = _channel_params(fcar, fs, phicar, fcode, phicode, d_min, "cpu").reshape(-1)
        got = _derive(float(fcar), fs, float(phicar), float(fcode), float(phicode), d_min)
        np.testing.assert_array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


# name -> (system, N, L, fs or None for N / 1 ms, code frequency or None for nominal)
ROW_CASES = {
    **{f"l1_n{1 << e}_l7": ("GPSL1", 1 << e, 7, None, None) for e in range(11, 19)},
    "l1_n262144_l3": ("GPSL1", 1 << 18, 3, None, None),
    "l5_n32768_l7": ("GPSL5", 32768, 7, None, None),
    "l5_n262144_l7": ("GPSL5", 1 << 18, 7, None, None),
    "two_chips_per_sample": ("GPSL1", 2000, 3, 0.5115e6, None),
    "negative_rate": ("GPSL1", 8192, 5, None, -1.023e6),
}


@pytest.mark.parametrize("name", sorted(ROW_CASES))
def test_replica_row_chips_equal_per_tap_chips(name):
    # fused.cu computes floor(m * rho + frac) once per tile position m; the
    # per-tap formula floor((j + delta_l) * rho + frac) rounds alike, since
    # j + delta_l is an exact small integer in f32.
    gnss, n, taps, fs, fcode = ROW_CASES[name]
    system = tmodels.get_system(gnss)
    fs = n / 1e-3 if fs is None else fs
    shifts = tmodels.correlator_sample_shifts(system, tmodels.EPLCorrelator(taps), fs)
    rng = np.random.default_rng(len(name))
    zeros = torch.zeros(n)
    call = channel_kernels.ChannelCall(
        zeros, zeros, torch.as_tensor(system.codes), 3, rng.uniform(-4000, 4000), fs,
        rng.uniform(0, 2 * np.pi), system.code_frequency if fcode is None else fcode,
        rng.uniform(0, system.code_length), tuple(int(s) for s in shifts),
        system.code_length, "fused")
    _, chip0, frac = channel_kernels._tile_phases(call)
    row = channel_kernels._replica_row(call, chip0, frac)
    assert row.shape == (call.num_tiles, channel_kernels.TILE + call.span)
    rho = call.params[2]
    j = torch.arange(channel_kernels.TILE, dtype=torch.float32)
    for delta in call.deltas:
        x = (j + float(delta)) * rho + frac[:, None]
        per_tap = torch.remainder(torch.floor(x).long() + chip0[:, None], system.code_length)
        assert torch.equal(row[:, delta:delta + channel_kernels.TILE], per_tap)


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 2048, 2049, 2500, 8192, 16384, 16385,
                               20000, 32768, 32769, 131072, 262144, (1 << 24) - 1])
def test_work_split_covers_every_tile_once(n):
    split = channel_kernels.work_split(n)
    tile = channel_kernels.TILE
    assert split.tiles == -(-n // tile)
    assert split.grid % split.cluster == 0
    assert 0 <= split.grid - split.tiles < split.cluster
    if split.tiles <= channel_kernels.MAX_CLUSTER:
        # One cluster, whose CTAs sum through shared memory and write the result.
        assert split.clusters == 1 and split.cluster in (1, 2, 4, 8, 16)
    else:
        assert split.cluster == channel_kernels.CLUSTER
    # CTA b, thread u covers tile b and in it samples 4 u + s, s < 4, below N.
    b, u, s = np.meshgrid(np.arange(split.grid), np.arange(256), np.arange(4),
                          indexing="ij")
    samples = (b * tile + 4 * u + s).ravel()
    samples = samples[samples < n]
    assert np.array_equal(np.bincount(samples, minlength=n), np.ones(n, dtype=np.int64))


def test_work_split_at_the_sweep_corners():
    # N <= 16384: one cluster, no partials; N = 32768: 32 CTAs in four
    # clusters; N = 2^18: 256 CTAs, two per SM of the H100's 132, in 32
    # clusters.
    split = channel_kernels.work_split
    assert split(32768) == channel_kernels.Split(32, 32, 8)
    assert split(1 << 18) == channel_kernels.Split(256, 256, 8)
    assert split(2048) == channel_kernels.Split(2, 2, 2)
    assert split(2049) == channel_kernels.Split(3, 4, 4)
    assert split(16384) == channel_kernels.Split(16, 16, 16)
    assert split(20000) == channel_kernels.Split(20, 24, 8)
    with pytest.raises(ValueError, match="at least one sample"):
        split(0)


def test_plain_versions_take_parameters_lazily():
    # The kernels take the raw parameters: a call prepared for the fused
    # kernel computes neither the f32 parameters nor the code column until a
    # plain version asks for them.
    system = tmodels.GPSL1()
    zeros = torch.zeros(2048)
    call = channel_kernels.ChannelCall(zeros, zeros, torch.as_tensor(system.codes), 4, 100.0,
                                       2.048e6, 0.5, 1.023e6, 10.25, (-1, 0, 1), 1023, "fused")
    assert "params" not in vars(call) and "column" not in vars(call)
    assert call.column.shape == (1023,) and call.params.shape == (4,)
    with pytest.raises(IndexError, match="outside a table"):
        channel_kernels._prn_arg(37, call.device, 37, [])
    assert channel_kernels._prn_arg(-1, call.device, 37, [])[1] == 36


def test_scratch_is_per_stream_and_per_capture(monkeypatch):
    # Eager launches share one zeroed buffer per (device, stream, size); a
    # launch under a CUDA graph capture takes one of its capture's own, so two
    # graphs never share a counter, and only the capture under way is kept.
    monkeypatch.setattr(channel_kernels, "_SCRATCH", {})
    monkeypatch.setattr(channel_kernels, "_CAPTURE_SCRATCH", {})
    scratch = channel_kernels._scratch
    dev = torch.device("cpu")
    eager = scratch(dev, 1, 0, 8)
    assert scratch(dev, 1, 0, 8) is eager and not eager.any()
    assert scratch(dev, 2, 0, 8) is not eager and scratch(dev, 1, 0, 12) is not eager
    first = scratch(dev, 1, 7, 8)
    assert first is not eager and not first.any() and scratch(dev, 1, 7, 8) is first
    second = scratch(dev, 1, 9, 8)
    assert second is not first and scratch(dev, 1, 0, 8) is eager
    assert [key[3] for key in channel_kernels._CAPTURE_SCRATCH] == [9]
