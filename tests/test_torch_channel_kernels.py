"""PyTorch port, per-channel kernel module: the plain versions of
`pallas_taps` and `pallas_fused` against the JAX kernels (Pallas interpret
mode) and the JAX `fused_xla`.

On the CPU each wrapper runs its plain version; the CUDA kernels themselves
are compared with those on the card by tests/test_torch_cuda.py and
``chip_smoke.py``. The cases and tolerances are those of
tests/test_pallas.py:44-110 (each f32 chip-boundary flip moves an
accumulator by +/-2): golden rtol 3.5e-4 (atol 0.5 for the imaginary parts),
offsets and sub-tile rtol 1e-3 atol 0.2, L=7 and wide span rtol 1e-3
atol 0.3, GPS L5 rtol 1e-3 atol 3.0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu.ops import registry as jregistry
from gpuacceleratedtracking_tpu_torch.ops import channel_kernels
from gpuacceleratedtracking_tpu_torch.ops import registry as tregistry

torch.set_num_threads(1)

GOLDEN = np.array([1476.0, 2500.0, 1476.0])

# name -> (GNSS, N, A, taps or explicit shifts, prn, f_carrier, carrier phase, code phase)
CASES = {
    "golden": ("GPSL1", 2500, 1, 3, 0, 1500.0, 0.0, 0.0),
    "offsets": ("GPSL1", 4096, 1, 3, 5, -2345.0, 0.9, 517.3),
    "multi_antenna": ("GPSL1", 2500, 4, 3, 0, 1500.0, 0.0, 0.0),
    "seven_taps": ("GPSL1", 8192, 1, 7, 0, 1500.0, 0.0, 0.0),
    "l5": ("GPSL5", 32768, 1, 3, 3, 2000.0, 0.0, 0.0),
    "wide_span": ("GPSL1", 4096, 1, (-150, 0, 163), 0, 1500.0, 0.0, 0.0),
    "sub_tile": ("GPSL1", 1000, 1, 3, 0, 500.0, 0.0, 0.0),
}
# name -> (rtol, atol)
TOLERANCES = {
    "golden": (3.5e-4, 0.5),
    "multi_antenna": (3.5e-4, 0.5),
    "offsets": (1e-3, 0.2),
    "seven_taps": (1e-3, 0.3),
    "l5": (1e-3, 3.0),
    "wide_span": (1e-3, 0.3),
    "sub_tile": (1e-3, 0.2),
}
KERNELS = ("pallas_taps", "pallas_fused")


@functools.lru_cache(maxsize=None)
def _case(name):
    gnss, n, a, taps, prn, fcar, phicar, phicode = CASES[name]
    system = jmodels.get_system(gnss)
    signal, fs = jmodels.gen_signal(system, prn, fcar, n,
                                    num_ants=None if a == 1 else a,
                                    start_code_phase=phicode,
                                    start_carrier_phase=phicar)
    if isinstance(taps, int):
        taps = jmodels.correlator_sample_shifts(system, jmodels.EPLCorrelator(taps), fs)
    return dict(system=system, sre=np.array(signal.real), sim=np.array(signal.imag),
                fs=fs, shifts=tuple(int(s) for s in taps), prn=prn, fcar=fcar,
                phicar=phicar, phicode=phicode)


@functools.lru_cache(maxsize=None)
def _jax(name, algo):
    """The JAX algorithm's accumulators (complex), computed once per process."""
    c = _case(name)
    fn = jax.jit(functools.partial(jregistry.get(algo), sample_shifts=c["shifts"],
                                   code_length=c["system"].code_length))
    are, aim = fn(jnp.asarray(c["sre"]), jnp.asarray(c["sim"]),
                  jnp.asarray(c["system"].codes), c["prn"], c["fcar"], c["fs"],
                  c["phicar"], c["system"].code_frequency, c["phicode"])
    return np.asarray(are) + 1j * np.asarray(aim)


def _port(fn, c):
    t = torch.as_tensor
    are, aim = fn(t(c["sre"]), t(c["sim"]), t(c["system"].codes), c["prn"], c["fcar"],
                  c["fs"], c["phicar"], c["system"].code_frequency, c["phicode"],
                  c["shifts"], c["system"].code_length)
    return are.numpy() + 1j * aim.numpy()


def _assert_close(got, want, name):
    rtol, atol = TOLERANCES[name]
    np.testing.assert_allclose(got.real, want.real, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.imag, want.imag, rtol=rtol, atol=atol)


@pytest.mark.parametrize("algo", KERNELS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_kernel(name, algo):
    got = _port(tregistry.get(algo), _case(name))
    want = _jax(name, algo)
    assert got.shape == want.shape
    _assert_close(got, want, name)


@pytest.mark.parametrize("algo", KERNELS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_fused_xla(name, algo):
    got = _port(tregistry.get(algo), _case(name))
    _assert_close(got, _jax(name, "fused_xla"), name)
    if name in ("golden", "multi_antenna"):
        np.testing.assert_allclose(got.real.reshape(-1, 3), np.tile(GOLDEN, (got.size // 3, 1)),
                                   rtol=3.5e-4)


@pytest.mark.parametrize("algo", KERNELS)
def test_wide_span_natively_at_n131072(algo):
    # tests/test_pallas.py:715-726: L=7 at 131 MHz, a 384-sample span, held
    # against the JAX fused_xla only (interpret mode is too slow here).
    system = jmodels.GPSL1()
    signal, fs = jmodels.gen_signal(system, 0, 1500.0, 131072)
    shifts = jmodels.correlator_sample_shifts(system, jmodels.EPLCorrelator(7), fs)
    assert int(max(shifts)) - int(min(shifts)) >= 128
    c = dict(system=system, sre=np.array(signal.real), sim=np.array(signal.imag), fs=fs,
             shifts=tuple(int(s) for s in shifts), prn=0, fcar=1500.0, phicar=0.0,
             phicode=0.0)
    fn = jax.jit(functools.partial(jregistry.get("fused_xla"), sample_shifts=c["shifts"],
                                   code_length=system.code_length))
    are, aim = fn(jnp.asarray(c["sre"]), jnp.asarray(c["sim"]), jnp.asarray(system.codes),
                  0, 1500.0, fs, 0.0, system.code_frequency, 0.0)
    got = _port(tregistry.get(algo), c)
    np.testing.assert_allclose(got.real, np.asarray(are), rtol=1e-3, atol=2.0)
    np.testing.assert_allclose(got.imag, np.asarray(aim), rtol=1e-3, atol=2.0)


def test_wrappers_run_their_plain_versions_on_cpu():
    c = _case("offsets")
    for fn, plain in ((channel_kernels.correlate_pallas_taps,
                       channel_kernels.correlate_taps_reference),
                      (channel_kernels.correlate_pallas_fused,
                       channel_kernels.correlate_fused_reference)):
        np.testing.assert_array_equal(_port(fn, c), _port(plain, c))
    assert channel_kernels.correlate_pallas_taps.launches == 0
    assert channel_kernels.correlate_pallas_fused.launches == 0


def test_channel_parameters_as_device_tensors():
    # track_step passes 0-d tensors, a bank loop one-element slices: the
    # same result as Python scalars.
    c = _case("offsets")
    t = torch.as_tensor
    want = _port(channel_kernels.correlate_pallas_fused, c)
    for shape in ((), (1,)):
        p = [t(x, dtype=dt).reshape(shape) for x, dt in
             ((c["prn"], torch.int32), (c["fcar"], torch.float32),
              (c["phicar"], torch.float32), (c["system"].code_frequency, torch.float32),
              (c["phicode"], torch.float32))]
        are, aim = channel_kernels.correlate_pallas_fused(
            t(c["sre"]), t(c["sim"]), t(c["system"].codes), p[0], p[1], c["fs"], p[2],
            p[3], p[4], c["shifts"], c["system"].code_length)
        np.testing.assert_array_equal(are.numpy() + 1j * aim.numpy(), want)


def test_one_channel_only_and_cpu_launch_refused():
    c = _case("golden")
    t = torch.as_tensor
    args = (t(c["sre"]), t(c["sim"]), t(c["system"].codes), t([0, 1]), t([1500.0, 900.0]),
            c["fs"], t([0.0, 0.0]), t([1.023e6, 1.023e6]), t([0.0, 0.0]), c["shifts"], 1023)
    with pytest.raises(ValueError, match="one channel"):
        channel_kernels.correlate_pallas_fused(*args)
    call = channel_kernels.ChannelCall(t(c["sre"]), t(c["sim"]), t(c["system"].codes), 0,
                                       1500.0, c["fs"], 0.0, 1.023e6, 0.0, c["shifts"], 1023,
                                       "fused")
    with pytest.raises(ValueError, match="CUDA tensors"):
        channel_kernels.launch_fused(call)
    with pytest.raises(ValueError, match="CUDA tensors"):
        channel_kernels.launch_taps(call)
    assert channel_kernels.correlate_pallas_fused.launches == 0


def test_first_tile_keeps_code_phase_exact():
    # At 1 MHz the earliest tap starts one sample early, so its code phase is
    # -rho: the whole chips are kept as integers, and the prompt tap meets the
    # chip boundary at sample 0 exactly (a wrap into [0, Lc) in f32 would not).
    call = channel_kernels.ChannelCall(
        torch.zeros(1000), torch.zeros(1000), torch.as_tensor(jmodels.GPSL1().codes), 0,
        500.0, 1e6, 0.0, 1.023e6, 0.0, (-1, 0, 1), 1023, "fused")
    _, chip0, frac = channel_kernels._tile_phases(call)
    rho = call.params[2]
    assert int(chip0[0]) == 1021
    assert float((1.0 * rho + frac[0]).floor()) == 2.0
