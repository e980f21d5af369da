"""PyTorch port, ops: replicas, plain correlators and the registry vs JAX."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import ops as jops
from gpuacceleratedtracking_tpu.ops import registry as jregistry
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import ops as tops
from gpuacceleratedtracking_tpu_torch.ops import registry as tregistry

torch.set_num_threads(1)

GOLDEN = np.array([1476.0, 2500.0, 1476.0])
SYSTEM = tmodels.GPSL1()
CODES = torch.as_tensor(SYSTEM.codes)


def _golden_signal(num_ants=None):
    signal, fs = tmodels.gen_signal(SYSTEM, 0, 1500.0, 2500, num_ants=num_ants, device="cpu")
    return (*tmodels.soa(signal), fs)


def _fused(sre, sim, fs, shifts, prn=0, fcar=1500.0, phicar=0.0, phicode=0.0):
    return tregistry.get("fused_xla")(
        sre, sim, CODES, prn, fcar, fs, phicar, SYSTEM.code_frequency, phicode,
        tuple(int(s) for s in shifts), SYSTEM.code_length,
    )


def test_golden_through_fused_xla():
    # tests/test_correlate.py's golden scenario and tolerance.
    sre, sim, fs = _golden_signal()
    shifts = tmodels.correlator_sample_shifts(SYSTEM, tmodels.EPLCorrelator(3), fs)
    np.testing.assert_array_equal(shifts, [-1, 0, 1])
    are, aim = _fused(sre, sim, fs, shifts)
    np.testing.assert_allclose(are.numpy(), GOLDEN, rtol=3.5e-4)
    np.testing.assert_allclose(aim.numpy(), 0.0, atol=0.5)


def test_golden_multi_antenna_and_seven_taps():
    sre, sim, fs = _golden_signal(num_ants=4)
    shifts = tmodels.correlator_sample_shifts(SYSTEM, tmodels.EPLCorrelator(3), fs)
    are, _ = _fused(sre, sim, fs, shifts)
    assert are.shape == (4, 3)
    for a in range(4):
        np.testing.assert_allclose(are[a].numpy(), GOLDEN, rtol=3.5e-4)
    sre, sim, fs = _golden_signal()
    shifts7 = tmodels.correlator_sample_shifts(SYSTEM, tmodels.EPLCorrelator(7), fs)
    are7, _ = _fused(sre, sim, fs, shifts7)
    assert are7.shape == (7,) and abs(float(are7[3]) - 2500.0) < 1.0


def _numpy_oracle(prn, carrier_freq, fs, carrier_phase, code_phase, shifts, signal):
    """Float64 correlator (tests/test_correlate.py's oracle)."""
    n = np.arange(signal.shape[-1], dtype=np.float64)
    carrier = np.exp(1j * (2 * np.pi * carrier_freq / fs * n + carrier_phase))
    dw = signal.astype(np.complex128) * np.conj(carrier)
    out = []
    for d in shifts:
        idx = np.mod(np.floor(SYSTEM.code_frequency / fs * (n + d) + code_phase)
                     .astype(np.int64), SYSTEM.code_length)
        out.append(np.sum(dw * SYSTEM.codes[idx, prn].astype(np.float64), axis=-1))
    return np.stack(out, axis=-1)


@pytest.mark.parametrize("fcar,phicar,phicode,prn", [
    (1500.0, 0.0, 0.0, 0),
    (-2600.0, 1.2, 345.6, 7),
    (4321.0, -0.4, 1022.9, 31),
])
def test_fused_matches_float64_oracle(fcar, phicar, phicode, prn):
    signal, fs = tmodels.gen_signal(SYSTEM, prn, fcar, 4096,
                                    start_code_phase=phicode,
                                    start_carrier_phase=phicar, device="cpu")
    sre, sim = tmodels.soa(signal)
    shifts = tmodels.correlator_sample_shifts(SYSTEM, tmodels.EPLCorrelator(3), fs)
    are, aim = _fused(sre, sim, fs, shifts, prn=prn, fcar=fcar, phicar=phicar,
                      phicode=phicode)
    ref = _numpy_oracle(prn, fcar, fs, phicar, phicode, shifts, signal.numpy())
    np.testing.assert_allclose(are.numpy() + 1j * aim.numpy(), ref,
                               rtol=2e-3, atol=0.6)


def test_code_replica_matches_jax():
    fs = 8.192e6
    prn = np.array([0, 5, 17], np.int32)
    f_code = np.float32(SYSTEM.code_frequency) + np.array([0.0, 2.5, -1.25], np.float32)
    phase = np.array([0.0, 100.25, 1022.5], np.float32)
    want = jax.vmap(lambda p, f, ph: jops.gen_code_replica(
        jnp.asarray(SYSTEM.codes), p, f, fs, ph, 8192, -4, 4, 1023))(
        jnp.asarray(prn), jnp.asarray(f_code), jnp.asarray(phase))
    got = tops.gen_code_replica(CODES, torch.as_tensor(prn), torch.as_tensor(f_code),
                                fs, torch.as_tensor(phase), 8192, -4, 4, 1023)
    # Both grids are rebased per 128-sample row; a chip may flip at a floor
    # boundary where the two rates differ by an ulp.
    mismatch = np.mean(got.numpy() != np.asarray(want))
    assert mismatch < 1e-3, mismatch


def test_carrier_replica_matches_jax():
    f = np.array([-3999.5, 0.0, 1234.5], np.float32)
    ph = np.array([0.0, 3.0, 6.2], np.float32)
    want = jax.vmap(lambda a, b: jops.gen_carrier_replica(a, 32.768e6, b, 32768))(
        jnp.asarray(f), jnp.asarray(ph))
    got = tops.gen_carrier_replica(torch.as_tensor(f), 32.768e6,
                                   torch.as_tensor(ph), 32768)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def _bank_case(num_samples, num_k, seed):
    rng = np.random.default_rng(seed)
    fs = num_samples / 1e-3
    signal, _ = jmodels.gen_signal(jmodels.GPSL1(), 0, 1500.0, num_samples)
    return dict(
        sre=np.array(signal.real), sim=np.array(signal.imag), fs=fs,
        shifts=tuple(int(s) for s in jmodels.correlator_sample_shifts(
            jmodels.GPSL1(), jmodels.EPLCorrelator(3), fs)),
        prn=(np.arange(num_k) % 32).astype(np.int32),
        dop=(1500.0 + rng.uniform(-4000, 4000, num_k)).astype(np.float32),
        cph=rng.uniform(0, 2 * np.pi, num_k).astype(np.float32),
        cf=(SYSTEM.code_frequency + rng.uniform(-3, 3, num_k)).astype(np.float32),
        coph=rng.uniform(0, SYSTEM.code_length, num_k).astype(np.float32),
    )


def test_xla_bank_matches_jax():
    c = _bank_case(8192, 4, seed=1)
    fn = jax.jit(functools.partial(
        jregistry.get("xla_bank"), sample_shifts=c["shifts"], code_length=1023,
        sampling_frequency=c["fs"]))
    want = fn(jnp.asarray(c["sre"]), jnp.asarray(c["sim"]),
              jnp.asarray(SYSTEM.codes), jnp.asarray(c["prn"]),
              jnp.asarray(c["dop"]), carrier_phase=jnp.asarray(c["cph"]),
              code_frequency=jnp.asarray(c["cf"]), code_phase=jnp.asarray(c["coph"]))
    t = torch.as_tensor
    got = tregistry.get("xla_bank")(
        t(c["sre"]), t(c["sim"]), CODES, t(c["prn"]), t(c["dop"]), c["fs"],
        t(c["cph"]), t(c["cf"]), t(c["coph"]), c["shifts"], 1023)
    for g, w in zip(got, want):
        assert g.shape == (4, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=0.3)


def test_xla_bank_chunks_like_one_batch(monkeypatch):
    from gpuacceleratedtracking_tpu_torch.ops import correlate

    c = _bank_case(4096, 5, seed=2)
    t = torch.as_tensor
    args = (t(c["sre"]), t(c["sim"]), CODES, t(c["prn"]), t(c["dop"]), c["fs"],
            t(c["cph"]), t(c["cf"]), t(c["coph"]), c["shifts"], 1023)
    whole = correlate.correlate_xla_bank(*args)
    monkeypatch.setattr(correlate, "_CHUNK_ELEMENTS", 2 * 3 * 4096)
    chunked = correlate.correlate_xla_bank(*args)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_registry_names_and_unported():
    # Every JAX name is ported: the two registries list the same names, and
    # each resolves to a callable.
    assert tregistry.names() == jregistry.names()
    assert tregistry.BANK_ALGORITHMS == jregistry.BANK_ALGORITHMS
    for name in tregistry.names():
        assert callable(tregistry.get(name))
    with pytest.raises(KeyError):
        tregistry.get("no_such_algorithm")
