"""PyTorch port: `correlate_unfused`, the reductions and the quantized code
replica against the JAX package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu.ops import correlate as jcorrelate
from gpuacceleratedtracking_tpu.ops import reduce as jreduce
from gpuacceleratedtracking_tpu.ops import replica as jreplica
from gpuacceleratedtracking_tpu_torch import ops as tops
from gpuacceleratedtracking_tpu_torch.ops import reduce as treduce

torch.set_num_threads(1)

GOLDEN = np.array([1476.0, 2500.0, 1476.0])
SYSTEM = jmodels.GPSL1()


def _signal(num_samples, num_ants=None, prn=0, fcar=1500.0, phicar=0.0, phicode=0.0,
            system=SYSTEM, taps=3):
    signal, fs = jmodels.gen_signal(system, prn, fcar, num_samples, num_ants=num_ants,
                                    start_code_phase=phicode, start_carrier_phase=phicar)
    shifts = tuple(int(s) for s in jmodels.correlator_sample_shifts(
        system, jmodels.EPLCorrelator(taps), fs))
    return np.array(signal.real), np.array(signal.imag), fs, shifts


def test_unfused_golden():
    sre, sim, fs, shifts = _signal(2500)
    are, aim = tops.correlate_unfused(torch.as_tensor(sre), torch.as_tensor(sim),
                                      torch.as_tensor(SYSTEM.codes), 0, 1500.0, fs, 0.0,
                                      SYSTEM.code_frequency, 0.0, shifts, 1023)
    np.testing.assert_array_equal(are.numpy(), GOLDEN)
    np.testing.assert_allclose(aim.numpy(), 0.0, atol=0.5)


@pytest.mark.parametrize("gnss,n,ants,taps,prn,fcar,phicar,phicode", [
    ("GPSL1", 4096, None, 3, 5, -2345.0, 0.9, 517.3),
    ("GPSL1", 2500, 4, 3, 0, 1500.0, 0.0, 0.0),
    ("GPSL1", 8192, None, 7, 3, 700.0, 0.3, 12.5),
    ("GPSL5", 32768, None, 3, 3, 2000.0, 0.0, 0.0),
])
def test_unfused_matches_jax_unfused(gnss, n, ants, taps, prn, fcar, phicar, phicode):
    # Both sides are plain f32 pipelines with the same replica arithmetic;
    # they differ in summation order only (and, at 1 ulp, in the rate).
    system = jmodels.get_system(gnss)
    sre, sim, fs, shifts = _signal(n, ants, prn, fcar, phicar, phicode, system, taps)
    fn = jax.jit(functools.partial(jcorrelate.correlate_unfused, sample_shifts=shifts,
                                   code_length=system.code_length))
    want = fn(jnp.asarray(sre), jnp.asarray(sim), jnp.asarray(system.codes), prn, fcar, fs,
              phicar, system.code_frequency, phicode)
    got = tops.correlate_unfused(torch.as_tensor(sre), torch.as_tensor(sim),
                                 torch.as_tensor(system.codes), prn, fcar, fs, phicar,
                                 system.code_frequency, phicode, shifts, system.code_length)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=0.2)


@pytest.mark.parametrize("ants", [None, 2])
def test_unfused_batches_channels_like_fused(ants):
    rng = np.random.default_rng(0)
    sre, sim, fs, shifts = _signal(4096, ants)
    k = 3
    t = torch.as_tensor
    params = (t(np.arange(k, dtype=np.int32)), t(rng.uniform(-3000, 3000, k).astype(np.float32)),
              t(rng.uniform(0, 6, k).astype(np.float32)),
              t(np.full(k, SYSTEM.code_frequency, np.float32)),
              t(rng.uniform(0, 1023, k).astype(np.float32)))
    args = (t(sre), t(sim), t(SYSTEM.codes))
    batched = tops.correlate_unfused(*args, params[0], params[1], fs, params[2], params[3],
                                     params[4], shifts, 1023)
    fused = tops.correlate_fused(*args, params[0], params[1], fs, params[2], params[3],
                                 params[4], shifts, 1023)
    for b, f in zip(batched, fused):
        assert b.shape == ((k, 3) if ants is None else (k, ants, 3))
        np.testing.assert_allclose(b.numpy(), f.numpy(), rtol=1e-4, atol=0.05)


@pytest.mark.parametrize("name", sorted(jreduce.REDUCTIONS))
def test_reductions_match_jax(name):
    rng = np.random.default_rng(7)
    prod_re = rng.standard_normal((1024, 2, 3)).astype(np.float32)
    prod_im = rng.standard_normal((1024, 2, 3)).astype(np.float32)
    want = jreduce.get_reduction(name)(jnp.asarray(prod_re), jnp.asarray(prod_im))
    got = treduce.get_reduction(name)(torch.as_tensor(prod_re), torch.as_tensor(prod_im))
    for g, w in zip(got, want):
        assert g.shape == (2, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(treduce.REDUCTIONS))
def test_ones_reduce_to_num_samples(name):
    # tests/test_bench.py:31-40 on the port: exactly N.
    n, a, l = 2048, 4, 3
    acc_re, acc_im = treduce.get_reduction(name)(torch.ones(n, a, l), torch.zeros(n, a, l))
    assert acc_re.shape == (a, l)
    np.testing.assert_array_equal(acc_re.numpy(), n)
    np.testing.assert_array_equal(acc_im.numpy(), 0.0)


def test_reduction_names_and_unknown():
    assert sorted(treduce.REDUCTIONS) == sorted(jreduce.REDUCTIONS)
    with pytest.raises(KeyError):
        treduce.get_reduction("harris_6")


@pytest.mark.parametrize("n", [2048, 5000, 16384, 65536])
def test_quantized_replica_bit_equal_to_jax(n):
    # tests/test_correlate.py:194's cells.
    fs = n / 1e-3
    want = jax.jit(functools.partial(
        jreplica.gen_code_replica_quantized, num_samples=n, min_shift=0, max_shift=0,
        code_length=SYSTEM.code_length))(jnp.asarray(SYSTEM.codes), 0,
                                          SYSTEM.code_frequency, fs, 0.0)
    got = tops.gen_code_replica_quantized(torch.as_tensor(SYSTEM.codes), 0,
                                          SYSTEM.code_frequency, fs, 0.0, n, 0, 0, 1023)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_replica_with_halo_and_offset():
    n, fs = 4096, 4.096e6
    want = jax.jit(functools.partial(
        jreplica.gen_code_replica_quantized, num_samples=n, min_shift=-2, max_shift=2,
        code_length=SYSTEM.code_length))(jnp.asarray(SYSTEM.codes), 7,
                                          SYSTEM.code_frequency, fs, 311.3)
    got = tops.gen_code_replica_quantized(torch.as_tensor(SYSTEM.codes), 7,
                                          SYSTEM.code_frequency, fs, 311.3, n, -2, 2, 1023)
    assert got.shape == (n + 4,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Against the exact replica: the 12-bit grid moves few chips, if any.
    exact = tops.gen_code_replica(torch.as_tensor(SYSTEM.codes), 7, SYSTEM.code_frequency,
                                  fs, 311.3, n, -2, 2, 1023)
    assert float((exact != got).float().mean()) <= 5e-4
