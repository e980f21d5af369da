"""PyTorch port, the one-hot bank route (`pallas_bank_onehot`): its plain
version against the JAX `correlate_pallas_bank_onehot` (Pallas interpret
mode) and against the port's rows route.

The route runs ``csrc/bank_rows.cu`` on the card (tests/test_torch_cuda.py);
on the CPU it runs that kernel's plain version with no envelope and no
nominal rates. Tolerances: tests/test_pallas.py:370-394 for the wide-span
cell (rtol 1e-3, atol 0.3); the chip-flip envelope of the bank suites
(rtol 2e-3, atol 4.5) where the two sides compute chip phases differently.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu.ops import pallas_epl
from gpuacceleratedtracking_tpu.ops import registry as jregistry
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
from gpuacceleratedtracking_tpu_torch.ops import registry as tregistry

torch.set_num_threads(1)

SYSTEM = jmodels.GPSL1()


def _case(num_samples, num_k, shifts=None, seed=0, golden=False):
    rng = np.random.default_rng(seed)
    fs = num_samples / 1e-3
    signal, _ = jmodels.gen_signal(SYSTEM, 0, 1500.0, num_samples)
    if shifts is None:
        shifts = jmodels.correlator_sample_shifts(SYSTEM, jmodels.EPLCorrelator(3), fs)
    if golden:
        params = dict(prn=np.zeros(num_k, np.int32), dop=np.full(num_k, 1500.0, np.float32),
                      cph=np.zeros(num_k, np.float32),
                      cf=np.full(num_k, SYSTEM.code_frequency, np.float32),
                      coph=np.zeros(num_k, np.float32))
    else:
        params = dict(
            prn=(np.arange(num_k) % 32).astype(np.int32),
            dop=(1500.0 + rng.uniform(-4000.0, 4000.0, num_k)).astype(np.float32),
            cph=rng.uniform(0, 2 * np.pi, num_k).astype(np.float32),
            cf=(SYSTEM.code_frequency + rng.uniform(-3, 3, num_k)).astype(np.float32),
            coph=rng.uniform(0, SYSTEM.code_length, num_k).astype(np.float32))
    return dict(sre=np.array(signal.real), sim=np.array(signal.imag), fs=fs,
                shifts=tuple(int(s) for s in shifts), **params)


def _jax(c, algo, **kw):
    fn = jax.jit(functools.partial(jregistry.get(algo), sample_shifts=c["shifts"],
                                   code_length=SYSTEM.code_length,
                                   sampling_frequency=c["fs"], **kw))
    are, aim = fn(jnp.asarray(c["sre"]), jnp.asarray(c["sim"]), jnp.asarray(SYSTEM.codes),
                  jnp.asarray(c["prn"]), jnp.asarray(c["dop"]),
                  carrier_phase=jnp.asarray(c["cph"]), code_frequency=jnp.asarray(c["cf"]),
                  code_phase=jnp.asarray(c["coph"]))
    return np.asarray(are), np.asarray(aim)


def _args(c):
    t = torch.as_tensor
    return (t(c["sre"]), t(c["sim"]), t(SYSTEM.codes), t(c["prn"]), t(c["dop"]), c["fs"],
            t(c["cph"]), t(c["cf"]), t(c["coph"]), c["shifts"], SYSTEM.code_length)


def _port(algo, c, **kw):
    are, aim = tregistry.get(algo)(*_args(c), **kw)
    return are.numpy(), aim.numpy()


@functools.lru_cache(maxsize=None)
def _wide_span_jax():
    c = _case(4096, 2, shifts=(-160, 0, 170), golden=True)
    return c, _jax(c, "pallas_bank_onehot", tile_rows=8)


def test_wide_span_matches_jax_onehot_kernel():
    # tests/test_pallas.py:370-394: K=2, N=4096, span 330 samples.
    c, want = _wide_span_jax()
    got = _port("pallas_bank_onehot", c)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 3)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=0.3)


def test_wide_span_matches_jax_fused_xla():
    c, _ = _wide_span_jax()
    fn = jax.jit(functools.partial(jregistry.get("fused_xla"), sample_shifts=c["shifts"],
                                   code_length=SYSTEM.code_length))
    are, aim = fn(jnp.asarray(c["sre"]), jnp.asarray(c["sim"]), jnp.asarray(SYSTEM.codes),
                  0, 1500.0, c["fs"], 0.0, SYSTEM.code_frequency, 0.0)
    got = _port("pallas_bank_onehot", c)
    np.testing.assert_allclose(got[0][0], np.asarray(are), rtol=1e-3, atol=0.3)
    np.testing.assert_allclose(got[1][0], np.asarray(aim), rtol=1e-3, atol=0.3)


@pytest.mark.parametrize("num_samples,num_k,seed", [(8192, 4, 1), (2500, 3, 2)])
def test_random_channels_match_jax_onehot_kernel(num_samples, num_k, seed):
    # 2.5 MHz is ~0.41 chips/sample, where the rows route refuses: the
    # one-hot route takes any chip rate.
    c = _case(num_samples, num_k, seed=seed)
    want = _jax(c, "pallas_bank_onehot", tile_rows=8)
    got = _port("pallas_bank_onehot", c)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=4.5)


@pytest.mark.parametrize("shifts", [None, (-160, 0, 170)])
def test_matches_the_rows_route(shifts):
    c = _case(32768, 6, shifts=shifts, seed=3)
    got = _port("pallas_bank_onehot", c)
    want = _port("pallas_bank_rows", c, nominal_code_frequency=SYSTEM.code_frequency)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=4.5)


def test_route_takes_no_envelope_and_no_nominal_rates():
    c = _case(2500, 2, seed=4)
    got = _port("pallas_bank_onehot", c)
    ref = epl_kernels.correlate_bank_rows_reference(*_args(c), route="pallas_bank_onehot")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    bank = epl_kernels.BankRowsCall(*_args(c), route="pallas_bank_onehot")
    assert (bank.rho_nom, bank.fcar_nom_cyc) == (0.0, 0.0)
    with pytest.raises(TypeError):
        epl_kernels.correlate_pallas_bank_onehot(
            *_args(c), nominal_code_frequency=SYSTEM.code_frequency)
    with pytest.raises(ValueError, match="CUDA tensors"):
        epl_kernels.launch_bank_rows(bank)
    assert epl_kernels.correlate_pallas_bank_onehot.launches == 0


def test_hoisted_code_tiles_give_the_same_result():
    c = _case(8192, 5, seed=5)
    args = _args(c)
    tiles = epl_kernels.prepare_bank_code_tiles_rows(args[2], args[3])
    got = epl_kernels.correlate_pallas_bank_onehot(*args, code_tiles=tiles)
    want = _port("pallas_bank_onehot", c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_jax_prepares_its_own_table():
    # The JAX kernel's padded [K, ceil(Lc/128), 128] planes hold the same
    # columns as the port's packed [K, ceil(Lc/32)] table.
    prn = np.array([0, 7, 31])
    jax_tiles = np.asarray(pallas_epl.prepare_bank_code_tiles_onehot(
        jnp.asarray(SYSTEM.codes), jnp.asarray(prn), code_length=SYSTEM.code_length))
    port = epl_kernels.prepare_bank_code_tiles_rows(torch.as_tensor(SYSTEM.codes),
                                                    torch.as_tensor(prn))
    port = epl_kernels.unpack_code_columns(port, SYSTEM.code_length).numpy()
    np.testing.assert_array_equal(jax_tiles.reshape(3, -1)[:, :SYSTEM.code_length], port)
