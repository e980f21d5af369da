"""PyTorch port, transition route: `pallas_bank` (served by the bank_rows
kernel, whose per-sample chip lookup has no chip-rate ceiling) against the
JAX transition kernel in Pallas interpret mode, and bank routing.

Routing against the JAX router over GPS L1 and L5 is held by
tests/test_torch_epl_kernels.py. Cases and tolerances are
tests/test_pallas.py's `TestBankKernel`: GPS L5 at
32.768 MHz (0.31 chips/sample), the L5 M=4 L=7 challenge cell, and GPS L1
below ~6 MHz. Each f32 chip-boundary flip moves one sample by +/-2.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu.ops import registry as jregistry
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch.ops import bank_comp, epl_kernels

torch.set_num_threads(1)

# name -> (system, N, K, A, taps, matched (prn, Hz) or None, seed, rtol, atol)
CASES = {
    "l5_n32768": ("GPSL5", 32768, 2, 1, 3, (3, 2000.0), 0, 1e-3, 3.0),
    "l5_a4_l7_challenge": ("GPSL5", 32768, 1, 4, 7, (6, -1800.0), 0, 2e-3, 8.0),
    "l5_random_k8": ("GPSL5", 32768, 8, 1, 3, None, 1, 2e-3, 8.0),
    "l1_n2500": ("GPSL1", 2500, 4, 1, 3, None, 2, 1e-3, 3.0),
    "l1_4096khz": ("GPSL1", 4096, 4, 1, 3, None, 3, 1e-3, 3.0),
    "l1_4096khz_a2": ("GPSL1", 4096, 3, 2, 3, None, 4, 1e-3, 3.0),
}


def _case(system_name, num_samples, num_k, num_ants, taps, matched, seed):
    system = jmodels.get_system(system_name)
    fs = num_samples / 1e-3
    prn, fcar = matched or (0, 1500.0)
    signal, _ = jmodels.gen_signal(system, prn, fcar, num_samples,
                                   num_ants=None if num_ants == 1 else num_ants)
    shifts = jmodels.correlator_sample_shifts(system, jmodels.EPLCorrelator(taps), fs)
    rng = np.random.default_rng(seed)
    c = dict(
        system=system_name, sre=np.array(signal.real), sim=np.array(signal.imag),
        fs=fs, shifts=tuple(int(s) for s in shifts),
        prn=(np.arange(num_k) % 32).astype(np.int32),
        dop=(fcar + rng.uniform(-4000.0, 4000.0, num_k)).astype(np.float32),
        cph=rng.uniform(0, 2 * np.pi, num_k).astype(np.float32),
        cf=(system.code_frequency + rng.uniform(-3, 3, num_k)).astype(np.float32),
        coph=rng.uniform(0, system.code_length, num_k).astype(np.float32),
    )
    if matched:
        z = np.zeros(num_k, np.float32)
        c.update(prn=z.astype(np.int32) + prn, dop=z + fcar, cph=z,
                 cf=z + np.float32(system.code_frequency), coph=z)
    return c


def _run_jax(algo, c):
    system = jmodels.get_system(c["system"])
    kw = {} if algo == "xla_bank" else {"nominal_code_frequency": system.code_frequency}
    fn = jax.jit(functools.partial(
        jregistry.get(algo), sample_shifts=c["shifts"], code_length=system.code_length,
        sampling_frequency=c["fs"], **kw))
    are, aim = fn(jnp.asarray(c["sre"]), jnp.asarray(c["sim"]),
                  jnp.asarray(system.codes), jnp.asarray(c["prn"]),
                  jnp.asarray(c["dop"]), carrier_phase=jnp.asarray(c["cph"]),
                  code_frequency=jnp.asarray(c["cf"]),
                  code_phase=jnp.asarray(c["coph"]))
    return np.asarray(are), np.asarray(aim)


def _args(c):
    system = tmodels.get_system(c["system"])
    t = torch.as_tensor
    return (t(c["sre"]), t(c["sim"]), t(system.codes), t(c["prn"]), t(c["dop"]),
            c["fs"], t(c["cph"]), t(c["cf"]), t(c["coph"]), c["shifts"],
            system.code_length)


def _run_port(fn, c, **kw):
    system = tmodels.get_system(c["system"])
    are, aim = fn(*_args(c), nominal_code_frequency=system.code_frequency, **kw)
    return are.numpy(), aim.numpy()


@pytest.fixture(scope="module")
def jax_results():
    """JAX transition kernel (interpret) per case, computed once."""
    out = {}
    for name, (*spec, _rtol, _atol) in CASES.items():
        c = _case(*spec)
        out[name] = (c, _run_jax("pallas_bank", c))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_transition_route_matches_jax_transition_kernel(jax_results, name):
    c, want = jax_results[name]
    rtol, atol = CASES[name][-2:]
    got = _run_port(epl_kernels.correlate_pallas_bank, c)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["l5_n32768", "l1_n2500", "l1_4096khz_a2"])
def test_auto_routes_to_transition(jax_results, name):
    c, want = jax_results[name]
    system = jmodels.get_system(c["system"])
    n = c["sre"].shape[-1]
    num_ants = c["sre"].shape[0] if c["sre"].ndim == 2 else 1
    assert epl_kernels.bank_algorithm_for(
        n, c["fs"], system.code_length, system.code_frequency,
        num_ants=num_ants) == "pallas_bank"
    got = _run_port(epl_kernels.correlate_pallas_bank_auto, c)
    plain = _run_port(epl_kernels.correlate_bank_rows_reference, c, route="pallas_bank")
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, w, rtol=CASES[name][-2], atol=CASES[name][-1])


def test_wide_span_raises():
    # tests/test_pallas.py:360: the transition kernel keeps span < 128.
    c = _case("GPSL1", 131072 // 16, 1, 1, 3, None, 0)
    c["shifts"] = (-64, 0, 64)
    with pytest.raises(ValueError, match="tap span 128"):
        _run_port(epl_kernels.correlate_pallas_bank, c)


def test_one_chip_per_sample_raises():
    c = _case("GPSL1", 2500, 1, 1, 3, None, 0)
    with pytest.raises(ValueError, match="< 1 chip per sample"):
        _run_port(epl_kernels.correlate_pallas_bank, c, max_chips_per_sample=1.0)


def test_transition_route_has_no_rows_ceiling():
    # The rows route refuses 0.31 chips/sample; the transition route takes it.
    c = _case("GPSL5", 8192, 2, 1, 3, None, 5)
    c["fs"] = 32.768e6
    with pytest.raises(ValueError, match="chips/sample"):
        _run_port(epl_kernels.correlate_pallas_bank_rows, c)
    are, _ = _run_port(epl_kernels.correlate_pallas_bank, c)
    assert are.shape == (2, 3) and np.isfinite(are).all()


def test_bf16_at_low_rate_warns_and_runs_f32():
    # tests/test_tracking.py:305-321: auto cannot honour bf16 here, and says so.
    c = _case("GPSL1", 2500, 2, 1, 3, None, 0)
    with pytest.warns(UserWarning, match="does not support bf16"):
        got = _run_port(epl_kernels.correlate_pallas_bank_auto, c, z_dtype="bf16")
    want = _run_port(epl_kernels.correlate_pallas_bank, c)
    np.testing.assert_array_equal(got[0], want[0])


def test_auto_routes_bf16_and_antennas_to_comp():
    c = _case("GPSL1", 8192, 3, 2, 3, None, 6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for z in ("f32", "bf16"):
            got = _run_port(epl_kernels.correlate_pallas_bank_auto, c, z_dtype=z)
            want = _run_port(bank_comp.correlate_pallas_bank_comp, c, z_dtype=z)
            np.testing.assert_array_equal(got[0], want[0])


def test_unknown_route_and_cpu_launch_are_refused():
    c = _case("GPSL1", 8192, 2, 1, 3, None, 0)
    bank = epl_kernels.BankRowsCall(*_args(c), tmodels.GPSL1().code_frequency,
                                    route="pallas_bank")
    with pytest.raises(ValueError, match="CUDA tensors"):
        epl_kernels.launch_bank_rows(bank)
    with pytest.raises(ValueError, match="unknown bank route"):
        epl_kernels.BankRowsCall(*_args(c), route="pallas_bank_onehot")
    assert epl_kernels.correlate_pallas_bank.launches == 0
