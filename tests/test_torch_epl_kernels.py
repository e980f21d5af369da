"""PyTorch port, bank kernel module: the plain version of `pallas_bank_rows`
against the JAX rows kernel (Pallas interpret mode) and the JAX plain bank.

On the CPU, `correlate_pallas_bank_rows` runs its plain version; the CUDA
kernel itself is compared with it on the card by tests/test_torch_cuda.py
and ``chip_smoke.py``. Tolerances are those of tests/test_pallas.py:
each f32 chip-boundary flip moves one sample by +/-2.
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
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
from gpuacceleratedtracking_tpu_torch.ops import registry as tregistry

torch.set_num_threads(1)

SYSTEM = jmodels.GPSL1()
CODES_T = torch.as_tensor(tmodels.GPSL1().codes)

# (name, N, K, A, shifts or None, seed)
CASES = {
    "n8192_k5": (8192, 5, 1, None, 0),
    "n32768_k8": (32768, 8, 1, None, 0),
    "wide_span": (8192, 4, 1, (-160, 0, 170), 5),
    "two_antennas": (8192, 3, 2, None, 4),
}


def _case(num_samples, num_k, num_ants, shifts, seed):
    rng = np.random.default_rng(seed)
    fs = num_samples / 1e-3
    signal, _ = jmodels.gen_signal(SYSTEM, 0, 1500.0, num_samples,
                                   num_ants=None if num_ants == 1 else num_ants)
    if shifts is None:
        shifts = jmodels.correlator_sample_shifts(SYSTEM, jmodels.EPLCorrelator(3), fs)
    return dict(
        sre=np.array(signal.real), sim=np.array(signal.imag), fs=fs,
        shifts=tuple(int(s) for s in shifts),
        prn=(np.arange(num_k) % 32).astype(np.int32),
        dop=(1500.0 + rng.uniform(-4000.0, 4000.0, num_k)).astype(np.float32),
        cph=rng.uniform(0, 2 * np.pi, num_k).astype(np.float32),
        cf=(SYSTEM.code_frequency + rng.uniform(-3, 3, num_k)).astype(np.float32),
        coph=rng.uniform(0, SYSTEM.code_length, num_k).astype(np.float32),
    )


def _run_jax(algo, c):
    kw = {} if algo == "xla_bank" else {"nominal_code_frequency": SYSTEM.code_frequency}
    fn = jax.jit(functools.partial(
        jregistry.get(algo), sample_shifts=c["shifts"],
        code_length=SYSTEM.code_length, sampling_frequency=c["fs"], **kw))
    are, aim = fn(jnp.asarray(c["sre"]), jnp.asarray(c["sim"]),
                  jnp.asarray(SYSTEM.codes), jnp.asarray(c["prn"]),
                  jnp.asarray(c["dop"]), carrier_phase=jnp.asarray(c["cph"]),
                  code_frequency=jnp.asarray(c["cf"]),
                  code_phase=jnp.asarray(c["coph"]))
    return np.asarray(are), np.asarray(aim)


def _args(c, device="cpu"):
    t = functools.partial(torch.as_tensor, device=device)
    return (t(c["sre"]), t(c["sim"]), CODES_T.to(device), t(c["prn"]),
            t(c["dop"]), c["fs"], t(c["cph"]), t(c["cf"]), t(c["coph"]),
            c["shifts"], SYSTEM.code_length)


def _run_port(algo, c):
    are, aim = tregistry.get(algo)(
        *_args(c), nominal_code_frequency=SYSTEM.code_frequency)
    return are.numpy(), aim.numpy()


@pytest.fixture(scope="module")
def jax_results():
    """JAX rows kernel (interpret) and JAX plain bank per case, computed once."""
    out = {}
    for name, spec in CASES.items():
        c = _case(*spec)
        out[name] = (c, _run_jax("pallas_bank_rows", c), _run_jax("xla_bank", c))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_rows_matches_jax_rows_and_xla_bank(jax_results, name):
    c, want_rows, want_xla = jax_results[name]
    got = _run_port("pallas_bank_rows", c)
    atol = 4.5
    for g, wr, wx in zip(got, want_rows, want_xla):
        assert g.shape == wr.shape
        np.testing.assert_allclose(g, wr, rtol=2e-3, atol=atol)
        np.testing.assert_allclose(g, wx, rtol=2e-3, atol=atol)


@pytest.mark.parametrize("name", ["n8192_k5", "n32768_k8", "wide_span"])
def test_auto_routes_to_rows(jax_results, name):
    c, want_rows, _ = jax_results[name]
    got = _run_port("pallas_bank_auto", c)
    rows = _run_port("pallas_bank_rows", c)
    for g, r, w in zip(got, rows, want_rows):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=4.5)


def test_reference_function_equals_cpu_dispatch():
    c = _case(8192, 3, 1, None, 7)
    kw = {"nominal_code_frequency": SYSTEM.code_frequency}
    a = epl_kernels.correlate_bank_rows_reference(*_args(c), **kw)
    b = epl_kernels.correlate_pallas_bank_rows(*_args(c), **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_plain_chunking_is_exact(monkeypatch):
    c = _case(8192, 5, 1, None, 8)
    kw = {"nominal_code_frequency": SYSTEM.code_frequency}
    whole = epl_kernels.correlate_bank_rows_reference(*_args(c), **kw)
    monkeypatch.setattr(epl_kernels, "_CHUNK_ELEMENTS", 2 * 8192)
    chunked = epl_kernels.correlate_bank_rows_reference(*_args(c), **kw)
    for x, y in zip(whole, chunked):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("num_ants", [1, 2])
def test_golden_prompt_is_exactly_n(num_ants):
    # tests/test_pallas.py's golden prompt: matched channels give exactly N.
    n = 32768
    fs = n / 1e-3
    system = tmodels.GPSL1()
    signal, _ = tmodels.gen_signal(system, 0, 1500.0, n,
                                   num_ants=None if num_ants == 1 else num_ants, device="cpu")
    sre, sim = tmodels.soa(signal)
    shifts = tuple(int(s) for s in tmodels.correlator_sample_shifts(
        system, tmodels.EPLCorrelator(3), fs))
    z = torch.zeros(3)
    are, _ = epl_kernels.correlate_pallas_bank_rows(
        sre, sim, CODES_T, torch.zeros(3, dtype=torch.int32), z + 1500.0, fs, z,
        z + system.code_frequency, z, shifts, system.code_length,
        nominal_code_frequency=system.code_frequency)
    prompt = are[..., 1].numpy()
    np.testing.assert_array_equal(prompt, np.full(prompt.shape, float(n)))


@pytest.mark.parametrize("fs", [2.5e6, 4.096e6, 5.0e6, 6.5536e6, 8.192e6,
                                16.384e6, 32.768e6, 65.536e6, 131.072e6, 262.144e6])
def test_bank_algorithm_for_agrees_with_jax(fs):
    n = int(round(fs * 1e-3))
    for system in (SYSTEM, jmodels.GPSL5()):
        for num_ants in (1, 2, 4):
            for j_z, t_z in ((jnp.float32, torch.float32), (jnp.bfloat16, "bf16")):
                want = pallas_epl.bank_algorithm_for(
                    n, fs, system.code_length, system.code_frequency,
                    num_ants=num_ants, z_dtype=j_z)
                got = epl_kernels.bank_algorithm_for(
                    n, fs, system.code_length, system.code_frequency,
                    num_ants=num_ants, z_dtype=t_z)
                assert got == want, (system.name, fs, num_ants, t_z)


def test_low_rate_rejected():
    # 2.5 MHz GPS L1 is ~0.41 chips/sample: the rows kernel refuses.
    c = _case(2500, 2, 1, None, 0)
    with pytest.raises(ValueError, match="chips/sample"):
        _run_port("pallas_bank_rows", c)


def test_auto_raises_for_unported_routes():
    # Every route the router resolves is ported now: the scenarios that once
    # raised NotImplementedError run their route's plain version on the CPU.
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp

    c = _case(2500, 2, 1, None, 0)   # 0.41 chips/sample: the transition route
    kw = {"nominal_code_frequency": SYSTEM.code_frequency}
    for x, y in zip(_run_port("pallas_bank_auto", c),
                    epl_kernels.correlate_pallas_bank(*_args(c), **kw)):
        np.testing.assert_array_equal(x, y.numpy())
    c = _case(8192, 2, 2, None, 0)   # multi-antenna routes to the composite kernel
    for x, y in zip(_run_port("pallas_bank_auto", c),
                    bank_comp.correlate_pallas_bank_comp(*_args(c), **kw)):
        np.testing.assert_array_equal(x, y.numpy())


def test_launch_counter_stays_zero_on_cpu():
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp

    counted = (epl_kernels.correlate_pallas_bank_rows, epl_kernels.correlate_pallas_bank,
               bank_comp.correlate_pallas_bank_comp)
    _run_port("pallas_bank_rows", _case(8192, 2, 1, None, 1))
    _run_port("pallas_bank_auto", _case(8192, 2, 1, None, 1))
    _run_port("pallas_bank_auto", _case(2500, 2, 1, None, 1))
    _run_port("pallas_bank_auto", _case(8192, 2, 2, None, 1))
    assert [fn.launches for fn in counted] == [0, 0, 0]


def test_tile_base_is_exact_nominal_phase():
    fs = 32.768e6
    rho_nom = SYSTEM.code_frequency / fs
    fnom = 1500.0 / fs
    base = epl_kernels._tile_base(8, epl_kernels.TILE, fnom, rho_nom, 1023,
                                  torch.device("cpu")).numpy()
    n0 = np.arange(8) * epl_kernels.TILE
    np.testing.assert_array_equal(
        base[:, 0], np.mod(fnom * n0, 1.0).astype(np.float32))
    np.testing.assert_array_equal(
        base[:, 1], np.mod(rho_nom * n0, 1023.0).astype(np.float32))


def test_kernel_input_checks():
    # Four taps, outside the instantiations: taken, as one launch of five
    # taps whose last repeats the fourth (`launch_groups`).
    c = _case(8192, 2, 1, (-16, -8, 0, 8), 0)
    bank = epl_kernels.BankRowsCall(*_args(c), SYSTEM.code_frequency, 0.0, None, None)
    epl_kernels._check_kernel_inputs(bank)
    assert epl_kernels.launch_groups(bank.num_ants, len(bank.deltas)) == \
        ((0, 1, (0, 1, 2, 3, 3)),)
    c = _case(8192, 2, 1, None, 0)
    bank = epl_kernels.BankRowsCall(*_args(c), SYSTEM.code_frequency, 0.0, None,
                             CODES_T.T[:2, :1000].contiguous())
    with pytest.raises(ValueError, match="code_tiles shape"):
        epl_kernels._check_kernel_inputs(bank)


def test_kernel_launch_refuses_cpu_tensors():
    bank = epl_kernels.BankRowsCall(*_args(_case(8192, 2, 1, None, 0)),
                                    SYSTEM.code_frequency)
    with pytest.raises(ValueError, match="CUDA tensors"):
        epl_kernels.launch_bank_rows(bank)
    assert epl_kernels.correlate_pallas_bank_rows.launches == 0
