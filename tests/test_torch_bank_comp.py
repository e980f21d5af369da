"""PyTorch port, composite bank route: the plain version of `pallas_bank_comp`
against the JAX composite kernel (Pallas interpret mode), the JAX rows kernel
and the port's rows route.

The cases are tests/test_pallas.py's `TestBankCompKernel`. The JAX suite holds
its composite kernel to 3e-5 of the largest accumulator against its rows
kernel, which shares its chip arithmetic; here the port's composite route is
held to that against the port's rows route, which shares the port's chip
arithmetic. Against the JAX kernels the port is held to the rows-parity
envelope of tests/test_torch_epl_kernels.py (rtol 2e-3, atol 4.5): the two
packages round chip phases differently (the port keeps the chip fraction
apart within 4096-sample tiles), and each chip-boundary flip moves one sample
by +/-2.
"""

import functools

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

SYSTEM = jmodels.GPSL1()
CODES_T = torch.as_tensor(tmodels.GPSL1().codes)
ENVELOPE = dict(rtol=2e-3, atol=4.5)

# name -> (N, K, A, shifts or None, seed, matched, JAX comp kwargs)
CASES = {
    "golden_k3": (32768, 3, 1, None, 0, True, {"chans_per_step": 3}),
    "matches_rows_n32768_k8": (32768, 8, 1, None, 0, False, {"chans_per_step": 4}),
    "matches_rows_n8192_k5": (8192, 5, 1, None, 0, False, {"chans_per_step": 4}),
    "halo_exact_tile": (32768, 4, 1, None, 7, False, {"chans_per_step": 2}),
    "padded_k5": (32768, 5, 1, None, 3, False, {"chans_per_step": 3}),
    "two_antennas": (32768, 2, 2, None, 0, True, {"chans_per_step": 2}),
    "wide_span_two_antennas": (8192, 3, 2, (-160, 0, 170), 6, False,
                               {"chans_per_step": 2, "tile_rows": 32}),
    "unaligned_n20000": (20000, 3, 1, None, 5, False, {"chans_per_step": 3}),
    "bf16_z": (32768, 4, 1, None, 11, False,
               {"chans_per_step": 2, "z_dtype": jnp.bfloat16,
                "mac_precision": jax.lax.Precision.DEFAULT}),
}


def _case(num_samples, num_k, num_ants, shifts, seed, matched):
    rng = np.random.default_rng(seed)
    fs = num_samples / 1e-3
    signal, _ = jmodels.gen_signal(SYSTEM, 0, 1500.0, num_samples,
                                   num_ants=None if num_ants == 1 else num_ants)
    if shifts is None:
        shifts = jmodels.correlator_sample_shifts(SYSTEM, jmodels.EPLCorrelator(3), fs)
    c = dict(
        sre=np.array(signal.real), sim=np.array(signal.imag), fs=fs,
        shifts=tuple(int(s) for s in shifts),
        prn=(np.arange(num_k) % 32).astype(np.int32),
        dop=(1500.0 + rng.uniform(-4000.0, 4000.0, num_k)).astype(np.float32),
        cph=rng.uniform(0, 2 * np.pi, num_k).astype(np.float32),
        cf=(SYSTEM.code_frequency + rng.uniform(-3, 3, num_k)).astype(np.float32),
        coph=rng.uniform(0, SYSTEM.code_length, num_k).astype(np.float32),
    )
    if matched:   # tests/test_pallas.py's golden channels: PRN 0, 1500 Hz, zero phases
        z = np.zeros(num_k, np.float32)
        c.update(prn=z.astype(np.int32), dop=z + 1500.0, cph=z,
                 cf=z + np.float32(SYSTEM.code_frequency), coph=z)
    return c


def _run_jax(algo, c, **kw):
    if algo != "xla_bank":
        kw["nominal_code_frequency"] = SYSTEM.code_frequency
    fn = jax.jit(functools.partial(
        jregistry.get(algo), sample_shifts=c["shifts"],
        code_length=SYSTEM.code_length, sampling_frequency=c["fs"], **kw))
    are, aim = fn(jnp.asarray(c["sre"]), jnp.asarray(c["sim"]),
                  jnp.asarray(SYSTEM.codes), jnp.asarray(c["prn"]),
                  jnp.asarray(c["dop"]), carrier_phase=jnp.asarray(c["cph"]),
                  code_frequency=jnp.asarray(c["cf"]),
                  code_phase=jnp.asarray(c["coph"]))
    return np.asarray(are), np.asarray(aim)


def _args(c):
    t = torch.as_tensor
    return (t(c["sre"]), t(c["sim"]), CODES_T, t(c["prn"]), t(c["dop"]), c["fs"],
            t(c["cph"]), t(c["cf"]), t(c["coph"]), c["shifts"], SYSTEM.code_length)


def _run_port(fn, c, **kw):
    are, aim = fn(*_args(c), nominal_code_frequency=SYSTEM.code_frequency, **kw)
    return are.numpy(), aim.numpy()


@pytest.fixture(scope="module")
def jax_results():
    """Per case: inputs, the JAX composite kernel (interpret), the JAX rows
    kernel and, for the wide span, the JAX plain bank. Computed once."""
    out = {}
    for name, (*spec, comp_kw) in CASES.items():
        c = _case(*spec)
        ref = "xla_bank" if name.startswith("wide_span") else "pallas_bank_rows"
        out[name] = (c, _run_jax("pallas_bank_comp", c, **comp_kw), _run_jax(ref, c))
    return out


@pytest.mark.parametrize("name", ["matches_rows_n32768_k8", "matches_rows_n8192_k5",
                                  "halo_exact_tile", "padded_k5", "unaligned_n20000"])
def test_plain_comp_matches_jax_comp_and_port_rows(jax_results, name):
    c, want_comp, want_rows = jax_results[name]
    got = _run_port(bank_comp.correlate_pallas_bank_comp, c)
    rows = _run_port(epl_kernels.correlate_pallas_bank_rows, c)
    scale = np.abs(rows[0]).max()
    for g, r, wc, wr in zip(got, rows, want_comp, want_rows):
        assert g.shape == wc.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=3e-5 * scale)
        np.testing.assert_allclose(g, wc, **ENVELOPE)
        np.testing.assert_allclose(g, wr, **ENVELOPE)


@pytest.mark.parametrize("name", ["golden_k3", "two_antennas"])
def test_matched_prompt_is_n(jax_results, name):
    # tests/test_pallas.py:622-634 and :660-673: prompt = N within rtol 1e-5.
    c, want_comp, _ = jax_results[name]
    got = _run_port(bank_comp.correlate_pallas_bank_comp, c)
    n = c["sre"].shape[-1]
    assert got[0].shape == want_comp[0].shape
    np.testing.assert_allclose(got[0][..., 1], np.full(got[0].shape[:-1], float(n)),
                               rtol=1e-5)
    np.testing.assert_allclose(got[0], want_comp[0], rtol=1e-5, atol=0.05)


def test_wide_span_two_antennas_matches_xla_bank(jax_results):
    # tests/test_pallas.py:675-689: against the JAX plain bank, atol 4.5.
    c, want_comp, want_xla = jax_results["wide_span_two_antennas"]
    got = _run_port(bank_comp.correlate_pallas_bank_comp, c)
    for g, wc, wx in zip(got, want_comp, want_xla):
        assert g.shape == wx.shape == (3, 2, 3)
        np.testing.assert_allclose(g, wx, **ENVELOPE)
        np.testing.assert_allclose(g, wc, **ENVELOPE)


def test_bf16_z_tracking_grade(jax_results):
    # tests/test_pallas.py:603-620: bf16 planes within 4e-3 of the largest
    # accumulator, against the JAX rows kernel and the JAX bf16 composite.
    c, want_comp, want_rows = jax_results["bf16_z"]
    got = _run_port(bank_comp.correlate_pallas_bank_comp, c, z_dtype="bf16")
    f32 = _run_port(bank_comp.correlate_pallas_bank_comp, c)
    scale = np.abs(want_rows[0]).max()
    for g, f, wc, wr in zip(got, f32, want_comp, want_rows):
        np.testing.assert_allclose(g, wr, rtol=0, atol=4e-3 * scale)
        np.testing.assert_allclose(g, wc, rtol=0, atol=4e-3 * scale)
        np.testing.assert_allclose(g, f, rtol=0, atol=4e-3 * scale)
    assert not np.array_equal(got[0], f32[0])   # the planes really were rounded
    torch_dtype = _run_port(bank_comp.correlate_pallas_bank_comp, c, z_dtype=torch.bfloat16)
    np.testing.assert_array_equal(torch_dtype[0], got[0])


def test_low_rate_rejected():
    # tests/test_pallas.py:700-703.
    c = _case(2500, 2, 1, None, 0, False)
    with pytest.raises(ValueError, match="chips/sample"):
        _run_port(bank_comp.correlate_pallas_bank_comp, c)


def test_reference_function_equals_cpu_dispatch():
    c = _case(8192, 3, 2, None, 7, False)
    for z in ("f32", "bf16"):
        a = _run_port(bank_comp.correlate_bank_comp_reference, c, z_dtype=z)
        b = _run_port(bank_comp.correlate_pallas_bank_comp, c, z_dtype=z)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_plain_chunking_is_exact(monkeypatch):
    c = _case(8192, 5, 1, None, 8, False)
    whole = _run_port(bank_comp.correlate_bank_comp_reference, c)
    monkeypatch.setattr(bank_comp, "_CHUNK_ELEMENTS", 2 * 8192)
    chunked = _run_port(bank_comp.correlate_bank_comp_reference, c)
    for x, y in zip(whole, chunked):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)


def test_single_antenna_squeezes():
    c = _case(8192, 3, 1, None, 2, False)
    are, aim = _run_port(bank_comp.correlate_pallas_bank_comp, c)
    assert are.shape == aim.shape == (3, 3)


def test_kernel_launch_refuses_cpu_tensors_and_bad_shapes():
    c = _case(8192, 2, 1, None, 0, False)
    bank = bank_comp.BankCompCall(*_args(c), SYSTEM.code_frequency)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bank_comp.launch_bank_comp(bank)
    c = _case(8192, 2, 1, (-16, -8, 0, 8), 0, False)   # four taps: no instantiation
    bank = bank_comp.BankCompCall(*_args(c), SYSTEM.code_frequency)
    with pytest.raises(ValueError, match="bank_comp kernel takes A in"):
        epl_kernels._check_kernel_inputs(bank, kernel="bank_comp")
    assert bank_comp.correlate_pallas_bank_comp.launches == 0


def test_shifted_planes_are_the_delayed_signal():
    c = _case(8192, 2, 2, (-3, 0, 5), 1, False)
    bank = bank_comp.BankCompCall(*_args(c), SYSTEM.code_frequency)
    planes = bank_comp._shifted_planes(bank).numpy()
    n, span = 8192, 8
    assert planes.shape == (12, bank.num_tiles * epl_kernels.TILE)
    for a in range(2):
        for l, delta in enumerate((0, 3, 8)):
            row = planes[a * 3 + l]
            np.testing.assert_array_equal(row[delta:delta + n], c["sre"][a])
            assert not row[:delta].any() and not row[delta + n:].any()
            np.testing.assert_array_equal(planes[6 + a * 3 + l][delta:delta + n],
                                          c["sim"][a])
    assert bank.num_tiles == -(-(n + span) // epl_kernels.TILE)
