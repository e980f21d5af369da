"""PyTorch port, the correlator kernels' antenna and tap range: the plain
versions of `pallas_bank_rows`, `pallas_bank_comp`, `pallas_fused` and
`pallas_taps` against the JAX kernels (Pallas interpret mode) at shapes
outside the CUDA kernels' instantiations (A <= 4, L in {3, 5, 7}), which the
wrappers cover on the card by launch groups (`epl_kernels.launch_groups`).

The banks run GPS L1 at 32.768 MHz, N = 32768, K = 2 (PRNs 6 and 7 at
1500 Hz, zero phases, against a PRN 0 signal); the per-channel kernels one
such channel (PRN 6) at 8.192 MHz, N = 8192. Tolerance: atol 5e-3, on
accumulators up to ~2000 (banks) and ~10 (one channel); the two packages
sum in other orders and round the chip phases apart, but no chip boundary
falls between them here (measured on the CPU: at most 1.4e-3 for the banks,
1.2e-4 for one channel). The kernels themselves are
held to these plain versions on the card by tests/test_torch_cuda.py and
``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu.ops import registry as jregistry
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
from gpuacceleratedtracking_tpu_torch.ops import registry as tregistry

torch.set_num_threads(1)

SYSTEM = jmodels.GPSL1()
ATOL = 5e-3
SHAPES = {"a8_l3": (8, 3), "a5_l3": (5, 3), "a1_l9": (1, 9)}
BANKS = ("pallas_bank_rows", "pallas_bank_comp")
CHANNELS = ("pallas_fused", "pallas_taps")


@functools.lru_cache(maxsize=None)
def _case(algo, shape):
    num_ants, num_taps = SHAPES[shape]
    bank = algo in BANKS
    n = 32768 if bank else 8192
    fs = n / 1e-3 if bank else 8.192e6
    signal, _ = jmodels.gen_signal(SYSTEM, 0, 1500.0, n, duration=n / fs,
                                   num_ants=None if num_ants == 1 else num_ants)
    shifts = jmodels.correlator_sample_shifts(SYSTEM, jmodels.EPLCorrelator(num_taps), fs)
    k = 2 if bank else 1
    return dict(sre=np.array(signal.real), sim=np.array(signal.imag), fs=fs,
                shifts=tuple(int(s) for s in shifts),
                prn=np.arange(6, 6 + k, dtype=np.int32),
                fcar=np.full(k, 1500.0, np.float32), zero=np.zeros(k, np.float32),
                fcode=np.full(k, SYSTEM.code_frequency, np.float32))


def _args(c, bank, lib):
    """The registry signature's arguments: ``[K]`` channel parameters for a
    bank, scalars for one channel."""
    if lib == "jax":
        arr = jnp.asarray
    else:
        arr = torch.as_tensor
    if bank:
        params = (arr(c["prn"]), arr(c["fcar"]), c["fs"], arr(c["zero"]), arr(c["fcode"]),
                  arr(c["zero"]))
    else:
        params = (int(c["prn"][0]), 1500.0, c["fs"], 0.0, SYSTEM.code_frequency, 0.0)
    return (arr(c["sre"]), arr(c["sim"]), arr(SYSTEM.codes), *params)


@functools.lru_cache(maxsize=None)
def _jax(algo, shape):
    c = _case(algo, shape)
    bank = algo in BANKS
    kw = {"nominal_code_frequency": SYSTEM.code_frequency} if bank else {}
    fn = jax.jit(functools.partial(jregistry.get(algo), sample_shifts=c["shifts"],
                                   code_length=SYSTEM.code_length, **kw),
                 static_argnums=(5,))                  # the sampling frequency
    are, aim = fn(*_args(c, bank, "jax"))
    return np.asarray(are), np.asarray(aim)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("algo", BANKS + CHANNELS)
def test_plain_version_matches_jax_outside_the_instantiations(algo, shape):
    c = _case(algo, shape)
    bank = algo in BANKS
    kw = {"nominal_code_frequency": SYSTEM.code_frequency} if bank else {}
    got = tregistry.get(algo)(*_args(c, bank, "torch"), sample_shifts=c["shifts"],
                              code_length=SYSTEM.code_length, **kw)
    want = _jax(algo, shape)
    num_ants, num_taps = SHAPES[shape]
    lead = (2,) if bank else ()
    expected = lead + ((num_ants,) if num_ants > 1 else ()) + (num_taps,)
    assert float(np.abs(want[0]).max()) > 1.0          # not a vacuous comparison
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == expected
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    # The launches that cover this shape on the card.
    groups = epl_kernels.launch_groups(num_ants, num_taps)
    assert len(groups) == -(-num_ants // 4) * (1 if num_taps <= 7 else 2)


@pytest.mark.parametrize("num_ants,num_taps,want", [
    (1, 3, ((0, 1, (0, 1, 2)),)),
    (4, 7, ((0, 4, (0, 1, 2, 3, 4, 5, 6)),)),
    (1, 4, ((0, 1, (0, 1, 2, 3, 3)),)),
    (2, 1, ((0, 2, (0, 0, 0)),)),
    (1, 9, ((0, 1, (0, 1, 2, 3, 4, 5, 6)), (0, 1, (7, 8, 8)))),
    (1, 11, ((0, 1, (0, 1, 2, 3, 4, 5, 6)), (0, 1, (7, 8, 9, 10, 10)))),
    (6, 3, ((0, 4, (0, 1, 2)), (4, 6, (0, 1, 2)))),
    (8, 9, ((0, 4, tuple(range(7))), (0, 4, (7, 8, 8)), (4, 8, tuple(range(7))),
            (4, 8, (7, 8, 8)))),
])
def test_launch_groups_cover_every_antenna_and_tap(num_ants, num_taps, want):
    groups = epl_kernels.launch_groups(num_ants, num_taps)
    assert groups == want
    for a0, a1, taps in groups:
        assert a1 - a0 <= epl_kernels.KERNEL_ANTENNAS and len(taps) in epl_kernels.KERNEL_TAPS
    covered = {(a, l) for a0, a1, taps in groups for a in range(a0, a1) for l in taps}
    assert covered == {(a, l) for a in range(num_ants) for l in range(num_taps)}


def test_split_launches_gathers_the_groups_columns():
    # A stand-in launch that returns out[k, a, l] = 100 a + delta_l (+ k): the
    # gathered result must be the unsplit call's.
    deltas = (0, 3, 5, 9, 11, 14, 20, 21, 30)

    def launch(a0, a1, taps):
        a = torch.arange(a0, a1, dtype=torch.float32)[None, :, None]
        d = torch.tensor([float(deltas[i]) for i in taps])[None, None, :]
        k = torch.arange(2, dtype=torch.float32)[:, None, None]
        return 100 * a + d + k, -(100 * a + d + k)

    got_re, got_im = epl_kernels.split_launches(launch, 6, len(deltas), (2,),
                                                torch.device("cpu"))
    want = (100 * torch.arange(6.0)[None, :, None] + torch.tensor(deltas, dtype=torch.float32)
            + torch.arange(2.0)[:, None, None])
    torch.testing.assert_close(got_re, want, rtol=0, atol=0)
    torch.testing.assert_close(got_im, -want, rtol=0, atol=0)


def test_launch_groups_refuse_an_empty_call():
    with pytest.raises(ValueError, match="A >= 1 and L >= 1"):
        epl_kernels.launch_groups(0, 3)
