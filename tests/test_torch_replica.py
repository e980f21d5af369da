"""PyTorch port, the code-replica kernel's module (`ops/replica_kernel.py`):
its plain versions against the JAX `gen_code_replica`,
`gen_code_replica_quantized` and the JAX taps wrapper's tap matrix, exactly,
and its dispatch on the CPU.

On the card, ``csrc/replica.cu`` is held to these plain versions bit for
bit by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu.ops import correlate as jcorrelate
from gpuacceleratedtracking_tpu.ops import replica as jreplica
from gpuacceleratedtracking_tpu_torch.ops import channel_kernels, epl_kernels, replica_kernel

torch.set_num_threads(1)

# name -> (GNSS, N, PRN, code phase, taps); the sampling frequency is N / 1 ms.
# Every EPL case has a negative d_min (and so a quantized grid origin below
# 0); N=10230 and N=4093 are not multiples of 4; at N=2^17 the taps are 64
# samples apart, so the tap rows cross code_phase_steps' 128-sample rows; at
# N=2^18 L=11 the taps span 1280 samples, past one launch's halo.
CASES = {
    "l1_n2048_l3": ("GPSL1", 2048, 0, 0.0, 3),
    "l1_n4096_l7_phase": ("GPSL1", 4096, 5, 517.3, 7),
    "l1_n8192_l3_wrap": ("GPSL1", 8192, 17, 1022.75, 3),
    "l5_n32768_l3": ("GPSL5", 32768, 3, 10229.5, 3),
    "l1_n10230_l9": ("GPSL1", 10230, 9, 1000.1, 9),
    "l1_n4093_l11_odd": ("GPSL1", 4093, 21, 3.7, 11),
    "l1_n131072_l7_rows": ("GPSL1", 131072, 30, 700.25, 7),
    "l1_n262144_l11_span": ("GPSL1", 262144, 2, 1022.5, 11),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    gnss, n, prn, phase, taps = CASES[name]
    system = jmodels.get_system(gnss)
    fs = n / 1e-3
    shifts = tuple(int(s) for s in jmodels.correlator_sample_shifts(
        system, jmodels.EPLCorrelator(taps), fs))
    return system, n, prn, phase, fs, shifts


def _jax(name, mode):
    system, n, prn, phase, fs, shifts = _case(name)
    gen = jreplica.gen_code_replica if mode == "exact" else jreplica.gen_code_replica_quantized
    row = jax.jit(functools.partial(gen, num_samples=n, min_shift=min(shifts),
                                    max_shift=max(shifts), code_length=system.code_length))(
        jnp.asarray(system.codes), prn, system.code_frequency, fs, phase)
    return np.asarray(row), np.asarray(jcorrelate._tap_matrix(row, shifts, n))


@pytest.mark.parametrize("mode", replica_kernel.MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_replica_equals_jax_exactly(name, mode):
    system, n, prn, phase, fs, shifts = _case(name)
    codes = torch.as_tensor(system.codes)
    want_row, want_taps = _jax(name, mode)
    row = replica_kernel.code_replica(codes, prn, system.code_frequency, fs, phase, n,
                                      min(shifts), max(shifts), system.code_length, mode)
    taps = replica_kernel.code_tap_matrix(codes, prn, system.code_frequency, fs, phase, n,
                                          shifts, system.code_length, mode)
    assert row.dtype == taps.dtype == torch.float32
    assert tuple(row.shape) == (n + max(shifts) - min(shifts),)
    assert tuple(taps.shape) == (len(shifts), n)
    np.testing.assert_array_equal(row.numpy(), want_row)
    np.testing.assert_array_equal(taps.numpy(), want_taps)
    assert replica_kernel.code_replica.launches == 0    # the plain version on the CPU


@pytest.mark.parametrize("mode", replica_kernel.MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_tap_rows_are_windows_of_one_haloed_row(name, mode):
    # What the kernel's design rests on: row l of the tap matrix is the haloed
    # row's window at d_l - d_min, so each launch of the wrapper's plan can
    # write its rows from one haloed tile per CTA (grid origin: the call's
    # d_min), and in the exact mode a chip is a function of its sample alone,
    # so a CTA's haloed tile [j0 + d_min, j0 + T + d_max) is that window of
    # the row. Bit for bit against the JAX replica and tap matrix.
    system, n, prn, phase, fs, shifts = _case(name)
    want_row, want_taps = _jax(name, mode)
    d_min, d_max = min(shifts), max(shifts)
    for l, d in enumerate(shifts):
        np.testing.assert_array_equal(want_taps[l], want_row[d - d_min:d - d_min + n])
    codes = torch.as_tensor(system.codes)
    plan = replica_kernel.launch_plan(shifts)
    for r0, r1 in plan:
        row = replica_kernel.replica_plain(codes, prn, system.code_frequency, fs, phase, n,
                                           d_min, max(shifts[r0:r1]), system.code_length,
                                           mode).numpy()
        for l in range(r0, r1):
            np.testing.assert_array_equal(row[shifts[l] - d_min:shifts[l] - d_min + n],
                                          want_taps[l])
    assert len(plan) == (2 if d_max - d_min > replica_kernel.MAX_SPAN else 1)
    if mode == "exact":
        for j0 in sorted({0, 256, n // 2 // 256 * 256, (n - 1) // 256 * 256}):
            cols = min(2048, n - j0)
            tile = jax.jit(functools.partial(
                jreplica.gen_code_replica, num_samples=j0 + cols, min_shift=j0 + d_min,
                max_shift=d_max, code_length=system.code_length))(
                jnp.asarray(system.codes), prn, system.code_frequency, fs, phase)
            np.testing.assert_array_equal(np.asarray(tile),
                                          want_row[j0:j0 + cols + d_max - d_min])


@pytest.mark.parametrize("offsets,plan", [
    ((-1, 0, 1), ((0, 3),)),
    ((-384, -256, -128, 0, 128, 256, 384), ((0, 7),)),
    ((-5, 0, 5, 5, 5), ((0, 5),)),                       # a padded launch group
    (tuple(range(-640, 641, 128)), ((0, 9), (9, 11))),   # L=11 at N=2^18: 1280 apart
    ((0, 1024, -1024, 0), ((0, 2), (2, 4))),
    ((7,), ((0, 1),)),
    (tuple(range(65)), ((0, 64), (64, 65))),
])
def test_launch_plan_takes_every_row_it_can_in_one_launch(offsets, plan):
    got = replica_kernel.launch_plan(offsets)
    assert got == plan
    assert got[0][0] == 0 and got[-1][1] == len(offsets)
    for (r0, r1), nxt in zip(got, got[1:] + ((None, None),)):
        rows = offsets[r0:r1]
        assert r1 - r0 <= replica_kernel.MAX_ROWS
        assert max(rows) - min(rows) <= replica_kernel.MAX_SPAN
        if nxt[0] is not None:                           # the next row would break a limit
            wider = offsets[r0:r1 + 1]
            assert (len(wider) > replica_kernel.MAX_ROWS
                    or max(wider) - min(wider) > replica_kernel.MAX_SPAN)


def test_cpu_dispatch_is_the_plain_version_and_launch_refuses_cpu():
    system, n, prn, phase, fs, shifts = _case("l1_n4096_l7_phase")
    codes = torch.as_tensor(system.codes)
    prn_t = torch.tensor(prn, dtype=torch.int32)
    fcode = torch.tensor(system.code_frequency, dtype=torch.float32)
    phase_t = torch.tensor(phase, dtype=torch.float32)
    got = replica_kernel.code_tap_matrix(codes, prn_t, fcode, fs, phase_t, n, shifts,
                                         system.code_length)
    want = replica_kernel.tap_matrix_plain(codes, prn, system.code_frequency, fs, phase, n,
                                           shifts, system.code_length)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # The plain taps version's tap matrix is this one, on any device.
    call = channel_kernels.ChannelCall(
        torch.zeros(n), torch.zeros(n), codes, prn_t, 1500.0, fs, 0.0, fcode, phase_t,
        shifts, system.code_length, "taps")
    torch.testing.assert_close(call.replica, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        replica_kernel.launch_replica(codes, prn, system.code_frequency, fs, phase, shifts,
                                      n, min(shifts), system.code_length)
    with pytest.raises(ValueError, match="replica mode"):
        replica_kernel.code_replica(codes, prn, system.code_frequency, fs, phase, n, -1, 1,
                                    system.code_length, mode="texture")
    assert replica_kernel.code_replica.launches == 0


@pytest.mark.parametrize("num_taps", [3, 9, 11])
def test_launch_group_rows_are_the_call_matrix_rows(num_taps):
    # On the card each launch group of a taps call takes its own tap matrix
    # from the replica kernel (a padded group repeats its last tap). A
    # sample's chip does not depend on the call's other taps, so a group's
    # plain rows are those rows of the whole call's plain matrix, exactly.
    system = jmodels.get_system("GPSL1")
    n, fs = 8192, 8.192e6
    shifts = tuple(int(s) for s in jmodels.correlator_sample_shifts(
        system, jmodels.EPLCorrelator(num_taps), fs))
    zeros = torch.zeros(n)
    call = channel_kernels.ChannelCall(
        zeros, zeros, torch.as_tensor(system.codes), 7, -1200.0, fs, 1.1,
        torch.tensor(-system.code_frequency, dtype=torch.float32), torch.tensor(311.7), shifts,
        system.code_length, "taps")
    groups = {taps for _, _, taps in epl_kernels.launch_groups(1, num_taps)}
    for taps in groups:
        np.testing.assert_array_equal(channel_kernels._tap_rows_plain(call, taps).numpy(),
                                      call.replica[list(taps)].numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        channel_kernels._tap_rows(call, next(iter(groups)))
    assert replica_kernel.code_replica.launches == 0
