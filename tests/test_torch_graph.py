"""PyTorch port, the captured block loop (`tracking.graphs`) on the CPU.

On the card `graphs.scan` captures a tracking entry point's block body as a
CUDA graph and replays it per block. Here its capture is swapped for a plain
call of the body, so the static-buffer path (copy-in, device-side block
index, chunked stacked outputs, copy-out, launch-count replay) runs on CPU
tensors and is held, bit for bit, against the eager loop, and against the
JAX `track_bank` and `track_bank_dual`. The bodies of `track`, `track_bank`
and `track_bank_dual`, and the sharded bank's on the bank kernels' routes,
write their outputs and carry through the entry's sink (the plain
versions' `graphs.write_sink` here, the loop kernel on the card); the
sharded bank's bodies for other correlators take none.
"""

import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import parallel as tparallel
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels
from gpuacceleratedtracking_tpu_torch.parallel import (
    channel_time_mesh, track_bank_dual_sharded, track_bank_sharded)
from gpuacceleratedtracking_tpu_torch.tracking import graphs
from gpuacceleratedtracking_tpu_torch.tracking.dual import dual_parts
from gpuacceleratedtracking_tpu_torch.tracking.track import _takes_tiles, bank_prepare

torch.set_num_threads(1)

BLOCKS = 7            # over two chunks of CHUNK_BLOCKS and a short tail
CHUNK_BLOCKS = 3


def _plain_capture(body, device):
    """The capture swapped for a plain call: the body runs once, as a trace
    would, and each "replay" runs it with the launch counts held, as a graph
    replay runs no wrapper."""
    body()

    def replay():
        counts = graphs._counts()
        body()
        graphs._set_counts(counts)

    return replay


@pytest.fixture
def captured(monkeypatch):
    """`graphs.scan` takes its captured path on CPU tensors."""
    monkeypatch.setattr(graphs, "enabled", lambda device: not graphs._EAGER)
    monkeypatch.setattr(graphs, "capture", _plain_capture)
    monkeypatch.setattr(graphs, "capture_mesh", _plain_capture)
    monkeypatch.setattr(graphs, "CHUNK", CHUNK_BLOCKS)
    graphs.clear()
    yield graphs._ENTRIES
    graphs.clear()


def _leaves(tree):
    return graphs._leaves(tree)


def _assert_same(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


def _storages(tree) -> set:
    return {x.untyped_storage().data_ptr() for x in _leaves(tree)}


def _l1_case(n=4096, fs=8.192e6, k=4, num_ants=None, seed=0):
    """``BLOCKS`` blocks of GPS L1 with 3 satellites, and a K-channel bank."""
    system = tmodels.GPSL1()
    rng = np.random.default_rng(seed)
    dops = rng.uniform(-3000.0, 3000.0, k)
    sig, _ = tmodels.gen_signal_mixed(system, np.arange(3), dops[:3], n * BLOCKS,
                                      num_ants=num_ants,
                                      duration=n * BLOCKS / fs, device="cpu")
    sre, sim = tmodels.soa(sig)
    if num_ants:
        sre, sim = (x.reshape(num_ants, BLOCKS, n).transpose(0, 1).contiguous()
                    for x in (sre, sim))
    else:
        sre, sim = sre.reshape(BLOCKS, n), sim.reshape(BLOCKS, n)
    states = ttracking.init_state(np.arange(k) % 32, carrier_doppler=dops + 15.0,
                                  code_phase=rng.uniform(0, 1023, k), device="cpu",
                                  num_taps=3)
    return system, torch.as_tensor(system.codes), states, sre, sim


# name -> (algorithm, N, fs, K, A, TrackConfig extras)
BANK_CASES = {
    "xla_bank": ("xla_bank", 4096, 8.192e6, 4, None, {}),
    "fused_xla": ("fused_xla", 2048, 4.096e6, 3, None, {}),
    "unfused_xla": ("unfused_xla", 2048, 4.096e6, 3, None, {}),
    "rows": ("pallas_bank_rows", 4096, 8.192e6, 8, None, {}),
    "comp_a2": ("pallas_bank_comp", 4096, 8.192e6, 4, 2, {}),
    "comp_bf16": ("pallas_bank_auto", 4096, 8.192e6, 4, 2, {"z_dtype": "bf16"}),
    "transition": ("pallas_bank", 4096, 4.096e6, 4, None, {}),
    "onehot": ("pallas_bank_onehot", 4096, 8.192e6, 4, None, {}),
    "taps": ("pallas_taps", 2048, 4.096e6, 3, None, {}),
    "fused": ("pallas_fused", 2048, 4.096e6, 3, None, {}),
    "coherent_3": ("xla_bank", 2048, 4.096e6, 3, None, {"coherent_blocks": 3}),
}


@pytest.mark.parametrize("name", sorted(BANK_CASES))
def test_track_bank_replays_the_eager_trajectory(captured, name):
    algorithm, n, fs, k, num_ants, extra = BANK_CASES[name]
    system, codes, states, sre, sim = _l1_case(n, fs, k, num_ants)
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm=algorithm, **extra)
    weights = None
    if num_ants:
        weights = (torch.tensor([1.0, 0.5]), torch.tensor([0.0, -0.25]))
    with graphs.eager():
        want = ttracking.track_bank(config, codes, states, sre, sim, ant_weights=weights)
    assert not captured
    got = ttracking.track_bank(config, codes, states, sre, sim, ant_weights=weights)
    assert len(captured[torch.device("cpu")]) == 1
    _assert_same(got, want)
    # A second call replays the same entry and gives the same run.
    _assert_same(ttracking.track_bank(config, codes, states, sre, sim, ant_weights=weights),
                 want)
    assert len(captured[torch.device("cpu")]) == 1


@pytest.mark.parametrize("algorithm", ["fused_xla", "pallas_fused"])
@pytest.mark.parametrize("num_ants", [None, 2])
def test_track_replays_the_eager_trajectory(captured, algorithm, num_ants):
    system, codes, _, sre, sim = _l1_case(2048, 4.096e6, 1, num_ants)
    config = ttracking.TrackConfig.for_system(system, 4.096e6, 2048, algorithm=algorithm)
    state = ttracking.init_state(1, carrier_doppler=-480.0, code_phase=3.25, device="cpu")
    weights = (np.array([1.0, 0.5]), np.array([0.0, -0.25])) if num_ants else None
    with graphs.eager():
        want = ttracking.track(config, codes, state, sre, sim, ant_weights=weights)
    _assert_same(ttracking.track(config, codes, state, sre, sim, ant_weights=weights), want)


def _l5_case(k=3, n=16384):
    sys_i, sys_q = tmodels.GPSL5(), tmodels.GPSL5(quadrature=True)
    fs = n / 1e-3
    sig, _ = tmodels.gen_signal(sys_i, 2, 700.0, n * BLOCKS, duration=BLOCKS * 1e-3,
                                secondary_code=sys_i.secondary_code, device="cpu")
    sre, sim = (x.reshape(BLOCKS, n) for x in tmodels.soa(sig))
    states = ttracking.init_state(np.arange(2, 2 + k), carrier_doppler=np.linspace(-600, 700, k),
                                  ms_elapsed=np.arange(k) * 3, device="cpu")
    return sys_i, sys_q, fs, states, sre, sim


@pytest.mark.parametrize("algorithm", ["xla_bank", "pallas_bank_auto", "pallas_fused"])
def test_track_bank_dual_replays_the_eager_trajectory(captured, algorithm):
    sys_i, sys_q, fs, states, sre, sim = _l5_case()
    config = ttracking.dual_config(ttracking.TrackConfig.for_system(
        sys_i, fs, 16384, algorithm=algorithm, use_secondary=False))
    codes_i, codes_q = torch.as_tensor(sys_i.codes), torch.as_tensor(sys_q.codes)
    with graphs.eager():
        want = ttracking.track_bank_dual(config, codes_i, codes_q, states, sre, sim)
    _assert_same(ttracking.track_bank_dual(config, codes_i, codes_q, states, sre, sim), want)


@pytest.mark.parametrize("chan,time_", [(2, 2), (4, 1), (1, 2)])
def test_sharded_bank_on_a_cpu_mesh_replays_the_eager_trajectory(captured, chan, time_):
    system, codes, states, sre, sim = _l1_case(8192, 8.192e6, 4)
    config = ttracking.TrackConfig.for_system(system, 8.192e6, 8192,
                                              algorithm="pallas_bank_auto")
    mesh = channel_time_mesh(chan, time_, devices=["cpu"] * (chan * time_))
    with graphs.eager():
        want = track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    _assert_same(track_bank_sharded(config, codes, states, sre, sim, mesh=mesh), want)
    assert len(captured[torch.device("cpu")]) == 1


def test_sharded_dual_bank_on_a_cpu_mesh_replays_the_eager_trajectory(captured):
    sys_i, sys_q, fs, states, sre, sim = _l5_case(k=4)
    config = ttracking.dual_config(ttracking.TrackConfig.for_system(
        sys_i, fs, 16384, algorithm="pallas_bank_auto", use_secondary=False))
    codes_i, codes_q = torch.as_tensor(sys_i.codes), torch.as_tensor(sys_q.codes)
    mesh = channel_time_mesh(2, 1, devices=["cpu"] * 2)
    with graphs.eager():
        want = track_bank_dual_sharded(config, codes_i, codes_q, states, sre, sim, mesh=mesh)
    got = track_bank_dual_sharded(config, codes_i, codes_q, states, sre, sim, mesh=mesh)
    _assert_same(got, want)
    # The unsharded dual bank, bit for bit on the CPU.
    _assert_same(got, ttracking.track_bank_dual(config, codes_i, codes_q, states, sre, sim))


@pytest.mark.parametrize("algorithm", ["pallas_bank_auto", "xla_bank"])
def test_sharded_dual_bank_on_one_device_is_one_graph_writing_each_shards_sink(
        captured, sink_writes, algorithm):
    # On one device every channel shard's dual body runs in one entry (one
    # graph on the card), each writing its 13 output leaves through its part
    # of the entry's sink, bit for bit the eager run and the unsharded bank.
    sys_i, sys_q, fs, states, sre, sim = _l5_case(k=4)
    config = ttracking.dual_config(ttracking.TrackConfig.for_system(
        sys_i, fs, 16384, algorithm=algorithm, use_secondary=False))
    codes_i, codes_q = torch.as_tensor(sys_i.codes), torch.as_tensor(sys_q.codes)
    mesh = channel_time_mesh(2, 1, devices=["cpu"] * 2)
    with graphs.eager():
        want = track_bank_dual_sharded(config, codes_i, codes_q, states, sre, sim, mesh=mesh)
    assert not captured and not sink_writes
    got = track_bank_dual_sharded(config, codes_i, codes_q, states, sre, sim, mesh=mesh)
    assert len(captured[torch.device("cpu")]) == 1
    assert sink_writes == [13] * 2 * (BLOCKS + 1)
    _assert_same(got, want)
    graphs.clear()
    _assert_same(got, ttracking.track_bank_dual(config, codes_i, codes_q, states, sre, sim))


def test_captured_track_bank_matches_jax(captured):
    # The slice end to end: the captured path against the JAX `track_bank`
    # (plain XLA correlator on both sides), at tests/test_tracking.py's
    # bank tolerances.
    n, fs, dops = 4096, 4.096e6, np.array([-900.0, 100.0, 1500.0])
    jsys = jmodels.GPSL1()
    mixed = sum(jmodels.gen_signal(jsys, prn, d, n * BLOCKS, duration=BLOCKS * 1e-3)[0]
                for prn, d in enumerate(dops))
    sre = np.array(mixed.real).reshape(BLOCKS, n)
    sim = np.array(mixed.imag).reshape(BLOCKS, n)
    jconfig = jtracking.TrackConfig.for_system(jsys, fs, n, algorithm="xla_bank")
    _, want = jtracking.track_bank(jconfig, jnp.asarray(jsys.codes),
                                   jtracking.init_state(np.arange(3), carrier_doppler=dops),
                                   jnp.asarray(sre), jnp.asarray(sim))
    system = tmodels.GPSL1()
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm="xla_bank")
    states = ttracking.init_state(np.arange(3), carrier_doppler=dops, device="cpu")
    _, got = ttracking.track_bank(config, torch.as_tensor(system.codes), states,
                                  torch.as_tensor(sre), torch.as_tensor(sim))
    assert captured
    np.testing.assert_allclose(got.prompt_re.numpy(), np.asarray(want.prompt_re),
                               rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(got.carrier_doppler.numpy(), np.asarray(want.carrier_doppler),
                               rtol=1e-3, atol=1.0)


@pytest.fixture
def sink_writes(monkeypatch):
    """Counts the captured bodies' writes through their sink."""
    calls = []
    write = graphs.write_sink

    def counted(sink, carry, new_carry, out):
        calls.append(len(sink.outs))
        return write(sink, carry, new_carry, out)

    monkeypatch.setattr(graphs, "write_sink", counted)
    return calls


def _entry_point(name):
    """A sink path of the slice: its run, and its output leaves per block."""
    if name == "track_bank_dual":
        sys_i, sys_q, fs, states, sre, sim = _l5_case()
        config = ttracking.dual_config(ttracking.TrackConfig.for_system(
            sys_i, fs, 16384, algorithm="pallas_bank_auto", use_secondary=False))
        codes_i, codes_q = torch.as_tensor(sys_i.codes), torch.as_tensor(sys_q.codes)
        return lambda: ttracking.track_bank_dual(config, codes_i, codes_q, states, sre, sim), 13
    if name == "track":
        system, codes, _, sre, sim = _l1_case(2048, 4.096e6, 1)
        config = ttracking.TrackConfig.for_system(system, 4.096e6, 2048, algorithm="pallas_fused")
        state = ttracking.init_state(1, carrier_doppler=-480.0, code_phase=3.25, device="cpu")
        return lambda: ttracking.track(config, codes, state, sre, sim), 11
    algorithm = {"track_bank_rows": "pallas_bank_rows", "track_bank_comp": "pallas_bank_comp",
                 "track_bank_coherent": "xla_bank"}[name]
    num_ants = 2 if name == "track_bank_comp" else None
    system, codes, states, sre, sim = _l1_case(4096, 8.192e6, 4, num_ants)
    extra = {"coherent_blocks": 3} if name == "track_bank_coherent" else {}
    config = ttracking.TrackConfig.for_system(system, 8.192e6, 4096, algorithm=algorithm, **extra)
    weights = (torch.tensor([1.0, 0.5]), torch.tensor([0.0, -0.25])) if num_ants else None
    return lambda: ttracking.track_bank(config, codes, states, sre, sim, ant_weights=weights), 11


@pytest.mark.parametrize("name", ["track_bank_rows", "track_bank_comp", "track_bank_coherent",
                                  "track", "track_bank_dual"])
def test_captured_bodies_write_their_outputs_and_carry_through_the_sink(captured, sink_writes,
                                                                        name):
    # The capture and every replayed block write all the block's outputs and
    # the carry through the entry's sink (the plain versions' `write_sink`
    # here, the loop kernel on the card), and the run is the eager one.
    run, leaves = _entry_point(name)
    with graphs.eager():
        want = run()
    assert not sink_writes
    _assert_same(run(), want)
    assert sink_writes == [leaves] * (BLOCKS + 1)


def test_sharded_bank_bodies_take_no_sink(captured, sink_writes):
    # A correlator that takes no code tiles keeps the body that cuts each
    # shard's piece and returns its outputs: the entry copies them.
    system, codes, states, sre, sim = _l1_case(8192, 8.192e6, 4)
    config = ttracking.TrackConfig.for_system(system, 8.192e6, 8192, algorithm="xla_bank")
    mesh = channel_time_mesh(2, 2, devices=["cpu"] * 4)
    track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    assert captured and not sink_writes


@pytest.mark.parametrize("chan,time_", [(2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("name", ["rows", "transition", "onehot", "comp_a2"])
def test_sharded_bank_kernel_bodies_write_through_each_channel_shards_sink(
        captured, sink_writes, name, chan, time_):
    # On the bank kernels' routes each channel shard's loop closure writes
    # its 11 output leaves and its carry through its own part of the
    # entry's sink, in the capture and in every replayed block, and the run
    # is the eager one bit for bit.
    algorithm, n, fs, k, num_ants, extra = BANK_CASES[name]
    system, codes, states, sre, sim = _l1_case(n, fs, k, num_ants)
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm=algorithm, **extra)
    mesh = channel_time_mesh(chan, time_, devices=["cpu"] * (chan * time_))
    with graphs.eager():
        want = track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    assert not sink_writes
    _assert_same(track_bank_sharded(config, codes, states, sre, sim, mesh=mesh), want)
    assert len(captured[torch.device("cpu")]) == 1
    assert sink_writes == [11] * chan * (BLOCKS + 1)


def _sink_step(carry, consts, block, sink=None):
    """`_tiny_step` writing its first output and its carry itself under a sink."""
    new, out = _tiny_step(carry, consts, block)
    if sink is None:
        return new, out
    sink.outs[0].index_copy_(0, sink.index.view(1), new.unsqueeze(0))
    carry.copy_(new)
    return carry, (graphs.WRITTEN, out[1])


def test_a_body_that_writes_some_outputs_gets_the_rest_copied(captured):
    step = graphs.writes_outputs(_sink_step)
    xs = (torch.arange(7 * 2 * 4, dtype=torch.float32).reshape(7, 2, 4),)
    carry, consts = torch.zeros(2, 4), (torch.full((), 0.5),)
    with graphs.eager():
        want = graphs.scan(step, carry, xs, consts, key=("sink",))
    _assert_same(graphs.scan(step, carry, xs, consts, key=("sink",)), want)
    _assert_same(want, graphs.scan(_tiny_step, carry, xs, consts, key=("tiny",)))
    assert torch.equal(carry, torch.zeros(2, 4))          # the caller's carry is untouched


@pytest.mark.parametrize("fault", ["extra_leaf", "written_without_sink"])
def test_a_body_whose_outputs_do_not_fit_its_entry_raises(captured, fault):
    def extra(carry, consts, block, sink=None):
        new, out = _sink_step(carry, consts, block, sink)
        return new, out + ((block[0] * 0.0,) if sink is not None else ())

    def unmarked(carry, consts, block):
        new, out = _tiny_step(carry, consts, block)
        return new, (graphs.WRITTEN, out[1])

    step = graphs.writes_outputs(extra) if fault == "extra_leaf" else unmarked
    xs = (torch.arange(3 * 2 * 4, dtype=torch.float32).reshape(3, 2, 4),)
    with pytest.raises(ValueError, match="output leaves|without a sink"):
        graphs.scan(step, torch.zeros(2, 4), xs, (torch.ones(()),), key=(fault,))


def test_captured_track_bank_dual_matches_jax(captured, sink_writes):
    # The dual slice end to end through the sink: the captured
    # `track_bank_dual` against the JAX one (plain XLA bank correlator on
    # both sides), at tests/test_torch_dual.py's closed-loop tolerances.
    n, fs, prns, dops = 16384, 16.384e6, np.array([3, 8]), np.array([900.0, -1500.0])
    jsys_i, jsys_q = jmodels.GPSL5(), jmodels.GPSL5(quadrature=True)
    total = 0
    for prn, dop in zip(prns, dops):
        common = dict(duration=BLOCKS * 1e-3,
                      code_frequency=jsys_i.code_frequency * (1 + dop / jsys_i.center_frequency))
        sig_i, _ = jmodels.gen_signal(jsys_i, prn, dop, n * BLOCKS,
                                      secondary_code=jsys_i.secondary_code, **common)
        sig_q, _ = jmodels.gen_signal(jsys_q, prn, dop, n * BLOCKS,
                                      secondary_code=jsys_q.secondary_code,
                                      start_carrier_phase=np.pi / 2, **common)
        total = total + np.asarray(sig_i) + np.asarray(sig_q)
    sre = np.ascontiguousarray(total.real, np.float32).reshape(BLOCKS, n)
    sim = np.ascontiguousarray(total.imag, np.float32).reshape(BLOCKS, n)
    jcfg = jtracking.dual_config(jtracking.TrackConfig.for_system(
        jsys_i, fs, n, algorithm="xla_bank", use_secondary=False))
    _, want = jtracking.track_bank_dual(
        jcfg, jnp.asarray(jsys_i.codes), jnp.asarray(jsys_q.codes),
        jtracking.init_state(prns, carrier_doppler=dops + 5.0), jnp.asarray(sre), jnp.asarray(sim))
    sys_i, sys_q = tmodels.GPSL5(), tmodels.GPSL5(quadrature=True)
    cfg = ttracking.dual_config(ttracking.TrackConfig.for_system(
        sys_i, fs, n, algorithm="xla_bank", use_secondary=False))
    states = ttracking.init_state(prns, carrier_doppler=dops + 5.0, device="cpu")
    _, got = ttracking.track_bank_dual(cfg, torch.as_tensor(sys_i.codes),
                                       torch.as_tensor(sys_q.codes), states,
                                       torch.as_tensor(sre), torch.as_tensor(sim))
    assert sink_writes == [13] * (BLOCKS + 1)
    for field in ("prompt_re", "prompt_im"):
        np.testing.assert_allclose(getattr(got.pilot, field).numpy(),
                                   np.asarray(getattr(want.pilot, field)), rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(got.pilot.carrier_doppler.numpy(),
                               np.asarray(want.pilot.carrier_doppler), rtol=1e-3, atol=1.0)
    np.testing.assert_allclose(got.data_prompt_re.numpy(), np.asarray(want.data_prompt_re),
                               rtol=5e-3, atol=10.0)


def test_results_are_fresh_and_inputs_untouched(captured):
    system, codes, states, sre, sim = _l1_case()
    config = ttracking.TrackConfig.for_system(system, 8.192e6, 4096, algorithm="xla_bank")
    inputs = [x.clone() for x in _leaves((states, sre, sim, codes))]
    first = ttracking.track_bank(config, codes, states, sre, sim)
    kept = [x.clone() for x in _leaves(first)]
    second = ttracking.track_bank(config, codes, first[0], sre[:4], sim[:4])
    (entry,) = captured[torch.device("cpu")].values()
    owned = _storages((entry.carry, entry.consts, tuple(entry.xs), tuple(entry.outs),
                       entry.index))
    assert not _storages(first) & _storages(second)
    assert not (_storages(first) | _storages(second)) & owned
    ttracking.track_bank(config, codes, states, sre, sim)
    for x, y in zip(_leaves(first), kept):
        assert torch.equal(x, y)
    for x, y in zip(_leaves((states, sre, sim, codes)), inputs):
        assert torch.equal(x, y)


def _tiny_step(carry, consts, block):
    """A counter over the blocks: carry + sum(block) * scale."""
    new = carry + block[0].sum() * consts[0]
    return new, (new, block[0][:2] * 2.0)


def test_blocks_share_an_entry_and_the_signature_makes_new_ones(captured, monkeypatch):
    def run(k=4, n=16, dtype=torch.float32, key=("tiny",), blocks=5, device="cpu"):
        xs = (torch.arange(blocks * k * n, dtype=dtype, device=device).reshape(blocks, k, n),)
        carry = torch.zeros(k, n, dtype=dtype, device=device)
        return graphs.scan(_tiny_step, carry, xs, (torch.ones((), dtype=dtype, device=device),),
                           key=key)

    entries = captured.setdefault(torch.device("cpu"), graphs.collections.OrderedDict())
    final, (acc, head) = run(blocks=5)
    with graphs.eager():
        want = run(blocks=5)
    _assert_same((final, (acc, head)), want)
    run(blocks=10)                                   # B and 2B: one entry
    assert len(entries) == 1
    for change in ({"key": ("tiny", "other config")}, {"k": 2}, {"n": 8},
                   {"dtype": torch.float64}):
        run(**change)
    assert len(entries) == 5
    run(device="meta")                               # another device: an entry of its own
    assert len(captured[torch.device("meta")]) == 1 and len(entries) == 5
    monkeypatch.setattr(graphs, "MAX_ENTRIES", 2)
    run(k=3)
    assert len(entries) == 2                         # the LRU bound evicts the oldest
    assert list(entries)[-1][1] == ("tiny",)


def _other_step(carry, consts, block):
    """`_tiny_step`'s shapes, another body."""
    new = carry - block[0].sum() * consts[0]
    return new, (new, block[0][:2] * 3.0)


def test_bodies_of_equal_shapes_get_entries_of_their_own(captured):
    # The signature holds the body's code: one key, two bodies, two graphs,
    # each replaying its own body.
    xs = (torch.arange(40.0).reshape(5, 2, 4),)
    carry, consts = torch.zeros(2, 4), (torch.full((), 0.5),)
    for step in (_tiny_step, _other_step, functools.partial(_other_step)):
        with graphs.eager():
            want = graphs.scan(step, carry, xs, consts, key=("same",))
        _assert_same(graphs.scan(step, carry, xs, consts, key=("same",)), want)
    assert len(captured[torch.device("cpu")]) == 2


def test_the_chunk_holds_at_most_chunk_bytes_of_input(captured, monkeypatch):
    # Three blocks' worth of bytes: chunks of 3 where CHUNK would give more,
    # and the run over them the eager one.
    monkeypatch.setattr(graphs, "CHUNK", 64)
    xs = (torch.arange(10 * 2 * 4, dtype=torch.float32).reshape(10, 2, 4),)
    monkeypatch.setattr(graphs, "CHUNK_BYTES", 3 * 2 * 4 * 4 + 5)
    carry, consts = torch.zeros(2, 4), (torch.ones(()),)
    with graphs.eager():
        want = graphs.scan(_tiny_step, carry, xs, consts, key=("bytes",))
    _assert_same(graphs.scan(_tiny_step, carry, xs, consts, key=("bytes",)), want)
    (entry,) = captured[torch.device("cpu")].values()
    assert entry.chunk == 3 and entry.xs[0].shape[0] == 3 and entry.outs[0].shape[0] == 3


def test_launch_counts_recorded_at_capture_are_added_per_replay(captured, monkeypatch):
    counter = epl_kernels.correlate_pallas_bank_rows
    monkeypatch.setattr(counter, "launches", 0)      # restored after the test

    def step(carry, consts, block):
        counter.launches += 2                        # as a wrapper counts two launches
        return carry + block[0], carry

    before = counter.launches
    graphs.scan(step, torch.zeros(3), (torch.ones(BLOCKS, 3),), key=("counted",))
    # The warm-up and the capture are not counted; each replayed block is.
    assert counter.launches - before == 2 * BLOCKS
    graphs.scan(step, torch.zeros(3), (torch.ones(2, 3),), key=("counted",))
    assert counter.launches - before == 2 * BLOCKS + 4


def test_eager_restores_the_loop(captured):
    system, codes, states, sre, sim = _l1_case()
    config = ttracking.TrackConfig.for_system(system, 8.192e6, 4096, algorithm="xla_bank")
    with graphs.eager():
        with graphs.eager():
            assert not graphs.enabled(torch.device("cpu"))
        ttracking.track_bank(config, codes, states, sre, sim)
    assert not captured
    assert graphs.enabled(torch.device("cpu"))
    ttracking.track_bank(config, codes, states, sre, sim)
    assert len(captured[torch.device("cpu")]) == 1


def test_on_the_cpu_the_entry_points_run_the_eager_loop():
    # Without the swap, CPU tensors never reach the captured path.
    graphs.clear()
    system, codes, states, sre, sim = _l1_case()
    config = ttracking.TrackConfig.for_system(system, 8.192e6, 4096, algorithm="xla_bank")
    assert not graphs.enabled(torch.device("cpu"))
    ttracking.track_bank(config, codes, states, sre, sim)
    assert not graphs._ENTRIES


def test_a_capture_that_fails_raises_and_caches_nothing(captured, monkeypatch):
    def refuse(body, device):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs, "capture", refuse)
    counts = graphs._counts()
    with pytest.raises(RuntimeError, match="capture refused"):
        graphs.scan(_tiny_step, torch.zeros(2, 4), (torch.ones(3, 2, 4),), (torch.ones(()),),
                    key=("refused",))
    assert not captured.get(torch.device("cpu"))
    assert graphs._counts() == counts


# --- A call as one program: code tiles derived per call in the prologue, the
# state and the outputs as views of one buffer per dtype.

def _chained_case(name):
    """A captured-path case for chained calls: ``call(state, lo, hi)`` runs
    blocks ``lo:hi`` from ``state``; the initial state; the code tables the
    call reads, copies of the systems' own (for in-place edits)."""
    if name == "dual":
        sys_i, sys_q, fs, states, sre, sim = _l5_case()
        config = ttracking.dual_config(ttracking.TrackConfig.for_system(
            sys_i, fs, 16384, algorithm="pallas_bank_auto", use_secondary=False))
        codes_i, codes_q = torch.tensor(sys_i.codes), torch.tensor(sys_q.codes)
        return (lambda st, lo, hi: ttracking.track_bank_dual(
            config, codes_i, codes_q, st, sre[lo:hi], sim[lo:hi]), states, (codes_i, codes_q))
    if name == "track":
        system, codes, _, sre, sim = _l1_case(2048, 4.096e6, 1)
        codes = codes.clone()
        config = ttracking.TrackConfig.for_system(system, 4.096e6, 2048, algorithm="pallas_fused")
        state = ttracking.init_state(1, carrier_doppler=-480.0, code_phase=3.25, device="cpu")
        return (lambda st, lo, hi: ttracking.track(config, codes, st, sre[lo:hi], sim[lo:hi]),
                state, (codes,))
    algorithm, n, fs, k, num_ants, extra = BANK_CASES[name]
    system, codes, states, sre, sim = _l1_case(n, fs, k, num_ants)
    codes = codes.clone()
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm=algorithm, **extra)
    weights = (torch.tensor([1.0, 0.5]), torch.tensor([0.0, -0.25])) if num_ants else None
    return (lambda st, lo, hi: ttracking.track_bank(config, codes, st, sre[lo:hi], sim[lo:hi],
                                                    ant_weights=weights), states, (codes,))


def _chained(call, state, split=4):
    """Two chained calls over the ``BLOCKS`` blocks, the second from the
    first's final state: both calls' outputs and the final state."""
    first_state, first = call(state, 0, split)
    final, second = call(first_state, split, BLOCKS)
    return first, second, final


def _entry():
    (entry,) = graphs._ENTRIES[torch.device("cpu")].values()
    return entry


def _in_entry_layout(state, entry) -> bool:
    """Whether ``state``'s leaves lie as ``entry`` lays out its carry: per
    dtype on one storage, each contiguous at the entry's offset."""
    leaves = _leaves(state)
    return all(graphs._flat_source([leaves[i] for i in places], offsets, region.numel())
               is not None for places, offsets, region in entry._carry_groups.values())


@pytest.mark.parametrize("name", sorted(BANK_CASES) + ["dual", "track"])
def test_a_state_passed_back_chains_as_two_eager_calls(captured, name):
    call, state, _ = _chained_case(name)
    with graphs.eager():
        want = _chained(call, state)
    got = _chained(call, state)
    _assert_same(got, want)
    # The second call loaded the first's state as one region per dtype.
    first_state, _ = call(state, 0, 4)
    assert _in_entry_layout(first_state, _entry())
    assert not _in_entry_layout(state, _entry())


def _jax_l1_chained(split=4):
    """Three GPS L1 satellites over ``BLOCKS`` blocks at 8.192 MHz, tracked by
    the JAX `track_bank` on its rows kernel in two chained calls."""
    n, fs, dops = 4096, 8.192e6, np.array([-900.0, 100.0, 1500.0])
    jsys = jmodels.GPSL1()
    mixed = sum(jmodels.gen_signal(jsys, prn, d, n * BLOCKS, duration=BLOCKS * n / fs)[0]
                for prn, d in enumerate(dops))
    sre = np.array(mixed.real).reshape(BLOCKS, n)
    sim = np.array(mixed.imag).reshape(BLOCKS, n)
    jconfig = jtracking.TrackConfig.for_system(jsys, fs, n, algorithm="pallas_bank_rows")
    st = jtracking.init_state(np.arange(3), carrier_doppler=dops)
    outs = []
    for lo, hi in ((0, split), (split, BLOCKS)):
        st, out = jtracking.track_bank(jconfig, jnp.asarray(jsys.codes), st,
                                       jnp.asarray(sre[lo:hi]), jnp.asarray(sim[lo:hi]))
        outs.append(out)
    system = tmodels.GPSL1()
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm="pallas_bank_rows")
    states = ttracking.init_state(np.arange(3), carrier_doppler=dops, device="cpu")
    call = (lambda s, lo, hi: ttracking.track_bank(
        config, torch.as_tensor(system.codes), s, torch.as_tensor(sre[lo:hi]),
        torch.as_tensor(sim[lo:hi])))
    return call, states, outs


def _jax_l5_chained(split=4):
    """Two GPS L5 satellites (data + pilot) over ``BLOCKS`` blocks, tracked by
    the JAX `track_bank_dual` (plain XLA bank correlator) in two chained
    calls, as `test_captured_track_bank_dual_matches_jax`'s run."""
    n, fs, prns, dops = 16384, 16.384e6, np.array([3, 8]), np.array([900.0, -1500.0])
    jsys_i, jsys_q = jmodels.GPSL5(), jmodels.GPSL5(quadrature=True)
    total = 0
    for prn, dop in zip(prns, dops):
        common = dict(duration=BLOCKS * 1e-3,
                      code_frequency=jsys_i.code_frequency * (1 + dop / jsys_i.center_frequency))
        sig_i, _ = jmodels.gen_signal(jsys_i, prn, dop, n * BLOCKS,
                                      secondary_code=jsys_i.secondary_code, **common)
        sig_q, _ = jmodels.gen_signal(jsys_q, prn, dop, n * BLOCKS,
                                      secondary_code=jsys_q.secondary_code,
                                      start_carrier_phase=np.pi / 2, **common)
        total = total + np.asarray(sig_i) + np.asarray(sig_q)
    sre = np.ascontiguousarray(total.real, np.float32).reshape(BLOCKS, n)
    sim = np.ascontiguousarray(total.imag, np.float32).reshape(BLOCKS, n)
    jcfg = jtracking.dual_config(jtracking.TrackConfig.for_system(
        jsys_i, fs, n, algorithm="xla_bank", use_secondary=False))
    st = jtracking.init_state(prns, carrier_doppler=dops + 5.0)
    outs = []
    for lo, hi in ((0, split), (split, BLOCKS)):
        st, out = jtracking.track_bank_dual(jcfg, jnp.asarray(jsys_i.codes),
                                            jnp.asarray(jsys_q.codes), st,
                                            jnp.asarray(sre[lo:hi]), jnp.asarray(sim[lo:hi]))
        outs.append(out.pilot._replace(prompt_re=out.data_prompt_re))
    sys_i, sys_q = tmodels.GPSL5(), tmodels.GPSL5(quadrature=True)
    cfg = ttracking.dual_config(ttracking.TrackConfig.for_system(
        sys_i, fs, n, algorithm="pallas_bank_auto", use_secondary=False))
    states = ttracking.init_state(prns, carrier_doppler=dops + 5.0, device="cpu")

    def call(s, lo, hi):
        final, out = ttracking.track_bank_dual(
            cfg, torch.as_tensor(sys_i.codes), torch.as_tensor(sys_q.codes), s,
            torch.as_tensor(sre[lo:hi]), torch.as_tensor(sim[lo:hi]))
        return final, out.pilot._replace(prompt_re=out.data_prompt_re)

    return call, states, outs


@pytest.mark.parametrize("name", ["rows", "dual"])
def test_chained_captured_calls_match_jax(captured, name):
    # The port's bank kernel route (the plain version here) through the
    # captured path, its state passed back, against the JAX package's two
    # chained calls, at tests/test_tracking.py's closed-loop tolerances; the
    # dual bank's data prompts are compared in the prompt_re field.
    call, states, want = (_jax_l1_chained if name == "rows" else _jax_l5_chained)()
    first, second, _ = _chained(call, states)
    assert captured
    for got, jax_out in zip((first, second), want):
        np.testing.assert_allclose(got.prompt_re.numpy(), np.asarray(jax_out.prompt_re),
                                   rtol=5e-3, atol=10.0)
        np.testing.assert_allclose(got.carrier_doppler.numpy(),
                                   np.asarray(jax_out.carrier_doppler), rtol=1e-3, atol=1.0)


def _other_prns(state, step=5, count=32):
    return state._replace(prn=((state.prn + step) % count).to(torch.int32))


@pytest.mark.parametrize("name", ["rows", "comp_a2", "transition", "onehot", "dual"])
def test_tiles_follow_the_prns_and_the_code_table_of_each_call(captured, name):
    # Calls of one signature whose states carry other PRNs, or whose code
    # table was edited in place, get the tiles of those: bit for bit the
    # eager call, and not the first call's run.
    call, state, tables = _chained_case(name)
    first = call(state, 0, BLOCKS)
    others = _other_prns(state, 1 if name == "dual" else 5)
    with graphs.eager():
        want = call(others, 0, BLOCKS)
    got = call(others, 0, BLOCKS)
    _assert_same(got, want)
    assert not torch.equal(got[1].pilot.prompt_re if name == "dual" else got[1].prompt_re,
                           first[1].pilot.prompt_re if name == "dual" else first[1].prompt_re)
    # A returned state (the entry's layout: one copy per dtype) whose PRNs
    # were edited in place.
    passed = call(state, 0, 2)[0]
    passed.prn.copy_(others.prn)
    assert _in_entry_layout(passed, _entry())
    with graphs.eager():
        want = call(passed, 2, BLOCKS)
    _assert_same(call(passed, 2, BLOCKS), want)
    # The code table edited in place: the tracked PRNs' chips negated.
    for table in tables:
        table[:, :8] = -table[:, :8]
    with graphs.eager():
        want = call(state, 0, BLOCKS)
    got = call(state, 0, BLOCKS)
    _assert_same(got, want)
    assert not torch.equal(got[1].pilot.accum_re if name == "dual" else got[1].accum_re,
                           first[1].pilot.accum_re if name == "dual" else first[1].accum_re)
    assert len(captured[torch.device("cpu")]) == 1


@pytest.mark.parametrize("name", ["rows", "dual"])
def test_in_graph_tiles_equal_prepare_bank_code_tiles_rows(captured, name):
    # Each call's tiles, packed into the entry's own buffer: one buffer for
    # every call of the entry.
    call, state, tables = _chained_case(name)
    ptrs = set()
    for st in (state, _other_prns(state, 1)):
        call(st, 0, 2)
        codes, prn = tables[0], st.prn
        if name == "dual":
            codes = torch.cat(tables, dim=1)
            prn = torch.cat([prn, prn + tables[0].shape[1]])
        tiles = _entry().prepared[2 if name == "dual" else 1]
        assert tiles.dtype == torch.int32
        assert torch.equal(tiles, epl_kernels.prepare_bank_code_tiles_rows(codes, prn))
        ptrs.add(tiles.data_ptr())
    assert len(ptrs) == 1


class _Writes(TorchDispatchMode):
    """The ops dispatched outside `epl_kernels.pack_code_tiles` (`_spy_pack`
    pauses it) that write a tensor, with the tensors each writes (its
    schema's mutable arguments, each tensor of a list)."""

    paused = 0

    def __init__(self):
        super().__init__()
        self.writes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _Writes.paused:
            written = []
            for i, arg in enumerate(func._schema.arguments):
                if arg.alias_info is None or not arg.alias_info.is_write:
                    continue
                value = args[i] if i < len(args) else (kwargs or {}).get(arg.name)
                values = value if isinstance(value, (list, tuple)) else [value]
                written += [x for x in values if isinstance(x, torch.Tensor)]
            if written:
                self.writes.append((func, written))
        return func(*args, **(kwargs or {}))


def _spy_pack(monkeypatch) -> list:
    """`epl_kernels.pack_code_tiles` recording its ``out`` and ``index`` per
    call, unseen by `_Writes`."""
    calls, pack = [], epl_kernels.pack_code_tiles

    def spy(*args, **kwargs):
        calls.append((kwargs.get("out"), kwargs.get("index")))
        _Writes.paused += 1
        try:
            return pack(*args, **kwargs)
        finally:
            _Writes.paused -= 1

    spy.launches = 0
    monkeypatch.setattr(epl_kernels, "pack_code_tiles", spy)
    return calls


@pytest.mark.parametrize("name", ["rows", "comp_a2", "transition", "onehot", "dual"])
def test_a_marked_prologue_packs_into_the_entry_and_zeroes_its_index(captured, monkeypatch,
                                                                      name):
    # A bank entry's prologue is `prepare` alone: the tiles packed into the
    # entry's buffer and the index zeroed by the packing, no copy into the
    # buffer and no fill of the index beside it; the run is the eager one's.
    calls = _spy_pack(monkeypatch)
    call, state, _ = _chained_case(name)
    call(state, 0, 2)
    entry = _entry()
    tiles = _leaves(entry.prepared)[2 if name == "dual" else 1]
    others = _other_prns(state, 1 if name == "dual" else 5)
    calls.clear()
    with _Writes() as mode:
        got = call(others, 0, 2)
    assert len(calls) == 1 and calls[0][0] is tiles and calls[0][1] is entry.index
    for func, written in mode.writes:
        ptrs = {x.data_ptr() for x in written}
        assert tiles.data_ptr() not in ptrs, func
        if entry.index.data_ptr() in ptrs:
            assert func is torch.ops.aten.add_.Tensor, func      # the body's index add
    assert _leaves(entry.prepared)[2 if name == "dual" else 1] is tiles
    with graphs.eager():
        want = call(others, 0, 2)
    _assert_same(got, want)


@pytest.mark.parametrize("name", sorted(BANK_CASES) + ["dual_xla", "dual"])
def test_the_prepare_is_marked_where_the_route_takes_tiles(name):
    if name.startswith("dual"):
        sys_i, sys_q = tmodels.GPSL5(), tmodels.GPSL5(quadrature=True)
        algorithm = "xla_bank" if name == "dual_xla" else "pallas_bank_auto"
        config = ttracking.dual_config(ttracking.TrackConfig.for_system(
            sys_i, 16.384e6, 16384, algorithm=algorithm, use_secondary=False))
        _, _, prepare = dual_parts(config, sys_i.codes, sys_q.codes, torch.device("cpu"))
    else:
        algorithm, n, fs, _, _, extra = BANK_CASES[name]
        config = ttracking.TrackConfig.for_system(tmodels.GPSL1(), fs, n, algorithm=algorithm,
                                                  **extra)
        prepare = bank_prepare(config)
    assert getattr(prepare, "takes_into", False) == _takes_tiles(config)


def test_a_marked_prepare_that_returns_another_leaf_raises(captured):
    @graphs.writes_prepared
    def prepare(carry, consts, into=None):
        return carry * 2 if into is None else carry * 3

    def step(carry, consts, block):
        return carry + consts * block[0], block[0]

    xs = (torch.arange(6.0).reshape(3, 2),)
    with pytest.raises(ValueError, match="writes_prepared"):
        graphs.scan(step, torch.ones(2), xs, key=("marked",), prepare=prepare)


def test_results_stay_fresh_across_calls_and_edits(captured):
    call, state, tables = _chained_case("rows")
    inputs = [x.clone() for x in _leaves((state,) + tables)]
    with graphs.eager():
        want = call(state, 0, 4)
        want_next = call(want[0], 4, BLOCKS)
    first = call(state, 0, 4)
    kept = [x.clone() for x in _leaves(first)]
    second = call(first[0], 4, BLOCKS)
    _assert_same(second, want_next)
    for x, y in zip(_leaves(first), kept):                  # call 2 leaves call 1 as it was
        assert torch.equal(x, y)
    # An in-place edit of one returned leaf changes that leaf alone, and a
    # state passed back with it edited is seen by the next call.
    second_kept = [x.clone() for x in _leaves(second)]
    second[1].prompt_re.add_(1.0)
    second[0].carrier_doppler.add_(3.0)
    edited = {id(second[1].prompt_re), id(second[0].carrier_doppler)}
    for x, y in zip(_leaves(second), second_kept):
        assert torch.equal(x, y) != (id(x) in edited)
    for x, y in zip(_leaves(first), kept):
        assert torch.equal(x, y)
    with graphs.eager():
        want = call(second[0], 0, 2)
    _assert_same(call(second[0], 0, 2), want)
    for x, y in zip(_leaves((state,) + tables), inputs):   # the caller's tensors untouched
        assert torch.equal(x, y)
    # Returned leaves: the eager loop's shapes and dtypes, contiguous.
    for g, w in zip(_leaves(second), _leaves(want_next)):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous()


@pytest.mark.parametrize("name", ["rows", "comp_a2", "dual", "track"])
def test_a_call_returns_views_of_one_buffer_per_dtype(captured, name):
    call, state, _ = _chained_case(name)
    final, out = call(state, 0, BLOCKS)
    entry = _entry()
    by_dtype: dict = {}
    for x in _leaves((final, out)):
        by_dtype.setdefault(x.dtype, set()).add(x.untyped_storage().data_ptr())
        assert x.is_contiguous() and x.storage_offset() * x.element_size() % graphs.ALIGN == 0
    assert by_dtype.keys() == {torch.float32, torch.int32}
    assert all(len(ptrs) == 1 for ptrs in by_dtype.values())
    # The state lies as the entry lays out its carry, at its offsets and
    # strides; the entry's own carry and stacked outputs share its buffers.
    leaves = _leaves(final)
    for dtype, (places, offsets, _) in entry._carry_groups.items():
        assert [leaves[i].storage_offset() for i in places] == list(offsets)
        assert all(leaves[i].stride() == _leaves(entry.carry)[i].stride() for i in places)
    assert {x.untyped_storage().data_ptr() for x in _leaves(entry.carry) + entry.outs} \
        == {x.untyped_storage().data_ptr() for x in entry.flat.values()}
    assert all(x.data_ptr() % graphs.ALIGN == 0 for x in _leaves(entry.carry) + entry.outs)


def test_a_body_that_swaps_carry_leaves_on_one_storage(captured):
    # `_write_carry` clones a new leaf that views the flat carry's storage
    # and is not its own old leaf before any old leaf is written.
    def swap(carry, consts, block):
        a, b = carry
        return (b + block[0], a), (a, b)

    xs = (torch.arange(5 * 4, dtype=torch.float32).reshape(5, 4),)
    carry = (torch.zeros(4), torch.ones(4))
    with graphs.eager():
        want = graphs.scan(swap, carry, xs, key=("swap",))
    _assert_same(graphs.scan(swap, carry, xs, key=("swap",)), want)
    entry = _entry()
    assert entry.carry[0].untyped_storage().data_ptr() == \
        entry.carry[1].untyped_storage().data_ptr()


class _HostOps(TorchDispatchMode):
    """The ops a call dispatches on the host, views aside (they launch no
    device work), and outside the graphs' replays (`_counted_capture`)."""

    paused = 0

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _HostOps.paused and not func.is_view:
            self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _counted_capture(body, device):
    """`_plain_capture` whose replays the `_HostOps` count leaves out: on the
    card they are graph replays, no dispatched op."""
    body()

    def replay():
        counts = graphs._counts()
        _HostOps.paused += 1
        try:
            body()
        finally:
            _HostOps.paused -= 1
        graphs._set_counts(counts)

    return replay


# The host ops of a steady call with its own state passed back: the load (one
# multi-tensor copy for the f32 state, constants and blocks, one for the int32
# state), one fresh buffer per dtype, and the copies of the outputs and the
# state into them.
STEADY_HOST_OPS = 6


def test_a_steady_call_issues_as_many_host_ops_whatever_its_leaves(captured, monkeypatch):
    monkeypatch.setattr(graphs, "capture", _counted_capture)
    system, codes, states, _, _ = _l1_case(k=4)
    with _HostOps() as packing:
        epl_kernels.prepare_bank_code_tiles_rows(codes, states.prn)
    copy_op = torch.ops.aten._foreach_copy_.default
    counts = {}
    for name in ("rows", "comp_a2", "dual"):
        call, state, _ = _chained_case(name)
        st, _ = call(state, 0, 2)
        st, _ = call(st, 2, 4)
        with _HostOps() as mode:
            call(st, 4, 6)
        counts[name] = len(mode.ops)
        assert not set(mode.ops) & set(packing.ops), name
        assert set(mode.ops) == {copy_op, torch.ops.aten.empty.memory_format}
    assert counts == dict.fromkeys(counts, STEADY_HOST_OPS)


def test_a_state_on_one_storage_in_another_layout_is_loaded_leaf_by_leaf(captured):
    # The returned state with two of its f32 leaves swapped lies on the
    # entry's storage but not at the entry's offsets: it is not one region,
    # and the call runs from the swapped state, as the eager loop does.
    call, state, _ = _chained_case("rows")
    passed = call(state, 0, 2)[0]
    swapped = passed._replace(carrier_doppler=passed.code_doppler,
                              code_doppler=passed.carrier_doppler)
    assert not _in_entry_layout(swapped, _entry())
    with graphs.eager():
        want = call(swapped, 2, BLOCKS)
    _assert_same(call(swapped, 2, BLOCKS), want)


# --- The sharded bank on distinct devices: `graphs.scan_mesh`, a card per
# (chan, time) shard. The CPU's devices named apart ("cpu:0".."cpu:3") take
# the distinct-card path; their tensors all lie on the CPU.

DISTINCT = [torch.device("cpu", i) for i in range(4)]
# The bank routes, then the correlators that take no code tiles (the
# per-channel kernels, batched over [K] or one call per channel).
MESH_ROUTES = ["rows", "comp_a2", "transition", "onehot", "fused", "taps", "fused_xla",
               "xla_bank"]
WITHOUT_TILES = ["fused", "taps", "fused_xla", "xla_bank"]


def _mesh_case(name, axes):
    # K a multiple of 4, so that every mesh's channel shards divide it.
    algorithm, n, fs, k, num_ants, extra = BANK_CASES[name]
    system, codes, states, sre, sim = _l1_case(n, fs, -(-k // 4) * 4, num_ants)
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm=algorithm, **extra)
    mesh = tparallel.make_mesh({"chan": axes[0], "time": axes[1]}, devices=DISTINCT)
    return config, codes, states, sre, sim, mesh


def _spy_scan_mesh(monkeypatch) -> list:
    """Each `graphs.scan_mesh` call's per-part results, as it returns them."""
    seen = []
    scan_mesh = graphs.scan_mesh

    def spy(*args, **kwargs):
        results = scan_mesh(*args, **kwargs)
        seen.append(results)
        return results

    monkeypatch.setattr(graphs, "scan_mesh", spy)
    return seen


@pytest.mark.parametrize("axes", [(2, 2), (1, 2), (2, 1), (4, 1)])
@pytest.mark.parametrize("name", MESH_ROUTES)
def test_a_distinct_card_mesh_replays_the_eager_loop_and_the_one_device_mesh(captured, name,
                                                                             axes):
    # The captured path (a card entry per shard, a graph per channel shard
    # over its cards) against the eager loop over the same cards and the
    # one-device mesh, bit for bit, over two chunks and a tail; a second
    # call from the first's final state chains as a second eager call.
    config, codes, states, sre, sim, mesh = _mesh_case(name, axes)
    one = tparallel.channel_time_mesh(*axes, devices=["cpu"] * 4)
    with graphs.eager():
        want = tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
        want2 = tparallel.track_bank_sharded(config, codes, want[0], sre, sim, mesh=mesh)
        _assert_same(tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=one),
                     want)
    got = tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    (entry,) = captured[tuple(DISTINCT[:axes[0] * axes[1]])].values()
    assert type(entry).__name__ == "_MeshEntry" and len(entry.cards) == axes[0] * axes[1]
    assert [len(group) for group in entry.groups] == [axes[1]] * axes[0]
    _assert_same(got, want)
    _assert_same(tparallel.track_bank_sharded(config, codes, got[0], sre, sim, mesh=mesh), want2)


@pytest.mark.parametrize("path", ["eager", "captured"])
@pytest.mark.parametrize("axes", [(2, 2), (1, 2)])
@pytest.mark.parametrize("name", ["rows"] + WITHOUT_TILES)
def test_every_time_shards_replica_of_the_carry_equals_the_time_zero_cards(
        captured, monkeypatch, name, axes, path):
    # Every card of a channel shard closes the loop on its own replica of the
    # carry, from the same partials in the same order: each time shard's
    # final carry (the eager loop's, or its card entry's after a captured
    # call) equals its time-0 card's bit for bit, and the call returns the
    # time-0 cards' results.
    config, codes, states, sre, sim, mesh = _mesh_case(name, axes)
    seen = _spy_scan_mesh(monkeypatch)
    finals = []
    loop = graphs.loop

    def spy(*args, **kwargs):
        carries, outs = loop(*args, **kwargs)
        finals.append(carries)
        return carries, outs

    monkeypatch.setattr(graphs, "loop", spy)
    with graphs.eager() if path == "eager" else contextlib.nullcontext():
        final, out = tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    num_chan, num_time = axes
    if path == "captured":
        assert not finals
        (entry,) = captured[tuple(DISTINCT[:num_chan * num_time])].values()
        finals.append(tuple(card.carry for card in entry.cards))
    (results,), (carries,) = seen, finals
    assert len(results) == num_chan and len(carries) == num_chan * num_time
    per = states.prn.shape[0] // num_chan
    for c in range(num_chan):
        lead_final, lead_out = results[c]
        for t in range(num_time):
            _assert_same(carries[c * num_time + t], lead_final)
        rows = slice(c * per, (c + 1) * per)
        for g, w in zip(_leaves(lead_final), _leaves(final)):
            assert torch.equal(g, w[rows])
        for g, w in zip(_leaves(lead_out), _leaves(out)):
            assert torch.equal(g, w[:, rows])


@pytest.mark.parametrize("name", MESH_ROUTES)
def test_distinct_cards_run_no_eager_loop_and_pack_their_shards_tiles(captured, monkeypatch,
                                                                      name):
    # No route on distinct cards reaches `graphs.loop` outside
    # `graphs.eager()` (where `graphs.loop_mesh` is that loop): the call is
    # one `_MeshEntry`, a group of 2 cards per channel shard. On a bank
    # route each card's prologue packs the code tiles of its channel
    # shard's PRNs, as `_bank_code_tile_kwargs` packs them; another route
    # has no prologue, and each card's constants are its code table.
    from gpuacceleratedtracking_tpu_torch.tracking.track import _bank_code_tile_kwargs

    def refused(*args, **kwargs):
        raise AssertionError("the eager block loop ran")

    config, codes, states, sre, sim, mesh = _mesh_case(name, (2, 2))
    with graphs.eager():
        want = tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    monkeypatch.setattr(graphs, "loop", refused)
    got = tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    _assert_same(got, want)
    (entry,) = captured[tuple(DISTINCT)].values()
    assert type(entry).__name__ == "_MeshEntry" and entry.groups == [[0, 1], [2, 3]]
    per = states.prn.shape[0] // 2
    for i, card in enumerate(entry.cards):
        c = i // 2
        assert card.device == DISTINCT[i]
        assert torch.equal(card.carry.prn, states.prn[c * per:(c + 1) * per])
        if name in WITHOUT_TILES:
            assert torch.equal(card.prepared[0], codes) and card.prepared[1] is None
            continue
        tiles = _bank_code_tile_kwargs(config, codes,
                                       states.prn[c * per:(c + 1) * per])["code_tiles"]
        assert torch.equal(card.prepared[1], tiles)


@pytest.mark.parametrize("name", ["rows"] + WITHOUT_TILES)
def test_a_distinct_card_call_cuts_and_joins_one_copy_per_dtype_per_card(captured,
                                                                          monkeypatch, name):
    # A steady 2 x 2 call's copies outside its replays: the cut is one
    # multi-tensor copy per dtype on the first device, each card loads its
    # carry as one region per dtype (with its code table and first chunk, one
    # multi-tensor copy per pair of dtypes), each channel shard's time-0 card
    # copies its results once per pair of dtypes (the other cards' replicas
    # stay in their entries), and the join moves each channel shard's results in one
    # copy per dtype and gathers them in one op per dtype. The results lie
    # as an unsharded call's: one buffer per dtype, each leaf where
    # `track_bank`'s results put it.
    monkeypatch.setattr(graphs, "CHUNK", BLOCKS)
    config, codes, states, sre, sim, mesh = _mesh_case(name, (2, 2))
    tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    counting = [True]
    calls = {"foreach": 0, "copy_": 0, "index_select": 0, "loaded_regions": 0}

    def replays_uncounted(replay):
        def run():
            counting[0] = False
            try:
                replay()
            finally:
                counting[0] = True
        return run

    for entry in graphs._ENTRIES[tuple(DISTINCT)].values():
        entry.replays = [(replays_uncounted(r), n) for r, n in entry.replays]
        for card in entry.cards:
            card.prologue = replays_uncounted(card.prologue)
    foreach, copy_, select = torch._foreach_copy_, torch.Tensor.copy_, torch.index_select
    flat_source = graphs._flat_source

    def count(name, fn):
        def wrapped(*args, **kwargs):
            if counting[0]:
                calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def regions(*args, **kwargs):
        src = flat_source(*args, **kwargs)
        calls["loaded_regions"] += src is not None
        return src

    with monkeypatch.context() as spies:
        spies.setattr(torch, "_foreach_copy_", count("foreach", foreach))
        spies.setattr(torch.Tensor, "copy_", count("copy_", copy_))
        spies.setattr(torch, "index_select", count("index_select", select))
        spies.setattr(graphs, "_flat_source", regions)
        final, out = tparallel.track_bank_sharded(config, codes, states, sre, sim, mesh=mesh)
    carry_dtypes = {x.dtype for x in _leaves(states)}
    result_dtypes = carry_dtypes | {x.dtype for x in _leaves(out)}
    load_pairs = len(carry_dtypes | {codes.dtype, sre.dtype})
    cards, shards = 4, 2
    assert calls == {
        "foreach": len(carry_dtypes) + cards * load_pairs + shards * len(result_dtypes),
        "copy_": shards * len(result_dtypes),
        "index_select": len(result_dtypes),
        # each card's carry, and each channel shard's results, one region a dtype
        "loaded_regions": cards * len(carry_dtypes) + shards * len(result_dtypes),
    }
    with graphs.eager():
        _, want = ttracking.track_bank(config, codes, states, sre, sim)
    unsharded = ttracking.track_bank(config, codes, states, sre, sim)
    for tree in ((final, out), unsharded):
        for dtype in result_dtypes:
            assert len({x.untyped_storage().data_ptr() for x in _leaves(tree)
                        if x.dtype == dtype}) == 1
    assert ([x.storage_offset() for x in _leaves((final, out))]
            == [x.storage_offset() for x in _leaves(unsharded)])
    torch.testing.assert_close(out.prompt_re, want.prompt_re, rtol=2e-3, atol=1e-2 * 4096)
