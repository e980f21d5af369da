"""PyTorch port, a replayed block as its kernels alone, on the CPU.

A bank kernel's block body passes the tracking state's leaves to the bank
wrappers (the state form, `epl_kernels.BankChannels`) and, in the captured
block loop, the chunk of blocks with the loop's device-side index (the index
form, `graphs.Chunk`); the prologue packs the code tiles with
`epl_kernels.pack_code_tiles`. On the card the kernels evaluate those
expressions; here the plain versions do, and every result is held, bit for
bit, against the registry signature's call with the expressions the block
body passed before (`intermediate_frequency + carrier_doppler`, the dual
bank's joined table and duplicated channels, the block selected by
`index_select`), over every bank route, taps whose earliest shift is not 0,
the dual bank's two channels per state entry and a call of 70 blocks (two
chunks of `graphs.CHUNK`).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu.ops import pallas_epl
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import epl_kernels, loop_kernel, registry
from gpuacceleratedtracking_tpu_torch.ops.replica import _TWO_PI_F32
from gpuacceleratedtracking_tpu_torch.tracking import graphs
from gpuacceleratedtracking_tpu_torch.tracking.dual import _overlay, dual_update
from gpuacceleratedtracking_tpu_torch.tracking.track import bank_correlator

torch.set_num_threads(1)

LONG_CALL = 70        # blocks: two chunks of graphs.CHUNK (64)

# name -> (wrapper, N, fs, K0, A, sample shifts or None for the config's, extras)
ROUTES = {
    "rows": ("pallas_bank_rows", 4096, 8.192e6, 8, None, None, {}),
    "rows_d_min": ("pallas_bank_rows", 4096, 8.192e6, 8, None, (-7, -2, 3), {}),
    "transition": ("pallas_bank", 2048, 4.096e6, 4, None, (-3, 0, 3), {}),
    "onehot": ("pallas_bank_onehot", 4096, 8.192e6, 4, None, (-160, 0, 170), {}),
    "comp_a2": ("pallas_bank_comp", 4096, 8.192e6, 4, 2, None, {}),
    "comp_a2_l7_d_min": ("pallas_bank_comp", 4096, 8.192e6, 4, 2, (-9, -6, -3, 0, 3, 6, 9),
                         {}),
    "comp_bf16": ("pallas_bank_comp", 4096, 8.192e6, 4, 2, None,
                  {"z_dtype": torch.bfloat16}),
    "auto_a2": ("pallas_bank_auto", 4096, 8.192e6, 4, 2, None, {}),
}


def _channels(rng, k0, code_length, device="cpu"):
    """``[K0]`` f32 state leaves: Dopplers, carrier phases in [0, 2 pi) and
    code phases in [0, Lc), made with numpy."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return (f32(rng.uniform(-4000.0, 4000.0, k0)), f32(rng.uniform(0.0, 2 * np.pi, k0)),
            f32(rng.uniform(-2.0, 2.0, k0)), f32(rng.uniform(0.0, code_length, k0)))


def _route_case(name, modulus, seed=0, blocks=3):
    wrapper, n, fs, k0, num_ants, shifts, extra = ROUTES[name]
    system = tmodels.GPSL1()
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm="pallas_bank_auto")
    shifts = config.sample_shifts if shifts is None else shifts
    rng = np.random.default_rng(seed)
    shape = (blocks, n) if num_ants is None else (blocks, num_ants, n)
    chunk_re = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    chunk_im = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    codes = torch.as_tensor(system.codes)
    pilot = torch.roll(-codes, 11, 0).contiguous()         # a second +/-1 table
    prn = torch.as_tensor(rng.integers(0, 32, k0), dtype=torch.int32)
    cd, cp, kd, kp = _channels(rng, k0, system.code_length)
    if modulus == 2:
        joined, prn_all = torch.cat([codes, pilot], 1), torch.cat([prn, prn + codes.shape[1]])
        tiles = epl_kernels.pack_code_tiles(codes, prn, pilot)
    else:
        joined, prn_all = codes, prn
        tiles = epl_kernels.pack_code_tiles(codes, prn)
    kwargs = dict(extra)
    if wrapper != "pallas_bank_onehot":
        kwargs.update(nominal_code_frequency=config.code_frequency,
                      nominal_carrier_frequency=config.intermediate_frequency)
    dup = lambda x: torch.cat([x] * modulus)  # noqa: E731
    # The registry signature with the expressions a block body passed.
    registry_args = (joined, prn_all, dup(config.intermediate_frequency + cd), fs, dup(cp),
                     dup(config.code_frequency + kd), dup(kp), shifts, system.code_length)
    channels = epl_kernels.BankChannels(config.intermediate_frequency, cd, cp,
                                        config.code_frequency, kd, kp)
    state_args = (codes, prn, None, fs, None, None, None, shifts, system.code_length)
    return (registry.get(wrapper), chunk_re, chunk_im, registry_args, state_args, channels,
            dict(kwargs, code_tiles=tiles))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("modulus", [1, 2])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_state_and_index_forms_equal_the_registry_signature(name, modulus):
    corr, chunk_re, chunk_im, registry_args, state_args, channels, kwargs = _route_case(
        name, modulus)
    for b in range(chunk_re.shape[0]):
        want = corr(chunk_re[b], chunk_im[b], *registry_args, **kwargs)
        assert want[0].shape[0] == modulus * channels.carrier_doppler.shape[0]
        _equal(corr(chunk_re[b], chunk_im[b], *state_args, **kwargs, channels=channels), want)
        index = torch.tensor(b, dtype=torch.int64)
        _equal(corr(chunk_re, chunk_im, *state_args, **kwargs, channels=channels,
                    block_index=index), want)
        # The index form with the registry signature's parameters.
        _equal(corr(chunk_re, chunk_im, *registry_args, **kwargs, block_index=index), want)


def test_state_form_params_are_the_registry_params_repeated_per_component():
    corr, chunk_re, chunk_im, registry_args, state_args, channels, kwargs = _route_case(
        "rows_d_min", 2)
    explicit = epl_kernels.BankRowsCall(chunk_re[0], chunk_im[0], *registry_args, **kwargs)
    state = epl_kernels.BankRowsCall(chunk_re, chunk_im, *state_args, **kwargs,
                                     channels=channels, block_index=torch.tensor(1))
    assert state.num_k == explicit.num_k == 2 * channels.carrier_doppler.shape[0]
    assert torch.equal(state.params, explicit.params)
    _equal(state.planes(), (chunk_re[1:2], chunk_im[1:2]))


def test_the_kernels_source_holds_the_roundings_of_the_plain_expressions():
    # What the kernels derive each channel's parameters with: torch's f32
    # roundings of the Python floats, and its divisions by a Python float on
    # CUDA as products with the double reciprocal.
    _, chunk_re, chunk_im, _, state_args, channels, kwargs = _route_case("comp_a2_l7_d_min", 2)
    bank = epl_kernels.BankRowsCall(chunk_re, chunk_im, *state_args, **kwargs,
                                    route="pallas_bank_comp", channels=channels,
                                    block_index=torch.tensor(2))
    src = bank.source()
    assert src.params is None
    assert src.block_index == bank.block_index.data_ptr()
    assert src.block_stride == 2 * 4096
    assert src.carrier_doppler == channels.carrier_doppler.data_ptr()
    assert src.code_phase == channels.code_phase.data_ptr()
    assert src.inv_fs == 1.0 / 8.192e6
    assert src.intermediate_frequency == float(np.float32(channels.intermediate_frequency))
    assert src.code_frequency == float(np.float32(channels.code_frequency))
    assert src.inv_two_pi == loop_kernel._recip(_TWO_PI_F32)
    assert src.d_min == -9.0 and src.modulus == channels.carrier_doppler.shape[0]
    # No time shard: the whole row of each antenna, the phases as they are.
    assert src.sample_offset == 0 and src.plane_stride == 4096 and src.shard == 0
    assert ctypes.sizeof(epl_kernels._Source) == 128
    explicit = epl_kernels.BankRowsCall(chunk_re[0], chunk_im[0], *state_args[:2],
                                        torch.zeros(4), 8.192e6, torch.zeros(4), torch.zeros(4),
                                        torch.zeros(4), *state_args[-2:],
                                        code_tiles=kwargs["code_tiles"][:4],
                                        route="pallas_bank_onehot")
    assert explicit.source().params == explicit.params.data_ptr()
    assert explicit.source().block_index is None


def test_pack_code_tiles_plain_equals_prepare_bank_code_tiles_rows():
    system = tmodels.GPSL5()
    pilot = torch.as_tensor(tmodels.GPSL5(quadrature=True).codes)
    codes = torch.as_tensor(system.codes)
    prn = torch.as_tensor([3, 0, 31, 3, 17], dtype=torch.int32)
    tiles = epl_kernels.pack_code_tiles(codes, prn)
    assert tiles.dtype == torch.int32 and tiles.shape == (5, -(-10230 // 32))
    assert torch.equal(tiles, epl_kernels.prepare_bank_code_tiles_rows(codes, prn))
    # The dual bank's two tables: the joined table's words, without a join.
    dual = epl_kernels.pack_code_tiles(codes, prn, pilot)
    joined = epl_kernels.prepare_bank_code_tiles_rows(
        torch.cat([codes, pilot], 1), torch.cat([prn, prn + codes.shape[1]]))
    assert torch.equal(dual, joined)
    assert torch.equal(epl_kernels.unpack_code_columns(dual[5:], 10230),
                       pilot[:, prn.long()].T)


@pytest.mark.parametrize("which", ["codes", "pilot"])
def test_pack_code_tiles_refuses_a_chip_other_than_one(which):
    codes = torch.as_tensor(tmodels.GPSL1().codes).clone()
    pilot = -codes
    (codes if which == "codes" else pilot)[100, 4] = 0.5
    prn = torch.tensor([1, 4, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="1 chips only"):
        epl_kernels.pack_code_tiles(codes, prn, pilot)
    # A chip of a PRN that no channel tracks is not read.
    prn_other = torch.tensor([1, 9], dtype=torch.int32)
    epl_kernels.pack_code_tiles(codes, prn_other, pilot)


# family -> its [Lc, P] code table or tables (the GPS L5 dual bank's data
# and pilot), in the port and in the JAX package.
FAMILIES = {
    "gpsl1": (lambda m: (m.GPSL1(),)),
    "gpsl5": (lambda m: (m.GPSL5(),)),
    "gpsl5_dual": (lambda m: (m.GPSL5(), m.GPSL5(quadrature=True))),
    "galileo_e1": (lambda m: (m.GalileoE1(),)),
    "beidou_b1i": (lambda m: (m.BeiDouB1I(),)),
    "glonass_l1of": (lambda m: (m.GLONASSL1(),)),
}


def _family_tables(family):
    return [torch.as_tensor(system.codes) for system in FAMILIES[family](tmodels)]


def _family_prns(tables, k, seed=0):
    """``k`` PRNs of the family's table, with repeats, made with numpy; a K
    below the table's P takes P - 1."""
    num_prns = tables[0].shape[1]
    k = num_prns - 1 if k == "below_p" else k
    return torch.as_tensor(np.random.default_rng(seed).integers(0, num_prns, k))


def _joined_words(tables, prn):
    """`prepare_bank_code_tiles_rows` on the joined table and PRNs."""
    prn = prn.long()
    return epl_kernels.prepare_bank_code_tiles_rows(
        torch.cat(tables, 1), torch.cat([prn + sum(t.shape[1] for t in tables[:i])
                                         for i in range(len(tables))]))


@pytest.mark.parametrize("prn_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("k", [1, 5, "below_p", 1024])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pack_code_tiles_writes_into_out_and_zeroes_the_index(family, k, prn_dtype):
    tables = _family_tables(family)
    prn = _family_prns(tables, k).to(prn_dtype)
    words = -(-tables[0].shape[0] // 32)
    out = torch.full((prn.numel() * len(tables), words), -1, dtype=torch.int32)
    ptr = out.data_ptr()
    index = torch.tensor(7, dtype=torch.int64)
    got = epl_kernels.pack_code_tiles(tables[0], prn, *tables[1:], out=out, index=index)
    assert got is out and out.data_ptr() == ptr and int(index) == 0
    assert torch.equal(out, _joined_words(tables, prn))
    assert torch.equal(out, epl_kernels.pack_code_tiles(tables[0], prn, *tables[1:]))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_packed_words_hold_the_jax_columns(family):
    # The JAX package's rows-kernel tables at 8 samples per chip hold each
    # channel's whole code column first: the port's words, unpacked, are
    # those columns, chip for chip.
    jsystems = FAMILIES[family](jmodels)
    tables = _family_tables(family)
    prn = _family_prns(tables, 5, seed=3)
    lc = jsystems[0].code_length
    out = torch.empty((5 * len(tables), -(-lc // 32)), dtype=torch.int32)
    epl_kernels.pack_code_tiles(tables[0], prn, *tables[1:], out=out,
                                index=torch.zeros((), dtype=torch.int64))
    for i, jsystem in enumerate(jsystems):
        want = pallas_epl.prepare_bank_code_tiles_rows(
            jnp.asarray(jsystem.codes), jnp.asarray(prn.numpy()), code_length=lc,
            num_samples=4096, sampling_frequency=8 * jsystem.code_frequency,
            nominal_code_frequency=jsystem.code_frequency)
        want = np.asarray(want).reshape(5, -1)[:, :lc]
        np.testing.assert_array_equal(
            epl_kernels.unpack_code_columns(out[5 * i:5 * (i + 1)], lc).numpy(), want)


# fault -> (out, index) the wrapper refuses, for 3 GPS L1 channels
_GOOD_OUT = lambda: torch.zeros((3, 32), dtype=torch.int32)  # noqa: E731
_GOOD_INDEX = lambda: torch.zeros((), dtype=torch.int64)  # noqa: E731
OUT_FAULTS = {
    "out_shape": (lambda: torch.zeros((3, 31), dtype=torch.int32), _GOOD_INDEX, "out must"),
    "out_rows": (lambda: torch.zeros((4, 32), dtype=torch.int32), _GOOD_INDEX, "out must"),
    "out_dtype": (lambda: torch.zeros((3, 32), dtype=torch.int64), _GOOD_INDEX, "out must"),
    "out_strided": (lambda: torch.zeros((32, 3), dtype=torch.int32).T, _GOOD_INDEX, "out must"),
    "out_device": (lambda: torch.zeros((3, 32), dtype=torch.int32, device="meta"), _GOOD_INDEX,
                   "out must"),
    "index_dtype": (_GOOD_OUT, lambda: torch.zeros((), dtype=torch.int32), "index must"),
    "index_shape": (_GOOD_OUT, lambda: torch.zeros((1,), dtype=torch.int64), "index must"),
    "index_device": (_GOOD_OUT, lambda: torch.zeros((), dtype=torch.int64, device="meta"),
                     "index must"),
}


@pytest.mark.parametrize("fault", sorted(OUT_FAULTS))
def test_pack_code_tiles_refuses_an_out_or_index_it_cannot_take(fault):
    make_out, make_index, match = OUT_FAULTS[fault]
    codes = torch.as_tensor(tmodels.GPSL1().codes)
    out, index = make_out(), make_index()
    with pytest.raises(ValueError, match=match):
        epl_kernels.pack_code_tiles(codes, torch.tensor([0, 4, 9]), out=out, index=index)


@pytest.mark.parametrize("vec", [4, 1])
@pytest.mark.parametrize("k", [1, 5, "below_p", 1024])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tiles_split_copies_every_word_once(family, k, vec):
    # The packing kernel's CTA (x, y, z), thread u copies words [x chunk + v
    # vec, + vec) of channel y channels + u // (chunk / vec) of table z, v = u
    # mod (chunk / vec), where that channel and word exist: every (channel,
    # word) once; each CTA's (word, column) pairs fit its threads' loop and
    # its rows its shared memory.
    tables = _family_tables(family)
    num_prns, num_k0 = max(t.shape[1] for t in tables), _family_prns(tables, k).numel()
    words = -(-tables[0].shape[0] // 32)
    split = epl_kernels.tiles_split(num_prns, words, num_k0, len(tables), vec)
    assert split.vec == vec and split.chunk % vec == 0
    assert split.channels * (split.chunk // vec) <= epl_kernels.TILES_THREADS
    assert epl_kernels.tiles_shared(num_prns, split.chunk) <= epl_kernels.TILES_MAX_SHARED
    grid_x, grid_y, grid_z = split.grid
    assert grid_z == len(tables) and grid_x == -(-words // split.chunk)
    assert grid_y == -(-num_k0 // split.channels)
    vecs = split.chunk // vec
    x, y, z, u, j = np.meshgrid(np.arange(grid_x), np.arange(grid_y), np.arange(grid_z),
                                np.arange(epl_kernels.TILES_THREADS), np.arange(vec),
                                indexing="ij")
    s, v = y * split.channels + u // vecs, u % vecs
    word = x * split.chunk + v * vec
    copies = (u < split.channels * vecs) & (s < num_k0) & (word < words)
    cells = ((z * num_k0 + s) * words + word + j)[copies]
    assert np.array_equal(np.bincount(cells, minlength=len(tables) * num_k0 * words),
                          np.ones(len(tables) * num_k0 * words, dtype=np.int64))


def _plain_capture(body, device):
    body()

    def replay():
        counts = graphs._counts()
        body()
        graphs._set_counts(counts)

    return replay


@pytest.fixture
def captured(monkeypatch):
    """`graphs.scan` takes its captured path on CPU tensors, its chunk as
    on the card (`graphs.CHUNK`)."""
    monkeypatch.setattr(graphs, "enabled", lambda device: not graphs._EAGER)
    monkeypatch.setattr(graphs, "capture", _plain_capture)
    graphs.clear()
    yield graphs._ENTRIES
    graphs.clear()


def test_a_body_marked_reads_chunk_takes_the_chunk_in_a_capture(captured):
    seen = []

    @graphs.reads_chunk
    def step(carry, consts, block):
        seen.append(type(block).__name__)
        x = block.block()[0] if isinstance(block, graphs.Chunk) else block[0]
        return carry + x.sum(), x * 2

    xs = torch.arange(12.0).reshape(4, 3)
    with graphs.eager():
        want = graphs.scan(step, torch.zeros(()), (xs,), key="reads_chunk")
    assert set(seen) == {"tuple"}
    seen.clear()
    got = graphs.scan(step, torch.zeros(()), (xs,), key="reads_chunk")
    assert set(seen) == {"Chunk"}
    _equal(graphs._leaves(got), graphs._leaves(want))
    entry = next(iter(captured[torch.device("cpu")].values()))
    assert entry.xs[0].shape == (graphs.CHUNK, 3)


def _registry_bank_step(config, corr, kwargs):
    """The block body of `track_bank` with the registry signature's
    expressions and the block selected by the entry."""
    def step(states, consts, block):
        codes, code_tiles, ant_weights = consts
        tiles = {} if code_tiles is None else {"code_tiles": code_tiles}
        accum_re, accum_im = corr(
            block[0], block[1], codes, states.prn,
            config.intermediate_frequency + states.carrier_doppler,
            config.sampling_frequency, states.carrier_phase,
            config.code_frequency + states.code_doppler, states.code_phase,
            config.sample_shifts, config.code_length, **kwargs, **tiles)
        return ttracking.loop_update(config, states, accum_re, accum_im, ant_weights)

    return step


def _long_l1_case(n, fs, k, num_ants, seed=3):
    system = tmodels.GPSL1()
    rng = np.random.default_rng(seed)
    dops = rng.uniform(-3000.0, 3000.0, k)
    sig, _ = tmodels.gen_signal_mixed(system, np.arange(3), dops[:3], n * LONG_CALL,
                                      num_ants=num_ants, duration=n * LONG_CALL / fs,
                                      device="cpu")
    sre, sim = tmodels.soa(sig)
    if num_ants:
        sre, sim = (x.reshape(num_ants, LONG_CALL, n).transpose(0, 1).contiguous()
                    for x in (sre, sim))
    else:
        sre, sim = sre.reshape(LONG_CALL, n), sim.reshape(LONG_CALL, n)
    states = ttracking.init_state(np.arange(k) % 32, carrier_doppler=dops + 15.0,
                                  code_phase=rng.uniform(0, 1023, k), device="cpu",
                                  num_taps=3)
    return system, torch.as_tensor(system.codes), states, sre, sim


# name -> (algorithm, N, fs, K, A, TrackConfig extras): the bank kernels of
# tests/test_torch_graph.py's BANK_CASES.
BANK_CASES = {
    "rows": ("pallas_bank_rows", 2048, 4.096e6 * 1.5, 8, None, {}),
    "comp_a2": ("pallas_bank_comp", 2048, 4.096e6 * 1.5, 4, 2, {}),
    "comp_bf16": ("pallas_bank_auto", 2048, 4.096e6 * 1.5, 4, 2, {"z_dtype": "bf16"}),
    "transition": ("pallas_bank", 2048, 4.096e6, 4, None, {}),
    "onehot": ("pallas_bank_onehot", 2048, 4.096e6 * 1.5, 4, None, {}),
}


@pytest.mark.parametrize("name", sorted(BANK_CASES))
def test_a_long_captured_call_equals_the_registry_expressions(captured, name):
    algorithm, n, fs, k, num_ants, extra = BANK_CASES[name]
    system, codes, states, sre, sim = _long_l1_case(n, fs, k, num_ants)
    config = ttracking.TrackConfig.for_system(system, fs, n, algorithm=algorithm, **extra)
    weights = None
    if num_ants:
        weights = (torch.tensor([[1.0, 0.5]] * k), torch.tensor([[0.0, -0.25]] * k))
    corr, kwargs = bank_correlator(config)
    tiles = epl_kernels.prepare_bank_code_tiles_rows(codes, states.prn)
    want = graphs.loop(_registry_bank_step(config, corr, kwargs), states, (sre, sim),
                       (codes, tiles, weights))
    got = ttracking.track_bank(config, codes, states, sre, sim, ant_weights=weights)
    entry = next(iter(captured[torch.device("cpu")].values()))
    assert entry.chunk == graphs.CHUNK < LONG_CALL
    _equal(graphs._leaves(got), graphs._leaves(want))
    with graphs.eager():
        _equal(graphs._leaves(ttracking.track_bank(config, codes, states, sre, sim,
                                                   ant_weights=weights)),
               graphs._leaves(want))


@pytest.mark.parametrize("algorithm", ["pallas_bank_auto", "pallas_bank_onehot"])
def test_a_long_captured_dual_call_equals_the_joined_expressions(captured, algorithm):
    sys_i, sys_q = tmodels.GPSL5(), tmodels.GPSL5(quadrature=True)
    n = 4096
    fs = n / 0.25e-3
    sig, _ = tmodels.gen_signal(sys_i, 2, 700.0, n * LONG_CALL, duration=LONG_CALL * 0.25e-3,
                                device="cpu")
    sre, sim = (x.reshape(LONG_CALL, n) for x in tmodels.soa(sig))
    k = 3
    states = ttracking.init_state(np.arange(2, 2 + k), carrier_doppler=np.linspace(-600, 700, k),
                                  ms_elapsed=np.arange(k) * 3, device="cpu")
    config = ttracking.dual_config(ttracking.TrackConfig.for_system(
        sys_i, fs, n, algorithm=algorithm, use_secondary=False))
    codes_i, codes_q = torch.as_tensor(sys_i.codes), torch.as_tensor(sys_q.codes)
    corr, kwargs = bank_correlator(config)
    data = _overlay(None, tmodels.gpsl5.neuman_hofman(False), "cpu")
    pilot = _overlay(None, tmodels.gpsl5.neuman_hofman(True), "cpu")

    def joined_step(states, consts, block):
        codes = torch.cat([codes_i, codes_q], 1)
        prn2 = torch.cat([states.prn, states.prn + codes_i.shape[1]])
        dup = lambda x: torch.cat([x, x])  # noqa: E731
        are, aim = corr(block[0], block[1], codes, prn2,
                        dup(config.intermediate_frequency + states.carrier_doppler),
                        config.sampling_frequency, dup(states.carrier_phase),
                        dup(config.code_frequency + states.code_doppler),
                        dup(states.code_phase), config.sample_shifts, config.code_length,
                        **kwargs, code_tiles=epl_kernels.prepare_bank_code_tiles_rows(codes,
                                                                                      prn2))
        return dual_update(config, states, are, aim, data, pilot)

    want = graphs.loop(joined_step, states, (sre, sim))
    got = ttracking.track_bank_dual(config, codes_i, codes_q, states, sre, sim)
    entry = next(iter(captured[torch.device("cpu")].values()))
    assert entry.chunk == graphs.CHUNK < LONG_CALL
    # The prologue joins nothing: the data table and the states' PRNs stay
    # the entry's own buffers, the tiles come from both tables.
    prepared = graphs._leaves(entry.prepared)
    assert prepared[0] is entry.const_leaves[0] and prepared[1].shape == (k,)
    assert prepared[2].shape == (2 * k, -(-10230 // 32))
    _equal(graphs._leaves(got), graphs._leaves(want))
