"""PyTorch port, loop closure: discriminators, loop filters, C/N0, state
interop and `loop_update` vs the JAX package."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu.tracking import cn0 as jcn0
from gpuacceleratedtracking_tpu.tracking import discriminators as jdisc
from gpuacceleratedtracking_tpu.tracking import loop_filter as jlf
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.tracking import cn0 as tcn0
from gpuacceleratedtracking_tpu_torch.tracking import discriminators as tdisc
from gpuacceleratedtracking_tpu_torch.tracking import loop_filter as tlf
from gpuacceleratedtracking_tpu_torch.ops import registry as tregistry

torch.set_num_threads(1)

RTOL = 1e-5


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=atol)


def _prompts(seed, k=16, scale=2000.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=k) * scale).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("name", ["pll_costas", "pll_atan2"])
def test_pll_discriminators(name):
    re, im, _, _ = _prompts(0)
    re[0] = 0.0
    _close(getattr(tdisc, name)(torch.as_tensor(re), torch.as_tensor(im)),
           getattr(jdisc, name)(jnp.asarray(re), jnp.asarray(im)))


def test_dll_emle():
    er, ei, lr, li = _prompts(1)
    t = [torch.as_tensor(x) for x in (er, ei, lr, li)]
    j = [jnp.asarray(x) for x in (er, ei, lr, li)]
    _close(tdisc.dll_emle(*t, 0.9775), jdisc.dll_emle(*j, 0.9775))


@pytest.mark.parametrize("name", ["fll_atan", "fll_atan2"])
def test_fll_discriminators(name):
    pr, pi, cr, ci = _prompts(2)
    t = [torch.as_tensor(x) for x in (pr, pi, cr, ci)]
    j = [jnp.asarray(x) for x in (pr, pi, cr, ci)]
    _close(getattr(tdisc, name)(*t, torch.tensor(1e-3)),
           getattr(jdisc, name)(*j, jnp.float32(1e-3)), atol=1e-4)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("fll_bandwidth", [0.0, 4.0])
def test_loop_filter_steps(order, fll_bandwidth):
    rng = np.random.default_rng(order)
    x1 = (rng.normal(size=8) * 300).astype(np.float32)
    x2 = (rng.normal(size=8) * 10).astype(np.float32)
    j_state = jlf.LoopFilterState(jnp.asarray(x1), jnp.asarray(x2))
    t_state = tlf.LoopFilterState(torch.as_tensor(x1), torch.as_tensor(x2))
    for step in range(5):
        err = (rng.normal(size=8) * 0.05).astype(np.float32)
        fll = (rng.normal(size=8) * 3).astype(np.float32)
        j_state, j_out = jlf.step(j_state, jnp.asarray(err), 1e-3, 18.0, order,
                                  fll_error=jnp.asarray(fll),
                                  fll_bandwidth=fll_bandwidth)
        t_state, t_out = tlf.step(t_state, torch.as_tensor(err), 1e-3, 18.0, order,
                                  fll_error=torch.as_tensor(fll),
                                  fll_bandwidth=fll_bandwidth)
        _close(t_out, j_out, atol=1e-4)
        for a, b in zip(t_state, j_state):
            _close(a, b, atol=1e-4)
    with pytest.raises(ValueError):
        tlf.step(tlf.init(device="cpu"), 0.0, 1e-3, 1.0, order=4)


def test_cn0_ring_buffer_and_estimate():
    rng = np.random.default_rng(5)
    j_state = jax.vmap(lambda _: jcn0.init(20))(jnp.arange(6))
    t_state = tcn0.CN0State(torch.zeros(6, 20), torch.zeros(6, 20),
                            torch.zeros(6, dtype=torch.int32))
    for _ in range(27):
        re = (1000 + rng.normal(size=6) * 50).astype(np.float32)
        im = (rng.normal(size=6) * 50).astype(np.float32)
        j_state = jax.vmap(jcn0.update)(j_state, jnp.asarray(re), jnp.asarray(im))
        t_state = tcn0.update(t_state, torch.as_tensor(re), torch.as_tensor(im))
        for a, b in zip(t_state, j_state):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(tcn0.estimate(t_state, torch.tensor(1e-3)),
               jax.vmap(lambda s: jcn0.estimate(s, jnp.float32(1e-3)))(j_state),
               atol=1e-4)


def _random_state_tree(seed, k, num_taps=3, ms_elapsed=None):
    """A JAX bank state with every field randomized, as a numpy tree."""
    rng = np.random.default_rng(seed)
    base = jtracking.init_state(np.arange(k) % 32,
                                carrier_doppler=rng.uniform(-4000, 4000, k),
                                num_taps=num_taps)
    tree = jax.tree.map(np.array, base)

    def f(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return tree._replace(
        carrier_phase=rng.uniform(0, 2 * np.pi, k).astype(np.float32),
        code_doppler=f(k, scale=2.0),
        code_phase=rng.uniform(0, 1023, k).astype(np.float32),
        pll_filter=tree.pll_filter._replace(x2=f(k, scale=5.0)),
        dll_filter=tree.dll_filter._replace(x1=f(k, scale=0.5)),
        cn0=tree.cn0._replace(prompts_re=f(k, 20, scale=1000.0),
                              prompts_im=f(k, 20, scale=100.0),
                              index=rng.integers(0, 40, k).astype(np.int32)),
        ms_elapsed=(rng.integers(0, 40, k) if ms_elapsed is None
                    else np.full(k, ms_elapsed)).astype(np.int32),
        prev_prompt_re=f(k, scale=1000.0),
        prev_prompt_im=f(k, scale=300.0),
        coh_re=f(k, num_taps, scale=1000.0),
        coh_im=f(k, num_taps, scale=300.0),
    )


def test_state_numpy_round_trip_is_bit_exact():
    tree = _random_state_tree(3, 8)
    state = ttracking.state_from_numpy(tree, device="cpu")
    assert isinstance(state, ttracking.TrackState)
    assert state.prn.dtype == torch.int32 and state.cn0.index.dtype == torch.int32
    back = ttracking.state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_state_matches_jax():
    dops = np.linspace(-4000, 4000, 5)
    want = jax.tree.map(np.asarray, jtracking.init_state(
        np.arange(5), carrier_doppler=dops, code_phase=3.5, ms_elapsed=2))
    got = ttracking.state_to_numpy(ttracking.init_state(
        np.arange(5), carrier_doppler=dops, code_phase=3.5, ms_elapsed=2, device="cpu"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_config_from_jax_fields():
    jcfg = jtracking.TrackConfig.for_system(
        jmodels.GPSL1(), 32.768e6, 32768, algorithm="pallas_bank_auto",
        tile_rows=256, chans_per_step=2)
    tcfg = ttracking.config_from_jax_fields(dataclasses.asdict(jcfg))
    assert tcfg == ttracking.TrackConfig.for_system(
        tmodels.GPSL1(), 32.768e6, 32768, algorithm="pallas_bank_auto")
    assert (tcfg.spacing_chips, tcfg.prompt_index, tcfg.integration_time) == (
        jcfg.spacing_chips, jcfg.prompt_index, jcfg.integration_time)


LOOP_CASES = {
    "default": ({}, None, None),
    "atan2_order2": ({"pll_discriminator": "atan2", "pll_order": 2}, None, None),
    "coherent_secondary": (
        {"coherent_blocks": 10,
         "secondary_code": (1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, -1.0, 1.0, 1.0)},
        None, 9),
    "two_antennas_weighted": ({}, 2, None),
}


@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_loop_update_matches_jax_vmap(name):
    extra, num_ants, ms_elapsed = LOOP_CASES[name]
    k = 8
    jcfg = jtracking.TrackConfig.for_system(jmodels.GPSL1(), 8.192e6, 8192, **extra)
    tcfg = ttracking.config_from_jax_fields(dataclasses.asdict(jcfg))
    tree = _random_state_tree(7, k, ms_elapsed=ms_elapsed)
    rng = np.random.default_rng(11)
    shape = (k, 3) if num_ants is None else (k, num_ants, 3)
    are = (rng.normal(size=shape) * 2000).astype(np.float32)
    aim = (rng.normal(size=shape) * 600).astype(np.float32)
    weights = None
    if num_ants is not None:
        weights = tuple(rng.normal(size=(k, num_ants)).astype(np.float32)
                        for _ in range(2))

    jstate = jax.tree.map(jnp.asarray, tree)
    tstate = ttracking.state_from_numpy(tree, device="cpu")
    # Three consecutive blocks, feeding each side its own state back.
    for step in range(3):
        a_re, a_im = are * (1 + 0.1 * step), aim * (1 - 0.1 * step)
        if weights is None:
            jstate, jout = jax.vmap(lambda s, x, y: jtracking.loop_update(
                jcfg, s, x, y))(jstate, jnp.asarray(a_re), jnp.asarray(a_im))
            tstate, tout = ttracking.loop_update(
                tcfg, tstate, torch.as_tensor(a_re), torch.as_tensor(a_im))
        else:
            jstate, jout = jax.vmap(lambda s, x, y, wr, wi: jtracking.loop_update(
                jcfg, s, x, y, (wr, wi)))(jstate, jnp.asarray(a_re),
                                          jnp.asarray(a_im),
                                          *map(jnp.asarray, weights))
            tstate, tout = ttracking.loop_update(
                tcfg, tstate, torch.as_tensor(a_re), torch.as_tensor(a_im),
                tuple(map(torch.as_tensor, weights)))
        for field, got, want in zip(tout._fields, tout, jout):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                       atol=1e-3, err_msg=f"{name} {field} {step}")
        for got, want in zip(jax.tree.leaves(ttracking.state_to_numpy(tstate)),
                             jax.tree.leaves(jstate)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-3)


def test_bf16_z_is_not_ported():
    # TrackConfig(z_dtype="bf16") is ported: through pallas_bank_auto it runs
    # the composite route with bf16 planes (on the CPU, its plain version).
    from gpuacceleratedtracking_tpu_torch.ops import bank_comp

    system = tmodels.GPSL1()
    cfg = ttracking.TrackConfig.for_system(system, 8.192e6, 8192,
                                           algorithm="pallas_bank_auto",
                                           z_dtype="bf16")
    signal, _ = tmodels.gen_signal(system, 0, 300.0, 8192, device="cpu")
    sre, sim = (x[None] for x in tmodels.soa(signal))
    codes = torch.as_tensor(system.codes)
    states = ttracking.init_state(np.arange(2), carrier_doppler=300.0, device="cpu")
    _, out = ttracking.track_bank(cfg, codes, states, sre, sim)
    want = bank_comp.correlate_bank_comp_reference(
        sre[0], sim[0], codes, states.prn,
        cfg.intermediate_frequency + states.carrier_doppler,
        cfg.sampling_frequency, states.carrier_phase,
        cfg.code_frequency + states.code_doppler, states.code_phase,
        cfg.sample_shifts, cfg.code_length,
        nominal_code_frequency=cfg.code_frequency, z_dtype="bf16")
    torch.testing.assert_close(out.accum_re[0], want[0], rtol=0, atol=0)
    assert abs(float(out.prompt_re[0, 0]) - 8192) < 4e-3 * 8192


def _outputs_equal(a, b):
    for field, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), field


def test_overlay_table_is_built_once_and_the_trajectory_is_unchanged():
    # loop_update reads the overlay signs from a table cached per (code,
    # device). A run equals, bit for bit, one that builds the table afresh
    # every block, as loop_update did before the cache.
    # The module, not the `track` function the package exports under its name.
    ttrack = importlib.import_module("gpuacceleratedtracking_tpu_torch.tracking.track")

    system = tmodels.BeiDouB1I()
    n, blocks, dops = 2048, 6, np.array([800.0, -1400.0])
    cfg = ttracking.TrackConfig.for_system(system, n / 1e-3, n, algorithm="xla_bank")
    assert len(cfg.secondary_code) == 20
    sig, _ = tmodels.gen_signal_mixed(system, np.arange(2), dops, n * blocks,
                                      duration=blocks * 1e-3, device="cpu")
    sre, sim = (x.reshape(blocks, n) for x in tmodels.soa(sig))
    codes = torch.as_tensor(system.codes)
    states = ttracking.init_state(np.arange(2), carrier_doppler=dops + 10.0, ms_elapsed=7,
                                  device="cpu")
    ttrack._overlay_table.cache_clear()
    final, out = ttracking.track_bank(cfg, codes, states, sre, sim)
    info = ttrack._overlay_table.cache_info()
    assert (info.misses, info.hits) == (1, blocks - 1)

    corr = tregistry.get("xla_bank")
    st, ref = states, []
    for b in range(blocks):
        ttrack._overlay_table.cache_clear()
        acc = corr(sre[b], sim[b], codes, st.prn, cfg.intermediate_frequency + st.carrier_doppler,
                   cfg.sampling_frequency, st.carrier_phase, cfg.code_frequency + st.code_doppler,
                   st.code_phase, cfg.sample_shifts, cfg.code_length)
        st, o = ttracking.loop_update(cfg, st, *acc)
        ref.append(o)
    _outputs_equal(out, ttracking.TrackOutput(*(torch.stack(x) for x in zip(*ref))))
    for x, y in zip(jax.tree.leaves(ttracking.state_to_numpy(final)),
                    jax.tree.leaves(ttracking.state_to_numpy(st))):
        np.testing.assert_array_equal(x, y)


def test_track_converts_ant_weights_once_and_the_trajectory_is_unchanged():
    # `track` converts host steering weights once; the run equals, bit for
    # bit, per-block `track_step` calls that convert them every block.
    system = tmodels.GPSL1()
    n, blocks = 2048, 4
    sig, fs = tmodels.gen_signal(system, 3, 700.0, n * blocks, num_ants=2,
                                 duration=blocks * 1e-3, device="cpu")
    sre, sim = (x.reshape(2, blocks, n).transpose(0, 1).contiguous() for x in tmodels.soa(sig))
    codes = torch.as_tensor(system.codes)
    cfg = ttracking.TrackConfig.for_system(system, fs, n, algorithm="fused_xla")
    state = ttracking.init_state(3, carrier_doppler=710.0, device="cpu")
    weights = (np.array([1.0, 0.5]), np.array([0.0, -0.25]))
    _, out = ttracking.track(cfg, codes, state, sre, sim, ant_weights=weights)
    _, out_t = ttracking.track(cfg, codes, state, sre, sim,
                               ant_weights=tuple(torch.as_tensor(w, dtype=torch.float32)
                                                 for w in weights))
    st, ref = state, []
    for b in range(blocks):
        st, o = ttracking.track_step(cfg, codes, st, sre[b], sim[b], weights)
        ref.append(o)
    _outputs_equal(out, ttracking.TrackOutput(*(torch.stack(x) for x in zip(*ref))))
    _outputs_equal(out, out_t)
