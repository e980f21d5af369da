"""PyTorch port, the runtime: native IQ ingest (`runtime.iq`) and the
streaming tracker (`runtime.stream`) against the JAX package.

The cases of tests/test_runtime.py through the port, plus: `decode` and the
`Resampler` bit-equal to the JAX `runtime.iq` on the same bytes, chunking
invariance, checkpoint/resume bit for bit, and checkpoints that either package
resumes.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuacceleratedtracking_tpu import models as jmodels
from gpuacceleratedtracking_tpu import runtime as jruntime
from gpuacceleratedtracking_tpu import tracking as jtracking
from gpuacceleratedtracking_tpu_torch import models as tmodels
from gpuacceleratedtracking_tpu_torch import runtime as truntime
from gpuacceleratedtracking_tpu_torch import tracking as ttracking
from gpuacceleratedtracking_tpu_torch.ops import registry as tregistry
from gpuacceleratedtracking_tpu_torch.runtime import iq as tiq

torch.set_num_threads(1)


def _write_iq(path, re, im, fmt):
    inter = np.empty(re.size * 2, dtype=np.float32)
    inter[0::2], inter[1::2] = re, im
    if fmt == "int8":
        inter = np.clip(np.round(inter), -127, 127).astype(np.int8)
    elif fmt == "int16":
        inter = np.clip(np.round(inter), -32767, 32767).astype(np.int16)
    inter.tofile(path)
    return inter


@contextlib.contextmanager
def _jax_on_the_port_build():
    """Point the JAX `runtime.iq` at the port's build of the same source and
    flags, so this file never compiles the JAX package's ``native/build``
    library: tests/test_runtime.py does that, possibly at the same time in
    another worker, and the JAX build is not atomic. Its loader's state is
    reset too: a worker that evaluated `native_available()` while collecting
    tests/test_runtime.py, as another worker was writing that library, keeps
    ``_lib_failed`` set, and its `Resampler` would then refuse to run."""
    from gpuacceleratedtracking_tpu.runtime import iq as jiq

    assert tiq.CXX_FLAGS == ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")
    assert tiq._SRC == jiq._SRC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jiq, "_LIB", tiq._library() and tiq.library_path())
        mp.setattr(jiq, "_lib", None)
        mp.setattr(jiq, "_lib_failed", False)
        yield


@pytest.fixture(scope="module", autouse=True)
def jax_loads_the_port_build():
    with _jax_on_the_port_build():
        yield


def test_library_builds_into_the_port_build_dir():
    assert truntime.native_available()
    path = tiq.library_path()
    assert path.parent.name == "torch_kernels" and path.parent.parent.name == "build"
    assert path.exists() and path.name.startswith("libiqstream_")


@pytest.mark.parametrize("fmt", ["int8", "int16", "float32"])
def test_decode_round_trip_and_bit_equal_to_jax(fmt, tmp_path):
    rng = np.random.default_rng(0)
    re = np.round(rng.uniform(-100, 100, 1000)).astype(np.float32)
    im = np.round(rng.uniform(-100, 100, 1000)).astype(np.float32)
    raw = _write_iq(tmp_path / "x.bin", re, im, fmt).tobytes()
    out_re, out_im = truntime.decode(raw, fmt, scale=1.0)
    np.testing.assert_array_equal(out_re, re)
    np.testing.assert_array_equal(out_im, im)
    for scale in (1.0, 1.0 / 3.7):
        got, want = truntime.decode(raw, fmt, scale), jruntime.decode(raw, fmt, scale)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_decode_scale():
    raw = np.array([100, -50], dtype=np.int8).tobytes()
    re, im = truntime.decode(raw, "int8", scale=1.0 / 128)
    np.testing.assert_allclose(re, [100 / 128])
    np.testing.assert_allclose(im, [-50 / 128])


def test_numpy_fallback_decodes_and_reads_the_same(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    raw = rng.integers(-127, 128, 4000).astype(np.int8)
    path = tmp_path / "cap.bin"
    raw.tofile(path)
    native = truntime.decode(raw.tobytes(), "int8", 0.25)
    with truntime.IQFile(path, "int8", 0.25) as f:
        native_blocks = [f.read(700) for _ in range(3)]
    monkeypatch.setattr(tiq, "_library", lambda: None)
    assert not truntime.native_available()
    for g, w in zip(truntime.decode(raw.tobytes(), "int8", 0.25), native):
        np.testing.assert_array_equal(g, w)
    with truntime.IQFile(path, "int8", 0.25) as f:
        assert f.num_samples == 2000
        for want in native_blocks:
            for g, w in zip(f.read(700), want):
                np.testing.assert_array_equal(g, w)
    with pytest.raises(RuntimeError, match="unavailable"):
        truntime.IQRing(16)


def test_iqfile_block_reads_and_eof(tmp_path):
    re = np.arange(2500, dtype=np.float32) % 97 - 48
    im = -re
    path = tmp_path / "cap.bin"
    _write_iq(path, re, im, "int16")
    with truntime.IQFile(path, "int16") as f:
        assert f.num_samples == 2500
        r1, i1 = f.read(1000)
        r2, i2 = f.read(1000)
        r3, i3 = f.read(1000)   # short read: only 500 left
    np.testing.assert_array_equal(np.concatenate([r1, r2, r3]), re)
    np.testing.assert_array_equal(np.concatenate([i1, i2, i3]), im)
    assert r3.size == 500


def test_iqfile_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        truntime.IQFile(tmp_path / "nope.bin", "int8")


def test_iqring_spsc_blocks():
    ring = truntime.IQRing(4096)
    assert len(ring) == 0
    assert ring.pop_block(100) is None
    re = np.arange(3000, dtype=np.float32)
    im = re + 0.5
    assert ring.push(re[:2000], im[:2000]) == 2000
    out = ring.pop_block(1500)
    np.testing.assert_array_equal(out[0], re[:1500])
    np.testing.assert_array_equal(out[1], im[:1500])
    assert ring.push(re[2000:], im[2000:]) == 1000
    out = ring.pop_block(1500)
    np.testing.assert_array_equal(out[0], re[1500:3000])
    assert len(ring) == 0
    ring.close()


def test_iqring_capacity_limit():
    ring = truntime.IQRing(100)
    re = np.ones(150, np.float32)
    assert ring.push(re, re) == 100
    ring.close()


# --- Resampler (tests/test_runtime.py:132-226) ----------------------------


def test_resampler_tone_frequency_and_amplitude():
    fs_in, fs_out, f_tone = 10.0e6, 8.192e6, 1.25e5
    x = np.exp(2j * np.pi * f_tone * np.arange(50000) / fs_in)
    rs = truntime.Resampler.for_rates(fs_in, fs_out)
    assert (rs.up, rs.down) == (512, 625)
    yr, yi = rs.process(np.real(x), np.imag(x))
    y = (yr + 1j * yi)[2000:-2000]
    phase = np.unwrap(np.angle(y))
    f_est = np.polyfit(np.arange(y.size), phase, 1)[0] / (2 * np.pi) * fs_out
    assert abs(f_est - f_tone) < 1.0
    np.testing.assert_allclose(np.abs(y).mean(), 1.0, atol=1e-3)
    with pytest.raises(ValueError, match="rational"):
        truntime.Resampler.for_rates(10.0e6, 8.192e6 * (1 + 1e-9) + 0.1, max_den=64)


def test_resampler_chunking_invariance_and_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    x_re = rng.standard_normal(30000).astype(np.float32)
    x_im = rng.standard_normal(30000).astype(np.float32)
    a_re, a_im = truntime.Resampler(512, 625).process(x_re, x_im)
    j_re, j_im = jruntime.Resampler(512, 625).process(x_re, x_im)
    np.testing.assert_array_equal(a_re, j_re)
    np.testing.assert_array_equal(a_im, j_im)
    chunked = truntime.Resampler(512, 625)
    parts = [chunked.process(x_re[c:c + 997], x_im[c:c + 997]) for c in range(0, 30000, 997)]
    b_re = np.concatenate([p[0] for p in parts])
    b_im = np.concatenate([p[1] for p in parts])
    np.testing.assert_array_equal(a_re[: b_re.size], b_re)
    np.testing.assert_array_equal(a_im[: b_im.size], b_im)


def test_jax_resampler_runs_after_its_own_build_failed_at_collection():
    # What a worker is left with when the JAX build failed while tests were
    # collected: the loader marked failed for good, no library loaded.
    from gpuacceleratedtracking_tpu.runtime import iq as jiq

    rng = np.random.default_rng(1)
    x_re = rng.standard_normal(5000).astype(np.float32)
    x_im = rng.standard_normal(5000).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jiq, "_lib", None)
        mp.setattr(jiq, "_lib_failed", True)
        with pytest.raises(RuntimeError, match="unavailable"):
            jruntime.Resampler(512, 625)
        with _jax_on_the_port_build():
            j_re, j_im = jruntime.Resampler(512, 625).process(x_re, x_im)
    a_re, a_im = truntime.Resampler(512, 625).process(x_re, x_im)
    np.testing.assert_array_equal(a_re, j_re)
    np.testing.assert_array_equal(a_im, j_im)


def test_resampler_alias_rejection():
    fs_in, fs_out, f_alias = 25.0e6, 8.192e6, 7.0e6
    x = np.exp(2j * np.pi * f_alias * np.arange(40000) / fs_in)
    rs = truntime.Resampler.for_rates(fs_in, fs_out)
    yr, yi = rs.process(np.real(x), np.imag(x))
    assert np.abs((yr + 1j * yi)[1000:-1000]).max() < 0.01


def test_resampled_gnss_capture_correlates():
    # A GPS L1 block at a 10 MHz front-end rate, resampled to 8.192 MHz,
    # correlates within 4 % of N through the port's fused_xla.
    system = tmodels.GPSL1()
    fs_in, fs_out, n_in, n_out = 10.0e6, 8.192e6, 20000, 8192
    sig, _ = tmodels.gen_signal(system, 0, 0.0, n_in, duration=n_in / fs_in, device="cpu")
    sre_in, sim_in = tmodels.soa(sig)
    yr, yi = truntime.Resampler.for_rates(fs_in, fs_out).process(sre_in.numpy(), sim_in.numpy())
    s0 = 256
    delay_s = (24 * 512 - 1) / 2 / 512 / fs_in
    phi = ((s0 / fs_out - delay_s) * system.code_frequency) % 1023
    shifts = tuple(int(s) for s in tmodels.correlator_sample_shifts(
        system, tmodels.EPLCorrelator(3), fs_out))
    corr = functools.partial(tregistry.get("fused_xla"), sample_shifts=shifts,
                             code_length=system.code_length)
    are, _ = corr(torch.as_tensor(yr[s0:s0 + n_out]), torch.as_tensor(yi[s0:s0 + n_out]),
                  torch.as_tensor(system.codes), 0, 0.0, fs_out, 0.0, system.code_frequency, phi)
    assert abs(float(are[1]) - n_out) < 0.04 * n_out


# --- streaming tracker ----------------------------------------------------

N_STREAM, MS_STREAM = 2048, 60
STREAM_DOPS = [700.0, -900.0]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """tests/test_runtime.py's two-satellite int8 capture at 2.048 MHz."""
    system = jmodels.GPSL1()
    total = 0
    for prn, d in enumerate(STREAM_DOPS):
        s, _ = jmodels.gen_signal(system, prn, d, N_STREAM * MS_STREAM,
                                  duration=MS_STREAM * 1e-3,
                                  code_frequency=system.code_frequency
                                  * (1.0 + d / system.center_frequency))
        total = total + np.asarray(s)
    path = tmp_path_factory.mktemp("capture") / "twosat.bin"
    _write_iq(path, total.real * 40, total.imag * 40, "int8")
    return path


def _config(**kw):
    return ttracking.TrackConfig.for_system(tmodels.GPSL1(), N_STREAM / 1e-3, N_STREAM, **kw)


def _states():
    return ttracking.init_state(np.array([0, 1]), carrier_doppler=np.asarray(STREAM_DOPS),
                                device="cpu")


def _equal_outputs(a, b):
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _equal_states(a, b):
    for u, v in zip(*(jax.tree.leaves(ttracking.state_to_numpy(s)) for s in (a, b))):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.fixture(scope="module")
def jax_stream(capture):
    jcfg = jtracking.TrackConfig.for_system(jmodels.GPSL1(), N_STREAM / 1e-3, N_STREAM)
    states = jtracking.init_state(np.array([0, 1]), carrier_doppler=np.asarray(STREAM_DOPS))
    res = jruntime.track_file(jcfg, jmodels.GPSL1().codes, states, capture, fmt="int8",
                              scale=1.0 / 40, blocks_per_dispatch=16)
    return res.stacked()


def test_track_file_closed_loop_matches_jax(capture, jax_stream):
    result = truntime.track_file(_config(), tmodels.GPSL1().codes, _states(), capture,
                                 fmt="int8", scale=1.0 / 40, blocks_per_dispatch=16)
    assert result.blocks_processed == MS_STREAM
    assert result.dispatch_block_s == [] and result.steady_block_s is None
    out = result.stacked()
    assert isinstance(out, ttracking.TrackOutput)
    assert out.prompt_re.shape == (MS_STREAM, 2) and isinstance(out.prompt_re, np.ndarray)
    assert (out.prompt_re[-1] > 1200).all(), out.prompt_re[-1]
    np.testing.assert_allclose(out.carrier_doppler[-1], STREAM_DOPS, atol=20.0)
    # Against the JAX track_file on the same bytes (tests/test_tracking.py's
    # closed-loop tolerances).
    np.testing.assert_allclose(out.prompt_re, np.asarray(jax_stream.prompt_re),
                               rtol=5e-3, atol=10.0)
    np.testing.assert_allclose(out.carrier_doppler, np.asarray(jax_stream.carrier_doppler),
                               rtol=1e-3, atol=1.0)


def test_chunking_is_bit_invariant(capture):
    runs = [truntime.track_file(_config(), tmodels.GPSL1().codes, _states(), capture,
                                fmt="int8", scale=1.0 / 40, blocks_per_dispatch=bpd)
            for bpd in (16, 60)]
    assert [len(r.outputs) for r in runs] == [4, 1]
    _equal_outputs(runs[0].stacked(), runs[1].stacked())
    _equal_states(runs[0].final_state, runs[1].final_state)


def test_measure_dispatch_times_each_chunk(capture):
    tracker = truntime.StreamTracker(_config(), tmodels.GPSL1().codes, _states(),
                                     blocks_per_dispatch=16, measure_dispatch=True)
    with truntime.IQFile(capture, "int8", 1.0 / 40) as f:
        result = tracker.run(truntime.blocks(f, N_STREAM), max_blocks=40)
    assert result.blocks_processed == 48    # whole chunks: stops after the third
    assert len(result.dispatch_block_s) == 3
    assert result.steady_block_s == pytest.approx(np.median(result.dispatch_block_s[1:]))


def test_resumed_run_equals_an_uninterrupted_one(capture, tmp_path):
    whole = truntime.track_file(_config(), tmodels.GPSL1().codes, _states(), capture,
                                fmt="int8", scale=1.0 / 40, blocks_per_dispatch=10)
    ckpt = tmp_path / "ckpt.npz"
    first = truntime.StreamTracker(_config(), tmodels.GPSL1().codes, _states(),
                                   blocks_per_dispatch=10, checkpoint_path=ckpt,
                                   checkpoint_every=20)
    with truntime.IQFile(capture, "int8", 1.0 / 40) as f:
        head = first.run(truntime.blocks(f, N_STREAM), max_blocks=25)
    assert head.blocks_processed == 30
    # The periodic checkpoint was written at block 20; resume from it cold.
    second = truntime.StreamTracker(_config(), tmodels.GPSL1().codes,
                                    ttracking.init_state(np.array([0, 1]), device="cpu"),
                                    blocks_per_dispatch=10, checkpoint_path=ckpt)
    done = second.load_checkpoint()
    assert done == 20
    with truntime.IQFile(capture, "int8", 1.0 / 40) as f:
        f.read(done * N_STREAM)
        tail = second.run(truntime.blocks(f, N_STREAM))
    assert tail.blocks_processed == MS_STREAM - 20
    _equal_outputs(tail.stacked(), jax.tree.map(lambda x: x[20:], whole.stacked()))
    _equal_states(tail.final_state, whole.final_state)


def _checkpoint_state(seed):
    """A JAX bank state with every field randomized (distinct leaves)."""
    rng = np.random.default_rng(seed)
    k = 3
    base = jax.tree.map(np.array, jtracking.init_state(np.arange(k), num_taps=3))
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return base._replace(
        carrier_doppler=f(k), carrier_phase=f(k), code_doppler=f(k), code_phase=f(k),
        pll_filter=base.pll_filter._replace(x1=f(k), x2=f(k)),
        dll_filter=base.dll_filter._replace(x1=f(k), x2=f(k)),
        cn0=base.cn0._replace(prompts_re=f(k, 20), prompts_im=f(k, 20),
                              index=rng.integers(0, 40, k).astype(np.int32)),
        ms_elapsed=rng.integers(0, 40, k).astype(np.int32),
        prev_prompt_re=f(k), prev_prompt_im=f(k), coh_re=f(k, 3), coh_im=f(k, 3))


def test_checkpoints_resume_across_packages(tmp_path):
    tree = _checkpoint_state(5)
    jcfg = jtracking.TrackConfig.for_system(jmodels.GPSL1(), 2.048e6, 2048)
    tcfg = ttracking.config_from_jax_fields(dataclasses.asdict(jcfg))
    codes = jmodels.GPSL1().codes
    # JAX writes, the port resumes.
    jpath = tmp_path / "jax.npz"
    jruntime.StreamTracker(jcfg, codes, jax.tree.map(jnp.asarray, tree),
                           checkpoint_path=jpath).save_checkpoint(123)
    port = truntime.StreamTracker(tcfg, codes, ttracking.init_state(np.arange(3), device="cpu"),
                                  checkpoint_path=jpath)
    assert port.load_checkpoint() == 123
    for got, want in zip(jax.tree.leaves(ttracking.state_to_numpy(port.states)),
                         jax.tree.leaves(tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # The port writes, JAX resumes.
    tpath = tmp_path / "port.npz"
    port.checkpoint_path = tpath
    port.save_checkpoint(77)
    back = jruntime.StreamTracker(jcfg, codes, jtracking.init_state(np.arange(3)),
                                  checkpoint_path=tpath)
    assert back.load_checkpoint() == 77
    for got, want in zip(jax.tree.leaves(back.states), jax.tree.leaves(tree)):
        assert np.asarray(got).dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.fixture
def captured_graphs(monkeypatch):
    """`tracking.graphs.scan` takes its captured path on CPU tensors, its
    capture a plain call of the body and each replay another, with the
    launch counts held (tests/test_torch_graph.py's `captured`)."""
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    def plain_capture(body, device):
        body()

        def replay():
            counts = graphs._counts()
            body()
            graphs._set_counts(counts)

        return replay

    monkeypatch.setattr(graphs, "enabled", lambda device: not graphs._EAGER)
    monkeypatch.setattr(graphs, "capture", plain_capture)
    graphs.clear()
    yield graphs._ENTRIES
    graphs.clear()


def test_stream_on_the_captured_path_equals_the_eager_run(capture, tmp_path, captured_graphs):
    # Three dispatches of 20 blocks through a bank kernel route (its code
    # tiles derived in the captured prologue), each passing the last one's
    # state back: outputs, final state and checkpoint bit for bit the eager
    # run's; a resume from the captured run's checkpoint gives its tail.
    from gpuacceleratedtracking_tpu_torch.tracking import graphs

    config = _config(algorithm="pallas_bank_auto")

    def run(ckpt, states=None, skip=0):
        tracker = truntime.StreamTracker(config, tmodels.GPSL1().codes,
                                         _states() if states is None else states,
                                         blocks_per_dispatch=20, checkpoint_path=ckpt,
                                         checkpoint_every=40)
        if skip:
            skip = tracker.load_checkpoint()
        with truntime.IQFile(capture, "int8", 1.0 / 40) as f:
            f.read(skip * N_STREAM)
            return tracker.run(truntime.blocks(f, N_STREAM)), skip

    with graphs.eager():
        want, _ = run(tmp_path / "eager.npz")
    assert not captured_graphs
    got, _ = run(tmp_path / "graph.npz")
    assert len(got.outputs) == 3 and len(captured_graphs[torch.device("cpu")]) == 1
    _equal_outputs(got.stacked(), want.stacked())
    _equal_states(got.final_state, want.final_state)
    with np.load(tmp_path / "eager.npz") as e, np.load(tmp_path / "graph.npz") as g:
        assert sorted(e.files) == sorted(g.files)
        for name in e.files:
            assert e[name].dtype == g[name].dtype
            np.testing.assert_array_equal(e[name], g[name])
    tail, done = run(tmp_path / "graph.npz", ttracking.init_state(np.array([0, 1]), device="cpu"),
                     skip=1)
    assert done == 40 and tail.blocks_processed == MS_STREAM - 40
    _equal_outputs(tail.stacked(), jax.tree.map(lambda x: x[40:], want.stacked()))
    _equal_states(tail.final_state, want.final_state)
