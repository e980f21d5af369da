"""The loop-closure kernel (csrc/loop_update.cu) and its dispatch.

`tracking.loop_update` launches the kernel once per call on CUDA tensors and
runs its plain version, `loop_update_plain`, on CPU tensors;
`tracking.dual.dual_update` does the same with the kernel's dual mode and
`dual_update_plain`. Here on the CPU: the dispatch (the plain versions run,
the kernel's counters stand still), the import without a CUDA compiler, the
f32 constants the wrapper passes (each equal to the one the plain
expression hands torch), the sink (a scan's stacked outputs and index: the
results written there and over the carry equal those returned without
one, bit for bit) and the refusals. The tests marked ``cuda`` hold the
kernel against the plain version on the card, bit for bit, fresh, under a
sink and in dual mode, over the grid of tests/test_torch_tracking.py's
``LOOP_CASES`` (the plain version against JAX) and ``DUAL_CASES``:
``python -m pytest --noconftest -m cuda tests/test_torch_loop_kernel.py``.
The file imports neither jax nor the JAX package.
"""

import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from gpuacceleratedtracking_tpu_torch.models import GPSL1, GPSL5, gpsl5
from gpuacceleratedtracking_tpu_torch.ops import loop_kernel
from gpuacceleratedtracking_tpu_torch.tracking import (
    TrackConfig, TrackOutput, dual_config, graphs, init_state, loop_update)
from gpuacceleratedtracking_tpu_torch.tracking.dual import dual_update, dual_update_plain
from gpuacceleratedtracking_tpu_torch.tracking.track import loop_update_plain

torch.set_num_threads(1)

# name -> (TrackConfig overrides, antennas (None: no antenna axis), steering
# weights (None, "channel" [K, A] or "shared" [A]), taps, ms_elapsed (None:
# random)); each case also runs on a scalar single-channel state.
LOOP_CASES = {
    "default": ({}, None, None, 3, None),
    "atan2_order2": ({"pll_discriminator": "atan2", "pll_order": 2}, None, None, 3, None),
    "coherent_secondary": (
        {"coherent_blocks": 10,
         "secondary_code": (1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, -1.0, 1.0, 1.0)},
        None, None, 3, 9),
    "coherent4_random_ms": ({"coherent_blocks": 4}, None, None, 3, None),
    "two_antennas_weighted": ({}, 2, "channel", 3, None),
    "dll_order1": ({"dll_order": 1}, None, None, 3, None),
    "dll_order3": ({"dll_order": 3}, None, None, 3, None),
    "pll_order1": ({"pll_order": 1}, None, None, 3, None),
    "order2_fll": ({"pll_order": 2}, None, None, 3, None),
    "fll_off": ({"fll_bandwidth": 0.0}, None, None, 3, None),
    "four_antennas": ({}, 4, None, 3, None),
    "shared_weights": ({}, 3, "shared", 3, None),
    "seven_taps": ({}, None, None, 7, None),
}
# The one leaf whose bits hang on torch's reduction order (the C/N0 window
# means; it feeds no state): the kernel keeps the order of torch's CUDA
# reduction kernel, and another order moves noise-like windows, where
# 2 M2^2 - M4 nearly cancels, by up to ~0.01 dB.
CN0_ATOL_DB = 0.05


def _inputs(name, k, device, seed=5):
    """A case's config (GPS L1, 1 ms blocks), a random state of ``k``
    channels (None: scalar), three blocks of accumulators and the weights."""
    extra, ants, weights, taps, ms_elapsed = LOOP_CASES[name]
    config = TrackConfig.for_system(GPSL1(), 8.192e6, 8192, num_correlators=taps, **extra)
    rng = np.random.default_rng(seed)
    batch = () if k is None else (k,)
    n = 1 if k is None else k

    def f(*shape, scale=1.0):
        x = np.asarray(rng.normal(size=batch + shape) * scale, dtype=np.float32)
        return torch.from_numpy(x).to(device)

    def ints(low, high):
        return torch.from_numpy(rng.integers(low, high, n).astype(np.int32).reshape(batch)).to(
            device)

    dop = rng.uniform(-4000, 4000, n)
    state = init_state(np.arange(n) % 32 if k else 3,
                       carrier_doppler=dop if k else float(dop[0]), num_taps=taps,
                       device=device)
    state = state._replace(
        carrier_phase=torch.from_numpy(
            rng.uniform(0, 2 * np.pi, n).astype(np.float32).reshape(batch)).to(device),
        code_doppler=f(scale=2.0),
        code_phase=torch.from_numpy(
            rng.uniform(0, 1023, n).astype(np.float32).reshape(batch)).to(device),
        pll_filter=state.pll_filter._replace(x2=f(scale=5.0)),
        dll_filter=state.dll_filter._replace(x1=f(scale=0.5)),
        cn0=state.cn0._replace(prompts_re=f(20, scale=1000.0), prompts_im=f(20, scale=100.0),
                               index=ints(0, 40)),
        ms_elapsed=(ints(0, 40) if ms_elapsed is None
                    else torch.full(batch, ms_elapsed, dtype=torch.int32, device=device)),
        prev_prompt_re=f(scale=1000.0), prev_prompt_im=f(scale=300.0),
        coh_re=f(taps, scale=1000.0), coh_im=f(taps, scale=300.0))
    acc = (taps,) if ants is None else (ants, taps)
    are, aim = f(*acc, scale=2000.0), f(*acc, scale=600.0)
    blocks = [(are * (1 + 0.1 * b), aim * (1 - 0.1 * b)) for b in range(3)]
    w = None
    if weights == "channel":
        w = (f(ants), f(ants))
    elif weights == "shared":
        w = tuple(torch.from_numpy(rng.normal(size=ants).astype(np.float32)).to(device)
                  for _ in range(2))
    return config, state, blocks, w


def _fields(state, out) -> dict:
    fields = {}
    for name, x in state._asdict().items():
        if isinstance(x, tuple):
            fields.update({f"{name}.{sub}": y for sub, y in x._asdict().items()})
        else:
            fields[name] = x
    fields.update(out._asdict())
    return fields


# --- On the CPU.

@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_cpu_tensors_run_the_plain_version(name):
    config, state, blocks, w = _inputs(name, 8, "cpu")
    before = loop_kernel.loop_update_kernel.launches
    got_state = want_state = state
    for are, aim in blocks:
        got_state, got = loop_update(config, got_state, are, aim, w)
        want_state, want = loop_update_plain(config, want_state, are, aim, w)
        for field, x in _fields(got_state, got).items():
            assert torch.equal(x, _fields(want_state, want)[field]), field
    assert loop_kernel.loop_update_kernel.launches == before


def test_imports_and_runs_on_the_cpu_without_a_cuda_compiler(tmp_path):
    # No nvcc on PATH or under CUDA_HOME: importing the package builds
    # nothing, and the CPU path never asks for the kernel's library.
    code = textwrap.dedent("""
        import torch
        from gpuacceleratedtracking_tpu_torch.ops import _build, loop_kernel
        from gpuacceleratedtracking_tpu_torch.tracking import TrackConfig, init_state, loop_update
        from gpuacceleratedtracking_tpu_torch.models import GPSL1
        assert _build.load_library.cache_info().currsize == 0
        config = TrackConfig.for_system(GPSL1(), 8.192e6, 8192)
        state = init_state([0, 1], device="cpu")
        acc = torch.ones(2, 3)
        state, out = loop_update(config, state, acc, acc)
        assert loop_kernel.loop_update_kernel.launches == 0
        assert _build.load_library.cache_info().currsize == 0
        print("ok")
    """)
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + ":/usr/bin:/bin",
               CUDA_HOME=str(tmp_path / "no_cuda"), CUDA_PATH=str(tmp_path / "no_cuda"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


class _Scalars(TorchFunctionMode):
    """Records every Python float a torch function or tensor operator is
    handed, with the function's name."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        self.seen += [(name, a) for a in (*args, *kwargs.values()) if isinstance(a, float)]
        return func(*args, **kwargs)


def _f32(x):
    return float(np.float32(x))


CONSTANT_CONFIGS = {
    "gps_l1_default": dict(),
    "orders_1_1": dict(pll_order=1, dll_order=1),
    "orders_2_3_fll": dict(pll_order=2, dll_order=3),
    "order3_fll_off": dict(fll_bandwidth=0.0),
    "atan2_coherent": dict(pll_discriminator="atan2", coherent_blocks=5, pll_bandwidth=7.5),
    "gps_l5_at_if": dict(system="GPSL5", intermediate_frequency=1.25e6, dll_bandwidth=0.4),
}
# The kernel's constants by how the plain version hands them to torch.
_MULTIPLIED = ("two_minus_d", "t_coh", "aid_scale", "two_pi", "t", "ten",
               *(f"{f}_{g}" for f in ("pll", "dll") for g in loop_kernel._FILTER))
_DIVIDED = ("inv_two_pi", "inv_two", "inv_fll", "inv_center")
_ADDED = ("intermediate_frequency", "code_frequency")


@pytest.mark.parametrize("name", sorted(CONSTANT_CONFIGS))
def test_kernel_constants_equal_the_plain_expressions(name):
    # Every f32 constant the wrapper passes is a scalar the plain version
    # hands torch, rounded to f32 as torch rounds it (a division by a Python
    # scalar on the card multiplies by its reciprocal, taken in double and
    # rounded to f32); every scalar the plain version multiplies, divides or
    # adds by is one of them.
    extra = dict(CONSTANT_CONFIGS[name])
    system = GPSL5() if extra.pop("system", None) == "GPSL5" else GPSL1()
    config = TrackConfig.for_system(system, 32.768e6, 32768, **extra)
    state = init_state(np.arange(4), carrier_doppler=[100.0, -200.0, 300.0, 0.0],
                       ms_elapsed=7, device="cpu")
    acc = torch.arange(1.0, 13.0).reshape(4, 3) * 100.0
    with _Scalars() as mode:
        loop_update_plain(config, state, acc, -acc)
    consts = loop_kernel.loop_constants(config, 20)
    assert set(consts) == set(loop_kernel._CONSTANTS)
    mults = {_f32(a) for f, a in mode.seen if f in ("mul", "__mul__", "__rmul__")}
    divs = {float(np.float32(1.0 / a)) for f, a in mode.seen if f in ("div", "__truediv__")}
    adds = {_f32(a) for f, a in mode.seen if f in ("add", "__add__", "__radd__")}
    clamps = {_f32(a) for f, a in mode.seen if f in ("clamp", "where", "lt", "__lt__")}
    order = {"pll": config.pll_order, "dll": config.dll_order}
    used = {1: ("g_out",), 2: ("g_out", "g_x1"), 3: ("g_out", "g_x1", "g_x2")}
    fll = config.fll_bandwidth > 0 and config.pll_order > 1
    for key in _MULTIPLIED:
        loop, _, factor = key.partition("_")
        if loop in order and factor in loop_kernel._FILTER:
            if factor.startswith("f_"):
                if not (loop == "pll" and fll) or (factor == "f_x2" and order[loop] < 3):
                    continue
            elif factor not in used[order[loop]]:
                continue
        assert consts[key] in mults, key
    for key in _DIVIDED:
        assert consts[key] in divs, key
    for key in _ADDED:
        assert consts[key] in adds, key
    assert {consts["eps"], consts["cn0_floor"]} <= clamps
    assert consts["code_length"] == _f32(config.code_length)
    assert consts["mean"] == float(np.float32(1.0) / np.float32(20.0))
    assert mults <= {consts[key] for key in _MULTIPLIED} | {0.5, 2.0}
    assert divs <= {consts[key] for key in _DIVIDED}
    assert adds <= {consts[key] for key in _ADDED}


@pytest.mark.parametrize("field, value", [("pll_order", 4), ("dll_order", 0)])
def test_a_filter_order_outside_1_to_3_raises(field, value):
    config = TrackConfig.for_system(GPSL1(), 8.192e6, 8192, **{field: value})
    with pytest.raises(ValueError, match="order must be 1, 2 or 3"):
        loop_kernel.loop_constants(config, 20)
    state = init_state(np.arange(2), device="cpu")
    with pytest.raises(ValueError, match="order must be 1, 2 or 3"):
        loop_update(config, state, torch.ones(2, 3), torch.ones(2, 3))


def test_the_kernel_takes_cuda_tensors_only():
    config = TrackConfig.for_system(GPSL1(), 8.192e6, 8192)
    state = init_state(np.arange(2), device="cpu")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        loop_kernel.loop_update_kernel(config, state, torch.ones(2, 3), torch.ones(2, 3))
    meta = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA tensors"):
        loop_update(config, state, meta, meta)


@pytest.mark.parametrize("weights, match", [
    (np.ones(3, np.float32), "f32 tensors on the"),
    (torch.ones(3, dtype=torch.float64), "f32 tensors on the"),
    (torch.ones(5), "do not broadcast"),
])
def test_steering_weights_the_kernel_does_not_take_raise(weights, match):
    # Weights come as f32 tensors on the accumulators' device (a host copy
    # per block would make the loop wait on the card), shaped [A] or [..., A].
    with pytest.raises(ValueError, match=match):
        loop_kernel._weight_rows(weights, (8,), 3, torch.device("cpu"))


def test_weight_rows_keep_shared_and_per_channel_layouts():
    shared, stride = loop_kernel._weight_rows(torch.arange(3.0), (8,), 3, torch.device("cpu"))
    assert stride == 0 and shared.shape == (8, 3)
    per, stride = loop_kernel._weight_rows(torch.ones(8, 3), (8,), 3, torch.device("cpu"))
    assert stride == 3
    expanded = torch.arange(3.0).expand(8, 3)
    same, stride = loop_kernel._weight_rows(expanded, (8,), 3, torch.device("cpu"))
    assert stride == 0 and same.data_ptr() == expanded.data_ptr()


# --- The sink: outputs into rows of a scan's stacks, the state in place.

def _clone(tree):
    """A copy of a state, leaf by leaf, in its NamedTuple structure."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(x) for x in tree))


def _sink(out, device, chunk=4):
    """A sink for ``out``'s leaves: ``[chunk, ...]`` buffers of a sentinel
    value and a row index on ``device``."""
    outs = tuple(torch.full((chunk,) + tuple(x.shape), -12345.0, dtype=x.dtype, device=device)
                 for x in graphs._leaves(out))
    return graphs.Sink(outs, torch.zeros((), dtype=torch.int64, device=device))


def _run_with_sink(update, state, blocks, sink, *args):
    """``update`` over ``blocks`` block b into row b + 1 of ``sink``, its
    state written in place; the state it returns must be the one it took,
    and every output leaf `graphs.WRITTEN`."""
    carry = _clone(state)
    for b, (are, aim) in enumerate(blocks):
        sink.index.fill_(b + 1)
        new, out = update(carry, are, aim, *args, sink)
        assert new is carry
        assert all(x is graphs.WRITTEN for x in graphs._leaves(out))
    return carry


# The dual grid: K dual channels, antennas (None: no antenna axis), seed.
DUAL_CASES = {f"k{k}_{'a' + str(a) if a else 'single'}": (k, a)
              for k in (8, 64) for a in (None, 2, 3, 4)}


def _dual_inputs(k, ants, device, seed=11):
    """The GPS L5 dual closure's config, a random [K] state (``ms_elapsed``
    across both overlay periods), three blocks of 2K-channel accumulators
    and the two overlay tables."""
    config = dual_config(TrackConfig.for_system(GPSL5(), 16.384e6, 16384, use_secondary=False))
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    state = init_state(np.arange(k) % 32, carrier_doppler=rng.uniform(-4000, 4000, k),
                       ms_elapsed=rng.integers(0, 40, k), device=device)
    state = state._replace(
        code_doppler=f(k, scale=2.0), prev_prompt_re=f(k, scale=1000.0),
        prev_prompt_im=f(k, scale=300.0),
        cn0=state.cn0._replace(prompts_re=f(k, 20, scale=1000.0),
                               prompts_im=f(k, 20, scale=100.0)))
    shape = (2 * k, 3) if ants is None else (2 * k, ants, 3)
    blocks = [(f(*shape, scale=2000.0), f(*shape, scale=600.0)) for _ in range(3)]
    tables = tuple(torch.tensor(gpsl5.neuman_hofman(pilot), dtype=torch.float32, device=device)
                   for pilot in (False, True))
    return config, state, blocks, tables


def _dual_fields(state, out) -> dict:
    return dict(_fields(state, out.pilot), data_prompt_re=out.data_prompt_re,
                data_prompt_im=out.data_prompt_im)


@pytest.mark.parametrize("name", sorted(DUAL_CASES))
def test_dual_update_on_cpu_tensors_is_the_plain_version(name):
    config, state, blocks, tables = _dual_inputs(*DUAL_CASES[name], "cpu")
    got_state = want_state = state
    for are, aim in blocks:
        got_state, got = dual_update(config, got_state, are, aim, *tables)
        want_state, want = dual_update_plain(config, want_state, are, aim, *tables)
        for field, x in _dual_fields(got_state, got).items():
            assert torch.equal(x, _dual_fields(want_state, want)[field]), field
        assert got.data_prompt_re.shape == (DUAL_CASES[name][0],)
    assert loop_kernel.dual_update_kernel.launches == 0


@pytest.mark.parametrize("k", [8, None], ids=["k8", "scalar"])
@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_a_sink_takes_what_the_plain_version_returns(name, k):
    # On CPU tensors `loop_update` with a sink runs the plain version and
    # writes its results: block b's outputs in row b + 1, the last state
    # over the carry, bit for bit what the calls without a sink return; the
    # other rows untouched, and the kernel's counter still.
    config, state, blocks, w = _inputs(name, k, "cpu")
    want_state, outs = state, []
    for are, aim in blocks:
        want_state, out = loop_update_plain(config, want_state, are, aim, w)
        outs.append(out)
    sink = _sink(outs[0], "cpu")
    before = loop_kernel.loop_update_kernel.launches
    carry = _run_with_sink(lambda st, are, aim, w, sk: loop_update(config, st, are, aim, w, sk),
                           state, blocks, sink, w)
    assert loop_kernel.loop_update_kernel.launches == before
    for field, x in _fields(carry, outs[-1]).items():
        assert torch.equal(x, _fields(want_state, outs[-1])[field]), field
    for buf, *leaves in zip(sink.outs, *(graphs._leaves(o) for o in outs)):
        assert (buf[0] == -12345.0).all()
        for b, x in enumerate(leaves):
            assert torch.equal(buf[b + 1], x)


def _sink_case():
    config = TrackConfig.for_system(GPSL1(), 8.192e6, 8192)
    state = init_state(np.arange(4), carrier_doppler=[100.0, -200.0, 300.0, 0.0], device="cpu")
    acc = torch.arange(1.0, 13.0).reshape(4, 3) * 100.0
    _, out = loop_update_plain(config, state, acc, -acc)
    return config, state, acc, out


def _swap(sink, i, buf):
    outs = list(sink.outs)
    outs[i] = buf
    return graphs.Sink(tuple(outs), sink.index)


@pytest.mark.parametrize("fault, match", [
    ("shape", "sink buffer 2 is"),
    ("dtype", "sink buffer 2 is"),
    ("device", "sink buffer 2 is"),
    ("strided", "sink buffer 2 is"),
    ("count", "holds 10 buffers for 11"),
    ("host_index", "int64 0-d tensor"),
    ("int32_index", "int64 0-d tensor"),
    ("index_shape", "int64 0-d tensor"),
    ("index_device", "int64 0-d tensor"),
])
def test_a_sink_the_body_cannot_take_raises(fault, match):
    config, state, acc, out = _sink_case()
    sink = _sink(out, "cpu")
    bad = {
        "shape": lambda: _swap(sink, 2, torch.zeros(4, 5)),
        "dtype": lambda: _swap(sink, 2, torch.zeros(4, 4, dtype=torch.float64)),
        "device": lambda: _swap(sink, 2, torch.zeros(4, 4, device="meta")),
        "strided": lambda: _swap(sink, 2, torch.zeros(4, 8)[:, ::2]),
        "count": lambda: graphs.Sink(sink.outs[:10], sink.index),
        "host_index": lambda: graphs.Sink(sink.outs, 0),
        "int32_index": lambda: graphs.Sink(sink.outs, torch.zeros((), dtype=torch.int32)),
        "index_shape": lambda: graphs.Sink(sink.outs, torch.zeros(1, dtype=torch.int64)),
        "index_device": lambda: graphs.Sink(sink.outs, torch.zeros((), dtype=torch.int64,
                                                                    device="meta")),
    }[fault]()
    carry = _clone(state)
    with pytest.raises((ValueError, TypeError), match=match):
        loop_update(config, carry, acc, -acc, None, bad)
    # The wrapper's own check of the same sink.
    leaves = [(x.shape, x.dtype) for x in graphs._leaves(out)]
    with pytest.raises((ValueError, TypeError), match=match):
        graphs.check_sink(bad, leaves, torch.device("cpu"))
    # Nothing was written.
    for x, y in zip(graphs._leaves(carry), graphs._leaves(state)):
        assert torch.equal(x, y)


def _halves_under_a_window(update, config, state, acc, out, device):
    """``update`` on each half of ``state``'s channels (contiguous views of
    a copy of it), each writing its columns of one whole sink's rows
    (`graphs.Sink.channel_window`); returns the copy and the sink."""
    carry, sink = _clone(state), _sink(out, device)
    for first in (0, 2):
        half = type(carry)(*(type(x)(*(y[first:first + 2] for y in x)) if isinstance(x, tuple)
                             else x[first:first + 2] for x in carry))
        update(config, half, acc[first:first + 2], -acc[first:first + 2], None,
               sink.channel_window(first, 4))
    return carry, sink


def test_a_channel_window_writes_the_shards_columns_as_one_call_writes_them():
    # Two channel shards writing their columns of one sink's rows (the
    # sharded bank on one device) give the whole call's rows and state.
    config, state, acc, out = _sink_case()
    carry, sink = _halves_under_a_window(loop_update, config, state, acc, out, "cpu")
    whole, want = _clone(state), _sink(out, "cpu")
    loop_update(config, whole, acc, -acc, None, want)
    for x, y in zip(graphs._leaves(carry), graphs._leaves(whole)):
        assert torch.equal(x, y)
    for x, y in zip(sink.outs, want.outs):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="does not hold"):
        graphs.check_sink(sink.channel_window(3, 4), [(x.shape, x.dtype)
                                                      for x in graphs._leaves(out)],
                          torch.device("cpu"))


def test_the_kernel_wrappers_refuse_what_they_cannot_write_in_place():
    # On the CPU the wrappers stop at the device; their in-place check of a
    # state leaf refuses a strided one.
    config, state, acc, out = _sink_case()
    for call in (lambda: loop_kernel.loop_update_kernel(config, state, acc, acc,
                                                        sink=_sink(out, "cpu")),
                 lambda: loop_kernel.dual_update_kernel(config, state, torch.cat([acc, acc]),
                                                        torch.cat([acc, acc]), torch.ones(10),
                                                        torch.ones(20))):
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            call()
    strided = torch.zeros(4, 2)[:, 0]
    with pytest.raises(ValueError, match="contiguous to take the new state in place"):
        loop_kernel._check("state.carrier_doppler", strided, (4,), torch.float32,
                           torch.device("cpu"), in_place=True)
    assert loop_kernel._check("x", strided, (4,), torch.float32, torch.device("cpu")).is_contiguous()


def test_state_leaves_round_trip_in_the_kernels_order():
    _, state, _, _ = _sink_case()
    leaves = loop_kernel.state_leaves(state)
    assert len(leaves) == len(loop_kernel._STATE)
    again = loop_kernel._state_from(state.prn, leaves)
    assert all(x is y for x, y in zip(graphs._leaves(again), graphs._leaves(state)))
    assert loop_kernel._OUTPUTS[:11] == TrackOutput._fields


def test_sink_and_dual_paths_run_on_the_cpu_without_a_cuda_compiler(tmp_path):
    # The sink and the dual entry on CPU tensors: the plain versions, nothing
    # built or loaded.
    code = textwrap.dedent("""
        import numpy as np, torch
        from gpuacceleratedtracking_tpu_torch.ops import _build, loop_kernel
        from gpuacceleratedtracking_tpu_torch.models import GPSL5
        from gpuacceleratedtracking_tpu_torch.tracking import (
            TrackConfig, dual_config, graphs, init_state, loop_update)
        from gpuacceleratedtracking_tpu_torch.tracking.dual import dual_update
        config = dual_config(TrackConfig.for_system(GPSL5(), 16.384e6, 16384,
                                                    use_secondary=False))
        state = init_state([0, 1], device="cpu")
        acc = torch.ones(4, 3)
        state, out = dual_update(config, state, acc, acc, torch.ones(10), torch.ones(20))
        sink = graphs.Sink(tuple(torch.zeros((2,) + x.shape) for x in graphs._leaves(out)),
                           torch.zeros((), dtype=torch.int64))
        new, written = dual_update(config, state, acc, acc, torch.ones(10), torch.ones(20), sink)
        assert new is state and all(x is graphs.WRITTEN for x in graphs._leaves(written))
        assert loop_kernel.dual_update_kernel.launches == 0
        assert loop_kernel.loop_update_kernel.launches == 0
        assert _build.load_library.cache_info().currsize == 0
        print("ok")
    """)
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + ":/usr/bin:/bin",
               CUDA_HOME=str(tmp_path / "no_cuda"), CUDA_PATH=str(tmp_path / "no_cuda"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# --- On the card.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 8, None], ids=["k1024", "k8", "scalar"])
@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_kernel_matches_plain_version(cuda, name, k):
    config, state, blocks, w = _inputs(name, k, cuda)
    ks = ps = state
    for b, (are, aim) in enumerate(blocks):
        before = loop_kernel.loop_update_kernel.launches
        ks, kout = loop_update(config, ks, are, aim, w)
        assert loop_kernel.loop_update_kernel.launches == before + 1
        ps, pout = loop_update_plain(config, ps, are, aim, w)
        want = _fields(ps, pout)
        for field, x in _fields(ks, kout).items():
            y = want[field]
            assert x.shape == y.shape and x.dtype == y.dtype and x.device == y.device, field
            if field == "cn0_dbhz":
                torch.testing.assert_close(x, y, rtol=0, atol=CN0_ATOL_DB)
            else:
                assert torch.equal(x, y), f"{name} block {b} {field}"


@pytest.mark.cuda
def test_one_launch_per_call_and_no_wait_on_the_card(cuda):
    config, state, blocks, w = _inputs("coherent_secondary", 256, cuda)
    state, _ = loop_update(config, state, *blocks[0])       # builds the library, the table
    torch.cuda.synchronize()
    before = loop_kernel.loop_update_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for are, aim in blocks:
            state, _ = loop_update(config, state, are, aim)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert loop_kernel.loop_update_kernel.launches == before + len(blocks)


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph_matches_the_eager_call(cuda):
    config, state, blocks, w = _inputs("two_antennas_weighted", 1024, cuda)
    are, aim = blocks[0]
    want = _fields(*loop_update(config, state, are, aim, w))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = _fields(*loop_update(config, state, are, aim, w))
    graph.replay()
    torch.cuda.synchronize()
    for field, x in got.items():
        assert torch.equal(x, want[field]), field
    assert not math.isnan(float(got["cn0_dbhz"].sum()))


def _assert_bitwise(got: dict, want: dict, what: str):
    for field, x in got.items():
        y = want[field]
        assert x.shape == y.shape and x.dtype == y.dtype and x.device == y.device, field
        assert torch.equal(x, y), f"{what} {field}"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 8, None], ids=["k1024", "k8", "scalar"])
@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_kernel_matches_plain_version_under_a_sink(cuda, name, k):
    # The kernel writing its outputs into rows of a sink and the new state
    # in place, against the plain version doing the same: every row and every
    # state leaf bit for bit, one launch per call.
    config, state, blocks, w = _inputs(name, k, cuda)
    _, out = loop_update_plain(config, state, *blocks[0], w)
    sinks = [_sink(out, cuda) for _ in range(2)]
    before = loop_kernel.loop_update_kernel.launches
    got = _run_with_sink(lambda st, are, aim, w, sk: loop_update(config, st, are, aim, w, sk),
                         state, blocks, sinks[0], w)
    assert loop_kernel.loop_update_kernel.launches == before + len(blocks)
    want = _run_with_sink(
        lambda st, are, aim, w, sk: loop_update_plain(config, st, are, aim, w, sk),
        state, blocks, sinks[1], w)
    _assert_bitwise(_fields(got, out), _fields(want, out), f"{name} state")
    for i, (x, y) in enumerate(zip(*(s.outs for s in sinks))):
        assert torch.equal(x, y), f"{name} output leaf {i}"


@pytest.mark.cuda
def test_kernel_under_a_channel_window_matches_plain_version(cuda):
    # Each channel shard's launch writes its columns of the whole sink's
    # rows and its part of the state in place, bit for bit the plain
    # version's writes.
    config, state, acc, out = _sink_case()
    state, out = (graphs._rebuild(t, iter([x.to(cuda) for x in graphs._leaves(t)]))
                  for t in (state, out))
    acc = acc.to(cuda)
    before = loop_kernel.loop_update_kernel.launches
    got = _halves_under_a_window(loop_update, config, state, acc, out, cuda)
    assert loop_kernel.loop_update_kernel.launches == before + 2
    want = _halves_under_a_window(loop_update_plain, config, state, acc, out, cuda)
    for x, y in zip(graphs._leaves(got[0]), graphs._leaves(want[0])):
        assert torch.equal(x, y)
    for x, y in zip(got[1].outs, want[1].outs):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DUAL_CASES))
def test_dual_kernel_matches_plain_version(cuda, name):
    # Fresh and under a sink, three blocks each side fed its own state back:
    # the wipes, the rotation, the closure and the data prompt's antenna sum
    # (torch's order for a strided [K, A] view) bit for bit.
    config, state, blocks, tables = _dual_inputs(*DUAL_CASES[name], cuda)
    ks = ps = state
    for b, (are, aim) in enumerate(blocks):
        before = loop_kernel.dual_update_kernel.launches
        ks, kout = dual_update(config, ks, are, aim, *tables)
        assert loop_kernel.dual_update_kernel.launches == before + 1
        ps, pout = dual_update_plain(config, ps, are, aim, *tables)
        _assert_bitwise(_dual_fields(ks, kout), _dual_fields(ps, pout), f"{name} block {b}")
    sinks = [_sink(pout, cuda) for _ in range(2)]
    got = _run_with_sink(lambda st, are, aim, sk: dual_update(config, st, are, aim, *tables, sk),
                         state, blocks, sinks[0])
    want = _run_with_sink(
        lambda st, are, aim, sk: dual_update_plain(config, st, are, aim, *tables, sk),
        state, blocks, sinks[1])
    _assert_bitwise(_fields(got, pout.pilot), _fields(want, pout.pilot), f"{name} sink state")
    for i, (x, y) in enumerate(zip(*(s.outs for s in sinks))):
        assert torch.equal(x, y), f"{name} sink output leaf {i}"


@pytest.mark.cuda
def test_sink_and_dual_calls_do_not_wait_on_the_card(cuda):
    config, state, blocks, w = _inputs("coherent_secondary", 256, cuda)
    dconfig, dstate, dblocks, tables = _dual_inputs(64, 2, cuda)
    _, out = loop_update(config, _clone(state), *blocks[0])         # builds the library
    _, dout = dual_update(dconfig, _clone(dstate), *dblocks[0], *tables)
    sink, dsink = _sink(out, cuda), _sink(dout, cuda)
    torch.cuda.synchronize()
    counts = loop_kernel.loop_update_kernel.launches, loop_kernel.dual_update_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _run_with_sink(lambda st, are, aim, sk: loop_update(config, st, are, aim, None, sk),
                       state, blocks, sink)
        for are, aim in dblocks:
            dstate, _ = dual_update(dconfig, dstate, are, aim, *tables)
        _run_with_sink(lambda st, are, aim, sk: dual_update(dconfig, st, are, aim, *tables, sk),
                       dstate, dblocks, dsink)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert loop_kernel.loop_update_kernel.launches == counts[0] + len(blocks)
    assert loop_kernel.dual_update_kernel.launches == counts[1] + 2 * len(dblocks)
