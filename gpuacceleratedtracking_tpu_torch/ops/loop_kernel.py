"""The loop-closure kernel's wrappers: one launch per `loop_update` call, and
one per block of the GPS L5 dual bank.

The JAX package closes every channel's loop inside its jit + lax.scan, where
XLA fuses the closure's elementwise maths, the scan's stacked outputs and
its carry into a few loops per block
(`gpuacceleratedtracking_tpu.tracking.track.loop_update`). The port's
counterpart of that fusion is ``csrc/loop_update.cu``: it computes
everything `tracking.track.loop_update_plain` computes (the overlay wipe,
the antenna sum, the coherent window, the discriminators, the filters,
carrier aiding, the NCO wraps and the C/N0 estimate), a CTA per tile of
channels, a warp per channel for the sums and a lane per channel for the
loop chain. `dual_update_kernel` is the same kernel in dual mode: it also
takes the GPS L5 dual body's overlay wipes, the pilot's rotation and the
data prompt (`tracking.dual.dual_update_plain`).

Where the results go: without a sink, into fresh tensors (every leaf of the
new `TrackState` and of the output); with a `graphs.Sink` (a captured scan's
stacked output buffers and its device-side block index), every output leaf
into its row of the stack and the new state over the old state's own
buffers, and the call returns the old state's tensors as the new state and
`graphs.WRITTEN` for each output leaf. A sink with a channel window
(`graphs.Sink.window`, a channel shard of a sharded bank) holds the whole
bank's rows, and the call writes its channels' columns of them.

`tracking.track.loop_update` and `tracking.dual.dual_update` dispatch on
where their tensors lie: CUDA tensors come here, CPU tensors run the plain
versions. Here a CUDA call launches the kernel or raises; nothing falls
back. Every launch adds one to ``loop_update_kernel.launches`` or
``dual_update_kernel.launches``.

Rounding follows the plain version on the card op by op (see the source):
the Python-float constants of the plain expressions are folded here in
double, as Python evaluates them, and rounded to f32 as torch rounds a
Python scalar (`loop_constants`); a torch division by a Python scalar on the
card is a multiply by its double reciprocal rounded to f32, which is
passed as such; the
antenna sums and the C/N0 window means keep the order of torch's CUDA
reduction kernel. So every leaf equals the plain version's bit for bit on
the card.

Host work per call: checks of shapes, dtypes and devices, the output
buffers (none under a sink) and the launch. No device value is read on the
host and no host value is copied to the card: the overlay tables, the
steering weights and the sink's index must already be on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build
from ..tracking import graphs
from ..tracking.cn0 import CN0State
from ..tracking.loop_filter import LoopFilterState
from ..tracking.state import TrackConfig, TrackOutput, TrackState

# The kernel's parameters, in the order of its structs (csrc/loop_update.cu).
_INPUTS = ("acc_re", "acc_im", "w_re", "w_im", "overlay", "data_overlay", "row")
_STATE = ("carrier_doppler", "carrier_phase", "code_doppler", "code_phase", "pll_x1", "pll_x2",
          "dll_x1", "dll_x2", "cn0_re", "cn0_im", "cn0_index", "ms_elapsed", "prev_re",
          "prev_im", "coh_re", "coh_im")
_OUTPUTS = TrackOutput._fields + ("data_re", "data_im")
_FILTER = ("g_out", "g_x1", "g_x2", "f_x1", "f_x2")
_CONSTANTS = ("intermediate_frequency", "code_frequency", "eps", "inv_two_pi",
              "two_minus_d", "inv_two", "inv_fll", "t_coh", "aid_scale", "inv_center",
              "two_pi", "t", "code_length", "cn0_floor", "mean", "ten",
              *(f"pll_{name}" for name in _FILTER), *(f"dll_{name}" for name in _FILTER))
_INTS = ("num_k", "num_ants", "num_taps", "w_stride", "window", "overlay_len", "k_coh",
         "prompt", "pll_order", "dll_order", "pll_fll", "atan2_disc", "steered", "antenna_axis",
         "dual", "data_overlay_len", "chunk", "row_channels", "first")
# The [K] f32 leaves of a fresh call's one per-channel buffer, in order: the
# state's, then the outputs' of their own (the outputs' Dopplers and phases
# are the state's).
_PER_CHANNEL = ("carrier_doppler", "carrier_phase", "code_doppler", "code_phase", "pll_x1",
                "pll_x2", "dll_x1", "dll_x2", "prev_re", "prev_im", "prompt_re", "prompt_im",
                "pll_error", "dll_error", "cn0_dbhz", "data_re", "data_im")
_ORDERS = (1, 2, 3)
MAX_TAPS = 32         # a lane per tap


def _f32(x: float) -> float:
    """``x`` rounded to f32 as torch rounds a Python scalar (double -> float)."""
    return float(np.float32(x))


def _recip(x: float) -> float:
    """What a torch division by the Python scalar ``x`` multiplies by on the
    card: the reciprocal of ``x`` in double, rounded to f32 (checked on the
    card; the f32 reciprocal of f32(x) differs for the GPS L5 centre
    frequency)."""
    return float(np.float32(1.0 / x))


def _filter_constants(bandwidth: float, order: int, fll_bandwidth: float = 0.0) -> dict:
    """`loop_filter.step`'s Python-float factors, as the plain expressions
    fold them (left to right, in double) and torch rounds them."""
    if order == 1:
        return {"g_out": _f32(4.0 * bandwidth)}
    if order == 2:
        omega0 = bandwidth / 0.53
        return {"g_x1": _f32(omega0**2), "g_out": _f32(math.sqrt(2.0) * omega0),
                "f_x1": _f32(4.0 * fll_bandwidth)}
    omega0 = bandwidth / 0.7845
    omega0f = fll_bandwidth / 0.53
    return {"g_x2": _f32(omega0**3), "g_x1": _f32(1.1 * omega0**2),
            "g_out": _f32(2.4 * omega0), "f_x2": _f32(omega0f**2),
            "f_x1": _f32(math.sqrt(2.0) * omega0f)}


def _check_order(order: int) -> None:
    if order not in _ORDERS:
        raise ValueError(f"order must be 1, 2 or 3, got {order}")


def loop_constants(config: TrackConfig, window: int) -> dict:
    """The f32 constants the kernel takes for ``config`` and a C/N0 window of
    ``window`` slots, by name (the order of ``_CONSTANTS``; unused filter
    factors 0)."""
    _check_order(config.pll_order)
    _check_order(config.dll_order)
    t = config.integration_time
    t_coh = _f32(t * max(int(config.coherent_blocks), 1))
    consts = dict.fromkeys(_CONSTANTS, 0.0)
    consts.update(
        intermediate_frequency=_f32(config.intermediate_frequency),
        code_frequency=_f32(config.code_frequency),
        eps=_f32(1e-12),
        inv_two_pi=_recip(2 * math.pi),
        two_minus_d=_f32(2.0 - config.spacing_chips),
        inv_two=_recip(2.0),
        inv_fll=_recip(2 * math.pi * t_coh),
        t_coh=t_coh,
        aid_scale=_f32(config.code_frequency),
        inv_center=_recip(config.center_frequency),
        two_pi=_f32(2 * math.pi),
        t=_f32(t),
        code_length=_f32(float(config.code_length)),
        cn0_floor=_f32(1e-20),
        # torch's mean scales its sum by float(outputs) / inputs, f32(1 / W).
        mean=float(np.float32(1.0) / np.float32(window)),
        ten=10.0,
    )
    pll = _filter_constants(config.pll_bandwidth, config.pll_order, config.fll_bandwidth)
    dll = _filter_constants(config.dll_bandwidth, config.dll_order)
    consts.update({f"pll_{k}": v for k, v in pll.items()})
    consts.update({f"dll_{k}": v for k, v in dll.items()})
    return consts


@functools.lru_cache(maxsize=256)
def _config_args(config: TrackConfig, window: int):
    """The launch's constants as a ctypes array, and its config-only ints."""
    consts = loop_constants(config, window)
    array = (ctypes.c_float * len(_CONSTANTS))(*(consts[name] for name in _CONSTANTS))
    ints = {
        "window": window,
        "k_coh": max(int(config.coherent_blocks), 1),
        "prompt": config.prompt_index,
        "pll_order": config.pll_order,
        "dll_order": config.dll_order,
        "pll_fll": int(config.fll_bandwidth > 0.0 and config.pll_order > 1),
        "atan2_disc": int(config.pll_discriminator == "atan2"),
    }
    return array, ints


def _weight_rows(w, batch: tuple, num_ants: int, device: torch.device):
    """Steering weights as ``[K or 1, A]`` rows with unit lane stride, and
    their channel stride (0: shared)."""
    if not isinstance(w, torch.Tensor) or w.device != device or w.dtype != torch.float32:
        raise ValueError(
            "the loop_update kernel takes steering weights as f32 tensors on the "
            f"accumulators' device ({device}); copy them to the card once, outside the loop")
    try:
        rows = w.expand(batch + (num_ants,)).reshape(-1, num_ants)
    except RuntimeError as exc:
        raise ValueError(f"steering weights of shape {tuple(w.shape)} do not broadcast to "
                         f"{batch + (num_ants,)}") from exc
    if rows.shape[0] > 1 and (rows.stride(-1) != 1 or rows.stride(0) not in (0, num_ants)):
        rows = rows.contiguous()
    return rows, (rows.stride(0) if rows.shape[0] > 1 else 0)


def _check(name: str, x, shape: tuple, dtype, device, in_place: bool = False) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the accumulators on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).split('.')[-1]}, got {x.dtype}")
    if x.shape != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if in_place and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous to take the new state in place")
    return x.contiguous()


def _table(name: str, x, device) -> torch.Tensor:
    """An overlay table: a non-empty f32 ``[S]`` tensor on ``device``."""
    size = x.shape[:1] if isinstance(x, torch.Tensor) and x.ndim == 1 and x.numel() else (1,)
    return _check(name, x, size, torch.float32, device)


def state_leaves(state: TrackState) -> tuple:
    """The state's leaves but ``prn``, in the kernel's order (``_STATE``)."""
    return (state.carrier_doppler, state.carrier_phase, state.code_doppler, state.code_phase,
            *state.pll_filter, *state.dll_filter, *state.cn0, state.ms_elapsed,
            state.prev_prompt_re, state.prev_prompt_im, state.coh_re, state.coh_im)


def _state_from(prn: torch.Tensor, leaves) -> TrackState:
    (cd, cp, kd, kp, px1, px2, dx1, dx2, cre, cim, index, ms, q_re, q_im, h_re,
     h_im) = leaves
    return TrackState(prn, cd, cp, kd, kp, LoopFilterState(px1, px2),
                      LoopFilterState(dx1, dx2), CN0State(cre, cim, index), ms, q_re, q_im,
                      h_re, h_im)


def _launch(config: TrackConfig, state: TrackState, accum_re, accum_im, ant_weights,
            overlay, data_overlay, sink, counter) -> tuple:
    """One launch of the kernel (dual mode where ``data_overlay`` is given);
    returns the new state and the output leaves in ``_OUTPUTS``' order (the
    data prompts only in dual mode), each `graphs.WRITTEN` under a sink."""
    device = accum_re.device
    if device.type != "cuda":
        raise ValueError(f"the loop_update kernel takes CUDA tensors, not {device}")
    dual = data_overlay is not None
    batch = tuple(state.prn.shape)
    if dual and len(batch) != 1:
        raise ValueError(f"the dual kernel takes a [K] channel axis, not {batch}")
    acc_batch = (2 * batch[0],) if dual else batch
    single = accum_re.ndim == len(acc_batch) + 1
    num_taps = accum_re.shape[-1]
    num_ants = 1 if single else accum_re.shape[-2]
    tail = (num_taps,) if single else (num_ants, num_taps)
    if not 0 <= config.prompt_index < num_taps:
        raise ValueError(f"prompt index {config.prompt_index} outside {num_taps} taps")
    if num_taps > MAX_TAPS:
        raise ValueError(f"the loop_update kernel takes at most {MAX_TAPS} taps, not {num_taps}")
    window = state.cn0.prompts_re.shape[-1]
    consts, config_ints = _config_args(config, window)
    f32, i32 = torch.float32, torch.int32
    in_place = sink is not None
    k_shape, l_shape, w_shape = batch, batch + (num_taps,), batch + (window,)
    shapes = dict.fromkeys(_STATE, (k_shape, f32))
    shapes.update(cn0_re=(w_shape, f32), cn0_im=(w_shape, f32), cn0_index=(k_shape, i32),
                  ms_elapsed=(k_shape, i32), coh_re=(l_shape, f32), coh_im=(l_shape, f32))
    old = [_check(f"state.{name}", x, *shapes[name], device, in_place)
           for name, x in zip(_STATE, state_leaves(state))]
    inputs = [_check("accum_re", accum_re, acc_batch + tail, f32, device),
              _check("accum_im", accum_im, acc_batch + tail, f32, device),
              None, None, None, None, None]
    steered = ant_weights is not None and not single
    w_stride = 0
    if steered:
        (inputs[2], w_stride), (inputs[3], _) = (
            _weight_rows(w, batch, num_ants, device) for w in ant_weights)
    if dual:
        if config.secondary_code:
            raise ValueError("the dual kernel wipes the overlays itself: use dual_config()")
        inputs[4] = _table("pilot overlay", overlay, device)
        inputs[5] = _table("data overlay", data_overlay, device)
    elif config.secondary_code:
        inputs[4] = _check("overlay", overlay, (len(config.secondary_code),), f32, device)
    wipe = inputs[4] is not None
    names = _OUTPUTS if dual else TrackOutput._fields
    leaf_shapes = dict.fromkeys(names, k_shape)
    leaf_shapes.update(accum_re=batch + tail, accum_im=batch + tail)

    row_channels, first = math.prod(batch), 0
    if in_place:
        chunk = graphs.check_sink(sink, [(leaf_shapes[name], f32) for name in names], device)
        inputs[6] = sink.index
        if sink.window is not None:
            if len(batch) != 1:
                raise ValueError(f"a sink's channel window takes a [K] channel axis, not {batch}")
            first, row_channels = sink.window
        new = old
        outputs = list(sink.outs) + [None] * (len(_OUTPUTS) - len(names))
    else:
        # Fresh buffers, one per kind, each cut into its leaves by unbind.
        chunk = 0
        per_channel = _PER_CHANNEL[:len(_PER_CHANNEL) - (0 if dual else 2)]
        leaf = dict(zip(per_channel, torch.empty((len(per_channel),) + k_shape, dtype=f32,
                                                 device=device).unbind(0)))
        leaf["coh_re"], leaf["coh_im"] = torch.empty((2,) + l_shape, dtype=f32,
                                                     device=device).unbind(0)
        leaf["cn0_re"], leaf["cn0_im"] = torch.empty((2,) + w_shape, dtype=f32,
                                                     device=device).unbind(0)
        leaf["cn0_index"], leaf["ms_elapsed"] = torch.empty((2,) + k_shape, dtype=i32,
                                                            device=device).unbind(0)
        if wipe or dual:
            leaf["accum_re"], leaf["accum_im"] = torch.empty((2,) + batch + tail, dtype=f32,
                                                             device=device).unbind(0)
        new = [leaf[name] for name in _STATE]
        outputs = [leaf.get(name) for name in _OUTPUTS]
        for name in ("carrier_doppler", "code_doppler", "carrier_phase", "code_phase"):
            outputs[_OUTPUTS.index(name)] = None        # the new state's own
    ints = dict(config_ints, num_k=math.prod(batch), num_ants=num_ants, num_taps=num_taps,
                w_stride=w_stride, steered=int(steered), antenna_axis=int(not single),
                overlay_len=inputs[4].shape[0] if wipe else 0, dual=int(dual),
                data_overlay_len=inputs[5].shape[0] if dual else 0, chunk=chunk,
                row_channels=row_channels, first=first)
    tensors = inputs + old + new + outputs
    pointers = (ctypes.c_void_p * len(tensors))(
        *(0 if x is None else x.data_ptr() for x in tensors))
    int_array = (ctypes.c_int * len(_INTS))(*(ints[name] for name in _INTS))
    err = _build.load_library("loop_update").loop_update_launch(
        pointers, len(tensors), consts, len(_CONSTANTS), int_array, len(_INTS),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"loop_update_launch failed with CUDA error {err}")
    counter.launches += 1

    if in_place:
        return state, [graphs.WRITTEN] * len(names)
    new_state = _state_from(state.prn, new)
    out = dict(zip(_OUTPUTS, outputs))
    for name in ("carrier_doppler", "code_doppler", "carrier_phase", "code_phase"):
        out[name] = leaf[name]
    if out["accum_re"] is None:                          # no wipe: the accumulators pass
        out["accum_re"], out["accum_im"] = accum_re, accum_im
    return new_state, [out[name] for name in names]


def loop_update_kernel(
    config: TrackConfig,
    state: TrackState,
    accum_re: torch.Tensor,
    accum_im: torch.Tensor,
    ant_weights=None,
    overlay: torch.Tensor | None = None,
    sink: graphs.Sink | None = None,
) -> tuple[TrackState, TrackOutput]:
    """`tracking.track.loop_update` on CUDA tensors: one launch of
    ``csrc/loop_update.cu``.

    ``accum_*``: ``[..., L]`` or ``[..., A, L]`` f32 over the state's channel
    axes; ``ant_weights``: optional ``(w_re, w_im)`` f32 on the card,
    broadcast to ``[..., A]``; ``overlay``: the config's overlay signs as an
    f32 ``[S]`` tensor on the card (`tracking.track._overlay_table`), None
    without one; ``sink``: a `graphs.Sink` of the `TrackOutput` leaves (the
    state's leaves must then be contiguous: they take the new state).
    Raises on anything the kernel does not take, and if the launch fails.
    Adds one to ``loop_update_kernel.launches``.
    """
    new_state, leaves = _launch(config, state, accum_re, accum_im, ant_weights, overlay, None,
                                sink, loop_update_kernel)
    return new_state, TrackOutput(*leaves)


def dual_update_kernel(
    config: TrackConfig,
    state: TrackState,
    accum_re: torch.Tensor,
    accum_im: torch.Tensor,
    data_overlay: torch.Tensor,
    pilot_overlay: torch.Tensor,
    sink: graphs.Sink | None = None,
):
    """`tracking.dual.dual_update` on CUDA tensors: one launch of
    ``csrc/loop_update.cu`` in dual mode.

    ``accum_*``: the 2K-channel bank's ``[2K, L]`` or ``[2K, A, L]`` f32
    accumulators, data channels first; ``data_overlay``, ``pilot_overlay``:
    the two components' overlay signs as f32 tensors on the card; ``config``:
    a `tracking.dual.dual_config` (no overlay of its own); ``sink``: a
    `graphs.Sink` of the `DualTrackOutput` leaves. Returns the new state and
    a `DualTrackOutput`. Adds one to ``dual_update_kernel.launches``.
    """
    from ..tracking.dual import DualTrackOutput

    new_state, leaves = _launch(config, state, accum_re, accum_im, None, pilot_overlay,
                                data_overlay, sink, dual_update_kernel)
    return new_state, DualTrackOutput(TrackOutput(*leaves[:-2]), *leaves[-2:])


loop_update_kernel.launches = 0
dual_update_kernel.launches = 0
