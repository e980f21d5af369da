"""The loop-closure kernel's wrapper: one launch per `loop_update` call.

The JAX package closes every channel's loop inside its jit + lax.scan, where
XLA fuses the closure's elementwise maths into a few loops per block
(`gpuacceleratedtracking_tpu.tracking.track.loop_update`). The port's
counterpart of that fusion is ``csrc/loop_update.cu``: a warp per channel
computes everything `tracking.track.loop_update_plain` computes (the
overlay wipe, the antenna sum, the coherent window, the discriminators, the
filters, carrier aiding, the NCO wraps and the C/N0 estimate) and writes a
fresh tensor for every leaf of the new `TrackState` and of `TrackOutput`.

`tracking.track.loop_update` dispatches on where its tensors lie: CUDA
tensors come here, CPU tensors run the plain version. Here a CUDA call
launches the kernel or raises; nothing falls back. Every launch adds one to
``loop_update_kernel.launches``.

Rounding follows the plain version on the card op by op (see the source):
the Python-float constants of the plain expressions are folded here in
double, as Python evaluates them, and rounded to f32 as torch rounds a
Python scalar (`loop_constants`); a torch division by a Python scalar on the
card is a multiply by the f32 reciprocal, which is passed as such; the
antenna sum and the C/N0 window means keep the order of torch's CUDA
reduction kernel. So every leaf equals the plain version's bit for bit on
the card; ``cn0_dbhz`` is the one whose bits hang on torch's reduction order.

Host work per call: checks of shapes, dtypes and devices, one f32 and one
int32 output buffer cut into views, and the launch. No device value is read
on the host and no host value is copied to the card: the overlay table and
the steering weights must already be on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build
from ..tracking.cn0 import CN0State
from ..tracking.loop_filter import LoopFilterState
from ..tracking.state import TrackConfig, TrackOutput, TrackState

# The kernel's parameters, in the order of its structs (csrc/loop_update.cu).
_INPUTS = ("acc_re", "acc_im", "w_re", "w_im", "overlay", "carrier_doppler",
           "carrier_phase", "code_doppler", "code_phase", "pll_x1", "pll_x2", "dll_x1",
           "dll_x2", "cn0_re", "cn0_im", "cn0_index", "ms_elapsed", "prev_re", "prev_im",
           "coh_re", "coh_im")
_FILTER = ("g_out", "g_x1", "g_x2", "f_x1", "f_x2")
_CONSTANTS = ("intermediate_frequency", "code_frequency", "eps", "inv_two_pi",
              "two_minus_d", "inv_two", "inv_fll", "t_coh", "aid_scale", "inv_center",
              "two_pi", "t", "code_length", "cn0_floor", "mean", "ten",
              *(f"pll_{name}" for name in _FILTER), *(f"dll_{name}" for name in _FILTER))
_INTS = ("num_k", "num_ants", "num_taps", "w_stride", "window", "overlay_len", "k_coh",
         "prompt", "pll_order", "dll_order", "pll_fll", "atan2_disc", "steered")
_OUTPUTS = ("channel", "coh", "cn0", "acc", "ints")
# The leaves of the [15, K] output buffer, in order.
_PER_CHANNEL = ("carrier_doppler", "carrier_phase", "code_doppler", "code_phase", "pll_x1",
                "pll_x2", "dll_x1", "dll_x2", "prev_re", "prev_im", "prompt_re", "prompt_im",
                "pll_error", "dll_error", "cn0_dbhz")
_ORDERS = (1, 2, 3)


def _f32(x: float) -> float:
    """``x`` rounded to f32 as torch rounds a Python scalar (double -> float)."""
    return float(np.float32(x))


def _recip(x: float) -> float:
    """What a torch division by the Python scalar ``x`` multiplies by on the
    card: the f32 reciprocal of f32(x), computed in f32."""
    return float(np.float32(1.0) / np.float32(x))


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
        "overlay_len": len(config.secondary_code),
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


def _check(name: str, x, shape: tuple, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the accumulators on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).split('.')[-1]}, got {x.dtype}")
    if x.shape != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    return x.contiguous()


def loop_update_kernel(
    config: TrackConfig,
    state: TrackState,
    accum_re: torch.Tensor,
    accum_im: torch.Tensor,
    ant_weights=None,
    overlay: torch.Tensor | None = None,
) -> tuple[TrackState, TrackOutput]:
    """`tracking.track.loop_update` on CUDA tensors: one launch of
    ``csrc/loop_update.cu``.

    ``accum_*``: ``[..., L]`` or ``[..., A, L]`` f32 over the state's channel
    axes; ``ant_weights``: optional ``(w_re, w_im)`` f32 on the card,
    broadcast to ``[..., A]``; ``overlay``: the config's overlay signs as an
    f32 ``[S]`` tensor on the card (`tracking.track._overlay_table`), None
    without one. Raises on anything the kernel does not take, and if the
    launch fails. Adds one to ``loop_update_kernel.launches``.
    """
    device = accum_re.device
    if device.type != "cuda":
        raise ValueError(f"the loop_update kernel takes CUDA tensors, not {device}")
    batch = tuple(state.prn.shape)
    single = accum_re.ndim == len(batch) + 1
    num_taps = accum_re.shape[-1]
    num_ants = 1 if single else accum_re.shape[-2]
    acc_shape = batch + (num_taps,) if single else batch + (num_ants, num_taps)
    window = state.cn0.prompts_re.shape[-1]
    consts, config_ints = _config_args(config, window)
    if not 0 <= config.prompt_index < num_taps:
        raise ValueError(f"prompt index {config.prompt_index} outside {num_taps} taps")
    f32, i32 = torch.float32, torch.int32
    w_shape, l_shape = batch + (window,), batch + (num_taps,)
    inputs = [
        _check("accum_re", accum_re, acc_shape, f32, device),
        _check("accum_im", accum_im, acc_shape, f32, device),
        None, None, None,
        *(_check(name, x, batch, f32, device) for name, x in (
            ("carrier_doppler", state.carrier_doppler), ("carrier_phase", state.carrier_phase),
            ("code_doppler", state.code_doppler), ("code_phase", state.code_phase),
            ("pll_filter.x1", state.pll_filter.x1), ("pll_filter.x2", state.pll_filter.x2),
            ("dll_filter.x1", state.dll_filter.x1), ("dll_filter.x2", state.dll_filter.x2))),
        _check("cn0.prompts_re", state.cn0.prompts_re, w_shape, f32, device),
        _check("cn0.prompts_im", state.cn0.prompts_im, w_shape, f32, device),
        _check("cn0.index", state.cn0.index, batch, i32, device),
        _check("ms_elapsed", state.ms_elapsed, batch, i32, device),
        _check("prev_prompt_re", state.prev_prompt_re, batch, f32, device),
        _check("prev_prompt_im", state.prev_prompt_im, batch, f32, device),
        _check("coh_re", state.coh_re, l_shape, f32, device),
        _check("coh_im", state.coh_im, l_shape, f32, device),
    ]
    steered = ant_weights is not None and not single
    w_stride = 0
    if steered:
        (inputs[2], w_stride), (inputs[3], _) = (
            _weight_rows(w, batch, num_ants, device) for w in ant_weights)
    wipe = bool(config.secondary_code)
    if wipe:
        inputs[4] = _check("overlay", overlay, (len(config.secondary_code),), f32, device)
    ints = dict(config_ints, num_k=math.prod(batch), num_ants=num_ants, num_taps=num_taps,
                w_stride=w_stride, steered=int(steered))

    # Fresh outputs, one buffer per kind, each cut into its leaves by unbind.
    outputs = [torch.empty((len(_PER_CHANNEL),) + batch, dtype=f32, device=device),
               torch.empty((2,) + l_shape, dtype=f32, device=device),
               torch.empty((2,) + w_shape, dtype=f32, device=device),
               torch.empty((2,) + acc_shape, dtype=f32, device=device) if wipe else None,
               torch.empty((2,) + batch, dtype=i32, device=device)]
    pointers = (ctypes.c_void_p * (len(_INPUTS) + len(_OUTPUTS)))(
        *(0 if x is None else x.data_ptr() for x in inputs + outputs))
    int_array = (ctypes.c_int * len(_INTS))(*(ints[name] for name in _INTS))
    outputs_at = ctypes.addressof(pointers) + len(_INPUTS) * ctypes.sizeof(ctypes.c_void_p)
    err = _build.load_library("loop_update").loop_update_launch(
        pointers, len(_INPUTS), outputs_at, len(_OUTPUTS), consts, len(_CONSTANTS), int_array,
        len(_INTS), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"loop_update_launch failed with CUDA error {err}")
    loop_update_kernel.launches += 1

    leaf = dict(zip(_PER_CHANNEL, outputs[0].unbind(0)))
    coh_re, coh_im = outputs[1].unbind(0)
    cn0_re, cn0_im = outputs[2].unbind(0)
    out_re, out_im = outputs[3].unbind(0) if wipe else (accum_re, accum_im)
    cn0_index, ms_elapsed = outputs[4].unbind(0)
    new_state = TrackState(
        prn=state.prn,
        carrier_doppler=leaf["carrier_doppler"],
        carrier_phase=leaf["carrier_phase"],
        code_doppler=leaf["code_doppler"],
        code_phase=leaf["code_phase"],
        pll_filter=LoopFilterState(leaf["pll_x1"], leaf["pll_x2"]),
        dll_filter=LoopFilterState(leaf["dll_x1"], leaf["dll_x2"]),
        cn0=CN0State(cn0_re, cn0_im, cn0_index),
        ms_elapsed=ms_elapsed,
        prev_prompt_re=leaf["prev_re"],
        prev_prompt_im=leaf["prev_im"],
        coh_re=coh_re,
        coh_im=coh_im,
    )
    output = TrackOutput(
        accum_re=out_re,
        accum_im=out_im,
        prompt_re=leaf["prompt_re"],
        prompt_im=leaf["prompt_im"],
        carrier_doppler=leaf["carrier_doppler"],
        code_doppler=leaf["code_doppler"],
        carrier_phase=leaf["carrier_phase"],
        code_phase=leaf["code_phase"],
        pll_error=leaf["pll_error"],
        dll_error=leaf["dll_error"],
        cn0_dbhz=leaf["cn0_dbhz"],
    )
    return new_state, output


loop_update_kernel.launches = 0
