"""The block loop as one captured program: the port's `jax.jit` + `lax.scan`.

The JAX package compiles each tracking run's block body once and loops over
it on the device. Here `scan` does the same on CUDA tensors: the body is
captured as a CUDA graph once per static signature and replayed once per
block, so the host issues one operation per block (``graph.replay()``) where
the eager loop issues every op of the block (the correlator, the loop-closure
kernel, the output writes).
On CPU tensors, and inside `eager()` (the counterpart of
``jax.disable_jit()``), `loop` runs the body block by block as before.

A cache entry (one per signature, an LRU of `MAX_ENTRIES` per device) owns
every buffer its graph reads and writes:

- the carry (the tracking state) and the per-call constants (code table,
  code tiles, steering weights), copied in from the caller's tensors at every
  call, device to device;
- a chunk of blocks of each scanned input (`CHUNK` blocks, fewer where
  they would pass `CHUNK_BYTES`), copied in per chunk, from which the body
  selects the block at a device-side index;
- ``[chunk, ...]`` stacked outputs, which the body writes at that index
  before it writes the new carry over the old one and adds one to the index.

A body marked with `writes_outputs` takes a fourth argument, a `Sink`: the
entry's stacked outputs and the index. It may write its outputs' rows and
the new carry itself (the loop-closure kernel does, where `lax.scan`'s
stacked outputs and carry are written inside the fused loop body), and it
returns `WRITTEN` in place of each output leaf it has written and the old
carry's own tensor for each carry leaf it wrote in place: the entry copies
the rest. A body without the mark, or any body outside a capture, gets no
sink and returns tensors.

After each chunk the outputs are copied into fresh ``[B, ...]`` tensors, and
after the last the carry is cloned: nothing a call returns aliases a graph
buffer, and the caller's tensors are never written, so results are
functional, as in JAX. The signature covers the body's code, the caller's
``key`` (the entry point and its static arguments, ``config`` as JAX's
``static_argnames``), the carry's and constants' shapes and dtypes, each
input's per-block shape and dtype, and the device; the number of blocks is
not in it, as a scan's body does not depend on the length. Tensors that a
body reads from outside its arguments (tile bases, tap offsets, overlay
tables) come from caches that never evict, so their addresses stay valid.

The first call of a signature runs one eager block on the entry's buffers on
a side stream (library loads, cluster opt-ins and the constant caches are
built on first use, and a capture may not build them), then captures the
body in the graph's own memory pool. The wrappers count their launches on
the host, which a replay does not run: the entry records how far the capture
moved each kernel's count and adds that much per replayed block; the
warm-up's launches, whose results are thrown away, and the capture's are not
counted. A capture or replay that fails raises; nothing falls back to the
eager loop.
"""

from __future__ import annotations

import collections
import contextlib
import warnings
from typing import Callable, NamedTuple

import torch

CHUNK = 64            # blocks per chunk of a cache entry
CHUNK_BYTES = 64 << 20  # at most this much scanned input per chunk (one block at least)
MAX_ENTRIES = 8       # captured signatures kept per device

_EAGER = 0
_ENTRIES: dict = {}   # device -> OrderedDict(signature -> _Entry)


@contextlib.contextmanager
def eager():
    """Run the tracking entry points' eager block loop, also on CUDA tensors
    (the counterpart of ``jax.disable_jit()``)."""
    global _EAGER
    _EAGER += 1
    try:
        yield
    finally:
        _EAGER -= 1


def enabled(device: torch.device) -> bool:
    """Whether `scan` captures its body on ``device``: on a CUDA device,
    outside `eager()`."""
    return device.type == "cuda" and not _EAGER


def capture(body: Callable[[], None], device: torch.device) -> Callable[[], None]:
    """Capture ``body`` as a CUDA graph on ``device``, in a memory pool of
    its own; returns the graph's replay. The capture runs on a stream of
    ``device``: `torch.cuda.graph`'s default capture stream belongs to the
    device that was current when it was first made."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
        body()
    return graph.replay


def capture_counted(body: Callable[[], None], device: torch.device):
    """`capture` ``body``, the launches counted in it taken back: returns the
    replay and how far the capture moved each wrapper's launch count (in
    `_counters` order), which the caller adds per replay (`count_replays`):
    a replay runs no wrapper code."""
    before = _counts()
    try:
        replay = capture(body, device)
        launched = [c - b for c, b in zip(_counts(), before)]
    finally:
        _set_counts(before)
    return replay, launched


def count_replays(launched: list, replays: int = 1) -> None:
    """Add a captured body's launches (`capture_counted`) ``replays`` times."""
    for fn, count in zip(_counters(), launched):
        fn.launches += count * replays


@contextlib.contextmanager
def uncounted():
    """Launches inside leave every wrapper's launch count as it was (a
    warm-up whose results are thrown away)."""
    before = _counts()
    try:
        yield
    finally:
        _set_counts(before)


def clear() -> None:
    """Drop every cache entry, and with them their graphs and buffers."""
    _ENTRIES.clear()


# --- Trees of tensors: tuples, NamedTuples and None, tensors at the leaves.

class _Written:
    """The place of an output leaf that a body wrote into its `Sink` itself."""

    def __repr__(self) -> str:
        return "graphs.WRITTEN"


WRITTEN = _Written()


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor) or tree is WRITTEN:
        return [tree]
    if isinstance(tree, tuple):
        return [leaf for child in tree for leaf in _leaves(child)]
    if tree is None:
        return []
    raise TypeError(f"a scan tree holds tensors, tuples and None, not {type(tree).__name__}")


def _tensors(out) -> list:
    """The leaves of an output a body returned without a sink: tensors only."""
    leaves = _leaves(out)
    if any(x is WRITTEN for x in leaves):
        raise ValueError("a scan body without a sink returned WRITTEN")
    return leaves


class _Leaf:
    """A leaf's place in a tree kept without its tensor."""


def _rebuild(like, leaves):
    """``like``'s structure with its tensors (or `_Leaf` places) taken in turn
    from ``leaves``."""
    if isinstance(like, (torch.Tensor, _Leaf)):
        return next(leaves)
    if isinstance(like, tuple):
        children = [_rebuild(child, leaves) for child in like]
        return type(like)(*children) if hasattr(like, "_fields") else tuple(children)
    return like


def _signature(tree, drop: int = 0):
    """``tree``'s structure, shapes (less ``drop`` leading axes) and dtypes."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape[drop:]), tree.dtype
    if isinstance(tree, tuple):
        return type(tree), tuple(_signature(child, drop) for child in tree)
    return None


def _like(x: torch.Tensor) -> torch.Tensor:
    """A contiguous buffer of ``x``'s shape and dtype on its device."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _copy(dsts: list, srcs: list) -> None:
    """``dst.copy_(src)`` for each pair, as few device ops as the shapes and
    dtypes allow: one multi-tensor copy per pair of dtypes (a list that mixes
    dtypes takes ``_foreach_copy_``'s one-copy-per-tensor route)."""
    groups: dict = {}
    for dst, src in zip(dsts, srcs):
        pair = groups.setdefault((dst.dtype, src.dtype), ([], []))
        pair[0].append(dst)
        pair[1].append(src)
    for group_dsts, group_srcs in groups.values():
        torch._foreach_copy_(group_dsts, group_srcs)


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


# --- The sink: a captured body's own writes of its outputs and carry.

class Sink(NamedTuple):
    """Where a body writes one block's outputs itself: ``outs``, a
    ``[chunk, ...]`` buffer per output leaf in the output tree's order, and
    ``index``, the block's row, an int64 0-d tensor on their device (read
    on the device, never on the host)."""

    outs: tuple
    index: torch.Tensor


def writes_outputs(step):
    """Mark ``step`` as a body that takes a `Sink` as a fourth argument
    (None outside a capture) and may write its outputs and carry itself."""
    step.takes_sink = True
    return step


def check_sink(sink: Sink, leaves: list, device: torch.device) -> int:
    """Raise unless ``sink`` takes one block of outputs of the ``(shape,
    dtype)`` pairs ``leaves`` on ``device``: a contiguous ``[chunk, *shape]``
    buffer of that dtype on ``device`` per leaf, and an int64 0-d index
    tensor there. Returns the chunk."""
    outs, index = sink
    if not isinstance(index, torch.Tensor):
        raise TypeError(f"a sink's index is an int64 0-d tensor on {device}, not "
                        f"{type(index).__name__}")
    if index.device != device or index.dtype != torch.int64 or index.ndim != 0:
        raise ValueError(f"a sink's index is an int64 0-d tensor on {device}, not "
                         f"{index.dtype} {tuple(index.shape)} on {index.device}")
    if len(outs) != len(leaves):
        raise ValueError(f"the sink holds {len(outs)} buffers for {len(leaves)} output leaves")
    chunk = outs[0].shape[0] if isinstance(outs[0], torch.Tensor) and outs[0].ndim else 0
    for i, (buf, (shape, dtype)) in enumerate(zip(outs, leaves)):
        want = (chunk,) + tuple(shape)
        if not isinstance(buf, torch.Tensor) or buf.device != device or buf.dtype != dtype \
                or tuple(buf.shape) != want or not buf.is_contiguous() or chunk == 0:
            got = (f"{tuple(buf.shape)} {buf.dtype} on {buf.device}"
                   if isinstance(buf, torch.Tensor) else type(buf).__name__)
            raise ValueError(f"sink buffer {i} is {got}, expected a contiguous {want} "
                             f"{dtype} on {device}")
    return chunk


def write_sink(sink: Sink, carry, new_carry, out):
    """A body's writes into ``sink``, in plain torch ops: ``out``'s leaves
    into their rows at ``sink.index``, ``new_carry``'s leaves over
    ``carry``'s own tensors. Returns ``carry`` (now holding the new values)
    and ``out`` with every leaf `WRITTEN`."""
    leaves = _leaves(out)
    check_sink(sink, [(x.shape, x.dtype) for x in leaves], leaves[0].device)
    index = sink.index.view(1)
    for buf, x in zip(sink.outs, leaves):
        buf.index_copy_(0, index, x.unsqueeze(0))
    _write_carry(_leaves(carry), _leaves(new_carry))
    return carry, _rebuild(out, iter([WRITTEN] * len(leaves)))


def _write_carry(carry_leaves: list, new_leaves: list) -> None:
    """Each new carry leaf over its old one, where it is not the old one."""
    if len(new_leaves) != len(carry_leaves):
        raise ValueError("the scan body changed the carry's structure")
    storages = {x.untyped_storage().data_ptr() for x in carry_leaves}
    # A new leaf that views an old one is copied first: the old one may be
    # overwritten before it is read.
    new_leaves = [x.clone() if x is not dst and x.untyped_storage().data_ptr() in storages
                  else x for x, dst in zip(new_leaves, carry_leaves)]
    for dst, x in zip(carry_leaves, new_leaves):
        if x.shape != dst.shape or x.dtype != dst.dtype:
            raise ValueError(
                f"the scan body changed a carry leaf from {tuple(dst.shape)} "
                f"{dst.dtype} to {tuple(x.shape)} {x.dtype}")
    moved = [(dst, x) for dst, x in zip(carry_leaves, new_leaves) if x is not dst]
    _copy([dst for dst, _ in moved], [x for _, x in moved])


# --- Launch counters.

def _counters() -> tuple:
    from ..ops import bank_comp, channel_kernels, epl_kernels, loop_kernel, replica_kernel

    return (epl_kernels.correlate_pallas_bank_rows, epl_kernels.correlate_pallas_bank,
            epl_kernels.correlate_pallas_bank_onehot, bank_comp.correlate_pallas_bank_comp,
            channel_kernels.correlate_pallas_taps, channel_kernels.correlate_pallas_fused,
            replica_kernel.code_replica, loop_kernel.dual_update_kernel,
            loop_kernel.loop_update_kernel)


def _counts() -> list:
    return [fn.launches for fn in _counters()]


def _set_counts(counts) -> None:
    for fn, count in zip(_counters(), counts):
        fn.launches = count


# --- The eager loop.

def loop(step, carry, xs: tuple, consts=None):
    """``step`` over the blocks of ``xs``, one Python iteration per block.

    ``step(carry, consts, block) -> (carry, out)``, ``block`` being
    ``tuple(x[b] for x in xs)``. Returns the final carry and ``out``'s leaves
    stacked ``[B, ...]`` in ``out``'s structure.
    """
    num_blocks = xs[0].shape[0]
    stacked = out = None
    for b in range(num_blocks):
        carry, out = step(carry, consts, tuple(x[b] for x in xs))
        leaves = _tensors(out)
        if stacked is None:
            stacked = [torch.empty((num_blocks,) + x.shape, dtype=x.dtype, device=x.device)
                       for x in leaves]
        for dst, x in zip(stacked, leaves):
            dst[b] = x
    return carry, _rebuild(out, iter(stacked))


# --- The captured loop.

class _Entry:
    """One captured signature: its graph and every buffer the graph touches."""

    def __init__(self, step, carry, xs, consts, device):
        self.device = device
        self.carry = _rebuild(carry, (_like(x) for x in _leaves(carry)))
        self.consts = _rebuild(consts, (_like(x) for x in _leaves(consts)))
        block_bytes = sum(x[0].numel() * x.element_size() for x in xs)
        self.chunk = max(1, min(CHUNK, CHUNK_BYTES // max(block_bytes, 1)))
        self.xs = [torch.empty((self.chunk,) + x.shape[1:], dtype=x.dtype, device=device)
                   for x in xs]
        self.index = torch.zeros((), dtype=torch.int64, device=device)
        self._load(carry, consts)
        self._load_chunk(xs, 0, 1)
        with uncounted(), warnings.catch_warnings():
            # A wrapper's warning is said once, at capture (JAX: at trace time).
            warnings.simplefilter("ignore")
            self._warm_up(step)
        self.replay, self.launches = capture_counted(self._body(step), device)

    def _load(self, carry, consts) -> None:
        _copy(_leaves(self.carry) + _leaves(self.consts), _leaves(carry) + _leaves(consts))

    def _load_chunk(self, xs, b0: int, num: int) -> None:
        _copy([dst[:num] for dst in self.xs], [x[b0:b0 + num] for x in xs])

    def _block(self) -> tuple:
        index = self.index.view(1)
        return tuple(torch.index_select(x, 0, index)[0] for x in self.xs)

    def _warm_up(self, step) -> None:
        """One eager block on a side stream, to build what is built on first
        use; its results only size the stacked outputs."""
        compute = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        side = torch.cuda.Stream(self.device) if compute is not None else None
        if side is not None:
            side.wait_stream(compute)
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            _, out = step(self.carry, self.consts, self._block())
            shapes = [(x.shape, x.dtype) for x in _tensors(out)]
        if side is not None:
            compute.wait_stream(side)
        self.out_tree = _rebuild(out, iter([_Leaf() for _ in shapes]))
        self.outs = [torch.empty((self.chunk,) + shape, dtype=dtype, device=self.device)
                     for shape, dtype in shapes]

    def _body(self, step):
        carry_leaves = _leaves(self.carry)
        sink = Sink(tuple(self.outs), self.index) if getattr(step, "takes_sink", False) else None

        def body():
            new_carry, out = (step(self.carry, self.consts, self._block()) if sink is None
                              else step(self.carry, self.consts, self._block(), sink))
            leaves = _leaves(out)
            if len(leaves) != len(self.outs):
                raise ValueError(f"the scan body returned {len(leaves)} output leaves, "
                                 f"its warm-up {len(self.outs)}")
            index = self.index.view(1)
            for buf, x in zip(self.outs, leaves):
                if x is WRITTEN:
                    if sink is None:
                        raise ValueError("a scan body without a sink returned WRITTEN")
                    continue
                buf.index_copy_(0, index, x.unsqueeze(0))
            _write_carry(carry_leaves, _leaves(new_carry))
            self.index.add_(1)

        return body

    def run(self, carry, xs, consts):
        """The scan over ``xs`` from ``carry``: per block one replay."""
        num_blocks = xs[0].shape[0]
        self._load(carry, consts)
        stacked = [torch.empty((num_blocks,) + buf.shape[1:], dtype=buf.dtype,
                               device=self.device) for buf in self.outs]
        for b0 in range(0, num_blocks, self.chunk):
            num = min(self.chunk, num_blocks - b0)
            self.index.zero_()
            self._load_chunk(xs, b0, num)
            for _ in range(num):
                self.replay()
            _copy([dst[b0:b0 + num] for dst in stacked], [buf[:num] for buf in self.outs])
            count_replays(self.launches, num)
        leaves = _leaves(self.carry)
        fresh = [_like(x) for x in leaves]
        _copy(fresh, leaves)
        final = _rebuild(self.carry, iter(fresh))
        return final, _rebuild(self.out_tree, iter(stacked))


def _code(step):
    """The code object of ``step`` (of the function a `functools.partial`
    wraps), which tells two bodies apart whatever their shapes."""
    while not hasattr(step, "__code__") and hasattr(step, "func"):
        step = step.func
    return getattr(step, "__code__", type(step))


def scan(step, carry, xs: tuple, consts=None, *, key):
    """``lax.scan`` of ``step`` over the blocks of ``xs``: on a CUDA device a
    replayed CUDA graph of ``step`` (see the module), else `loop`.

    ``step(carry, consts, block) -> (carry, out)``: ``carry`` and ``consts``
    are trees of tensors (tuples, NamedTuples, None), ``xs`` a tuple of
    ``[B, ...]`` tensors on one device, ``block`` ``tuple(x[b] for x in
    xs)``; ``out`` is a tree of tensors. ``key`` must hold every value that
    ``step``'s closure captures (the entry point and its static arguments:
    config, correlator, kernel options, tables): the cache tells bodies
    apart by their code and ``key`` alone, so two closures of one function
    that differ in a value missing from ``key`` would share one graph. A
    body marked `writes_outputs` gets the entry's `Sink` as a fourth
    argument in its capture. Returns the final carry and the outputs stacked
    ``[B, ...]``.
    """
    device = xs[0].device
    if not enabled(device):
        return loop(step, carry, xs, consts)
    if xs[0].shape[0] == 0:
        raise ValueError("scan over zero blocks")
    signature = (_code(step), key, _signature(carry), _signature(consts), _signature(xs, drop=1))
    entries = _ENTRIES.setdefault(device, collections.OrderedDict())
    with _on(device):
        entry = entries.get(signature)
        if entry is None:
            entry = _Entry(step, carry, xs, consts, device)
            entries[signature] = entry
            while len(entries) > MAX_ENTRIES:
                entries.popitem(last=False)
        entries.move_to_end(signature)
        return entry.run(carry, xs, consts)
