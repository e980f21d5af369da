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
every buffer its graphs read and write:

- the carry (the tracking state) and a chunk of ``[chunk, ...]`` stacked
  outputs, laid out as contiguous views of one flat buffer per dtype, the
  carry first, each leaf on an `ALIGN`-byte boundary;
- the per-call constants (code table, steering weights) and a chunk of
  blocks of each scanned input (`CHUNK` blocks, fewer where they would pass
  `CHUNK_BYTES`), from which the body selects the block at a device-side
  index;
- the constants a ``prepare`` derives once per call from the carry and the
  constants (the bank kernels' packed code tiles from the PRNs, the dual
  bank's joined code table), where ``scan`` is given one.

A call is one program, as a jitted JAX call is: the host copies the
caller's carry, constants and first chunk in (one multi-tensor copy per
pair of dtypes; a carry whose leaves lie as the entry lays them out, a
call's own result passed back, is one region of that copy), replays the
entry's prologue once (the index to 0 and ``prepare``, captured like the
body, so the code tiles are derived on the card inside the program; a
``prepare`` marked `writes_prepared` writes into the entry's buffers and
zeroes the index itself, so the bank entries' prologue is one launch), then
the body once per block; after each chunk the outputs, and after the last
the carry, are copied into one fresh buffer per dtype, laid out as the
entry's with B rows. Views aside, the ops a call dispatches do not grow
with the number of leaves. The body writes the outputs' rows at the index
before it writes the new carry over the old one and adds one to the index.

A body marked with `reads_chunk` takes its block, in the captured path, as
a `Chunk`: the entry's ``[chunk, ...]`` buffer of each scanned input and the
index, so that its kernels read the block's row at the index on the device
(the bank kernels do) where the body would otherwise select it by two
``index_select`` ops per block; the eager loop passes it the block's tensors,
as to any body.

A body marked with `writes_outputs` takes a fourth argument, a `Sink`: the
entry's stacked outputs and the index. It may write its outputs' rows and
the new carry itself (the loop-closure kernel does, where `lax.scan`'s
stacked outputs and carry are written inside the fused loop body), and it
returns `WRITTEN` in place of each output leaf it has written and the old
carry's own tensor for each carry leaf it wrote in place: the entry copies
the rest. A body without the mark, or any body outside a capture, gets no
sink and returns tensors.

Nothing a call returns aliases a graph buffer, and the caller's tensors are
never written, so results are functional, as in JAX: the final carry and
the stacked outputs are contiguous views of that call's fresh buffers. The
signature covers the body's and the prologue's code, the caller's ``key``
(the entry point and its static arguments, ``config`` as JAX's
``static_argnames``), the carry's and constants' shapes and dtypes, each
input's per-block shape and dtype, and the device; the number of blocks is
not in it, as a scan's body does not depend on the length. Tensors that a
body reads from outside its arguments (tile bases, tap offsets, overlay
tables) come from caches that never evict, so their addresses stay valid.

The first call of a signature runs ``prepare`` and one eager block on a side
stream (library loads, cluster opt-ins and the constant caches are built on
first use, and a capture may not build them; the outputs' shapes size the
flat buffers), then captures the prologue and the body, each in a memory
pool of its own, and leaves one call's results' worth of memory in the
allocator's cache, so that a chained second call asks the device for none.
The wrappers count their launches on the host, which a replay does not run:
the entry records how far each capture moved each kernel's count and adds
that much per replay; the warm-up's launches, whose results are thrown away,
and the captures' are not counted. A capture or replay that fails raises;
nothing falls back to the eager loop.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math
import warnings
from typing import Callable, NamedTuple

import torch

CHUNK = 64            # blocks per chunk of a cache entry
CHUNK_BYTES = 64 << 20  # at most this much scanned input per chunk (one block at least)
MAX_ENTRIES = 8       # captured signatures kept per device
ALIGN = 16            # bytes: each leaf of an entry's flat buffers starts on a multiple

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
        if count:
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


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensors to ``leaves``, in `_leaves` order; returns
    its structure, hashable, without the tensors."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return True
    if isinstance(tree, tuple):
        return type(tree), tuple([_flatten(child, leaves) for child in tree])
    if tree is None:
        return None
    raise TypeError(f"a scan tree holds tensors, tuples and None, not {type(tree).__name__}")


def _specs(leaves, drop: int = 0) -> tuple:
    """Each leaf's shape (less ``drop`` leading axes) and dtype."""
    return tuple([(x.shape[drop:], x.dtype) for x in leaves])


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
    on the device, never on the host). With a ``window`` ``(first, total)``
    the buffers' rows hold ``total`` channels and the writer's ``K`` are
    columns ``first:first + K`` of each (`channel_window`): a channel shard
    writing its part of the whole bank's outputs."""

    outs: tuple
    index: torch.Tensor
    window: tuple | None = None

    def channel_window(self, first: int, total: int) -> "Sink":
        """This sink for the writer of channels ``first:first + K`` of rows
        of ``total`` channels."""
        return self._replace(window=(int(first), int(total)))


def writes_outputs(step):
    """Mark ``step`` as a body that takes a `Sink` as a fourth argument
    (None outside a capture) and may write its outputs and carry itself."""
    step.takes_sink = True
    return step


# --- The chunk: a captured body's block, read at the index on the device.

class Chunk(NamedTuple):
    """A block as a captured body marked `reads_chunk` gets it: ``xs``, the
    entry's ``[chunk, ...]`` buffer of each scanned input, and ``index``,
    the block's row, an int64 0-d tensor on their device (the `Sink`'s)."""

    xs: tuple
    index: torch.Tensor

    def block(self) -> tuple:
        """The block's tensors, selected by `index_select` (what the entry
        does for a body without the mark)."""
        index = self.index.view(1)
        return tuple(torch.index_select(x, 0, index)[0] for x in self.xs)


def reads_chunk(step):
    """Mark ``step`` as a body that takes its block as a `Chunk` in the
    captured path (a tuple of the block's tensors in the eager loop)."""
    step.takes_chunk = True
    return step


# --- The prologue's own writes: a prepare that derives into the entry.

class Into(NamedTuple):
    """Where a ``prepare`` marked `writes_prepared` writes in a capture:
    ``prepared``, the body's constants as the entry holds them (each leaf
    ``prepare`` derives as the entry's own buffer, each other leaf as the
    entry's constant or carry leaf), and ``index``, the entry's block index
    (the `Sink`'s), which ``prepare`` sets to 0."""

    prepared: object
    index: torch.Tensor


def writes_prepared(prepare):
    """Mark ``prepare`` as one that takes an `Into` as a third argument (None
    outside a capture), writes each leaf it derives into its buffer there,
    sets the index to 0, and returns ``into.prepared``'s own leaves: the
    entry's prologue is then ``prepare`` alone (the bank kernels' code
    tiles: one launch of the packing kernel), where it would otherwise fill
    the index and copy each derived leaf into the entry."""
    prepare.takes_into = True
    return prepare


def check_sink(sink: Sink, leaves: list, device: torch.device) -> int:
    """Raise unless ``sink`` takes one block of outputs of the ``(shape,
    dtype)`` pairs ``leaves`` on ``device``: a contiguous ``[chunk, *shape]``
    buffer of that dtype on ``device`` per leaf (with a window ``(first,
    total)``, ``[chunk, total, *shape[1:]]``, ``first + shape[0] <=
    total``), and an int64 0-d index tensor there. Returns the chunk."""
    outs, index, window = sink
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
        if window is not None:
            first, total = window
            if not shape or first < 0 or first + shape[0] > total:
                raise ValueError(f"a sink window {window} does not hold leaf {i}'s "
                                 f"{tuple(shape)} channels")
            want = (chunk, total) + tuple(shape[1:])
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
        if sink.window is not None:
            buf = buf.narrow(1, sink.window[0], x.shape[0])
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

@functools.cache
def _counters() -> tuple:
    from ..ops import bank_comp, channel_kernels, epl_kernels, loop_kernel, replica_kernel

    return (epl_kernels.correlate_pallas_bank_rows, epl_kernels.correlate_pallas_bank,
            epl_kernels.correlate_pallas_bank_onehot, bank_comp.correlate_pallas_bank_comp,
            channel_kernels.correlate_pallas_taps, channel_kernels.correlate_pallas_fused,
            epl_kernels.pack_code_tiles, replica_kernel.code_replica,
            loop_kernel.dual_update_kernel, loop_kernel.loop_update_kernel)


def _counts() -> list:
    return [fn.launches for fn in _counters()]


def _set_counts(counts) -> None:
    for fn, count in zip(_counters(), counts):
        fn.launches = count


# --- The eager loop.

def loop(step, carry, xs: tuple, consts=None, prepare=None):
    """``step`` over the blocks of ``xs``, one Python iteration per block.

    ``step(carry, consts, block) -> (carry, out)``, ``block`` being
    ``tuple(x[b] for x in xs)``; with a ``prepare``, ``step`` takes
    ``prepare(carry, consts)`` in place of ``consts``, computed once before
    the first block. Returns the final carry and ``out``'s leaves stacked
    ``[B, ...]`` in ``out``'s structure.
    """
    if prepare is not None:
        consts = prepare(carry, consts)
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


# --- Flat buffers: leaves as contiguous views of one buffer per dtype.

@functools.lru_cache(maxsize=256)
def _layout(specs: tuple) -> tuple:
    """Where the leaves of ``specs`` (``(shape, dtype)`` pairs, in order) lie
    in one flat buffer per dtype, one after another, each starting on an
    `ALIGN`-byte boundary: ``(dtype, size in elements)`` per dtype, and each
    leaf's ``(dtype, shape, contiguous strides, offset in elements)``."""
    sizes, places = {}, []
    for shape, dtype in specs:
        align = max(1, ALIGN // dtype.itemsize)
        start = -(-sizes.get(dtype, 0) // align) * align
        strides = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        places.append((dtype, shape, strides, start))
        sizes[dtype] = start + math.prod(shape)
    return tuple(sizes.items()), tuple(places)


def _views(buffers: dict, places: tuple) -> list:
    """The contiguous view of each leaf placed by `_layout` in ``buffers``
    (dtype -> flat buffer)."""
    return [buffers[dtype].as_strided(shape, strides, offset)
            for dtype, shape, strides, offset in places]


def _flat_source(leaves: list, offsets: tuple, size: int):
    """``leaves`` (of one dtype) as the first ``size`` elements of the first
    one's storage, where they lie there exactly as a flat buffer lays them
    out (each contiguous, at its offset, in that storage's memory); else
    None."""
    first = leaves[0]
    itemsize = first.element_size()
    base = first.data_ptr() - first.storage_offset() * itemsize
    for x, offset in zip(leaves, offsets):
        if x.storage_offset() != offset or x.data_ptr() != base + offset * itemsize \
                or not x.is_contiguous():
            return None
    if first.untyped_storage().nbytes() < size * itemsize:
        return None
    return first.as_strided((size,), (1,), 0)


# --- The captured loop.

class _Entry:
    """One captured signature: its two graphs (the call's prologue and the
    block body) and every buffer they touch."""

    def __init__(self, step, prepare, carry, xs, consts, device):
        self.device = device
        self.const_leaves = [_like(x) for x in _leaves(consts)]
        self.consts = _rebuild(consts, iter(self.const_leaves))
        block_bytes = sum(x[0].numel() * x.element_size() for x in xs)
        self.chunk = max(1, min(CHUNK, CHUNK_BYTES // max(block_bytes, 1)))
        self.xs = [torch.empty((self.chunk,) + x.shape[1:], dtype=x.dtype, device=device)
                   for x in xs]
        self.index = torch.zeros((), dtype=torch.int64, device=device)
        # The warm-up runs on a carry of its own: the flat buffers are laid
        # out from the output shapes it finds.
        warm_carry = _rebuild(carry, (_like(x) for x in _leaves(carry)))
        _copy(_leaves(warm_carry) + _leaves(self.consts) + [x[:1] for x in self.xs],
              _leaves(carry) + _leaves(consts) + [x[:1] for x in xs])
        with uncounted(), warnings.catch_warnings():
            # A wrapper's warning is said once, at capture (JAX: at trace time).
            warnings.simplefilter("ignore")
            prepared, out = self._warm_up(step, prepare, warm_carry)
        self.out_tree = _rebuild(out, iter([_Leaf() for _ in _leaves(out)]))
        self.carry_specs = tuple((tuple(x.shape), x.dtype) for x in _leaves(carry))
        self.out_specs = tuple((tuple(x.shape), x.dtype) for x in _leaves(out))
        # The carry and a chunk of stacked outputs as views of one flat buffer
        # per dtype, the carry first: a call returns its results in the same
        # layout with B rows (`_result_layout`).
        sizes, places = self._result_layout(self.chunk)
        self.flat = {dtype: torch.empty(size, dtype=dtype, device=device)
                     for dtype, size in sizes}
        views = _views(self.flat, places)
        num_carry = len(self.carry_specs)
        self.carry = _rebuild(carry, iter(views[:num_carry]))
        self.carry_leaves, self.outs = views[:num_carry], views[num_carry:]
        carry_sizes, carry_places = _layout(self.carry_specs)
        # dtype -> (its carry leaves' indices, their offsets, the carry's region)
        self._carry_groups = {
            dtype: ([i for i, place in enumerate(carry_places) if place[0] == dtype],
                    tuple(place[3] for place in carry_places if place[0] == dtype),
                    self.flat[dtype][:size])
            for dtype, size in carry_sizes}
        self._heads = {self.chunk: (self.outs, self.xs)}
        self.prepared, self._derived = self._prepared_buffers(prepared, warm_carry)
        self._load(_leaves(carry), _leaves(consts), xs, 1)
        self.prologue, self.prologue_launches = capture_counted(self._prologue(prepare), device)
        self.replay, self.launches = capture_counted(self._body(step), device)
        self._spare = True

    def buffers(self) -> list:
        """Every buffer the entry owns."""
        derived = [x for i, x in enumerate(_leaves(self.prepared)) if i in self._derived]
        return (list(self.flat.values()) + _leaves(self.consts) + derived + self.xs
                + [self.index])

    def _result_layout(self, rows: int) -> tuple:
        """The `_layout` of a call's results, the carry's leaves then the
        outputs stacked ``[rows, ...]``, in one flat buffer per dtype: the
        carry's places do not depend on ``rows``."""
        return _layout(self.carry_specs + tuple(((rows,) + shape, dtype)
                                                for shape, dtype in self.out_specs))

    def _head(self, num: int) -> tuple:
        """The first ``num`` rows of the stacked outputs and of the chunk of
        blocks, views kept per ``num``."""
        head = self._heads.get(num)
        if head is None:
            head = self._heads[num] = ([buf[:num] for buf in self.outs],
                                       [x[:num] for x in self.xs])
        return head

    def _prepared_buffers(self, prepared, warm_carry):
        """The body's constants: ``prepare``'s result with each leaf that is
        an entry buffer (a constant, or a carry leaf) kept as that buffer,
        and a buffer of the entry's own for each leaf it derives; and the
        derived leaves' indices."""
        if prepared is self.consts:
            return self.consts, []
        own = {id(w): x for w, x in zip(_leaves(warm_carry), self.carry_leaves)}
        own.update((id(x), x) for x in _leaves(self.consts))
        leaves = _leaves(prepared)
        buffers = [own[id(x)] if id(x) in own else _like(x) for x in leaves]
        return (_rebuild(prepared, iter(buffers)),
                [i for i, x in enumerate(leaves) if id(x) not in own])

    def _load(self, leaves, consts, xs, num: int) -> None:
        """The caller's carry and constants (their leaves) and first ``num``
        blocks into the entry's buffers, one multi-tensor copy per pair of
        dtypes: a carry whose leaves of a dtype lie as the entry lays them
        out (a call's own result passed back) is one region of that copy."""
        dsts, srcs = [], []
        for dtype, (places, offsets, region) in self._carry_groups.items():
            src = _flat_source([leaves[i] for i in places], offsets, region.numel())
            if src is not None:
                dsts.append(region)
                srcs.append(src)
            else:
                dsts += [self.carry_leaves[i] for i in places]
                srcs += [leaves[i] for i in places]
        _copy(dsts + self.const_leaves + self._head(num)[1],
              srcs + consts + [x if x.shape[0] == num else x[:num] for x in xs])

    def _load_chunk(self, xs, b0: int, num: int) -> None:
        _copy(self._head(num)[1], [x[b0:b0 + num] for x in xs])

    def _block(self, step):
        """What ``step`` takes as its block: the `Chunk` where it is marked
        `reads_chunk`, else the block's tensors."""
        chunk = Chunk(tuple(self.xs), self.index)
        return chunk if getattr(step, "takes_chunk", False) else chunk.block()

    def _warm_up(self, step, prepare, carry):
        """One eager block on a side stream, to build what is built on first
        use; its results only size the entry's buffers. Returns the body's
        constants it prepared and its output."""
        compute = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        side = torch.cuda.Stream(self.device) if compute is not None else None
        if side is not None:
            side.wait_stream(compute)
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            prepared = self.consts if prepare is None else prepare(carry, self.consts)
            _, out = step(carry, prepared, self._block(step))
            _tensors(out)
        if side is not None:
            compute.wait_stream(side)
        return prepared, out

    def _prologue(self, prepare):
        """Once per call, before the first block: the index to 0 and, with a
        ``prepare``, the constants it derives from the loaded carry and
        constants into the entry's buffers (by ``prepare`` alone where it is
        marked `writes_prepared`)."""
        prepared = _leaves(self.prepared)
        kept = [i for i in range(len(prepared)) if i not in self._derived]

        if getattr(prepare, "takes_into", False):
            into = Into(self.prepared, self.index)

            def prologue():
                leaves = _leaves(prepare(self.carry, self.consts, into))
                if len(leaves) != len(prepared) or any(x is not y
                                                       for x, y in zip(leaves, prepared)):
                    raise ValueError("a prepare marked writes_prepared returned leaves other "
                                     "than the entry's buffers")

            return prologue

        def prologue():
            self.index.zero_()
            if prepare is None:
                return
            leaves = _leaves(prepare(self.carry, self.consts))
            if len(leaves) != len(prepared) or any(leaves[i] is not prepared[i] for i in kept):
                raise ValueError("prepare changed the structure of the body's constants")
            _copy([prepared[i] for i in self._derived], [leaves[i] for i in self._derived])

        return prologue

    def _body(self, step):
        sink = Sink(tuple(self.outs), self.index) if getattr(step, "takes_sink", False) else None

        def body():
            block = self._block(step)
            new_carry, out = (step(self.carry, self.prepared, block) if sink is None
                              else step(self.carry, self.prepared, block, sink))
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
            _write_carry(self.carry_leaves, _leaves(new_carry))
            self.index.add_(1)

        return body

    def run(self, carry, xs, consts):
        """The scan over ``xs`` from ``carry`` with ``consts`` (the leaves of
        both): the prologue's replay, then one replay per block. The final
        carry and the stacked outputs come back as views of one fresh buffer
        per dtype."""
        num_blocks = xs[0].shape[0]
        self._load(carry, consts, xs, min(self.chunk, num_blocks))
        self.prologue()
        count_replays(self.prologue_launches)
        fresh = None
        for b0 in range(0, num_blocks, self.chunk):
            num = min(self.chunk, num_blocks - b0)
            if b0:
                self.index.zero_()
                self._load_chunk(xs, b0, num)
            for _ in range(num):
                self.replay()
            count_replays(self.launches, num)
            if fresh is None:
                # Made while the card runs the first chunk's blocks.
                sizes, places = self._result_layout(num_blocks)
                fresh = {dtype: torch.empty(size, dtype=dtype, device=self.device)
                         for dtype, size in sizes}
                views = _views(fresh, places)
                final, stacked = views[:len(self.carry_specs)], views[len(self.carry_specs):]
            dsts = stacked if num == num_blocks else [dst[b0:b0 + num] for dst in stacked]
            srcs = self._head(num)[0]
            if b0 + num == num_blocks:
                dsts = dsts + [fresh[dtype][:region.numel()]
                               for dtype, (_, _, region) in self._carry_groups.items()]
                srcs = srcs + [region for _, _, region in self._carry_groups.values()]
            _copy(dsts, srcs)
        if self._spare:
            # A chained call holds its input, the last call's results, while
            # it allocates its own: the first call leaves that much memory
            # in the allocator's cache, so the next asks the device for none.
            self._spare = False
            spare = [torch.empty(size, dtype=dtype, device=self.device)
                     for dtype, size in sizes]
            del spare
        return _rebuild(self.carry, iter(final)), _rebuild(self.out_tree, iter(stacked))


def _code(step):
    """The code object of ``step`` (of the function a `functools.partial`
    wraps), which tells two bodies apart whatever their shapes."""
    while not hasattr(step, "__code__") and hasattr(step, "func"):
        step = step.func
    return getattr(step, "__code__", type(step))


def scan(step, carry, xs: tuple, consts=None, *, key, prepare=None):
    """``lax.scan`` of ``step`` over the blocks of ``xs``: on a CUDA device a
    replayed CUDA graph of ``step`` (see the module), else `loop`.

    ``step(carry, consts, block) -> (carry, out)``: ``carry`` and ``consts``
    are trees of tensors (tuples, NamedTuples, None), ``xs`` a tuple of
    ``[B, ...]`` tensors on one device, ``block`` ``tuple(x[b] for x in
    xs)``; ``out`` is a tree of tensors. ``prepare(carry, consts)``, if
    given, derives the constants ``step`` takes from the call's carry and
    constants (the bank kernels' code tiles from the PRNs), once per call:
    in the captured path as the entry's prologue, a graph replayed before
    the first block. ``key`` must hold every value that ``step``'s and
    ``prepare``'s closures capture (the entry point and its static
    arguments: config, correlator, kernel options, tables): the cache tells
    bodies apart by their code and ``key`` alone, so two closures of one
    function that differ in a value missing from ``key`` would share one
    graph. A body marked `writes_outputs` gets the entry's `Sink` as a
    fourth argument in its capture, a ``prepare`` marked `writes_prepared`
    the entry's `Into` as a third. Returns the final carry and the outputs
    stacked ``[B, ...]``.
    """
    device = xs[0].device
    if not enabled(device):
        return loop(step, carry, xs, consts, prepare)
    if xs[0].shape[0] == 0:
        raise ValueError("scan over zero blocks")
    carry_leaves, const_leaves = [], []
    signature = (_code(step), key, _flatten(carry, carry_leaves), _specs(carry_leaves),
                 _flatten(consts, const_leaves), _specs(const_leaves), _specs(xs, drop=1),
                 _code(prepare))
    entries = _ENTRIES.setdefault(device, collections.OrderedDict())
    with _on(device):
        entry = entries.get(signature)
        if entry is None:
            entry = _Entry(step, prepare, carry, xs, consts, device)
            entries[signature] = entry
            while len(entries) > MAX_ENTRIES:
                entries.popitem(last=False)
        entries.move_to_end(signature)
        return entry.run(carry_leaves, xs, const_leaves)
