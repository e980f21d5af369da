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
and the captures' are not counted. `scan` counts, on itself, the entries it
made (``scan.captures``, a `scan_mesh` entry one), the entries the cache
dropped (``scan.evictions``), the blocks replayed (``scan.replays``) and
the device ops those replays ran (``scan.replayed_nodes``: each body
graph's node count, taken once at capture from the graph before it is
instantiated, per block; a `scan_mesh` block every group's graph's);
`uncounted()` and the warm-up leave these alone. An `_Entry`'s phases are
`spans` (on only while a profiler session records), inside the entry
point's: ``scan.load`` (the carry, constants and first chunk),
``scan.prologue``, ``scan.replay`` (a chunk's replays), ``scan.next_chunk``,
``scan.collect`` (a chunk's output copies) and ``scan.results``. A capture
or replay that fails raises; nothing falls back to the eager loop.

`scan_mesh` runs one block body over several cards in lockstep, the JAX
``shard_map`` program: an entry per part (card) holds that part's buffers
and prologue on its card, and each group of parts that exchange data inside
a block (a channel shard's time shards) is one CUDA graph over its cards
(`capture_mesh`: their streams join one capture, so the cross-card copies
and the orders they set are the graph's own), replayed once per block; the
host waits on no card inside a call. A group's parts end as replicas of
one another, so a call returns each group's first part's results.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import itertools
import math
import warnings
from typing import Callable, NamedTuple

import torch

from . import spans

CHUNK = 64            # blocks per chunk of a cache entry
CHUNK_BYTES = 64 << 20  # at most this much scanned input per chunk (one block at least)
MAX_ENTRIES = 8       # captured signatures kept per device
ALIGN = 16            # bytes: each leaf of an entry's flat buffers starts on a multiple

_EAGER = 0
_ENTRIES: dict = {}   # device -> OrderedDict(signature -> _Entry)
_KEPT: dict = {}      # device -> OrderedDict(key -> what `kept` made)


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


@functools.cache
def _graph_get_nodes():
    """``cuGraphGetNodes`` of ``libcuda.so.1`` (loaded with the CUDA
    context), through ctypes; it takes the runtime's graph handle."""
    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    return fn


def _instantiated(graph) -> Callable[[], None]:
    """The replay of ``graph`` (captured with ``keep_graph=True``), its node
    count read from the graph and kept as the replay's ``nodes``, then the
    graph instantiated, before its first replay."""
    count = ctypes.c_size_t(0)
    err = _graph_get_nodes()(graph.raw_cuda_graph(), None, ctypes.byref(count))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with error {err}")
    graph.instantiate()
    replay = functools.partial(graph.replay)
    replay.nodes = count.value
    return replay


def capture(body: Callable[[], None], device: torch.device) -> Callable[[], None]:
    """Capture ``body`` as a CUDA graph on ``device``, in a memory pool of
    its own; returns the graph's replay, its node count as ``nodes``. The
    capture runs on a stream of ``device``: `torch.cuda.graph`'s default
    capture stream belongs to the device that was current when it was first
    made."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
        body()
    return _instantiated(graph)


def capture_mesh(body: Callable[[], None], devices: list) -> Callable[[], None]:
    """Capture ``body`` as one CUDA graph over the distinct cards ``devices``:
    the capture begins on a stream of ``devices[0]``, and a stream of each
    other card joins it (an event of the first stream, waited on) and is
    that card's current stream while ``body`` runs, so every op ``body``
    issues on a card, and each order a cross-card copy sets between two
    cards' streams, is a node and an edge of the one graph. Each other card
    allocates from a pool of its own, kept with the graph (`torch.cuda.graph`
    keeps the first card's). Returns the graph's replay, its node count as
    ``nodes``, on the first card's current stream: a replay runs every
    card's part, in the captured order, and ends when the last card's part
    ends."""
    origin = devices[0]
    streams = [torch.cuda.Stream(d) for d in devices]
    pools = []
    for device in devices[1:]:
        # A pool belongs to the card current where it is made: it holds the
        # blocks the capture freed, which the graph's nodes still address.
        with torch.cuda.device(device):
            pools.append(torch.cuda.MemPool())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.device(origin), torch.cuda.graph(graph, stream=streams[0]):
        with contextlib.ExitStack() as stack:
            for device, stream, pool in zip(devices[1:], streams[1:], pools):
                stream.wait_stream(streams[0])
                stack.enter_context(torch.cuda.stream(stream))
                stack.enter_context(torch.cuda.use_mem_pool(pool, device))
            with torch.cuda.device(origin):
                body()
            for stream in streams[1:]:
                streams[0].wait_stream(stream)
    with torch.cuda.device(origin):
        replay = _instantiated(graph)
    replay.keep = (graph, streams, pools)
    return replay


def capture_counted(body: Callable[[], None], device):
    """`capture` ``body`` (on a list of cards, `capture_mesh`), the launches
    counted in it taken back: returns the replay and how far the capture
    moved each wrapper's launch count (in `_counters` order), which the
    caller adds per replay (`count_replays`): a replay runs no wrapper
    code."""
    before = _counts()
    try:
        replay = capture_mesh(body, device) if isinstance(device, list) else capture(body, device)
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
    _KEPT.clear()


def _cached(store: dict, where, key, make: Callable[[], object]):
    """``store[where][key]``, made by ``make()`` where it is missing: at
    most `MAX_ENTRIES` kept per ``where``, the least recently used dropped
    first. The captured entries' makes and drops are counted in
    ``scan.captures`` and ``scan.evictions``."""
    entries = store.setdefault(where, collections.OrderedDict())
    value = entries.get(key)
    if value is None:
        value = entries[key] = make()
        counted = store is _ENTRIES
        scan.captures += counted
        while len(entries) > MAX_ENTRIES:
            entries.popitem(last=False)
            scan.evictions += counted
    entries.move_to_end(key)
    return value


def kept(device: torch.device, key, make: Callable[[], object]):
    """``make()``, made once per ``device`` and ``key`` and kept as the
    captured entries are (`MAX_ENTRIES` per device, all dropped by
    `clear`)."""
    return _cached(_KEPT, device, key, make)


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


def _like(x: torch.Tensor, device: torch.device | None = None) -> torch.Tensor:
    """A contiguous buffer of ``x``'s shape and dtype on ``device`` (its own
    by default)."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device if device is None else device)


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
            epl_kernels.correlate_pallas_bank_onehot, epl_kernels.boundary_rows,
            epl_kernels.position_rows, bank_comp.correlate_pallas_bank_comp,
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


def _flat(leaves: list) -> tuple:
    """``leaves`` as one flat buffer per dtype laid out by `_layout`: their
    own storage where a dtype's leaves lie so (`_flat_source`: a captured
    call's results, a mesh's cut), else a buffer of their device filled by
    one multi-tensor copy per pair of dtypes. Returns the buffers and the
    leaves' places."""
    sizes, places = _layout(_specs(leaves))
    flat, dsts, srcs = {}, [], []
    for dtype, size in sizes:
        idx = [i for i, place in enumerate(places) if place[0] == dtype]
        src = _flat_source([leaves[i] for i in idx], tuple(places[i][3] for i in idx), size)
        if src is None:
            src = torch.empty(size, dtype=dtype, device=leaves[idx[0]].device)
            dsts += _views({dtype: src}, tuple(places[i] for i in idx))
            srcs += [leaves[i] for i in idx]
        flat[dtype] = src
    _copy(dsts, srcs)
    return flat, places


# --- The captured loop.

@contextlib.contextmanager
def _warming():
    """A warm-up's launches left uncounted, and a wrapper's warning said
    once, at capture (JAX: at trace time)."""
    with uncounted(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _chunk_of(xs) -> int:
    """Blocks per chunk of an entry scanning ``xs``: `CHUNK`, fewer where
    they would pass `CHUNK_BYTES`, one at least."""
    block_bytes = sum(x[0].numel() * x.element_size() for x in xs)
    return max(1, min(CHUNK, CHUNK_BYTES // max(block_bytes, 1)))


def _chunks(num_blocks: int, chunk: int):
    """``(first block, blocks)`` of each chunk of a call."""
    return [(b0, min(chunk, num_blocks - b0)) for b0 in range(0, num_blocks, chunk)]


class _Entry:
    """One captured signature: its two graphs (the call's prologue and the
    block body) and every buffer they touch. A card of a `scan_mesh` is an
    entry whose body graph is the mesh's (`_MeshEntry`): it is set up in
    the same steps, less its own warm-up and body."""

    def __init__(self, step, prepare, carry, xs, consts, device):
        self._setup(carry, xs, consts, device)
        with _warming():
            prepared, out = self._warm_up(step, prepare, self._warm_carry)
        self._lay_out(prepare, carry, consts, xs, prepared, out)
        self.replay, self.launches = capture_counted(self._body(step), device)
        # A replay that is no CUDA graph (a test's stand-in) counts no nodes.
        self.nodes = getattr(self.replay, "nodes", 0)

    def _setup(self, carry, xs, consts, device, chunk: int | None = None) -> None:
        """The constants' and the chunk's buffers, the index, and a copy of
        the caller's carry, constants and first block for the warm-up."""
        self.device = device
        self.const_leaves = [_like(x, device) for x in _leaves(consts)]
        self.consts = _rebuild(consts, iter(self.const_leaves))
        self.chunk = _chunk_of(xs) if chunk is None else chunk
        self.xs = [torch.empty((self.chunk,) + x.shape[1:], dtype=x.dtype, device=device)
                   for x in xs]
        self.index = torch.zeros((), dtype=torch.int64, device=device)
        # The warm-up runs on a carry of its own: the flat buffers are laid
        # out from the output shapes it finds.
        self._warm_carry = _rebuild(carry, (_like(x, device) for x in _leaves(carry)))
        _copy(_leaves(self._warm_carry) + _leaves(self.consts) + [x[:1] for x in self.xs],
              _leaves(carry) + _leaves(consts) + [x[:1] for x in xs])

    def _lay_out(self, prepare, carry, consts, xs, prepared, out) -> None:
        """After the warm-up (its prepared constants and output): the flat
        buffers, the prepared constants' buffers, the load of the caller's
        call, and the prologue's capture."""
        self.out_tree = _rebuild(out, iter([_Leaf() for _ in _leaves(out)]))
        self.carry_specs = tuple((tuple(x.shape), x.dtype) for x in _leaves(carry))
        self.out_specs = tuple((tuple(x.shape), x.dtype) for x in _leaves(out))
        # The carry and a chunk of stacked outputs as views of one flat buffer
        # per dtype, the carry first: a call returns its results in the same
        # layout with B rows (`_result_layout`).
        sizes, places = self._result_layout(self.chunk)
        self.flat = {dtype: torch.empty(size, dtype=dtype, device=self.device)
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
        self.prepared, self._derived = self._prepared_buffers(prepared, self._warm_carry)
        del self._warm_carry
        self._load(_leaves(carry), _leaves(consts), xs, 1)
        self.prologue, self.prologue_launches = capture_counted(self._prologue(prepare),
                                                                self.device)
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
        out (a call's own result passed back, or a mesh's cut) is one region
        of that copy."""
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

    def _sink(self, step):
        return Sink(tuple(self.outs), self.index) if getattr(step, "takes_sink", False) else None

    def _write(self, new_carry, out, sink) -> None:
        """A block's writes after the body: each output leaf the body did not
        write into its sink into its row at the index, the new carry over the
        old, and the index's add."""
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

    def _body(self, step):
        sink = self._sink(step)

        def body():
            block = self._block(step)
            new_carry, out = (step(self.carry, self.prepared, block) if sink is None
                              else step(self.carry, self.prepared, block, sink))
            self._write(new_carry, out, sink)

        return body

    def _start(self, carry, xs, consts) -> None:
        """A call's load of the caller's carry, constants and first chunk,
        and the prologue's replay."""
        with spans.span("scan.load"):
            self._load(carry, consts, xs, min(self.chunk, xs[0].shape[0]))
        with spans.span("scan.prologue"):
            self.prologue()
        count_replays(self.prologue_launches)
        self._fresh = None

    def _next_chunk(self, xs, b0: int, num: int) -> None:
        self.index.zero_()
        self._load_chunk(xs, b0, num)

    def _collect(self, b0: int, num: int, num_blocks: int) -> None:
        """After a chunk's replays: its outputs, and after the last chunk
        the carry, copied into the call's fresh buffers (made at the first
        chunk, while the card runs its blocks)."""
        if self._fresh is None:
            self._sizes, places = self._result_layout(num_blocks)
            self._fresh = {dtype: torch.empty(size, dtype=dtype, device=self.device)
                           for dtype, size in self._sizes}
            views = _views(self._fresh, places)
            self._final = views[:len(self.carry_specs)]
            self._stacked = views[len(self.carry_specs):]
        stacked = self._stacked
        dsts = stacked if num == num_blocks else [dst[b0:b0 + num] for dst in stacked]
        srcs = self._head(num)[0]
        if b0 + num == num_blocks:
            dsts = dsts + [self._fresh[dtype][:region.numel()]
                           for dtype, (_, _, region) in self._carry_groups.items()]
            srcs = srcs + [region for _, _, region in self._carry_groups.values()]
        _copy(dsts, srcs)

    def _results(self):
        """The call's final carry and stacked outputs, views of its fresh
        buffers."""
        if self._spare:
            # A chained call holds its input, the last call's results, while
            # it allocates its own: the first call leaves that much memory
            # in the allocator's cache, so the next asks the device for none.
            self._spare = False
            spare = [torch.empty(size, dtype=dtype, device=self.device)
                     for dtype, size in self._sizes]
            del spare
        final, stacked = self._final, self._stacked
        self._fresh = self._final = self._stacked = None
        return _rebuild(self.carry, iter(final)), _rebuild(self.out_tree, iter(stacked))

    def run(self, carry, xs, consts):
        """The scan over ``xs`` from ``carry`` with ``consts`` (the leaves of
        both): the prologue's replay, then one replay per block. The final
        carry and the stacked outputs come back as views of one fresh buffer
        per dtype."""
        num_blocks = xs[0].shape[0]
        self._start(carry, xs, consts)
        for b0, num in _chunks(num_blocks, self.chunk):
            if b0:
                with spans.span("scan.next_chunk"):
                    self._next_chunk(xs, b0, num)
            with spans.span("scan.replay"):
                for _ in range(num):
                    self.replay()
            count_replays(self.launches, num)
            _count_blocks(num, self.nodes)
            with spans.span("scan.collect"):
                self._collect(b0, num, num_blocks)
        with spans.span("scan.results"):
            return self._results()


class Part(NamedTuple):
    """One card's part of a `scan_mesh`: its carry and constants (trees of
    tensors) and its scanned inputs (``[B, ...]`` tensors), on any device
    (the call loads them onto ``device``), and the card."""

    carry: object
    xs: tuple
    consts: object
    device: torch.device


def _streams_of(devices: list):
    """Each CUDA card's current stream (None for a CPU device)."""
    return [torch.cuda.current_stream(d) if d.type == "cuda" else None for d in devices]


def _wait_all(waiter, streams) -> None:
    """``waiter`` waits for each other stream of ``streams`` (no host wait)."""
    for stream in streams:
        if waiter is not None and stream is not None and stream != waiter:
            waiter.wait_stream(stream)


class _MeshEntry:
    """One captured signature of `scan_mesh`: an `_Entry` per part (its
    buffers, its load and its prologue on its card) and, per group of parts,
    one graph of the group's block over its cards (`capture_mesh`; a group
    on one card, `capture`), each replayed once per block."""

    def __init__(self, step, prepare, parts: list, groups: list):
        self.groups = groups
        self.cards = [_Entry.__new__(_Entry) for _ in parts]
        self.chunk = min(_chunk_of(part.xs) for part in parts)
        for card, part in zip(self.cards, parts):
            with _on(part.device):
                card._setup(part.carry, part.xs, part.consts, part.device, self.chunk)
        with _warming():
            prepared, outs = self._warm_up(step, prepare)
        for card, part, prep, out in zip(self.cards, parts, prepared, outs):
            with _on(part.device):
                card._lay_out(prepare, part.carry, part.consts, part.xs, prep, out)
        self.replays = []
        for group in groups:
            devices = self._devices(group)
            self.replays.append(capture_counted(self._body(step, group),
                                                devices if len(devices) > 1 else devices[0]))
        self.nodes = sum(getattr(replay, "nodes", 0) for replay, _ in self.replays)

    def _devices(self, group: list) -> list:
        """The distinct cards of ``group``'s parts, its first part's first."""
        return list(dict.fromkeys(self.cards[i].device for i in group))

    def _warm_up(self, step, prepare):
        """Every part's ``prepare`` and one eager block of each group's body,
        each card's work on a side stream of its own; returns each part's
        prepared constants and output."""
        devices = list(dict.fromkeys(card.device for card in self.cards))
        computes = _streams_of(devices)
        sides = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]
        outs = []
        with contextlib.ExitStack() as stack:
            for side, compute in zip(sides, computes):
                if side is not None:
                    side.wait_stream(compute)
                    stack.enter_context(torch.cuda.stream(side))
            prepared = []
            for card in self.cards:
                with _on(card.device):
                    prepared.append(card.consts if prepare is None
                                    else prepare(card._warm_carry, card.consts))
            for group in self.groups:
                with _on(self.cards[group[0]].device):
                    _, group_outs = step(tuple(self.cards[i]._warm_carry for i in group),
                                         tuple(prepared[i] for i in group),
                                         tuple(self.cards[i]._block(step) for i in group))
                for out in group_outs:
                    _tensors(out)
                outs += list(group_outs)
        for side, compute in zip(sides, computes):
            if side is not None:
                compute.wait_stream(side)
        return prepared, outs

    def _body(self, step, group: list):
        cards = [self.cards[i] for i in group]
        sinks = [card._sink(step) for card in cards]
        takes_sink = getattr(step, "takes_sink", False)

        def body():
            args = (tuple(card.carry for card in cards), tuple(card.prepared for card in cards),
                    tuple(card._block(step) for card in cards))
            new, outs = step(*args, tuple(sinks)) if takes_sink else step(*args)
            for card, new_carry, out, sink in zip(cards, new, outs, sinks):
                with _on(card.device):
                    card._write(new_carry, out, sink)

        return body

    def run(self, parts: list) -> list:
        """The scan of every part (its carry's, constants' and inputs'
        leaves): each card's load and prologue on its card, then per block
        one replay of each group's graph, every group's before the next
        block's, each issued on its first card after its cards' loads; each
        group's first card's results copied after its last block (the
        other cards' replicas stay in their entries). The host waits on no
        card."""
        cards = self.cards
        firsts = [cards[group[0]] for group in self.groups]
        num_blocks = parts[0][1][0].shape[0]
        for card, (carry, xs, consts) in zip(cards, parts):
            with _on(card.device):
                card._start(carry, xs, consts)
        streams = [_streams_of(self._devices(group)) for group in self.groups]
        for b0, num in _chunks(num_blocks, self.chunk):
            if b0:
                for card, (_, xs, _) in zip(cards, parts):
                    with _on(card.device):
                        card._next_chunk(xs, b0, num)
            for group_streams in streams:
                _wait_all(group_streams[0], group_streams)
            for _ in range(num):
                for group, (replay, _) in zip(self.groups, self.replays):
                    with _on(cards[group[0]].device):
                        replay()
            for _, launches in self.replays:
                count_replays(launches, num)
            _count_blocks(num, self.nodes)
            for group_streams in streams:
                for stream in group_streams[1:]:
                    _wait_all(stream, group_streams[:1])
            for card in firsts:
                with _on(card.device):
                    card._collect(b0, num, num_blocks)
        results = []
        for card in firsts:
            with _on(card.device):
                results.append(card._results())
        return results


def _moved(tree, device: torch.device):
    """``tree`` on ``device``: one copy per dtype of its leaves' flat
    buffers (`_flat`), the leaves views of them."""
    leaves = _leaves(tree)
    if not leaves:
        return tree
    flat, places = _flat(leaves)
    return _rebuild(tree, iter(_views({dtype: x.to(device) for dtype, x in flat.items()},
                                      places)))


def loop_mesh(step, parts: list, prepare=None, group: int | None = None) -> list:
    """`scan_mesh`'s eager block loop: `loop` over the tuple of every
    part's carry, constants and inputs, each moved onto its card (the
    inputs contiguous, as an entry's chunk is), each part's ``prepare`` on
    its card, and per block ``step`` over each group of parts. Returns each
    group's first part's final carry and outputs stacked ``[B, ...]``."""
    groups = _groups(len(parts), group)
    moved = [(_moved(p.carry, p.device), tuple(x.to(p.device).contiguous() for x in p.xs),
              _moved(p.consts, p.device)) for p in parts]
    ends = list(itertools.accumulate(len(p.xs) for p in parts))

    def prepare_all(carries, consts):
        prepared = []
        for part, carry, const in zip(parts, carries, consts):
            with _on(part.device):
                prepared.append(const if prepare is None else prepare(carry, const))
        return tuple(prepared)

    def body(carries, consts, block):
        blocks = [block[end - len(p.xs):end] for p, end in zip(parts, ends)]
        new, outs = list(carries), [None] * len(parts)
        for members in groups:
            with _on(parts[members[0]].device):
                group_new, group_outs = step(*(tuple(arg[i] for i in members)
                                               for arg in (carries, consts, blocks)))
            for i, carry, out in zip(members, group_new, group_outs):
                new[i], outs[i] = carry, out
        return tuple(new), tuple(outs)

    carries, outs = loop(body, tuple(m[0] for m in moved), tuple(x for m in moved for x in m[1]),
                         tuple(m[2] for m in moved), prepare_all)
    return [(carries[g[0]], outs[g[0]]) for g in groups]


def _groups(num_parts: int, group: int | None) -> list:
    """The parts' indices in groups of ``group`` (every part in one group
    for None)."""
    size = num_parts if group is None else int(group)
    if size < 1 or num_parts % size:
        raise ValueError(f"{num_parts} parts do not fall into groups of {size}")
    return [list(range(g, g + size)) for g in range(0, num_parts, size)]


def _count_blocks(num: int, nodes: int) -> None:
    """``num`` blocks replayed, ``nodes`` device ops each."""
    scan.replays += num
    scan.replayed_nodes += num * nodes


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
    with _on(device):
        entry = _cached(_ENTRIES, device, signature,
                        lambda: _Entry(step, prepare, carry, xs, consts, device))
        return entry.run(carry_leaves, xs, const_leaves)


scan.captures = scan.evictions = scan.replays = scan.replayed_nodes = 0


def scan_mesh(step, parts: list, *, key, prepare=None, group: int | None = None) -> list:
    """`scan` of one block body over several cards in lockstep, as the JAX
    package's ``shard_map`` over a mesh runs one program on every device:
    ``parts`` is a `Part` per card (distinct cards, or a card named more
    than once), taken in groups of ``group`` consecutive parts (all in one
    by default) that exchange data inside a block, where parts of two
    groups exchange none; ``step(carries, consts, blocks) -> (carries,
    outs)`` one block of a group's parts, each argument and result a tuple
    over them in their order; ``prepare(carry, consts)``, if given, derives
    a part's constants once per call on its card (a card's prologue). A
    body marked `writes_outputs` takes a tuple of the parts' `Sink` as a
    fourth argument in the capture, and `reads_chunk` a `Chunk` per part.

    On CUDA cards (outside `eager()`) each part has an entry of its own,
    its buffers on its card, its carry loaded from the caller's in one copy
    per dtype where the caller's leaves lie as the entry lays them out (a
    mesh's cut: `_layout` of the carry's leaves in one buffer per dtype),
    its prologue replayed on its card; a group's block is one CUDA graph
    over its cards (`capture_mesh`; on one card, `capture`), so a block's
    cross-card copies and the orders they set between the cards' streams
    are the graph's own, and the host issues one replay per group and
    block. Else `loop_mesh`. A group's parts end as replicas of one another
    (each card of a channel shard closes the loop on its own): returns each
    group's first part's final carry and outputs stacked ``[B, ...]``, on
    its card (on the cards: views of one fresh buffer per dtype, laid out as
    a `scan` call's results; the other parts' final carries stay in their
    entries)."""
    devices = list(dict.fromkeys(p.device for p in parts))
    groups = _groups(len(parts), group)
    if not all(enabled(d) for d in devices):
        return loop_mesh(step, parts, prepare, group)
    if parts[0].xs[0].shape[0] == 0:
        raise ValueError("scan over zero blocks")
    flat = []
    signature = [_code(step), key, _code(prepare), len(groups)]
    for part in parts:
        carry_leaves, const_leaves = [], []
        signature += [part.device, _flatten(part.carry, carry_leaves), _specs(carry_leaves),
                      _flatten(part.consts, const_leaves), _specs(const_leaves),
                      _specs(part.xs, drop=1)]
        flat.append((carry_leaves, part.xs, const_leaves))
    with _on(devices[0]):
        entry = _cached(_ENTRIES, tuple(devices), tuple(signature),
                        lambda: _MeshEntry(step, prepare, parts, groups))
        return entry.run(flat)
