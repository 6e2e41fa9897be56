"""Captured CUDA graphs of a decode loop's step: the port's counterpart of
``jax.jit``'s compile cache around the reference's ``lax.scan`` loops
(``JaxBackend._decode_multi`` and its ``_scan_cache``;
``repro.models.model.decode_multi``).

A caller keeps its loop's inputs, carries and outputs in static buffers (a
``state`` object of its own), writes one step of the loop as a function of
those buffers, and asks a ``GraphCache`` to run the step ``n`` times.  On
the card the step is captured once per key with ``torch.cuda.CUDAGraph``
and replayed: one graph launch a step in place of the hundreds to
thousands of kernel launches the host would make one by one.  The key is
the caller's: shapes, the storage (``storage_key``) of every tensor the
step reads or writes in place, and the Python values the step closes over.
A graph reads and writes fixed addresses, so a tensor with new storage
takes a new capture.

The first run of a key warms up and captures.  The first of its ``n``
steps runs eagerly on a side stream, as PyTorch's recipe asks before a
capture (cuBLAS's handles and workspaces, the kernel library's one-time
attributes and occupancy queries, the kernels' split buffers sized for
this shape); it is a real step of the call, so nothing is undone.  The
step is then captured on that stream, and the graph replays the other
``n - 1``.  Warm-up, capture and replay run under
``torch.cuda.set_sync_debug_mode("error")``, so a host sync in the step
raises.  A failed capture raises: nothing falls back to an eager loop.

All graphs of one cache allocate from one private memory pool.  That is
safe because they replay one after another on one stream, never
concurrently, and no graph keeps an output in the pool: the outputs are
the caller's static buffers, made outside the capture.  The kernels' split
buffers in use at capture (``_build.SCRATCH``) are kept alive with the
graph, since a wrapper replaces its buffer when a larger shape needs more.

Launch books.  A replay runs no Python, so the kernel wrappers' launch
counters would stand still.  While capturing, each registered wrapper's
count (``_build.COUNTED``) rises by the launches it records into the
graph; the cache takes those back out (a captured kernel has not run) and
keeps them as the graph's books, and every replay adds them.  The
counters then count the kernels that ran, as ``torch.profiler`` counts
them, whichever wrappers the step reaches.
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Callable, Hashable

import torch

from repro_torch.kernels import _build


def storage_key(*tensors) -> tuple:
    """Where and how each tensor lies: (address, shape, strides, dtype)."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors)


@contextlib.contextmanager
def _no_sync():
    """Raise on any host sync inside the block."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class _Entry:
    """One key's state (the caller's static buffers), its graph once
    captured, its books ((wrapper, launches, launches by route) for each
    wrapper that launched inside the capture), the split buffers it uses,
    and the host seconds its capture took."""

    __slots__ = ("state", "graph", "books", "keep", "capture_s")

    def __init__(self, state):
        self.state = state
        self.graph = None
        self.books = ()
        self.keep = ()
        self.capture_s = 0.0


class GraphCache:
    """At most ``capacity`` captured steps, least recently used dropped
    first; each caller derives its bound from the keys its traffic can
    make.  ``entry(key, make_state)`` finds or makes a key's entry;
    ``run(entry, step, n)`` runs its step ``n`` times (see the module
    docstring).  ``captures``, ``replays`` and ``capture_s`` (host seconds
    spent capturing, instantiation included) add up over its life."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict = OrderedDict()
        self._stream = None
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def __len__(self) -> int:
        return len(self._entries)

    def entry(self, key: Hashable, make_state: Callable[[], object]
              ) -> _Entry:
        found = self._entries.get(key)
        if found is not None:
            self._entries.move_to_end(key)
            return found
        made = _Entry(make_state())
        self._entries[key] = made
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        return made

    def run(self, entry: _Entry, step: Callable[[], None], n: int) -> None:
        """``step`` ``n`` times on the current stream: replays of its
        graph, which the first run captures after running the first step
        as the warm-up."""
        if n < 1:
            return
        with _no_sync():
            if entry.graph is None:
                self._capture(entry, step)
                n -= 1
            for _ in range(n):
                entry.graph.replay()
        for wrapper, launched, routes in entry.books:
            wrapper.launches += launched * n
            for route, r_launched in routes.items():
                wrapper.launches_by_route[route] += r_launched * n
        self.replays += n

    def _capture(self, entry: _Entry, step: Callable[[], None]) -> None:
        current = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            step()                                  # the warm-up
            before = _build.launch_counts()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            graph.capture_begin(pool=self._pool)
            try:
                step()
            except BaseException:
                # leave the stream out of capture mode, then report the
                # step's own error
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            finally:
                books = _take_back(before)
            graph.capture_end()
        current.wait_stream(side)
        entry.graph, entry.books = graph, books
        entry.keep = tuple(_build.SCRATCH.values())
        entry.capture_s = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += entry.capture_s


def _take_back(before: list) -> tuple:
    """Reset every registered wrapper's counts to ``before``
    (``_build.launch_counts()`` taken earlier); return what each wrapper
    that launched since then added, as (wrapper, launches, by route)."""
    books = []
    for w, (n, routes) in zip(_build.COUNTED, before):
        launched = w.launches - n
        by_route = {r: c - routes[r]
                    for r, c in getattr(w, "launches_by_route", {}).items()
                    if c != routes[r]}
        if launched or by_route:
            books.append((w, launched, by_route))
        w.launches = n
        if routes:
            w.launches_by_route.update(routes)
    return tuple(books)
