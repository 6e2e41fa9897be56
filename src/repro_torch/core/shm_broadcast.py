"""Lock-free 1-writer-N-reader shared-memory broadcast ring (paper §V-B).

Mirrors vLLM V1's ``shm_broadcast.py`` MessageQueue on real POSIX shared
memory (/dev/shm via multiprocessing.shared_memory):

  * the writer (EngineCore) publishes one scheduling message per step;
  * N readers (one per GPU/TPU worker; N = tensor-parallel degree) consume
    every message;
  * synchronization is per-slot sequence numbers + per-reader ack counters —
    no mutexes; both sides busy-wait (vLLM's loop never sleeps, which is
    precisely the contention mechanism the paper measures);
  * every enqueue/dequeue records (wall time, spin iterations) so Fig. 13's
    contended-vs-uncontended dequeue distributions are measured, not modeled.

Layout (8-byte little-endian words):
  [0]  magic            [1] n_slots        [2] slot_bytes      [3] n_readers
  per-slot header (stride = 2 + n_readers words):
     seq | payload_len | ack[0..n_readers)
  payload region: n_slots x slot_bytes raw bytes.

Ring slot lifecycle (the invariants both sides rely on):

  * a message with sequence number ``seq`` lives in slot ``seq % n_slots``
    — placement is deterministic, readers never search;
  * the writer publishes payload-then-seq: it copies the payload and
    length into the slot FIRST and stores the slot's ``seq`` word last,
    so a reader that observes ``seq`` is guaranteed a complete payload
    (no torn reads without locks);
  * a reader consumes seq-then-ack: it spins until the slot's ``seq``
    matches the message it expects, copies the payload out, and only then
    advances its ack counter — acking is the one-way "I will never read
    this slot at this lap again" signal;
  * the writer may overwrite a slot holding ``seq`` only after EVERY
    reader's ack for that slot reached ``seq`` (one full lap behind):
    slow readers exert backpressure by parking the writer in a spin, and
    messages are never dropped or skipped;
  * each reader sees every message exactly once, in order — the ring is
    broadcast, not work-stealing; sequence numbers only grow, and the
    ack rule above makes falling a lap behind impossible by
    construction, so neither side checks for it at runtime.

Copied from ``src/repro/core/shm_broadcast.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

MAGIC = 0x5245_5052_4F51_0001
_WORD = 8


@dataclasses.dataclass
class OpStats:
    wall_s: float
    spins: int
    payload: int


class _Layout:
    def __init__(self, n_slots: int, slot_bytes: int, n_readers: int):
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self.n_readers = n_readers
        self.header_words = 4
        self.slot_header_words = 2 + n_readers
        self.meta_words = self.header_words + n_slots * self.slot_header_words
        self.payload_off = self.meta_words * _WORD
        self.total_bytes = self.payload_off + n_slots * slot_bytes

    def slot_word(self, slot: int, field: int) -> int:
        return self.header_words + slot * self.slot_header_words + field

    def payload_slice(self, slot: int) -> Tuple[int, int]:
        off = self.payload_off + slot * self.slot_bytes
        return off, off + self.slot_bytes


class ShmBroadcastQueue:
    """Owner-side handle; see ``writer()`` / ``reader(i)``."""

    def __init__(self, shm: shared_memory.SharedMemory, layout: _Layout,
                 owner: bool):
        self._shm = shm
        self._layout = layout
        self._owner = owner
        self._words = memoryview(shm.buf).cast("Q")

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, n_readers: int, n_slots: int = 8,
               slot_bytes: int = 1 << 16,
               name: Optional[str] = None) -> "ShmBroadcastQueue":
        layout = _Layout(n_slots, slot_bytes, n_readers)
        shm = shared_memory.SharedMemory(
            create=True, size=layout.total_bytes, name=name)
        q = cls(shm, layout, owner=True)
        w = q._words
        for i in range(layout.meta_words):
            w[i] = 0
        w[0], w[1], w[2], w[3] = MAGIC, n_slots, slot_bytes, n_readers
        return q

    @classmethod
    def attach(cls, name: str) -> "ShmBroadcastQueue":
        shm = shared_memory.SharedMemory(name=name)
        words = memoryview(shm.buf).cast("Q")
        assert words[0] == MAGIC, "not a repro broadcast queue"
        layout = _Layout(int(words[1]), int(words[2]), int(words[3]))
        return cls(shm, layout, owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self) -> None:
        self._words.release()
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    # -- endpoints -----------------------------------------------------------

    def writer(self) -> "Writer":
        return Writer(self)

    def reader(self, idx: int) -> "Reader":
        assert 0 <= idx < self._layout.n_readers
        return Reader(self, idx)


class CompletionBoard:
    """Per-worker last-completed-step counters in shared memory.

    Models the host-side half of the collective barrier: the engine spins
    until every rank has posted step completion (paper §V-A — one late rank
    stalls the group).
    """

    def __init__(self, shm: shared_memory.SharedMemory, n: int, owner: bool):
        self._shm = shm
        self._n = n
        self._owner = owner
        self._words = memoryview(shm.buf).cast("Q")

    @classmethod
    def create(cls, n_workers: int) -> "CompletionBoard":
        shm = shared_memory.SharedMemory(create=True, size=n_workers * _WORD)
        b = cls(shm, n_workers, owner=True)
        for i in range(n_workers):
            b._words[i] = 0
        return b

    @classmethod
    def attach(cls, name: str, n_workers: int) -> "CompletionBoard":
        return cls(shared_memory.SharedMemory(name=name), n_workers,
                   owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def mark(self, idx: int, step: int) -> None:
        self._words[idx] = step

    def wait_all(self, step: int, *, timeout: float = 120.0,
                 yield_every: int = 0) -> OpStats:
        t0 = time.perf_counter()
        spins = 0
        while True:
            if all(self._words[i] >= step for i in range(self._n)):
                break
            spins += 1
            if yield_every and spins % yield_every == 0:
                os.sched_yield()
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"barrier stalled at step {step}: "
                                   f"{[self._words[i] for i in range(self._n)]}")
        return OpStats(time.perf_counter() - t0, spins, 0)

    def close(self) -> None:
        self._words.release()
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


class _Endpoint:
    def __init__(self, q: ShmBroadcastQueue):
        self.q = q

    def _spin_hook(self, spins: int, yield_every: int) -> None:
        if yield_every and spins % yield_every == 0:
            os.sched_yield()


class Writer(_Endpoint):
    def __init__(self, q: ShmBroadcastQueue):
        super().__init__(q)
        self.seq = 0

    def enqueue(self, payload: bytes, *, timeout: float = 60.0,
                yield_every: int = 0) -> OpStats:
        lay = self.q._layout
        w = self.q._words
        assert len(payload) <= lay.slot_bytes, "payload exceeds slot"
        seq = self.seq + 1
        slot = (seq - 1) % lay.n_slots
        need = seq - lay.n_slots       # every ack must have reached this
        t0 = time.perf_counter()
        spins = 0
        if need > 0:
            base = lay.slot_word(slot, 2)
            while True:
                ok = all(w[base + r] >= need for r in range(lay.n_readers))
                if ok:
                    break
                spins += 1
                self._spin_hook(spins, yield_every)
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError(f"writer stalled at seq {seq}")
        self.seq = seq
        lo, _ = lay.payload_slice(slot)
        self.q._shm.buf[lo:lo + len(payload)] = payload
        w[lay.slot_word(slot, 1)] = len(payload)
        w[lay.slot_word(slot, 0)] = seq           # publish (release)
        return OpStats(time.perf_counter() - t0, spins, len(payload))


class Reader(_Endpoint):
    def __init__(self, q: ShmBroadcastQueue, idx: int):
        super().__init__(q)
        self.idx = idx
        self.seq = 0
        self.stats: List[OpStats] = []     # the worker reports dequeue_wall

    def dequeue(self, *, timeout: float = 60.0,
                yield_every: int = 0) -> Tuple[bytes, OpStats]:
        lay = self.q._layout
        w = self.q._words
        self.seq += 1
        slot = (self.seq - 1) % lay.n_slots
        t0 = time.perf_counter()
        spins = 0
        seq_word = lay.slot_word(slot, 0)
        while w[seq_word] < self.seq:          # acquire
            spins += 1
            self._spin_hook(spins, yield_every)
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(
                    f"reader {self.idx} stalled at seq {self.seq}")
        n = int(w[lay.slot_word(slot, 1)])
        lo, _ = lay.payload_slice(slot)
        payload = bytes(self.q._shm.buf[lo:lo + n])
        w[lay.slot_word(slot, 2 + self.idx)] = self.seq   # ack
        st = OpStats(time.perf_counter() - t0, spins, n)
        self.stats.append(st)
        return payload, st
