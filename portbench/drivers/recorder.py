"""What the benchmark watches inside a serving worker.

The engine's workers build their backend through
``repro_torch.backend.make_backend``, after the fork.  The serving harness
puts ``recording(...)`` in its place before the engine starts, so each
worker builds the program's own backend and gets it back wrapped in a
``Recorder``: it hands every plan to the backend unchanged and keeps the
plan and the backend's result.  When the worker process ends, the
recorder turns what it kept into each request's token stream (the tokens
written at each position, and each token sampled with the length of the
stream it was sampled over) and writes it to the run's directory, where
the serving harness reads it to check the served tokens against the plain
reference.  Keeping a plan and its result is one list append: nothing is
computed on the timed path.

Before the first plan it also makes every CUDA graph the backend's k-step
loop can need in the window (the loop captures one graph per bucket of
(rows, table width) at first use), through the backend's own ``execute``
with k-step plans whose rows have no budget, so that nothing is captured
inside the window.  It does not copy the backend's bucketing: it runs a
plan at every row count and at every table width up to the cell's
largest, watches the backend's own count of captures to learn which of
them began a new bucket, and runs one plan for each pair of those.  The
harness reports the graphs captured later, inside the window
(``captures_in_window``).

In a traced run it traces the worker's device activity with
``torch.profiler`` (device activity only) and keeps the kernels'
intervals on the host's monotonic clock.

The records are written when the harness, the window's requests served,
raises ``flush`` and sends one last request: the worker writes them while
it executes that plan, in its main thread.  A worker that never gets
there writes them at exit.
"""
from __future__ import annotations

import multiprocessing.util
import os
import pickle
import threading
import time
from typing import Callable, Dict, List, Optional

# marks a run's fake rows: below any request id the engine hands out
FAKE_RID = -(1 << 40)

def streams(log) -> Dict[int, list]:
    """Each request's events in order from (plan, result) pairs: ("w",
    start, tokens) for tokens written at positions start.., ("e", n, tok)
    for a token sampled over the first n positions."""
    out: Dict[int, list] = {}
    length: Dict[int, int] = {}
    for plan, res in log:
        for rid in plan.preempted:
            length.pop(rid, None)
        for rid, start, n in plan.prefill:
            toks = [int(t) for t in plan.new_tokens.get(rid, [])]
            ev = out.setdefault(rid, [])
            ev.append(("w", start, toks))
            length[rid] = start + n
            if rid in res.tokens and not (plan.num_steps > 1
                                          and rid in plan.decode):
                ev.append(("e", start + n, int(res.tokens[rid])))
        if plan.speculative:
            continue
        if plan.num_steps > 1:
            steps = res.token_steps or []
            for rid in plan.decode:
                pos = length.get(rid, 0)
                fed = int(plan.new_tokens.get(rid, [0])[0])
                ev = out.setdefault(rid, [])
                for row in steps:
                    if rid not in row:
                        break
                    ev.append(("w", pos, [fed]))
                    fed = int(row[rid])
                    pos += 1
                    ev.append(("e", pos, fed))
                length[rid] = pos
        else:
            for rid in plan.decode:
                pos = length.get(rid, 0)
                fed = int(plan.new_tokens.get(rid, [0])[0])
                ev = out.setdefault(rid, [])
                ev.append(("w", pos, [fed]))
                length[rid] = pos + 1
                if rid in res.tokens:
                    ev.append(("e", pos + 1, int(res.tokens[rid])))
    return out


class Recorder:
    """The program's backend, its plans and results kept (module
    docstring)."""

    def __init__(self, inner, out_dir: str, *, trace: bool,
                 buckets: Optional[Dict] = None,
                 fault: Optional[Callable] = None, flush=None):
        self.inner = inner
        self._out_dir = out_dir
        self._log: list = []
        self._fault = fault
        self._prof = None
        self._dumped = threading.Lock()
        if buckets is not None:
            self._capture(**buckets)
        graphs = getattr(inner, "graphs", None)
        self.captures_ready = graphs.captures if graphs is not None else 0
        self.t_ready = time.perf_counter()
        if trace and inner.device.type == "cuda":
            self._start_trace()
        self._flush = flush
        multiprocessing.util.Finalize(None, self._dump, exitpriority=10)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute(self, plan, block_tables=None):
        res = (self.inner.execute(plan) if block_tables is None
               else self.inner.execute(plan, block_tables))
        if self._fault is not None:
            res = self._fault(plan, res)
        self._log.append((plan, res))
        if self._flush is not None and self._flush.value:
            # the window's requests are served and this is the harness's
            # last plan: write the records now, in the thread that
            # started the trace, and not in the worker's exit, which the
            # engine's shutdown may cut short
            self._dump()
        return res

    # -- set-up --------------------------------------------------------------

    def _capture(self, *, rows: int, blocks: int, steps: int) -> None:
        """Capture every bucket a k-step plan of up to ``rows`` rows and
        ``blocks`` blocks a row can meet (module docstring)."""
        graphs = getattr(self.inner, "graphs", None)
        if steps < 2 or graphs is None:
            return
        from repro_torch.serving.scheduler import StepPlan

        def run(n_rows: int, width: int) -> bool:
            before = graphs.captures
            rids = [FAKE_RID - i for i in range(n_rows)]
            self.inner.execute(StepPlan(
                0, [], rids, [],
                block_tables={r: [0] * width for r in rids},
                new_tokens={r: [0] for r in rids}, num_steps=steps,
                decode_steps={r: 0 for r in rids}))
            for r in rids:
                self.inner.release(r)
            return graphs.captures > before

        run(1, 1)
        # where a count or a width captures, a bucket begins
        row_starts = [r for r in range(2, rows + 1) if run(r, 1)]
        width_starts = [w for w in range(2, blocks + 1) if run(1, w)]
        for r in row_starts:
            for w in width_starts:
                run(r, w)

    def _start_trace(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    # -- at exit -------------------------------------------------------------

    def _dump(self) -> None:
        """Write the records once (a later call does nothing): the token
        streams first, then, in a traced run, the device operations."""
        if not self._dumped.acquire(blocking=False):
            return
        graphs = getattr(self.inner, "graphs", None)
        rec = {"pid": os.getpid(), "streams": streams(self._log),
               "captures_ready": self.captures_ready,
               "captures": graphs.captures if graphs is not None else 0,
               "t_ready": self.t_ready}
        if self.inner.device.type == "cuda":
            import torch
            rec["device_name"] = torch.cuda.get_device_name()
            rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        self._write("worker", rec)
        if self._prof is not None:
            self._prof.stop()
            self._write("trace", device_ops(self._prof))

    def _write(self, kind: str, obj) -> None:
        path = os.path.join(self._out_dir, f"{kind}-{os.getpid()}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(obj, f)
        os.replace(path + ".part", path)


def device_ops(prof) -> list:
    """(name, start, seconds) of every device operation a stopped
    ``torch.profiler`` session holds, its start on the host's monotonic
    clock (``time.perf_counter``): the trace's clock is the Unix epoch's
    nanoseconds, so the two are tied by reading both clocks at once."""
    import torch
    shift = time.perf_counter_ns() - time.time_ns()
    return [(e.name(), (e.start_ns() + shift) * 1e-9, e.duration_ns() * 1e-9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def recording(make_backend, out_dir: str, *, trace: bool,
              buckets: Optional[Dict] = None,
              fault: Optional[Callable] = None, flush=None):
    """A ``make_backend`` that returns the program's backend wrapped in a
    ``Recorder``."""
    def make(*args, **kwargs):
        return Recorder(make_backend(*args, **kwargs), out_dir, trace=trace,
                        buckets=buckets, fault=fault, flush=flush)
    return make
