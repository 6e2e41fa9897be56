"""The backend leaf's readers on hand-built spans and a hand-built device
trace of two workers: each value is worked out by hand below."""
import pytest

from portbench import run as R
from portbench.metrics import _leaf
from repro_torch.profiling import SpanEvent

SPANS = ["leaf_pack", "leaf_copy", "leaf_launch", "leaf_read"]


def _span(role, site, a, b, step=1):
    return role, SpanEvent(site, a, b - a, step=step, phase="decode")


def _data(leaf=True, trace=True):
    """Window [10, 20).  Two plans published in it (one more after it).
    worker0: device [10.1, 11.1] = pack [10.1, 10.3], copy [10.3, 10.4],
    launch [10.4, 10.5], read [10.5, 11.0], its own time [11.0, 11.1].
    worker1: device [12.1, 12.9] = pack 0.3, copy 0.1, launch 0.1, read
    0.2, own 0.1; device [10.45, 10.55] all read; device [11.05, 11.2] all
    pack.  One device span of worker0 before the window, all read."""
    s = [("engine", SpanEvent("shm_publish", t, 0.01, step=1))
         for t in (10.0, 12.0, 25.0)]
    s += [_span("worker0", "device", 5.0, 5.5),
          _span("worker0", "device", 10.1, 11.1),
          _span("worker1", "device", 12.1, 12.9),
          _span("worker1", "device", 10.45, 10.55),
          _span("worker1", "device", 11.05, 11.2)]
    if leaf:
        s += [_span("worker0", "leaf_read", 5.0, 5.5),
              _span("worker0", "leaf_pack", 10.1, 10.3),
              _span("worker0", "leaf_copy", 10.3, 10.4),
              _span("worker0", "leaf_launch", 10.4, 10.5),
              _span("worker0", "leaf_read", 10.5, 11.0),
              _span("worker1", "leaf_pack", 12.1, 12.4),
              _span("worker1", "leaf_copy", 12.4, 12.5),
              _span("worker1", "leaf_launch", 12.5, 12.6),
              _span("worker1", "leaf_read", 12.6, 12.8),
              _span("worker1", "leaf_read", 10.45, 10.55),
              _span("worker1", "leaf_pack", 11.05, 11.2)]
    data = {"t_open": 10.0, "t_close": 20.0,
            "spans": sorted(s, key=lambda p: p[1].t0)}
    if trace:
        # the card is busy in [10.2, 10.25] (under worker0's pack), all of
        # worker0's copy, [10.6, 11.0] (under its read) and all of worker1's
        # first device span
        data["device_trace"] = {"t0": 10.0, "t1": 20.0, "ops": [
            ("k", 10.2, 0.05), ("k", 10.3, 0.1), ("k", 10.6, 0.4),
            ("k", 12.1, 0.8)]}
    return data


def _read(name, data):
    return R.reader(R.ROOT, name)(data, None)


@pytest.mark.parametrize("site,seconds", [
    ("leaf_pack", 0.2 + 0.3 + 0.15), ("leaf_copy", 0.1 + 0.1),
    ("leaf_launch", 0.1 + 0.1), ("leaf_read", 0.5 + 0.2 + 0.1)])
def test_span_readers_sum_over_device_spans(site, seconds):
    # four device spans start in the window
    assert _read(f"{site}_ms_per_step.serve", _data()) == pytest.approx(
        seconds / 4 * 1e3)


def test_idle_counts_host_work_and_not_waits():
    """Idle under worker0's pack [10.1, 10.2] and [10.25, 10.3], under its
    launch [10.4, 10.5] (worker1 reads in half of it, and that does not
    take it off), and [11.0, 11.2] under worker0's own time and worker1's
    pack, counted once where they overlap; the idle [10.5, 10.6] under
    worker0's read does not count.  0.15 + 0.1 + 0.2 s over two plans."""
    assert _read("leaf_idle_ms_per_step.serve", _data()) == pytest.approx(
        (0.15 + 0.1 + 0.2) / 2 * 1e3)


def test_the_four_spans_fit_in_execute():
    data = _data()
    total = sum(_read(f"{s}_ms_per_step.serve", data) for s in SPANS)
    assert total <= _read("execute_ms_per_step.serve", data)


@pytest.mark.parametrize("name", [f"{s}_ms_per_step.serve" for s in SPANS]
                         + ["leaf_idle_ms_per_step.serve"])
def test_none_without_leaf_spans(name):
    """A program that records no leaf span (the device spans alone)."""
    assert _read(name, _data(leaf=False)) is None


def test_idle_none_without_a_trace():
    assert _read("leaf_idle_ms_per_step.serve", _data(trace=False)) is None
    assert _read("leaf_idle_ms_per_step.serve", dict(
        _data(), device_trace={"t0": 10.0, "t1": 20.0, "ops": []})) is None


def test_minus():
    assert _leaf.minus([(0, 10)], [(2, 3), (5, 6)]) == [(0, 2), (3, 5),
                                                        (6, 10)]
    assert _leaf.minus([(0, 2), (1, 4), (6, 8)], [(-1, 0.5), (3, 7)]) == [
        (0.5, 3), (7, 8)]
    assert _leaf.minus([(0, 1)], [(0, 1)]) == []
    assert _leaf.minus([(0, 1)], []) == [(0, 1)]
