"""Shared arithmetic of the backend leaf's readers: the leaf's trace-only
spans (``leaf_pack``, ``leaf_copy``, ``leaf_launch``, ``leaf_read``), which
the program records inside each worker's ``device`` span.  A program
without them gives every reader None."""
from portbench import stats
from portbench.metrics import _spans

# the leaf spans in which the host waits on the card
WAITS = ("leaf_copy", "leaf_read")


def ms_per_device_span(data, site):
    """The workers' ``site`` spans that start in the window, summed, over
    the workers' ``device`` spans that start in the window, in ms."""
    spans = _spans.window_spans(data, site, "worker")
    devices = _spans.window_spans(data, "device", "worker")
    if not spans or not devices:
        return None
    return sum(ev.dur for ev in spans) / len(devices) * 1e3


def minus(ivs, cut):
    """The union of ``ivs`` less the union of ``cut``, as intervals."""
    out = []
    cut = stats.merge(cut)
    j = 0
    for a, b in stats.merge(ivs):
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < b:
            if cut[k][0] > a:
                out.append((a, cut[k][0]))
            a = max(a, cut[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def idle_ms_per_step(data):
    """Seconds of the window in which the card runs no operation and some
    worker is in its ``device`` span but in none of its ``WAITS`` spans,
    per plan the engine published in the window, in ms."""
    tr = data.get("device_trace")
    if not tr or not tr["ops"]:
        return None
    steps = len(_spans.window_spans(data, "shm_publish", "engine"))
    by_role = {}
    for role, ev in data["spans"]:
        if role.startswith("worker") and not ev.instant:
            by_role.setdefault(role, []).append(ev)
    if not steps or not any(ev.site == "leaf_pack"
                            for evs in by_role.values() for ev in evs):
        return None
    host = []
    for evs in by_role.values():
        host += minus([(ev.t0, ev.t0 + ev.dur) for ev in evs
                       if ev.site == "device"],
                      [(ev.t0, ev.t0 + ev.dur) for ev in evs
                       if ev.site in WAITS])
    idle = minus(host, [(s, s + d) for _, s, d in tr["ops"]])
    return stats.covered(idle, tr["t0"], tr["t1"]) / steps * 1e3
