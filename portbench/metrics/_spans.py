"""Shared arithmetic of the span readers: the program's spans (``role``,
``SpanEvent``) that start inside the window."""


def window_spans(data, site, role_prefix=""):
    t0, t1 = data["t_open"], data["t_close"]
    return [ev for role, ev in data["spans"]
            if ev.site == site and role.startswith(role_prefix)
            and not ev.instant and t0 <= ev.t0 < t1]


def per_step(data, sites, role_prefix="engine"):
    """The seconds of ``sites``' spans in the window per plan the engine
    published in it, in ms; None without spans."""
    steps = len(window_spans(data, "shm_publish", "engine"))
    if not steps:
        return None
    total = sum(ev.dur for site in sites
                for ev in window_spans(data, site, role_prefix))
    return total / steps * 1e3


def mean_ms(data, site, role_prefix):
    spans = window_spans(data, site, role_prefix)
    return sum(ev.dur for ev in spans) / len(spans) * 1e3 if spans else None
