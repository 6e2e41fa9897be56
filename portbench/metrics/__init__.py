"""One reader a per-layer metric, ``<metric>.py``, loaded by path: its
``read(data, job)`` returns the metric or None."""
