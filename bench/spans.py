"""What the span metrics share: the program's spans
(``repro_torch.core.trace``), which it records while the profiled slice
runs, and only then in a run of ``bench/run.py``."""


def mean_device_ms(rec, driver, name):
    """The mean ``device_ms`` of the spans ``name`` of the profiled slice,
    in cells of ``driver``; None without a profiled slice, for a program
    that records no spans, or where no span has a device time (no card)."""
    if rec.get("driver") != driver or not rec.get("profile"):
        return None
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    ms = [s.device_ms for s in trace.spans()
          if s.name == name and s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
