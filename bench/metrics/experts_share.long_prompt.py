"""The share of the profiled call's prefill spent in the routed experts'
grouped products: the ``moe.experts`` spans' ``device_ms`` over the
``serve.prefill`` span's.  The decode steps' products are replays of a
captured graph and record no span."""


def read(rec):
    if rec.get("driver") != "generate" or not rec.get("profile"):
        return None
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    ms = {"moe.experts": 0.0, "serve.prefill": 0.0}
    for s in trace.spans():
        if s.name in ms and s.device_ms is not None:
            ms[s.name] += s.device_ms
    if ms["moe.experts"] <= 0 or ms["serve.prefill"] <= 0:
        return None
    return ms["moe.experts"] / ms["serve.prefill"]
