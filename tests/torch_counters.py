"""The port serve engine's counters as the reference keeps them."""


def reference_counters(stats):
    """A port serve engine's ``stats`` as the reference counts them:
    without the counters the reference does not keep
    (``repro_torch.serve.engine.PORT_COUNTERS``: the host times and
    ``generate``'s prefilled positions), which must be there."""
    from repro_torch.serve.engine import PORT_COUNTERS
    missing = set(PORT_COUNTERS) - set(stats)
    assert not missing, missing
    return {k: v for k, v in stats.items() if k not in PORT_COUNTERS}
