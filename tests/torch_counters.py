"""The port serve engine's counters as the reference keeps them."""


def reference_counters(stats):
    """A port serve engine's ``stats`` as the reference counts them:
    without the host times (``repro_torch.serve.engine.HOST_NS``), which
    the reference does not keep, and which must be there."""
    from repro_torch.serve.engine import HOST_NS
    missing = set(HOST_NS) - set(stats)
    assert not missing, missing
    return {k: v for k, v in stats.items() if k not in HOST_NS}
