"""Share of the profiled call in which no operation ran on the device."""

from bench.readers import idle_share


def read(rec):
    return idle_share(rec, "generate")
