"""The mean device time of the profiled call's decode steps: the
``serve.step`` spans' ``device_ms`` (a captured step's replay and the copy
of its tokens), at the longest prompt's positions."""

from bench.spans import mean_device_ms


def read(rec):
    return mean_device_ms(rec, "generate", "serve.step")
