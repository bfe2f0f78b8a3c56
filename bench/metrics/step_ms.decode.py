"""The mean device time of the profiled call's ragged decode steps: the
``serve.step`` spans' ``device_ms`` (the replay of the captured step and
the copy of its tokens)."""

from bench.spans import mean_device_ms


def read(rec):
    return mean_device_ms(rec, "batch_generate", "serve.step")
