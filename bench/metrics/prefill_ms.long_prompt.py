"""The device time of the profiled call's prefill (4 rows of the longest
prompt): the ``serve.prefill`` span's ``device_ms``."""

from bench.spans import mean_device_ms


def read(rec):
    return mean_device_ms(rec, "generate", "serve.prefill")
