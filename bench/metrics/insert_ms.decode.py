"""The mean stream time of the profiled call's inserts: the
``serve.insert`` spans' ``device_ms`` (a prompt's eager prefill and the
writes of its cache rows into its slot), between two CUDA events on the
stream, so it includes the stream's idle between the insert's kernels
while the host launches them."""

from bench.spans import mean_device_ms


def read(rec):
    return mean_device_ms(rec, "batch_generate", "serve.insert")
