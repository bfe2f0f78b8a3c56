"""The device time of a profiled training step's AdamW update (the global
norm, the clip and the per-tensor loop): the mean of the ``train.adamw``
spans' ``device_ms``, one a step."""

from bench.spans import mean_device_ms


def read(rec):
    return mean_device_ms(rec, "train", "train.adamw")
