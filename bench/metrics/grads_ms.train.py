"""The device time of a profiled training step's loss and gradients: the
mean of the ``train.grads`` spans' ``device_ms``, one a step."""

from bench.spans import mean_device_ms


def read(rec):
    return mean_device_ms(rec, "train", "train.grads")
