"""step_device_ms: device time of all operations but the hand-
written kernels per batch in the traced window (profiler), ms."""
from benchmark import layers


def read(rec):
    return layers.step_device_ms(rec)
