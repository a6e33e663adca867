"""device_idle: share of the traced window with no device operation
running (profiler), %."""
from benchmark import layers


def read(rec):
    return layers.device_idle(rec)
