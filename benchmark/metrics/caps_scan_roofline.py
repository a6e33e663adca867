"""caps_scan_roofline: caps_scan.cu's least time at its launched
shape over its mean device time (profiler), %."""
from benchmark import layers


def read(rec):
    return layers.kernel_roofline(rec, "caps_scan_kernel", layers.caps_bound_s)
