"""shortlist_select_roofline: shortlist_select.cu's least time at
its launched shape over its mean device time (profiler), %."""
from benchmark import layers


def read(rec):
    return layers.kernel_roofline(rec, "shortlist_select_kernel",
                                  layers.select_bound_s)
