"""resolve_cpu_ms: the CPU seconds of the threads that ran resolve's
tail and the commit flush, over resolve_ms's windows, per batch
(resolve_cpu_s_total / batches), ms. None where the program has no such
counter."""
from benchmark import layers


def read(rec):
    if "resolve_cpu_s_total" not in rec["counters"]:
        return None
    return layers.per_batch_ms(rec, "resolve_cpu_s_total")
