"""step_device_span_ms: the solo step's device span per batch, from the
program's CUDA events before its first launch and after the decision
pack (step_device_span_s_total / batches), ms. It includes the card's
waits for the host's launches inside the step (step_device_ms, the
profiler's busy time, does not). None where the program has no such
counter."""
from benchmark import layers


def read(rec):
    if "step_device_span_s_total" not in rec["counters"]:
        return None
    return layers.per_batch_ms(rec, "step_device_span_s_total")
