"""step_ms: the engine's step seconds per batch on the host clock
(step_s_total / batches), ms."""
from benchmark import layers


def read(rec):
    return layers.per_batch_ms(rec, "step_s_total")
