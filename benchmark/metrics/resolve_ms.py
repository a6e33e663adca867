"""resolve_ms: the engine's resolve and commit seconds per batch
(resolve_s_total / batches), ms."""
from benchmark import layers


def read(rec):
    return layers.per_batch_ms(rec, "resolve_s_total")
