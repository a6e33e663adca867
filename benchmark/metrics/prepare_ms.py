"""prepare_ms: the engine's prepare seconds per batch
(prepare_s_total / batches), ms."""
from benchmark import layers


def read(rec):
    return layers.per_batch_ms(rec, "prepare_s_total")
