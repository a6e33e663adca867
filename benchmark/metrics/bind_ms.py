"""bind_ms: the binder's store commit seconds per batch
(bind_s_total / batches), ms."""
from benchmark import layers


def read(rec):
    return layers.per_batch_ms(rec, "bind_s_total")
