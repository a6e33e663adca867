"""fetch_wait_ms: the wall seconds the host spent in blocking reads of
the card per batch (fetch_wait_s_total / batches), ms. None where the
program has no such counter."""
from benchmark import layers


def read(rec):
    if "fetch_wait_s_total" not in rec["counters"]:
        return None
    return layers.per_batch_ms(rec, "fetch_wait_s_total")
