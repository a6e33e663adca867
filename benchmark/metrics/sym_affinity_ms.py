"""sym_affinity_ms: the host's seconds per batch on upstream's symmetric
InterPodAffinity term (sym_affinity_s_total / batches: the encoder's
matching and table build and the cache's term index), ms. None where the
program keeps no such counter."""
from benchmark import layers


def read(rec):
    if "sym_affinity_s_total" not in rec["counters"]:
        return None
    return layers.per_batch_ms(rec, "sym_affinity_s_total")
