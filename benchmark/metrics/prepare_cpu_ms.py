"""prepare_cpu_ms: the scheduling thread's CPU seconds over the prepare
windows per batch (prepare_cpu_s_total / batches), ms; beside
prepare_ms, the part of prepare the thread ran. None where the program
has no such counter."""
from benchmark import layers


def read(rec):
    if "prepare_cpu_s_total" not in rec["counters"]:
        return None
    return layers.per_batch_ms(rec, "prepare_cpu_s_total")
