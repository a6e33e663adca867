"""gc_pause_ms: the interpreter's garbage-collector pauses per batch,
read from the program's own collector watch (gc_pause_s_total /
batches), ms; gc_pause_share reads the same pauses from outside. None
where the program has no such counter."""
from benchmark import layers


def read(rec):
    if "gc_pause_s_total" not in rec["counters"]:
        return None
    return layers.per_batch_ms(rec, "gc_pause_s_total")
