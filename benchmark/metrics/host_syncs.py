"""host_syncs: the blocking reads of the card per batch
(host_syncs_total / batches). None where the program has no such
counter, or no batch ran."""


def read(rec):
    c = rec["counters"]
    if "host_syncs_total" not in c or not c.get("batches"):
        return None
    return c["host_syncs_total"] / c["batches"]
