"""gc_pause_share: the share of the window in which the interpreter's
garbage collector held the process (every thread stopped), read from
``gc.callbacks`` by the benchmark's host watch, %."""


def read(rec):
    host = rec.get("host")
    if not host or rec.get("seconds", 0) <= 0:
        return None
    return 100.0 * host["gc_s"] / rec["seconds"]
