"""batch_fill: pods per batch (pods_seen / batches) over
max_batch_size (engine counters, whole window)."""
from benchmark import layers


def read(rec):
    return layers.batch_fill(rec)
