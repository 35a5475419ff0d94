"""search_roofline (kernels): the least time of the needed work of
the traced batches (``perfbench/work.py``: 2 D FLOPs per probed row and
query, each probed list's rows read once a batch, at the card's
data-sheet peaks) over the device time inside those batches."""


def read(run):
    batches = [b for b in run.traced_batches if b.least_s is not None]
    device_s = sum(run.trace.batch_device_s[b.bid] for b in batches)
    if not batches or device_s <= 0:
        return None
    return 100.0 * sum(b.least_s for b in batches) / device_s
