"""device_wait_pct (executor): the share of the executor's time in which
the host waits for the card's answer: the program's ``executor.wait``
spans (the first host read of the ring's output) over its
``executor.search_batch`` spans, summed over the traced batches."""

from perfbench.metrics.probe_select_ms import batch_spans


def read(run):
    spans = [s for b in batch_spans(run).values() for s in b]
    wall = sum(s.end_ns - s.start_ns for s in spans if s.name == "executor.search_batch")
    wait = [s.end_ns - s.start_ns for s in spans if s.name == "executor.wait"]
    return 100.0 * sum(wait) / wall if wait and wall > 0 else None

