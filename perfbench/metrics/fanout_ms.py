"""fanout_ms (front end): the time the front end takes to resolve a batch's
futures, their done-callbacks included: the program's ``frontend.fanout``
spans summed over the traced batches, over the batches."""

from perfbench.metrics.probe_select_ms import batch_spans


def read(run):
    batches = batch_spans(run)
    ns = [s.end_ns - s.start_ns for spans in batches.values() for s in spans
          if s.name == "frontend.fanout"]
    return sum(ns) / 1e6 / len(batches) if ns else None

