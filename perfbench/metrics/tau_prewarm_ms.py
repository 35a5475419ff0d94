"""tau_prewarm_ms (executor): the time of the tau prewarm a batch (the
sample rows' host gather, their upload and scoring): the program's
``executor.prewarm_tau`` spans summed over the traced batches, over the
batches."""

from perfbench.metrics.probe_select_ms import batch_spans


def read(run):
    batches = batch_spans(run)
    ns = [s.end_ns - s.start_ns for spans in batches.values() for s in spans
          if s.name == "executor.prewarm_tau"]
    return sum(ns) / 1e6 / len(batches) if ns else None

