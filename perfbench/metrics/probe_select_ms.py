"""probe_select_ms (engine): the host time of probe selection a batch: the
program's ``engine.assign_queries`` spans summed over the traced batches,
over the batches.

:func:`batch_spans` picks the program's spans of the traced batches for
every reader of them."""


def read(run):
    batches = batch_spans(run)
    ns = [s.end_ns - s.start_ns for spans in batches.values() for s in spans
          if s.name == "engine.assign_queries"]
    return sum(ns) / 1e6 / len(batches) if ns else None


def batch_spans(run):
    """The program's spans (``repro_torch.tracing``) of each traced
    batch, by batch id: its ``frontend.batch`` span, the newest where
    several share the id, and every span of the id inside it. Empty
    where the program has no tracer or recorded nothing."""
    try:
        from repro_torch import tracing
    except ImportError:
        return {}
    want = {b.bid for b in run.traced_batches}
    spans = tracing.spans()
    roots = {s.bid: s for s in spans if s.name == "frontend.batch" and s.bid in want}
    out = {bid: [] for bid in roots}
    for s in spans:
        root = roots.get(s.bid)
        if root is not None and root.start_ns <= s.start_ns and s.end_ns <= root.end_ns:
            out[s.bid].append(s)
    return out
