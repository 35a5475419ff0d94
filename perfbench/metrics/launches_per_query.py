"""launches_per_query (ring): device kernels launched inside the traced
batches over the queries those batches answered."""


def read(run):
    batches = run.traced_batches
    queries = sum(b.queries for b in batches)
    if not queries:
        return None
    return sum(run.trace.batch_launches[b.bid] for b in batches) / queries
