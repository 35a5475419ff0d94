"""qps: queries answered in the window (the batches that completed in
it) over the window's seconds. The window opens and closes at batch
completions, so no batch is counted in part."""


def read(run):
    batches = run.window_batches
    if not batches:
        return None
    return sum(b.queries for b in batches) / run.window_s
