"""tile_skip_pct (ring): the executor's dead tiles over its tiles in the
window's batches (``tile_skipped`` / ``tile_total``)."""


def read(run):
    batches = run.window_batches
    total = sum(b.tile_total for b in batches)
    if not total:
        return None
    return 100.0 * sum(b.tile_skipped for b in batches) / total
