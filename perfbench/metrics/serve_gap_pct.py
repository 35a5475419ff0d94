"""serve_gap_pct (front end): the share of the window in which no
``search_batch`` ran: 1 - (the engine's measured wall of the window's
batches, ``ServeStats``) / the window."""


def read(run):
    batches = run.window_batches
    if not batches:
        return None
    return 100.0 * (1.0 - sum(b.engine_wall_s for b in batches) / run.window_s)
