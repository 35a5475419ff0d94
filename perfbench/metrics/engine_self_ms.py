"""engine_self_ms (engine): the engine's own host time a batch, its
measured wall less the executor's (``ServeStats.wall_s`` and
``SpmdExecutor.wall_s`` over the window's batches)."""


def read(run):
    batches = run.window_batches
    if not batches:
        return None
    own = sum(b.engine_wall_s - b.exec_wall_s for b in batches)
    return 1e3 * own / len(batches)
