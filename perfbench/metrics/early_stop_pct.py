"""early_stop_pct (ring): the early stop across dimension blocks: over the
traced batches' ``executor.search_batch`` spans, the tiles that the τ
test emptied before a ring stage after the first (``tiles_stopped``)
over the tiles that the probe mask left live at those stages
(``tiles_after_mask``). None where the program counts neither, or at one
dimension block, where there is no later stage."""

from perfbench.metrics.probe_select_ms import batch_spans


def read(run):
    spans = [s for b in batch_spans(run).values() for s in b
             if s.name == "executor.search_batch"]
    live = sum(s.counts.get("tiles_after_mask", 0) for s in spans)
    stopped = sum(s.counts.get("tiles_stopped", 0) for s in spans)
    return 100.0 * stopped / live if live > 0 else None
