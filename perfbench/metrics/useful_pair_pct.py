"""useful_pair_pct (ring): the share of the scored work that a query
needed: over the traced batches' ``executor.search_batch`` spans, the
(query, row, dimension block) triples of each query's probed lists
(``pairs_needed``) over those of the tiles the distance kernel scored
(``pairs_scored``)."""

from perfbench.metrics.probe_select_ms import batch_spans


def read(run):
    spans = [s for b in batch_spans(run).values() for s in b
             if s.name == "executor.search_batch"]
    scored = sum(s.counts.get("pairs_scored", 0) for s in spans)
    needed = sum(s.counts.get("pairs_needed", 0) for s in spans)
    return 100.0 * needed / scored if scored > 0 else None

