"""request_p95_ms (front end): the 95th percentile (numpy's linear rule)
of request latency over every request completed in the window, a
request being one client's call, timed from its send to its last
answer. A per-layer reading: where the host sets the pace, the tail is
no end-to-end metric."""

import numpy as np


def read(run):
    lat = [(r.done_s - r.send_s) * 1e3 for r in run.window_requests]
    return float(np.percentile(lat, 95)) if lat else None
