"""The 95th percentile (nearest rank) over every request completed in the
window of its time from dispatch to its first token on the host, in
milliseconds.  The requests of one batch share their batch's time."""

import math


def read(run):
    ttft = sorted(1e3 * (r["t_first"] - r["t_dispatch"])
                  for r in run["records"] for _ in range(r["requests"]))
    return ttft[math.ceil(0.95 * len(ttft)) - 1]
