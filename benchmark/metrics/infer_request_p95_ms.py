"""The 95th percentile (nearest rank) over every request completed in the
window of the time from its video's ``run()`` call to its masks on the host."""

import math


def read(ctx):
    lat = ctx.get("latencies_ms") if ctx.get("kind") == "infer" else None
    if not lat:
        return None
    s = sorted(lat)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]
