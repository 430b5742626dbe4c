"""The 95th percentile of every call's latency in the window, on the host
clock from the call's start until its result is ready."""

import statistics


def read(rec):
    lat = rec["window"]["latencies_s"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
