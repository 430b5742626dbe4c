"""Device kernels a call: the kernels of the traced stretch over its
calls."""

def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["calls"]:
        return None
    t0, t1 = tr["span_us"]
    kernels = sum(1 for _, kind, s, _ in tr["device"]
                  if kind == "kernel" and t0 <= s < t1)
    return kernels / tr["calls"]

