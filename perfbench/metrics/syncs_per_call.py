"""Host synchronizations a call, as PyTorch's sync debug mode counts them
inside the program's entry (the harness's own wait for the result is not
counted), averaged over the calls counted."""


def read(rec):
    syncs = rec.get("syncs") or []
    return sum(syncs) / len(syncs) if syncs else None
