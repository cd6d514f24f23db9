"""Host microseconds a memo DB lookup costs (the WL bucket, then the exact
isomorphism checks): the program's ``memo.lookup`` spans
(``repro_torch.obs``), their total over their calls.  None where the
program records no such span."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    rows = [v for (name, _), v in obs.table().items() if name == "memo.lookup"]
    calls = sum(v["calls"] for v in rows)
    if not calls:
        return None
    return sum(v["total_ns"] for v in rows) * 1e-3 / calls
