"""Host microseconds the packet event loop itself costs an event: the self
time of the program's ``packet.loop`` spans (``repro_torch.obs``), the
Wormhole kernel's call-outs and the spans' own recording left out, over
the wormhole events of the traced iterations.  None where the program records no such span."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    rows = [v for (name, _), v in obs.table().items() if name == "packet.loop"]
    events = sum(it.events.get("wormhole", 0) for it in ctx.iterations)
    if not rows or not events:
        return None
    return sum(v["self_ns"] for v in rows) * 1e-3 / events
