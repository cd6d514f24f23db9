"""Share of the packet event loop's time spent in the Wormhole kernel's
call-outs, in percent: the ``wormhole.*`` spans whose parent is
``packet.loop`` over the ``packet.loop`` spans (``repro_torch.obs``),
each total less the recording of the spans inside it.
None where the program records no such span."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    table = obs.table()
    loop = sum(v["total_ns"] for (name, _), v in table.items() if name == "packet.loop")
    if loop <= 0:
        return None
    callouts = sum(v["total_ns"] for (name, parent), v in table.items()
                   if name.startswith("wormhole.") and parent == "packet.loop")
    return 100.0 * callouts / loop
