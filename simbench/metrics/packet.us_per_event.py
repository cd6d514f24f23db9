"""Host microseconds a processed event costs under the wormhole kernel: the
wall of the traced iterations' wormhole calls (the harness's clock around
each) over their events.  It tells fewer events from cheaper events."""


def read(ctx):
    its = [it for it in ctx.iterations if it.events.get("wormhole")]
    if not its:
        return None
    return 1e6 * sum(it.spans["wormhole"] for it in its) / sum(it.events["wormhole"] for it in its)
