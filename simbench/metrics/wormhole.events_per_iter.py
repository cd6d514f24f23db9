"""Events the wormhole kernel processed in an iteration
(``RunResult.events_processed``), the mean over the traced iterations."""


def read(ctx):
    ev = [it.events["wormhole"] for it in ctx.iterations if "wormhole" in it.events]
    return sum(ev) / len(ev) if ev else None
