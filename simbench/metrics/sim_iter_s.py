"""Host wall time to simulate one training iteration: the whole measured
window over the iterations completed in it (each ends in a device sync)."""


def read(ctx):
    return ctx.window_s / len(ctx.iterations)
