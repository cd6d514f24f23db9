"""Process start to the first timed iteration: imports, the card, the
program's libraries (built on a checkout's first run), the warm iteration
and, in a warm-memo cell, the warmed DB."""


def read(ctx):
    return ctx.setup_s
