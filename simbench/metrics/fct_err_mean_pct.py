"""Mean per-flow FCT error of the wormhole results, in percent, against the
packet oracle on the same iterations (the comparison of ``simbench.checks``)."""


def read(ctx):
    c = ctx.checks.get("wormhole_fct_err_mean_pct")
    return None if c is None else c["value"]
