"""Share of the memo DB's lookups that hit, in the traced iterations
(``kernel_report`` ``run_db_hits`` over ``run_db_lookups``)."""


def read(ctx):
    reps = [it.kernel_report["wormhole"] for it in ctx.iterations if "wormhole" in it.kernel_report]
    lookups = sum(r.get("run_db_lookups", 0) for r in reps)
    if not lookups:
        return None
    return 100.0 * sum(r.get("run_db_hits", 0) for r in reps) / lookups
