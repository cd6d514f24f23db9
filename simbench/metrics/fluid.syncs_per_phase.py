"""Times a fluid phase makes the host wait on the card's stream: the
program's ``fluid.syncs`` counter (``repro_torch.obs``) over the phases
with flows; 0 where the phases ran and nothing synced (the CPU).  None
where the program records no ``fluid.route`` span."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    table = obs.table()
    phases = sum(len(it.fluid_shapes) for it in ctx.iterations)
    if not phases or not any(name == "fluid.route" for name, _ in table):
        return None
    return sum(v["count"] for (name, _), v in table.items() if name == "fluid.syncs") / phases
