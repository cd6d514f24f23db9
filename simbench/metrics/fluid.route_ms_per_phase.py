"""Host milliseconds the fluid engine spends routing a phase's flows: the
program's ``fluid.route`` spans (``repro_torch.obs``) over the phases with
flows.  None where the program records no such span."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    rows = [v for (name, _), v in obs.table().items() if name == "fluid.route"]
    phases = sum(len(it.fluid_shapes) for it in ctx.iterations)
    if not rows or not phases:
        return None
    return sum(v["total_ns"] for v in rows) * 1e-6 / phases
