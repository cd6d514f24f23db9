"""Host milliseconds the program spends building an iteration's phase DAG
(``WorkloadSpec.build_phases``, every flow of every phase): the program's
``workload.build`` spans (``repro_torch.obs``), their total over the
window's iterations.  None where the program records no such span."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    rows = [v for (name, _), v in obs.table().items() if name == "workload.build"]
    if not rows or not ctx.iterations:
        return None
    return sum(v["total_ns"] for v in rows) * 1e-6 / len(ctx.iterations)
