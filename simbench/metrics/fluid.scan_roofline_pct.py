"""The fluid scans' least time over the device's busy time in the traced
fluid calls, in percent.  The least time of a scan is the larger of its
bytes at the HBM peak and its operations at the float32 peak, from the
frozen count of its shapes (``simbench.workcount``), whatever kernels ran."""

from simbench.workcount import least_seconds


def read(ctx):
    tr = ctx.trace
    spans = tr.spans.get("simbench.fluid", []) if tr is not None else []
    busy = sum(tr.busy_ns(a, b) for a, b in spans) * 1e-9 if spans else 0.0
    if busy <= 0:
        return None
    steps = ctx.cell.config["fluid"]["steps"]
    least = sum(least_seconds(F, L, nnz, steps)[0]
                for it in ctx.iterations for F, L, nnz in it.fluid_shapes)
    return 100.0 * least / busy
