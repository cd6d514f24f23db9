"""Host milliseconds a fluid phase costs: the traced fluid calls' wall
(their spans in the trace) less the device's busy time inside them, over
the phases with flows.  The engine reads every phase back before the next,
so host and device take turns."""


def read(ctx):
    tr = ctx.trace
    spans = tr.spans.get("simbench.fluid", []) if tr is not None else []
    phases = sum(len(it.fluid_shapes) for it in ctx.iterations)
    if not spans or not phases or tr.busy_s <= 0:
        return None
    host_ns = sum((b - a) - tr.busy_ns(a, b) for a, b in spans)
    return host_ns * 1e-6 / phases
