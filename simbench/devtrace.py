"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer readers and the result's ``breakdown`` need.

The harness marks each timed iteration, and each backend call inside it,
with a ``simbench.*`` span; the profiler's own host events (torch
operations, launches) name what the host did inside them.  Device activity is every event the profiler puts on the CUDA device
(kernels, copies, fills), merged into busy intervals.  The reduction reads
the profiler's event list once and builds no per-event Python objects
beyond a tuple.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

MAIN_SPAN = "simbench.iteration"
SPAN_PREFIX = "simbench."
TOP = 10


class Trace:
    """Busy intervals of the device, the harness's spans, and the host's
    work in the idle gaps, over the traced window (nanoseconds)."""

    def __init__(self, device: list[tuple[int, int, str]], host: list[tuple[int, int, str]]) -> None:
        self.spans: dict[str, list[tuple[int, int]]] = defaultdict(list)
        for a, b, name in sorted(host):
            if name.startswith("simbench."):
                self.spans[name].append((a, b))
        its = self.spans.get(MAIN_SPAN, [])
        self.window = (its[0][0], its[-1][1]) if its else (0, 0)
        lo, hi = self.window
        self.op_seconds: dict[str, float] = defaultdict(float)
        merged: list[list[int]] = []
        for a, b, name in sorted(device):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            self.op_seconds[name] += (b - a) * 1e-9
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.prefix = [0]
        for a, b in merged:
            self.prefix.append(self.prefix[-1] + b - a)
        self.gaps = self._label_gaps(host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns(*self.window) * 1e-9

    def busy_ns(self, a: int, b: int) -> int:
        """Device busy time inside [a, b]."""
        if b <= a or not self.starts:
            return 0
        i = bisect.bisect_right(self.ends, a)          # first interval ending after a
        j = bisect.bisect_left(self.starts, b)         # intervals starting before b
        if j <= i:
            return 0
        total = self.prefix[j] - self.prefix[i]
        total -= max(0, a - self.starts[i])
        total -= max(0, self.ends[j - 1] - b)
        return max(0, total)

    def _label_gaps(self, host: list[tuple[int, int, str]]) -> dict[str, float]:
        """Idle seconds inside the window, summed by what the host was doing
        at each gap's midpoint: the open ``simbench.`` spans and
        the innermost torch operation, if any."""
        lo, hi = self.window
        edges = [lo] + [x for a, b in zip(self.starts, self.ends) for x in (a, b)] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        events = sorted(host, key=lambda e: (e[0], -e[1]))
        out: dict[str, float] = defaultdict(float)
        stack: list[tuple[int, int, str]] = []
        j = 0
        for a, b in gaps:
            m = (a + b) // 2
            while j < len(events) and events[j][0] <= m:
                while stack and stack[-1][1] < events[j][0]:
                    stack.pop()
                stack.append(events[j])
                j += 1
            while stack and stack[-1][1] < m:
                stack.pop()
            spans = [n for _, _, n in stack if n.startswith(SPAN_PREFIX)]
            label = "/".join(spans) or "outside the iterations"
            if stack and not stack[-1][2].startswith(SPAN_PREFIX):
                label += ": " + stack[-1][2]
            elif spans:
                label += ": python"
            out[label] += (b - a) * 1e-9
        return out

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.op_seconds), "idle_gaps": top(self.gaps)}


def from_profiler(prof) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile``: device
    events, and host events on the thread that ran the iterations."""
    from torch.autograd import DeviceType
    device, host = [], []
    events = prof.profiler.kineto_results.events()
    main = None
    for e in events:
        if e.name() == MAIN_SPAN and e.device_type() == DeviceType.CPU:
            main = e.start_thread_id()
            break
    for e in events:
        a = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no device work
            if not e.is_user_annotation() and not e.name().startswith(SPAN_PREFIX):
                device.append((a, a + e.duration_ns(), short_name(e.name())))
        elif e.start_thread_id() == main:
            host.append((a, a + e.duration_ns(), e.name()))
    return Trace(device, host)


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut].strip()
