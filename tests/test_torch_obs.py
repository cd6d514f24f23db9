"""The recorder of spans and counters (``repro_torch.obs``): silent and
cheap with no profiler, and under ``torch.profiler`` the spans of the
fluid engine, the packet loop, the Wormhole kernel's call-outs and the
memo DB, with their parents, on the profiler's timeline.  Recording
changes no result.  The last test runs only on the card (``-m gpu``): the
``fluid.syncs`` counter against torch's own count of synchronising calls.

The file imports neither JAX nor the JAX package: the machine with the
card has none, and the benchmark's harness refuses a process that loaded
either."""
import os
import sys
import threading
import time
import warnings
from collections import defaultdict

import pytest
import torch

from repro_torch import obs
from repro_torch.api import FlowSpec, Scenario, TopologySpec, run, training_scenario
from test_torch_fluid_memo import distinct_solves

CPU = [torch.profiler.ProfilerActivity.CPU]
CALLOUTS = ("wormhole.admit", "wormhole.finish", "wormhole.unpark", "wormhole.sample")
# a phase's routing and incidence, then its solve's (a distinct phase's only)
FLUID_SPANS = ("fluid.route", "fluid.incidence", "fluid.upload", "fluid.scan",
               "fluid.t_conv", "fluid.readback")
WORKLOAD_ROWS = ("workload.build", "workload.flows", "workload.a2a_flows")


def _quickstart():
    """``examples/quickstart.py``'s two waves of four contending flows, the
    second repeating the first, built with the port's API (the example
    imports the JAX package)."""
    flows = [FlowSpec(4 * w + i, i, 12 + i % 2, size=8e6, start=start, cca="dctcp",
                      tag=f"wave@{start}")
             for w, start in enumerate((0.0, 0.02)) for i in range(4)]
    return Scenario(name="quickstart", flows=flows,
                    topology=TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                   "n_spines": 2}))


def _gpt32():
    return training_scenario(n_gpus=32, scale=1 / 256)


@pytest.fixture
def profiled():
    """Runs a callable under a CPU profiler on an empty table; returns its
    result, the table and the profiler's events."""
    def go(fn):
        obs.reset()
        with torch.profiler.profile(activities=CPU) as prof:
            out = fn()
        table = obs.table()
        obs.reset()
        return out, table, prof.events()
    return go


def _same(a, b):
    assert a.fcts == b.fcts and a.flow_bytes == b.flow_bytes and a.tags == b.tags
    assert a.iteration_time == b.iteration_time
    assert a.events_processed == b.events_processed
    assert a.kernel_report == b.kernel_report


def test_without_a_profiler_nothing_records_and_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler active")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(obs, "_recorder", refuse)
    obs.reset()
    assert obs.span("fluid.route") is obs.NOOP
    assert obs.span("packet.loop") is obs.span("memo.lookup")
    obs.count("fluid.syncs", 3)
    run(_quickstart(), backend="wormhole")
    run(_gpt32(), backend="fluid", device="cpu")
    assert obs.table() == {}


def test_spans_and_counters_nest_under_a_profiler(profiled):
    def fn():
        with obs.span("outer"):
            obs.count("c", 2)
            with obs.span("inner"):
                obs.count("c")
            with obs.span("inner"):
                pass
        obs.count("c", 5)
    _, table, _ = profiled(fn)
    assert set(table) == {("outer", None), ("inner", "outer"), ("c", "outer"),
                          ("c", "inner"), ("c", None)}
    assert table[("c", "outer")] == {"count": 2}
    assert table[("c", "inner")] == {"count": 1} and table[("c", None)] == {"count": 5}
    outer, inner = table[("outer", None)], table[("inner", "outer")]
    assert outer["calls"] == 1 and inner["calls"] == 2
    assert outer["self_ns"] == outer["total_ns"] - inner["total_ns"]
    assert inner["self_ns"] == inner["total_ns"]


@pytest.mark.parametrize("recorder", ["fast", "record_function"])
def test_the_table_leaves_the_recording_cost_out(profiled, monkeypatch, recorder):
    """A span's total leaves out the recording of the spans and counts in
    it, and its self time their whole cost: an outer span around many empty
    ones reads far less than its wall clock, its self time least of all."""
    if recorder == "record_function":
        monkeypatch.setattr(obs, "_recorder", torch.autograd.profiler.record_function)
    n = 2000

    def fn():
        t = time.perf_counter_ns()
        with obs.span("outer"):
            for _ in range(n):
                with obs.span("inner"):
                    obs.count("c")
        return time.perf_counter_ns() - t
    wall, table, events = profiled(fn)
    outer, inner = table[("outer", None)], table[("inner", "outer")]
    assert inner["calls"] == n and table[("c", "inner")] == {"count": n}
    assert outer["self_ns"] == outer["total_ns"] - inner["total_ns"]
    assert inner["self_ns"] == inner["total_ns"]
    assert 0 <= outer["self_ns"] < outer["total_ns"] < 0.6 * wall
    assert sum(e.name == "inner" for e in events) == n


def test_threads_keep_their_own_parents_and_lose_no_update(profiled):
    """More threads than cores, switching every microsecond: each thread's
    spans nest under its own, and no call or count is lost."""
    n_threads, n = 2 * (os.cpu_count() or 1) + 2, 300

    def work(i):
        for _ in range(n):
            with obs.span(f"t{i}"):
                with obs.span("leaf"):
                    obs.count("hits")

    def fn():
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            return [t.is_alive() for t in threads]
        finally:
            sys.setswitchinterval(old)
    alive, table, _ = profiled(fn)
    assert not any(alive)
    for i in range(n_threads):
        assert table[(f"t{i}", None)]["calls"] == n
        assert table[("leaf", f"t{i}")]["calls"] == n
    assert table[("hits", "leaf")] == {"count": n_threads * n}
    assert len(table) == 2 * n_threads + 1


def _assert_nested(table, events):
    """Self time within total, one profiler event a call, and each program
    span's interval in the profiler's events inside one of its parent's."""
    spans = {k: row for k, row in table.items() if "calls" in row}
    parents = defaultdict(set)
    calls = defaultdict(int)
    for (name, parent), row in spans.items():
        assert 0 <= row["self_ns"] <= row["total_ns"]
        parents[name].add(parent)
        calls[name] += row["calls"]
    intervals = defaultdict(list)
    for e in events:
        if e.name in parents:
            intervals[e.name].append((e.time_range.start, e.time_range.end))
    assert {n: len(ivs) for n, ivs in intervals.items()} == calls
    for name, ps in parents.items():
        if None in ps:
            continue
        outer = [iv for p in ps for iv in intervals[p]]
        for a, b in intervals[name]:
            assert any(pa <= a and b <= pb for pa, pb in outer), name


def test_wormhole_records_the_loop_callouts_and_lookups(profiled):
    res, table, events = profiled(lambda: run(_quickstart(), backend="wormhole"))
    assert table[("packet.loop", None)]["calls"] == 1
    callouts = {n for n, p in table if n.startswith("wormhole.")}
    assert {"wormhole.admit", "wormhole.unpark", "wormhole.sample"} <= callouts
    assert callouts <= set(CALLOUTS)
    assert all(p == "packet.loop" for n, p in table if n.startswith("wormhole."))
    lookups = {p: row for (n, p), row in table.items() if n == "memo.lookup"}
    assert lookups and set(lookups) <= {"wormhole.admit", "wormhole.finish",
                                        "wormhole.unpark"}
    assert sum(r["calls"] for r in lookups.values()) == res.kernel_report["run_db_lookups"]
    dsts = {f.dst for f in _quickstart().flows}
    assert sum(row["count"] for (n, _), row in table.items()
               if n == "topology.dist_builds") == len(dsts)
    assert {n for n, _ in table} == {"packet.loop", "memo.lookup", "topology.dist_builds",
                                     *callouts}
    _assert_nested(table, events)


def test_fluid_records_one_route_a_phase_and_no_sync_on_the_cpu(profiled):
    """Every phase with flows is routed; each distinct one is solved once
    (uploads, scan, ``_t_conv``, readback) and the others are hits."""
    scn = _gpt32()
    phases = sum(1 for ph in scn.build_phases() if ph.flows)
    distinct = distinct_solves(scn)
    assert distinct < phases
    _, table, events = profiled(lambda: run(scn, backend="fluid", device="cpu"))
    assert set(table) == {(n, None) for n in FLUID_SPANS + WORKLOAD_ROWS} | {
        ("topology.dist_builds", "fluid.route"), ("topology.array_routes", "fluid.route"),
        ("fluid.solve_hits", None)}
    assert all(table[(n, None)]["calls"] == phases for n in FLUID_SPANS[:2])
    assert all(table[(n, None)]["calls"] == distinct for n in FLUID_SPANS[2:])
    assert table[("fluid.solve_hits", None)] == {"count": phases - distinct}
    assert not any(n == "fluid.syncs" for n, _ in table)
    _assert_nested(table, events)


def test_fluid_computes_each_destinations_distances_once_a_run(profiled):
    """A run builds its topology afresh and routes each destination's flows
    from one table: one BFS a destination, whatever the phases repeat."""
    scn = _gpt32()
    dsts = {f.dst for ph in scn.build_phases() for f in ph.flows}
    flows = sum(len(ph.flows) for ph in scn.build_phases())
    assert flows > len(dsts) > 1
    _, table, _ = profiled(lambda: run(scn, backend="fluid", device="cpu"))
    assert table[("topology.dist_builds", "fluid.route")] == {"count": len(dsts)}
    obs.reset()
    run(scn, backend="fluid", device="cpu")
    assert obs.table() == {}


def test_fluid_routes_every_flow_of_a_run_as_arrays(profiled):
    """``topology.array_routes`` counts each flow of the phases with flows,
    once: the fluid engine routes them all through ``Topology.routes``."""
    scn = _gpt32()
    flows = sum(len(ph.flows) for ph in scn.build_phases() if ph.flows)
    _, table, _ = profiled(lambda: run(scn, backend="fluid", device="cpu"))
    assert table[("topology.array_routes", "fluid.route")] == {"count": flows}
    assert sum(row.get("count", 0) for (n, _), row in table.items()
               if n == "topology.array_routes") == flows


@pytest.mark.parametrize("fid0", [0, 2**62, 2**64])
def test_array_routes_count_every_flow(profiled, fid0):
    """Every flow goes through the array walk, whatever its id, even one
    past what int64 holds, so ``topology.array_routes`` counts each;
    ``topology.dist_builds`` counts each destination once."""
    topo = TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4, "n_spines": 2}).build()
    src, dst = list(range(8)), [15 - s for s in range(8)]
    fid = [fid0 + i for i in range(8)]
    _, table, _ = profiled(lambda: topo.routes(fid, src, dst))
    assert table[("topology.dist_builds", None)] == {"count": 8}
    assert table[("topology.array_routes", None)] == {"count": 8}


@pytest.mark.parametrize("backend", ["wormhole", "fluid"])
def test_results_are_the_same_with_the_profiler_on(profiled, backend):
    scn = _quickstart() if backend == "wormhole" else _gpt32()
    opts = {"device": "cpu"} if backend == "fluid" else {}
    off = run(scn, backend=backend, **opts)
    on, table, _ = profiled(lambda: run(scn, backend=backend, **opts))
    assert table
    _same(on, off)


@pytest.mark.gpu
def test_the_sync_counter_misses_no_sync_on_the_card(profiled):
    """Every point of a fluid run where the host waits on the card's stream
    is one of ``fluid.syncs``: torch's sync debug mode warns once for each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the fluid scan runs only on the card")
    scn = training_scenario(n_gpus=128, scale=1 / 64)
    run(scn, backend="fluid")                          # builds and loads the kernel
    torch.cuda.synchronize()

    def fn():
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run(scn, backend="fluid")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return [w for w in caught if "synchroniz" in str(w.message)]
    syncs, table, _ = profiled(fn)
    counted = sum(row["count"] for (n, _), row in table.items() if n == "fluid.syncs")
    phases = sum(1 for ph in scn.build_phases() if ph.flows)
    assert table[("fluid.route", None)]["calls"] == phases
    assert counted == len(syncs) > 0, (counted, len(syncs), phases)
