"""Engine protocol + registry of the port's backends.

The port has its own registry, under the reference's engine names.  Its
run store keys results by backend name with the reference's hash, so a
campaign directory or a store server belongs to one package
(``repro_torch.api.campaign``, ``repro_torch.api.serve``).

    packet    per-packet DES oracle (the ns-3 stand-in), on the host
    wormhole  the same oracle under the memoizing/fast-forwarding kernel,
              on the host
    hybrid    adaptive per-partition packet/flow granularity on the
              partition-sharded loop, on the host
    fluid     DCTCP fluid rate dynamics through the hand-written
              ``fluid_scan`` kernel (a phase's control steps and its steady
              detector in one launch; batched sweeps in ``run_batch``)
    analytic  flow-level max-min fair sharing, on the host (cheapest,
              coarsest)
    learned   an MLP fitted on packet-level runs (``repro_torch.learned``),
              served on the card: batched what-if queries, in-distribution

The fluid and learned engines run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no ``device``, ``run`` raises.  The
packet, wormhole, hybrid and analytic engines take no ``device``: they are
event simulators on the host in both packages, and their results are the
reference's bit for bit, with the serial loop or the partition-sharded one
(``parallel="partitions"``, ``intra_workers``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

from repro_torch import obs
from repro_torch.api.analytic import AnalyticSim
from repro_torch.api.results import RunResult
from repro_torch.api.scenario import Scenario
from repro_torch.core.memo import SimDB
from repro_torch.core.wormhole import WormholeConfig, WormholeKernel
from repro_torch.net import chaos as chaos_mod
from repro_torch.net.hybrid_sim import FIDELITIES, HybridConfig, HybridKernel, HybridSim
from repro_torch.net.packet_sim import PacketSim
from repro_torch.net.sharded_sim import ShardedPacketSim
from repro_torch.workload.driver import WorkloadDriver

_REGISTRY: dict[str, type] = {}


def register_engine(name: str):
    """Class decorator: make ``name`` resolvable through ``get_engine``."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_engine(name: str) -> Engine:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; "
            f"available: {', '.join(available_backends())}") from None
    return cls()


class Engine:
    """Backend protocol: evaluate scenarios into :class:`RunResult`s.

    ``uses_db = True`` declares that ``run`` accepts a ``db=`` SimDB (the
    seam ``run_many(shared_db=True)`` threads one memo DB through).

    ``option_names`` declares the opts ``run`` accepts; :meth:`check_opts`
    rejects anything else with one error naming the accepted set, so a
    typoed opt fails loudly instead of being swallowed by ``**opts``.  An
    engine that declares none (a third-party engine registered later)
    stays unvalidated, as in the reference."""
    name = "abstract"
    uses_db = False
    option_names: tuple[str, ...] | None = None

    def check_opts(self, opts: dict) -> None:
        """Raise ValueError on any opt this backend does not accept."""
        if self.option_names is None:
            return
        unknown = sorted(set(opts) - set(self.option_names))
        if unknown:
            raise ValueError(
                f"backend {self.name!r} does not accept "
                f"opt{'s' if len(unknown) > 1 else ''} "
                f"{', '.join(map(repr, unknown))}; accepted opts: "
                f"{', '.join(sorted(self.option_names)) or '(none)'}")

    def run(self, scenario: Scenario, **opts) -> RunResult:
        raise NotImplementedError

    def run_batch(self, scenarios: list[Scenario], **opts) -> list[RunResult]:
        return [self.run(s, **opts) for s in scenarios]


@contextlib.contextmanager
def _gc_paused():
    """The cyclic garbage collector off for the body, and on again after it
    if it was on.  A fluid run of a 1024-GPU job makes 131 072 flows, their
    routes and each phase's arrays, none of them in a reference cycle:
    reference counting frees them all, and the collector's passes over them
    find nothing and cost a third of the run's host time."""
    if not gc.isenabled():
        yield
        return
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@register_engine("fluid")
class FluidEngine(Engine):
    """DCTCP-form fluid dynamics: per-phase converged rates turn into FCT
    estimates; the phase DAG is scheduled analytically on top.  ``run``
    solves each distinct phase once (``FluidPaths.key``) and counts the
    phases that reuse a solve as ``fluid.solve_hits``.  The engine
    ignores ``cca``: every flow takes the DCTCP form.  ``run_batch``
    evaluates a whole padded sweep of flow scenarios in one batched run."""
    option_names = ("device", "dt", "steps")

    @_gc_paused()
    def run(self, scenario: Scenario, steps: int = 200, dt: float | None = None,
            device=None, **opts) -> RunResult:
        from repro_torch.device import device_name, resolve_device
        from repro_torch.net.fluid import FluidPaths, fluid_converged_rates
        t0 = time.perf_counter()
        dev = resolve_device(device)
        chaos_mod.check_backend(chaos_mod.plan_for(scenario), self.name)
        topo = scenario.build_topology()
        phases = scenario.build_phases()
        fcts: dict[int, float] = {}
        flow_bytes: dict[int, float] = {}
        tags: dict[int, str] = {}
        done_t: list[float] = [0.0] * len(phases)
        total_steps = 0
        # this run's rates by solve key: a training program repeats its layers,
        # and with them its phases, so each distinct phase is solved once; dt
        # as given, since the default is the base RTTs' median
        solved: dict[tuple, list[float]] = {}
        for i, ph in enumerate(phases):
            start = max((done_t[d] for d in set(ph.deps)), default=0.0) + ph.compute
            if scenario.kind == "flows":
                start += ph.flows[0].start if ph.flows else 0.0
            end = start
            if ph.flows:
                paths = FluidPaths.from_flows(
                    topo, [(f.fid, f.src, f.dst, f.size) for f in ph.flows])
                key = (paths.key(), steps, dt)
                rates = solved.get(key)
                if rates is None:
                    out = fluid_converged_rates(paths.scenario(), steps=steps, dt=dt,
                                                device=dev)["rates"]
                    with obs.span("fluid.readback"):
                        if out.is_cuda:
                            obs.count("fluid.syncs")
                        rates = solved[key] = out.tolist()
                else:
                    obs.count("fluid.solve_hits")
                total_steps += steps
                for f, rate in zip(ph.flows, rates):
                    fct = f.size / max(rate, 1e3)
                    fcts[f.fid] = fct
                    flow_bytes[f.fid] = f.size
                    tags[f.fid] = f.tag
                    end = max(end, start + fct)
            done_t[i] = end
        wall = time.perf_counter() - t0
        iteration = max(done_t) if done_t else None
        return RunResult(backend=self.name, scenario=scenario.name,
                         fcts=fcts, flow_bytes=flow_bytes, tags=tags,
                         iteration_time=iteration, events_processed=total_steps,
                         wall_time=wall, extras={"device": device_name(dev)})

    def run_batch(self, scenarios: list[Scenario], steps: int = 200,
                  dt: float | None = None, device=None, **opts) -> list[RunResult]:
        """Pad + batch: one run evaluates every flow scenario's converged
        rates at once (workload scenarios fall back to a loop)."""
        from repro_torch.device import device_name, resolve_device
        from repro_torch.net.fluid import FluidScenario, sweep_converged_rates
        dev = resolve_device(device)
        for s in scenarios:
            chaos_mod.check_backend(chaos_mod.plan_for(s), self.name)
        if any(s.kind != "flows" for s in scenarios):
            return [self.run(s, steps=steps, dt=dt, device=dev, **opts)
                    for s in scenarios]
        dt = dt if dt is not None else 1e-5    # the batched run shares one dt
        t0 = time.perf_counter()
        fls = [FluidScenario.from_flows(
            s.build_topology(), [(f.fid, f.src, f.dst, f.size) for f in s.flows])
            for s in scenarios]
        per_scn_rates = sweep_converged_rates(fls, dt=dt, steps=steps, device=dev)
        wall = time.perf_counter() - t0
        out = []
        for s, rates in zip(scenarios, per_scn_rates):
            fcts, rate_map = {}, {}
            for f, rate in zip(s.flows, rates.tolist()):
                fcts[f.fid] = f.size / max(rate, 1e3)
                rate_map[f.fid] = rate
            finishes = [f.start + fcts[f.fid] for f in s.flows]
            out.append(RunResult(
                backend=self.name, scenario=s.name, fcts=fcts,
                flow_bytes={f.fid: f.size for f in s.flows},
                tags={f.fid: f.tag for f in s.flows},
                iteration_time=(max(finishes) - min(f.start for f in s.flows))
                if finishes else None,
                events_processed=steps, wall_time=wall / len(scenarios),
                extras={"rates": rate_map, "batch_wall": wall,
                        "device": device_name(dev)}))
        return out


# ---------------------------------------------------------------------- #
# event simulators driven by the workload layer (packet, wormhole, analytic)
# ---------------------------------------------------------------------- #
def _drive(scenario: Scenario, sim) -> WorkloadDriver | None:
    if scenario.kind == "workload":
        return WorkloadDriver(sim, scenario.build_phases())
    for fl in scenario.flows:
        sim.add_flow(dataclasses.replace(fl))
    plan = chaos_mod.plan_for(scenario)
    if plan is not None:
        # flow scenarios skip the phase DAG, so the phase-level mice
        # injectors land here: each arrival is a plain flow whose start
        # carries the phase's compute (= the Poisson arrival time)
        for ph in plan.mice_phases(scenario._n_hosts()):
            sim.add_flow(dataclasses.replace(ph.flows[0], start=ph.compute))
    return None


def _collect(backend: str, scenario: Scenario, sim, driver, t0: float,
             kernel_report: dict | None = None,
             record_rtt=()) -> RunResult:
    if driver is not None:
        assert driver.finished, f"{scenario.name}: program did not finish"
        iteration = driver.iteration_time
    elif sim.results:
        iteration = (max(r.finish for r in sim.results.values())
                     - min(r.start for r in sim.results.values()))
    else:
        iteration = None
    extras = {}
    if record_rtt:
        extras["rtt_samples"] = {fid: list(sim.flows[fid].rtt_samples)
                                 for fid in record_rtt}
    return RunResult(
        backend=backend, scenario=scenario.name,
        fcts={fid: r.fct for fid, r in sim.results.items()},
        flow_bytes={fid: r.bytes for fid, r in sim.results.items()},
        tags={fid: r.tag for fid, r in sim.results.items()},
        iteration_time=iteration, events_processed=sim.events_processed,
        wall_time=time.perf_counter() - t0, kernel_report=kernel_report, extras=extras)


@register_engine("packet")
class PacketEngine(Engine):
    """Baseline per-packet DES — the accuracy oracle everything else is
    judged against.  It runs on the host (its per-packet Python loop is the
    reference's, event for event) and takes no ``device``.

    opts (shared by the wormhole subclass):
      parallel       None (single-heap serial loop) or ``"partitions"``
                     (partition-sharded loop, ``repro_torch.net.sharded_sim``)
      intra_workers  worker processes for the sharded loop's heavy-lane
                     fan-out; 1 keeps sharded execution in-process.  Results
                     are identical to the serial loop for any value.
    """
    option_names = ("intra_workers", "parallel", "record_rtt", "until",
                    "validate")

    def _make_kernel(self, scenario: Scenario, **opts):
        return None, None

    def run(self, scenario: Scenario, record_rtt=(), until: float = float("inf"),
            parallel: str | None = None, intra_workers: int = 1,
            validate: bool = False, **opts) -> RunResult:
        t0 = time.perf_counter()
        plan = chaos_mod.plan_for(scenario)
        chaos_mod.check_backend(plan, self.name, intra_workers=intra_workers)
        topo = scenario.build_topology()
        kernel, report_fn = self._make_kernel(scenario, **opts)
        if parallel is None or parallel == "none":
            if intra_workers > 1 or validate:
                # silently running the serial loop would make the user
                # believe the fan-out (or invariant checking) was active
                raise ValueError(
                    "intra_workers/validate require parallel='partitions'")
            sim = PacketSim(topo, kernel=kernel, **scenario.sim)
        elif parallel == "partitions":
            sim = ShardedPacketSim(topo, kernel=kernel,
                                   intra_workers=intra_workers,
                                   validate=validate, **scenario.sim)
        else:
            raise ValueError(
                f"unknown parallel mode {parallel!r} (use 'partitions')")
        sim.record_rtt_fids = set(record_rtt)
        driver = _drive(scenario, sim)
        if plan is not None and plan.has_link_events:
            plan.install(sim)
        try:
            sim.run(until=until)
        finally:
            if parallel == "partitions":
                sim.close()
        result = _collect(self.name, scenario, sim, driver, t0,
                          kernel_report=report_fn() if report_fn else None,
                          record_rtt=record_rtt)
        if parallel == "partitions":
            result.extras["shard"] = sim.shard_report()
        return result


@register_engine("wormhole")
class WormholeEngine(PacketEngine):
    """Packet oracle + the Wormhole memoization/fast-forwarding kernel, on
    the host.

    opts:
      config   WormholeConfig or dict merged over scenario.kernel
      db       a SimDB to reuse across runs (cross-run warm cache, §6.1);
               per-run hit/lookup deltas land in kernel_report["run_db_*"].
               ``SimDB.load_or_new``/``save`` persist it in the reference's
               JSON format, so either package warm-starts from the other's.
    """
    uses_db = True
    option_names = PacketEngine.option_names + ("config", "db")

    def run(self, scenario: Scenario, db: SimDB | None = None,
            **opts) -> RunResult:
        return super().run(scenario, db=db, **opts)

    def _make_kernel(self, scenario: Scenario, config=None, db: SimDB | None = None,
                     **opts):
        if isinstance(config, WormholeConfig):
            cfg = config
        else:
            cfg = WormholeConfig(**{**scenario.kernel, **(config or {})})
        kernel = WormholeKernel(cfg, db=db)
        hits0, lookups0 = kernel.db.hits, kernel.db.lookups

        def report():
            rep = kernel.report()
            rep["run_db_hits"] = kernel.db.hits - hits0
            rep["run_db_lookups"] = kernel.db.lookups - lookups0
            return rep
        return kernel, report


@register_engine("hybrid")
class HybridEngine(Engine):
    """HyGra-style adaptive granularity on the sharded packet loop: rate-
    stable partitions demote to a max-min-solver-driven flow-level lane and
    promote back on contention change (``repro_torch.net.hybrid_sim``), on
    the host.  The flow lane solves with the exact float64 host solver, as
    the reference does, so results are the reference's bit for bit.

    opts:
      fidelity       "packet" (bit-identical to the sharded serial loop) |
                     "auto" (adaptive demote/promote, the default) |
                     "flow" (everything flow-level from t=0, coarsest)
      demote_after   stable samples before a partition demotes (auto mode)
      config         HybridConfig or dict merged over scenario.kernel
                     (foreign keys are ignored — scenarios share one
                     kernel-knob dict across backends)
      intra_workers  worker processes for heavy packet-lane fan-out, as in
                     the packet/wormhole backends

    ``RunResult.extras["granularity"]`` reports per-granularity event
    counts (packet_lane_events / flow_lane_events) and transition stats.
    """
    option_names = ("config", "demote_after", "fidelity", "intra_workers",
                    "record_rtt", "until", "validate")

    def run(self, scenario: Scenario, fidelity: str | None = None,
            demote_after: int | None = None, config=None,
            record_rtt=(), until: float = float("inf"),
            intra_workers: int = 1, validate: bool = False,
            **opts) -> RunResult:
        t0 = time.perf_counter()
        if isinstance(config, HybridConfig):
            cfg = dataclasses.replace(config)    # never mutate the caller's
        else:
            cfg = HybridConfig.from_knobs({**scenario.kernel, **(config or {})})
        # explicit engine opts override the config; an unset opt must not
        # clobber a fidelity carried by config=/scenario.kernel
        if fidelity is not None:
            cfg.fidelity = fidelity
        if demote_after is not None:
            cfg.demote_after = demote_after
        if cfg.fidelity not in FIDELITIES:
            raise ValueError(f"unknown fidelity {cfg.fidelity!r}; "
                             f"have {FIDELITIES}")
        plan = chaos_mod.plan_for(scenario)
        chaos_mod.check_backend(plan, self.name, intra_workers=intra_workers)
        topo = scenario.build_topology()
        kernel, report_fn = None, None
        if cfg.fidelity != "packet":
            kernel = HybridKernel(cfg)
            report_fn = kernel.report
        sim = HybridSim(topo, kernel=kernel, intra_workers=intra_workers,
                        validate=validate, **scenario.sim)
        sim.record_rtt_fids = set(record_rtt)
        driver = _drive(scenario, sim)
        if plan is not None and plan.has_link_events:
            plan.install(sim)
        try:
            sim.run(until=until)
        finally:
            sim.close()
        result = _collect(self.name, scenario, sim, driver, t0,
                          kernel_report=report_fn() if report_fn else None,
                          record_rtt=record_rtt)
        result.extras["granularity"] = sim.granularity_report()
        result.extras["shard"] = sim.shard_report()
        return result


@register_engine("analytic")
class AnalyticEngine(Engine):
    """Progressive max-min fair-share model — the flow-level abstraction the
    paper positions against (§2.2).  Shares the WorkloadDriver, so it runs
    the same phase DAGs the packet backends do.

    It does its work on the host in float64, through the exact solver, as
    the reference does (whose analytic engine imports no JAX either), and
    takes no ``device``: its results are the reference's bit for bit.  The
    card's part of the max-min solver is ``maxmin_rates_torch``
    (``repro_torch.kernels.maxmin``), which this engine does not call."""
    option_names = ("until",)

    def run(self, scenario: Scenario, until: float = float("inf"),
            **opts) -> RunResult:
        t0 = time.perf_counter()
        chaos_mod.check_backend(chaos_mod.plan_for(scenario), self.name)
        sim = AnalyticSim(scenario.build_topology())
        driver = _drive(scenario, sim)
        sim.run(until=until)
        return _collect(self.name, scenario, sim, driver, t0)


# the learned engine lives in its own package (it has a training half the
# registry does not need); a plain import is safe in either import order —
# repro_torch.learned.engine only pulls names already defined above
import repro_torch.learned.engine  # noqa: E402, F401
