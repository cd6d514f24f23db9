"""Engine protocol + registry of the port's backends.

The port has its own registry, under the reference's engine names, and no
run store: nothing keys a result by backend name across the two packages.

    packet    per-packet DES oracle (the ns-3 stand-in), on the host
    wormhole  the same oracle under the memoizing/fast-forwarding kernel,
              on the host
    fluid     DCTCP fluid rate dynamics through the hand-written
              ``fluid_scan`` kernel (a phase's control steps and its steady
              detector in one launch; batched sweeps in ``run_batch``)
    analytic  flow-level max-min fair sharing, on the host (cheapest,
              coarsest)

The fluid engine runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no ``device``, ``run`` raises.  The
packet, wormhole and analytic engines take no ``device``: they are event
simulators on the host in both packages, and their results are the
reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.api.analytic import AnalyticSim
from repro_torch.api.results import RunResult
from repro_torch.api.scenario import Scenario
from repro_torch.core.memo import SimDB
from repro_torch.core.wormhole import WormholeConfig, WormholeKernel
from repro_torch.device import device_name, resolve_device
from repro_torch.net import chaos as chaos_mod
from repro_torch.net.fluid import (FluidScenario, fluid_converged_rates,
                                   sweep_converged_rates)
from repro_torch.net.packet_sim import PacketSim
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
    typoed opt fails loudly instead of being swallowed by ``**opts``."""
    name = "abstract"
    uses_db = False
    option_names: tuple[str, ...] = ()

    def check_opts(self, opts: dict) -> None:
        """Raise ValueError on any opt this backend does not accept."""
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


@register_engine("fluid")
class FluidEngine(Engine):
    """DCTCP-form fluid dynamics: per-phase converged rates turn into FCT
    estimates; the phase DAG is scheduled analytically on top.  The engine
    ignores ``cca``: every flow takes the DCTCP form.  ``run_batch``
    evaluates a whole padded sweep of flow scenarios in one batched run."""
    option_names = ("device", "dt", "steps")

    def run(self, scenario: Scenario, steps: int = 200, dt: float | None = None,
            device=None, **opts) -> RunResult:
        dev = resolve_device(device)
        chaos_mod.check_backend(chaos_mod.plan_for(scenario), self.name)
        topo = scenario.build_topology()
        phases = scenario.build_phases()
        t0 = time.perf_counter()
        fcts: dict[int, float] = {}
        flow_bytes: dict[int, float] = {}
        tags: dict[int, str] = {}
        done_t: list[float] = [0.0] * len(phases)
        total_steps = 0
        for i, ph in enumerate(phases):
            start = max((done_t[d] for d in set(ph.deps)), default=0.0) + ph.compute
            if scenario.kind == "flows":
                start += ph.flows[0].start if ph.flows else 0.0
            end = start
            if ph.flows:
                fs = FluidScenario.from_flows(
                    topo, [(f.fid, f.src, f.dst, f.size) for f in ph.flows])
                rates = fluid_converged_rates(fs, steps=steps, dt=dt,
                                              device=dev)["rates"].tolist()
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


def _collect(backend: str, scenario: Scenario, sim, driver, wall: float,
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
        wall_time=wall, kernel_report=kernel_report, extras=extras)


@register_engine("packet")
class PacketEngine(Engine):
    """Baseline per-packet DES — the accuracy oracle everything else is
    judged against.  It runs on the host (its per-packet Python loop is the
    reference's, event for event) and takes no ``device``.

    opts (shared by the wormhole subclass):
      parallel       None or ``"none"`` (the single-heap serial loop); the
                     reference's ``"partitions"`` (partition-sharded loop)
                     raises NotImplementedError until that loop is ported
      intra_workers  1; more workers belong to the sharded loop and raise
                     NotImplementedError
    """
    option_names = ("intra_workers", "parallel", "record_rtt", "until",
                    "validate")

    def _make_kernel(self, scenario: Scenario, **opts):
        return None, None

    def run(self, scenario: Scenario, record_rtt=(), until: float = float("inf"),
            parallel: str | None = None, intra_workers: int = 1,
            validate: bool = False, **opts) -> RunResult:
        plan = chaos_mod.plan_for(scenario)
        chaos_mod.check_backend(plan, self.name, intra_workers=intra_workers)
        topo = scenario.build_topology()
        kernel, report_fn = self._make_kernel(scenario, **opts)
        if parallel not in (None, "none", "partitions"):
            raise ValueError(
                f"unknown parallel mode {parallel!r} (use 'partitions')")
        if parallel == "partitions" or intra_workers > 1:
            raise NotImplementedError(
                f"parallel={parallel!r}, intra_workers={intra_workers}: the "
                "partition-sharded event loop is not ported yet (ROADMAP.md "
                "Queue 1, the sharded-loop item); use parallel=None")
        if validate:
            # silently running the serial loop would make the user believe
            # the invariant checking was active
            raise ValueError(
                "intra_workers/validate require parallel='partitions'")
        sim = PacketSim(topo, kernel=kernel, **scenario.sim)
        sim.record_rtt_fids = set(record_rtt)
        driver = _drive(scenario, sim)
        if plan is not None and plan.has_link_events:
            plan.install(sim)
        t0 = time.perf_counter()
        sim.run(until=until)
        wall = time.perf_counter() - t0
        return _collect(self.name, scenario, sim, driver, wall,
                        kernel_report=report_fn() if report_fn else None,
                        record_rtt=record_rtt)


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
        chaos_mod.check_backend(chaos_mod.plan_for(scenario), self.name)
        sim = AnalyticSim(scenario.build_topology())
        driver = _drive(scenario, sim)
        t0 = time.perf_counter()
        sim.run(until=until)
        wall = time.perf_counter() - t0
        return _collect(self.name, scenario, sim, driver, wall)
