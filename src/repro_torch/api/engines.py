"""Engine protocol + registry of the port's backends.

The port has its own registry, under the reference's engine names, and no
run store: nothing keys a result by backend name across the two packages.

    fluid     DCTCP fluid rate dynamics through the hand-written
              ``fluid_scan`` kernel (a phase's control steps and its steady
              detector in one launch; batched sweeps in ``run_batch``)
    analytic  flow-level max-min fair sharing, on the host (cheapest,
              coarsest)

The fluid engine runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no ``device``, ``run`` raises.  The
analytic engine takes no ``device``: it runs on the host in both packages.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.api.analytic import AnalyticSim
from repro_torch.api.results import RunResult
from repro_torch.api.scenario import Scenario
from repro_torch.device import device_name, resolve_device
from repro_torch.net import chaos as chaos_mod
from repro_torch.net.fluid import (FluidScenario, fluid_converged_rates,
                                   sweep_converged_rates)
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

    ``option_names`` declares the opts ``run`` accepts; :meth:`check_opts`
    rejects anything else with one error naming the accepted set, so a
    typoed opt fails loudly instead of being swallowed by ``**opts``."""
    name = "abstract"
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
# analytic backend (flow-level max-min fair sharing)
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


def _collect(backend: str, scenario: Scenario, sim, driver,
             wall: float) -> RunResult:
    if driver is not None:
        assert driver.finished, f"{scenario.name}: program did not finish"
        iteration = driver.iteration_time
    elif sim.results:
        iteration = (max(r.finish for r in sim.results.values())
                     - min(r.start for r in sim.results.values()))
    else:
        iteration = None
    return RunResult(
        backend=backend, scenario=scenario.name,
        fcts={fid: r.fct for fid, r in sim.results.items()},
        flow_bytes={fid: r.bytes for fid, r in sim.results.items()},
        tags={fid: r.tag for fid, r in sim.results.items()},
        iteration_time=iteration, events_processed=sim.events_processed,
        wall_time=wall)


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
