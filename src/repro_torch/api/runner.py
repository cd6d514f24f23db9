"""Top-level entry points: run one scenario, or a sweep of many.

The port has no campaign layer yet: ``run`` and ``run_many`` call the
engine directly, in this process, and keep nothing.  Scenarios are
evaluated where the engine runs them: on the CUDA card unless
``device="cpu"`` is passed."""
from __future__ import annotations

from repro_torch.api.engines import get_engine
from repro_torch.api.results import RunResult
from repro_torch.api.scenario import Scenario

__all__ = ["run", "run_many"]


def run(scenario: Scenario, backend: str = "fluid", **opts) -> RunResult:
    """Evaluate one scenario on one backend."""
    engine = get_engine(backend)
    engine.check_opts(opts)
    return engine.run(scenario, **opts)


def run_many(scenarios: list[Scenario], backend: str = "fluid",
             workers: int = 1, **opts) -> list[RunResult]:
    """Evaluate a sweep through the engine's ``run_batch`` (the fluid
    engine's padded batch, which shares one ``dt`` across the sweep).
    Results keep scenario order.  ``workers`` other than 1 is refused: the
    port's engines run in this process, on its device."""
    if workers != 1:
        raise ValueError(
            f"run_many(workers={workers}): the port evaluates sweeps in "
            "this process (batched on the device); process fan-out is not "
            "ported")
    engine = get_engine(backend)
    engine.check_opts(opts)
    return engine.run_batch(list(scenarios), **opts)
