"""Fault tolerance for 1000+-node runs.

The failure model: any host can die between (or during) steps.  Recovery =
step-atomic checkpoints + deterministic data pipeline + elastic re-mesh:

  * checkpoints publish atomically every ``ckpt_every`` steps (a crash never
    leaves a partial checkpoint visible);
  * on restart, FaultManager finds the latest step, restores params+opt,
    and skips the data pipeline ahead — the byte stream is identical by
    construction;
  * straggler mitigation at this layer is deadline-based: a step whose wall
    time exceeds ``straggler_factor ×`` the trailing median is recorded and
    surfaced (on real fleets this feeds the scheduler; in the simulator the
    same event appears as a compute-delay perturbation that Wormhole handles
    as an interrupt).

``FailureInjector`` drives the integration tests: it kills the training
loop at a chosen step and the harness restarts it.

Copy of ``repro.train.fault``, which the port may not import, over the
port's :mod:`repro_torch.train.checkpoint`.
"""
from __future__ import annotations

import dataclasses
import pathlib
import shutil
import statistics
import time

from repro_torch.train import checkpoint as C


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_step: int = -1
    fired: bool = False

    def maybe_fail(self, step: int) -> None:
        if step == self.fail_at_step and not self.fired:
            self.fired = True
            raise InjectedFailure(f"injected host failure at step {step}")


@dataclasses.dataclass
class FaultManager:
    ckpt_dir: str
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    keep: int = 3

    def __post_init__(self) -> None:
        self._durations: list[float] = []
        self._t0 = None
        self.straggler_steps: list[int] = []

    # -- checkpoint cadence --------------------------------------------- #
    def maybe_save(self, step: int, params, opt_state, extra: dict) -> bool:
        if step % self.ckpt_every != 0 or step == 0:
            return False
        C.save(self.ckpt_dir, step, params, opt_state, extra)
        self._gc()
        return True

    def _gc(self) -> None:
        ckpts = sorted(pathlib.Path(self.ckpt_dir).glob("step_*"))
        for old in ckpts[:-self.keep]:
            shutil.rmtree(old)

    def resume_info(self):
        return C.latest_step(self.ckpt_dir)

    # -- straggler detection --------------------------------------------- #
    def step_started(self) -> None:
        self._t0 = time.perf_counter()

    def step_finished(self, step: int) -> None:
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        if len(self._durations) >= 8:
            med = statistics.median(self._durations[-32:])
            if dt > self.straggler_factor * med:
                self.straggler_steps.append(step)
        self._durations.append(dt)
