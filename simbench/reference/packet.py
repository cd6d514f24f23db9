"""The packet-level ground truth of one iteration: the frozen oracle driven
by the frozen phase-DAG driver over the job's own fabric and program."""
from __future__ import annotations

from simbench.reference.driver import WorkloadDriver
from simbench.reference.job import Job
from simbench.reference.packet_sim import PacketSim


def run_packet(job: Job, scale: float,
               straggler: tuple[int, float] | None) -> tuple[dict[int, float], float, int]:
    """(per-flow FCTs, iteration time, events) of the packet oracle."""
    sim = PacketSim(job.topology(), **job.config["sim"])
    driver = WorkloadDriver(sim, job.phases(scale, straggler))
    sim.run()
    if not driver.finished:
        raise RuntimeError("the packet reference did not finish the iteration")
    return ({fid: r.fct for fid, r in sim.results.items()}, driver.iteration_time,
            sim.events_processed)
