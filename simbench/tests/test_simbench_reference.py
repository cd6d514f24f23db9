"""The benchmark's plain reference against the program's CPU path, on
scenarios small enough for a test run, and the frozen work count.

Run from the checkout's root: ``python -m pytest -q simbench/tests``."""
from __future__ import annotations

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest

from repro_torch.api import run
from repro_torch.api.scenario import Scenario, TopologySpec
from repro_torch.net.flows import FlowSpec as PortFlowSpec
from simbench.harness import port_scenario
from simbench.reference.flows import FlowSpec
from simbench.reference.fluid import FluidReference, to_bfloat16
from simbench.reference.job import Job
from simbench.reference.packet import run_packet
from simbench.reference.packet_sim import PacketSim
from simbench.reference.topology import TOPOLOGY_BUILDERS
from simbench.workcount import least_seconds

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "repro_torch"}

# gpt@32 as the program resolves it: the 64-GPU row's model, TP8-DP2-PP2
GPT32 = {
    "name": "gpt32-test",
    "job": {"family": "gpt", "n_gpus": 32},
    "model": {"name": "gpt-7b", "n_layers": 32, "d_model": 4096, "d_ff": 16384,
              "vocab": 50304, "params": 7e9, "active_params": 7e9, "seq_len": 4096,
              "micro_batch": 1, "moe_experts": 0, "moe_top_k": 0, "moe_layer_every": 1,
              "dtype_bytes": 2.0},
    "parallelism": {"tp": 8, "dp": 2, "pp": 2, "ep": 1, "ep_over_dp": 0,
                    "num_microbatches": None},
    "compute": {"chip_flops": 197e12, "mfu": 0.4},
    "fabric": {"kind": "roft", "n_servers": 4, "gpus_per_server": 8, "leaf_radix": 32,
               "n_spines": 8, "bw": 12.5e9, "delay": 1e-6},
    "cca": "hpcc", "collective": "ring",
    "sim": {"mtu": 1000.0, "ecn_k": 64000.0, "buffer_bytes": 512000.0},
    "fluid": {"steps": 200, "g": 0.0625, "ecn_k": 64000.0, "mss": 1000.0,
              "precision": "float32"},
    "guarantees": {"wormhole_fct_err_mean_pct": 1.0, "wormhole_fct_err_max_pct": 5.0},
    "assumed": {"straggler_mult": [1.1, 1.5]},
}


def _limit(name: str) -> float:
    """The fluid cells' limit on a flow's FCT gap: the tolerance the fluid
    reference is held to here too."""
    return json.loads((BENCH / "limits" / f"{name}.json").read_text())["fluid_fct_gap"]


def test_packet_oracle_matches_the_program_on_quickstart():
    flows = [(fid, i, 12 + (i % 2), 8e6, start)
             for fid, (start, i) in enumerate((s, i) for s in (0.0, 0.02) for i in range(4))]
    scn = Scenario(name="quickstart",
                   topology=TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4, "n_spines": 2}),
                   flows=[PortFlowSpec(f, s, d, size=z, start=t, cca="dctcp")
                          for f, s, d, z, t in flows])
    prog = run(scn, backend="packet")
    sim = PacketSim(TOPOLOGY_BUILDERS["clos"](n_hosts=16, leaf_down=4, n_spines=2))
    for f, s, d, z, t in flows:
        sim.add_flow(FlowSpec(f, s, d, size=z, start=t, cca="dctcp"))
    sim.run()
    assert {f: r.fct for f, r in sim.results.items()} == prog.fcts
    assert sim.events_processed == prog.events_processed


@pytest.mark.parametrize("straggler", [None, (5, 1.37)])
def test_packet_oracle_matches_the_program_on_gpt32(straggler):
    prog = run(port_scenario({**GPT32, "message_bytes_scale": 1 / 256}, straggler, "t"),
               backend="packet")
    fcts, it_time, events = run_packet(Job(GPT32), 1 / 256, straggler)
    assert fcts == prog.fcts
    assert it_time == prog.iteration_time
    assert events == prog.events_processed


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH / "configs").glob("*.json")))
def test_job_builds_the_programs_phases(name):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    for straggler in (None, (3, 1.25)):
        ours = Job(config).phases(config["message_bytes_scale"], straggler)
        theirs = port_scenario(config, straggler, "t").build_phases()
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert (a.name, a.deps, a.compute) == (b.name, b.deps, b.compute)
            assert [(f.fid, f.src, f.dst, f.size, f.cca, f.tag) for f in a.flows] == \
                [(f.fid, f.src, f.dst, f.size, f.cca, f.tag) for f in b.flows]


@pytest.mark.parametrize("straggler", [None, (17, 1.21)])
def test_fluid_reference_matches_the_programs_cpu_path(straggler):
    prog = run(port_scenario({**GPT32, "message_bytes_scale": 1.0}, straggler, "t"),
               backend="fluid", device="cpu")
    job = Job(GPT32)
    fcts, it_time, shapes = FluidReference(job.topology(), GPT32["fluid"]).iteration(
        job.phases(1.0, straggler))
    assert fcts.keys() == prog.fcts.keys()
    gap = max(abs(prog.fcts[f] / fcts[f] - 1) for f in fcts)
    assert gap <= _limit("gpt13b-128.fluid")
    assert abs(prog.iteration_time / it_time - 1) <= _limit("gpt13b-128.fluid")
    assert shapes and all(F >= 1 and L >= 1 and nnz >= F for F, L, nnz in shapes)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-9, 3.0e38, -2.5, 0.0, math.inf])
    got = to_bfloat16(x)
    assert got[0] == 1.0 and got[4] == -2.5 and got[5] == 0.0 and got[6] == math.inf
    assert got[1] == 1.0                      # a tie rounds to even
    assert got[2] == 1.0 + 2**-7               # above the tie rounds up
    assert abs(got[3] / 3.0e38 - 1) < 2**-8


def test_work_count_pins_k1s_bound_at_gpt128():
    by_bytes, what = least_seconds(64, 64, 128, 200, window=False)
    ops = least_seconds(64, 64, 128, 200, window=False,
                        peaks={"f32_flops": 67e12, "hbm_bytes_per_s": math.inf})[0]
    assert what == "bytes"
    assert round(by_bytes * 1e3, 8) == 0.00003653
    assert round(ops * 1e3, 9) == 0.000007833
    # with the steady detector's window (the engine's scan), and moe@1024's largest
    assert round(least_seconds(64, 64, 128, 200)[0] * 1e3, 8) == 0.00003668
    assert round(least_seconds(1024, 400, 2304, 200, window=False)[0] * 1e3, 7) == 0.0008433


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program_or_jax(path):
    assert not _imports(path) & FORBIDDEN
    assert not _imports(path) & {"torch"}, "the reference is NumPy and Python"


# the tests import the program, to hold the reference against it
@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py") if p.parent.name != "tests"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}
