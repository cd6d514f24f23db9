"""The control's readings, which set a cell's limits from above, through
the comparison of ``simbench.checks`` (the harness's own runs give the
sound readings, from below).

    python3 simbench/control.py --workload <cell> --seeds <n,n,...>

The control stands in the program's place at the cell's own size, on each
``--seeds`` draw (seed, 0), and has to come out not correct:

* fluid results: the NumPy fluid model with every intermediate rounded to
  bfloat16, the precision below the float32 the configuration states;
* wormhole results: the program's own flow-level path (the ``hybrid``
  backend at ``fidelity="flow"``), the coarser granularity that would
  tempt a change to skip more events.

One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_iteration(cell, seed: int):
    from repro_torch.api import runner
    from simbench.checks import Iteration
    from simbench.harness import port_scenario, straggler_draw
    from simbench.reference.fluid import FluidReference
    from simbench.reference.job import Job
    job = Job(cell.config)
    straggler = straggler_draw(cell.config, seed, 0)
    it = Iteration(k=0, straggler=straggler)
    for b in cell.mix["backends"]:
        if b == "fluid":
            ref = FluidReference(job.topology(), cell.config["fluid"], rounding="bfloat16")
            fcts, t, _ = ref.iteration(job.phases(cell.config["message_bytes_scale"], straggler))
        else:
            res = runner.run(port_scenario(cell.config, straggler, "control"),
                             backend="hybrid", fidelity="flow")
            fcts, t = res.fcts, res.iteration_time
        it.fcts[b], it.iteration_time[b] = fcts, t
    return it


def main(argv=None, root: Path = ROOT) -> int:
    from simbench.checks import verify
    from simbench.harness import load_cell
    ap = argparse.ArgumentParser(prog="simbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(root, args.workload, trace=False)
    for seed in (int(x) for x in args.seeds.split(",") if x):
        it = control_iteration(cell, seed)
        checks, failed = verify(cell.config, cell.mix, cell.limits, [it], seed)
        print(json.dumps({"kind": "control", "seed": seed, "failed": failed, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
