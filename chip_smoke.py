#!/usr/bin/env python3
"""Proof that the PyTorch port runs on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, one JSON line each:

1. device   the card's name, count and power limit (exits 1 with no card);
2. build    nvcc builds the port's kernels from ``src/repro_torch/csrc``
            (one nvcc per source, all started together), with ptxas's
            register / shared-memory / spill report;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the shapes of the fluid engine's real phases and of the analytic
            engine's largest solves (plus the max-min solver's ceiling and
            degenerate cases), with the error and the device time of both;
            ``fluid_scan`` (K1) runs a phase's 200 control steps in one
            launch from the fluid engine's initial state, held to the plain
            loop at the histories' bar, with its time per scan and per step
            and the bound's parts; its fused steady detector (the window
            the engine asks for) must equal ``steady_scan`` (K3) over the
            scan's own history bit for bit, with the scan's time with and
            without it; ``cca_step`` is the same kernel at one step from a
            random mid-run state; K3 alone also runs at the reference's
            production monitor size;
            ``maxmin`` must equal its plain version bit for bit, with its
            regime (one cluster, or the cooperative grid) and the kernels a
            solve launches;
            ``flash_attention`` at the reference test's shapes (float32 and
            bf16), its convex-hull property, and granite-3-2b's prefill
            shape, each with the device time of the kernel, of its plain
            version and of PyTorch's ``scaled_dot_product_attention`` (the
            library yardstick, which the port never calls);
4. e2e      ``repro_torch.api.run(..., backend="fluid")`` at full width and
            real flow bytes (``scale=1.0``) for gpt@128 and moe@128 on the
            card, held against the same call on the CPU, and moe@1024 on the
            card alone; each run's kernel launch counts must be one
            fluid_scan per phase and no steady_scan (fused into the scan);
5. batch    ``run_many`` over 8 flow scenarios on the card against the CPU:
            one fluid_scan launch and no steady_scan;
6. profile  gpt@128 again, untraced and then under ``torch.profiler``: the
            device's busy share of the wall time and its time by kernel;
7. analytic ``repro_torch.api.run(..., backend="analytic")`` (host-only, exact)
            for gpt@128, moe@128 and moe@1024 at ``scale=1.0``; the same run
            built by hand (simulator + workload driver, with a flow table
            that records every solve) must equal it bit for bit, and every
            recorded solve is replayed on the card through
            ``maxmin_rates_torch(..., impl="kernel")``, held to the exact
            rates at rtol 1e-4, with one ``maxmin`` launch per solve;
8. packet   the host-only event simulators beside the card's fluid engine:
            ``compare(gpt@128 at scale 1/64, backends=("packet", "wormhole",
            "hybrid", "fluid", "analytic"))`` with each backend's events,
            wall, speedups and FCT errors against the ``packet`` oracle
            (wormhole held to the reference's bars, mean under 1 % and max
            under 5 %; hybrid at ``fidelity="auto"`` with its demotions and
            promotions, held to finite errors; fluid, on the card with one
            fluid_scan per phase, only to finite errors); then
            ``wormhole`` and ``hybrid`` (``fidelity`` "flow" and "auto") on
            gpt@128 at ``scale=1.0`` (the paper's GPT-13B on 128 GPUs) with
            their reports and iteration times beside the fluid and analytic
            ones; two identical wormhole runs with fresh SimDBs, which must
            be bit-identical; a warm two-run ``run_many(..., shared_db=True)``
            sweep; and ``packet`` at scale 1/256 on the serial loop and on
            the partition-sharded one (``parallel="partitions"``,
            ``intra_workers`` 1 and 2), whose FCTs and events must equal the
            serial run's, with the lane-worker pool's start-up time and a
            check that its worker holds no torch;
9. learned  the learned engine end to end: ``benchmarks/learned_bench.py``'s
            64-scenario wave family (16 sizes x dctcp/hpcc x 16/32 hosts) on
            ``wormhole`` as ground truth, swept by a durable campaign whose
            ``export_dataset`` must equal ``build_dataset`` over the same
            runs' records built by hand,
            ``fit`` on the card (hidden (64, 64), 1200 steps, seed 0; held-out
            mean FCT error under 0.10) twice, which must be identical, and
            once on the CPU from the same initial weights; ``predict`` on the
            card against the CPU (rtol 1e-5, atol 1e-6 on log slowdowns);
            one ``run_batch`` over a 1024-query what-if sweep, with the
            host's feature extraction and the card's ``predict`` timed
            apart; and ``compare()`` of all six backends on a held-out
            scenario, with one fluid_scan per phase;
10. campaign the experiment layer on the card: a durable campaign sweeps
            gpt@128 at ``scale=1.0`` in 4 size variants on ``fluid`` (as many
            fluid_scan launches as ``run_many`` over them), is closed and
            reopened, and the same sweep is 4 cache hits with no launch and
            the stored records; ``workers=2`` sweeps of wormhole (gpt@128 at
            1/64, equal to serial ``run()`` bit for bit, then the reopened
            campaign's SimDB warm) and of fluid (each spawn worker on the
            card, at the card-vs-CPU bar); the 10 ``campaign/*`` and
            ``learned/*`` counters of ``benchmarks/ci_regression.py`` (the fit
            on the card) against ``artifacts/ci_baseline.json``; a store
            server shared by this process and a ``python -m repro_torch
            sweep --store`` child over overlapping quickstart variants (exactly
            N records, equal by key; its ``/metrics``); and the CLI as child
            processes (``run`` twice, the second a cache hit; ``compare``,
            ``backends``, ``ls``, ``show``, ``rm``; ``fit`` of the learned
            phase's campaign on the card, its params naming the card, and the
            learned engine served from that file); the phase's wall under
            ``CAMPAIGN_PHASE_WALL_S``; every directory a temporary one;
11. serve   ``repro_torch.launch.serve.generate`` on granite-3-2b at full
            width and depth in bf16 (seeded weights): batch 4, a 2048-token
            prompt through ``Model.prefill``, then 32 greedy tokens through
            ``Model.decode_step``; exactly 40 ``flash_attention`` launches in
            the prefill and none in decode, every logit finite; one prefill
            and 4 decode steps under ``torch.profiler``; then the
            decode-after-prefill continuation at full width and depth in
            float32 (rtol 2e-2, on weights whose attention is not chaotic:
            see ``phase_serve``), and the card against the CPU at full width
            with 2 layers in float32 (prefill logits and cache).

Then the kernels line, the ``nvidia-smi`` name/power line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without that line.  It imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "tools"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
STEPS = 200                  # the fluid engine's default control intervals
WINDOW = max(8, STEPS // 10)  # the steady detector's window the engine asks for
K1_TOL = dict(rtol=1e-5, atol=1e-3)   # tests/test_kernels.py cca_step bar
# a scan's histories and final state, tests/test_torch_fluid.py's bar: rtol
# 1e-4, and one byte of atol on byte counts (queues, delivered)
SCAN_RTOL, SCAN_ATOL = 1e-4, {"queues": 1.0, "queue_hist": 1.0, "delivered": 1.0}
SCAN_KEYS = ("M", "line", "rtt0", "size", "bw", "W", "alpha", "delivered", "q")
K3_TOL = dict(rtol=1e-5, atol=0.0, fluct_rtol=1e-4)   # tests/test_kernels.py steady_scan bars
E2E_RTOL = 1e-4                       # FCTs, card vs CPU
K2_RTOL = 1e-4                        # dense float32 solver vs the exact one (tests/test_maxmin.py)
K4_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),    # tests/test_kernels.py flash bars
          "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_NEW = "granite-3-2b", 4, 2048, 32
CONTINUATION_TOL = 2e-2               # tests/test_archs.py:125
CARD_CPU_NORMWISE = 1e-3              # max|card - cpu| <= tol * max|cpu|, float32
WORMHOLE_MEAN_ERR, WORMHOLE_MAX_ERR = 0.01, 0.05   # tests/test_wormhole.py:37-42
PACKET_PHASE_WALL_S = 300             # the packet phase's whole wall, a guard on the time limit
CAMPAIGN_PHASE_WALL_S = 180           # likewise for the campaign phase
LEARNED_HELDOUT_ERR = 0.10            # tests/test_learned.py:125-128
PREDICT_TOL = dict(rtol=1e-5, atol=1e-6)   # log slowdowns, card vs CPU
LEARNED_BACKENDS = ("packet", "wormhole", "hybrid", "fluid", "analytic", "learned")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------- #
# timing
# ---------------------------------------------------------------------- #
def device_ms(torch, fn, n: int = 50) -> tuple[float, float]:
    """(device ms per call, host ms per call).  The calls are queued behind
    a sleeping kernel, so the device runs them back to back and the events
    time the device's work, not the host's enqueue; the host time says what
    one call costs the caller."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)          # ~0.1 s at H100 clocks
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    host = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_errs(outs, refs, rtol: float, atol: float) -> tuple[float, float, bool]:
    abs_err, rel_err, ok = 0.0, 0.0, True
    for o, r in zip(outs, refs):
        d = (o - r).abs()
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / r.abs().clamp_min(1e-30)).max()))
        ok = ok and bool((d <= atol + rtol * r.abs()).all())
    return abs_err, rel_err, ok


def ptxas_report(lib, fragment: str) -> dict:
    """ptxas's registers, static shared memory and spill bytes of every
    entry function whose mangled name holds ``fragment``, by that name."""
    kernels, name = {}, None
    for ln in lib.log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and fragment in name:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            used = re.search(r"Used (\d+) registers", ln)
            if spills:
                kernels.setdefault(name, {})["spill_bytes"] = int(spills[1]) + int(spills[2])
            elif used:
                smem = re.search(r"(\d+) bytes smem", ln)
                kernels.setdefault(name, {}).update(registers=int(used[1]),
                                                    static_smem_bytes=int(smem[1]) if smem else 0)
    return kernels


def tensor_core_report(lib) -> dict:
    """Registers and spills of K4's bf16 kernel from ptxas's report (it must
    not spill), and, where the toolkit has cuobjdump, how many tensor-core
    instructions (HGMMA: wgmma; HMMA: mma.sync) its SASS holds."""
    from repro_torch.kernels.build import find_nvcc
    kernels = {"D" + name.split("flash_attention_tc_kernelILi")[1].split("E")[0]: v
               for name, v in ptxas_report(lib, "flash_attention_tc_kernelILi").items()}
    check(kernels and all(k.get("spill_bytes") == 0 for k in kernels.values()),
          f"flash_attention bf16 kernel: spills or no ptxas report: {kernels}")
    sass = {}
    cuobjdump = pathlib.Path(find_nvcc()).parent / "cuobjdump"
    if cuobjdump.exists():
        text = subprocess.run([str(cuobjdump), "-sass", str(lib.path)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        sass = {op: text.count(op) for op in ("HGMMA", "HMMA")}
    return dict(ptxas=kernels, sass_tensor_core_ops=sass or "cuobjdump not found")


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #
def fluid_phases(scn):
    """Every phase's FluidScenario: the host's share of a fluid run (phase
    DAG, ECMP routing, incidence matrices), done here on its own."""
    from repro_torch.net.fluid import FluidScenario
    topo = scn.build_topology()
    return [FluidScenario.from_flows(topo, [(f.fid, f.src, f.dst, f.size)
                                            for f in ph.flows])
            for ph in scn.build_phases() if ph.flows]


def largest_phase(scn):
    return max(fluid_phases(scn), key=lambda fs: fs.incidence.size)


def k1_inputs(torch, fs, rng, batch: int | None):
    """The phase's real incidence, rates and capacities, with a random
    mid-run state (queues across the ECN ramp, some flows done)."""
    F, L = fs.incidence.shape
    shape = (batch,) if batch else ()

    def t(x):
        return torch.from_numpy(np.array(x, np.float32, order="C")).cuda()
    line = np.broadcast_to(fs.line_rate, (*shape, F))
    rtt0 = np.broadcast_to(fs.base_rtt, (*shape, F))
    size = np.broadcast_to(fs.size, (*shape, F))
    cap = 2 * line * rtt0
    return dict(
        R=t(line), W=t(np.maximum(rng.uniform(0.05, 1.0, (*shape, F)) * cap, 1000.0)),
        alpha=t(rng.uniform(0, 1, (*shape, F))),
        delivered=t(rng.uniform(0, 1.2, (*shape, F)) * size), size=t(size),
        line=t(line), rtt0=t(rtt0),
        M=t(np.broadcast_to(fs.incidence, (*shape, F, L))),
        q=t(rng.uniform(0, 2e5, (*shape, L))),
        bw=t(np.broadcast_to(fs.link_bw, (*shape, L))))


def scan_flops(B: int, F: int, L: int, nnz: int, steps: int) -> int:
    """Operations of ``steps`` fluid steps on these inputs: per set bit of
    the incidence one add for the queue delay, one max for the mark and one
    add for the arrivals; about 25 per flow (the DCTCP update) and 10 per
    link (the queue update, q / bw and the mark)."""
    return steps * (3 * nnz + B * (25 * F + 10 * L))


def host_ms(torch, fn, n: int = 20) -> float:
    """Host clock per call of ``fn`` (a wrapper, its checks and its sync
    included), each call waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def batched(a: dict) -> dict:
    """Inputs with the leading batch dimension the kernel's launch takes."""
    return {k: v if v.dim() == (3 if k == "M" else 2) else v.unsqueeze(0) for k, v in a.items()}


def cca_step_rows(torch, cases, rng, rows: dict) -> None:
    """K1 at one step (``cca_step``) from a random mid-run state."""
    from repro_torch.kernels.cca_step import cca_step, cca_step_plain
    from repro_torch.kernels.cca_step.ops import fluid_scan_kernel
    for name, fs, batch in cases:
        a = k1_inputs(torch, fs, rng, batch)
        consts = dict(dt=1e-5, g=1 / 16, ecn_k=64_000.0, mss=1000.0)
        out = cca_step(**a, **consts)
        ref = cca_step_plain(**a, **consts)
        torch.cuda.synchronize()
        abs_err, rel_err, ok = max_errs(out, ref, **K1_TOL)
        t = batched({k: v for k, v in a.items() if k != "R"})
        ms, _ = device_ms(torch, lambda t=t: fluid_scan_kernel(t, steps=1, history=False,
                                                               **consts))
        call_ms = host_ms(torch, lambda a=a: cca_step(**a, **consts))
        plain_ms, _ = device_ms(torch, lambda a=a: cca_step_plain(**a, **consts))
        B = batch or 1
        F, L = fs.incidence.shape
        nbytes = 4 * B * (6 * F + F * L + 2 * L + 4 * F + L)
        flops = scan_flops(B, F, L, B * int(fs.incidence.sum()), 1)
        b_ms, b_by = bound(nbytes, flops)
        row = dict(kernel="cca_step", case=name, B=B, F=F, L=L, steps=1,
                   max_abs_err=abs_err, max_rel_err=rel_err, tolerance=K1_TOL,
                   ok=ok, ms=ms, host_ms_per_call=call_ms, plain_ms=plain_ms,
                   note="the fluid_scan kernel at one step; ms times its launch alone, "
                        "host_ms_per_call the wrapper with its 0/1 check (a sync)",
                   plain_note="plain PyTorch version, not a yardstick",
                   bound_ms=b_ms, bound_by=b_by)
        emit("kernels", **row)
        check(ok, f"cca_step disagrees with its plain version at {name}: {row}")
        rows[("cca_step", name)] = row


def scan_inputs(torch, fs, batch: int | None) -> tuple[dict, float]:
    """The fluid engine's call for this phase (``fluid_converged_rates``):
    its initial state, unbounded flows, dt the median base RTT."""
    F, L = fs.incidence.shape
    shape = (batch,) if batch else ()

    def t(x, *n):
        return torch.from_numpy(np.array(np.broadcast_to(x, (*shape, *n)), np.float32,
                                         order="C")).cuda()
    line, rtt0, bw = t(fs.line_rate, F), t(fs.base_rtt, F), t(fs.link_bw, L)
    a = dict(M=t(fs.incidence, F, L),
             line=line, rtt0=rtt0, size=torch.full_like(line, float("inf")), bw=bw,
             W=line * rtt0, alpha=torch.ones_like(line), delivered=torch.zeros_like(line),
             q=torch.zeros_like(bw))
    return a, float(np.median(fs.base_rtt))


def fluid_scan_rows(torch, cases, rows: dict, ptxas: dict) -> None:
    """K1 as the fluid engine runs it: one scan of STEPS control steps with
    the steady detector over its last WINDOW steps; and that detector (K3
    fused into the scan) against K3 over the scan's own history."""
    from repro_torch.kernels.cca_step import fluid_scan, fluid_scan_plain
    from repro_torch.kernels.cca_step.ops import fluid_scan_kernel, workspace_bytes
    from repro_torch.kernels.steady_scan import steady_scan, steady_scan_plain
    for name, fs, batch in cases:
        a, dt = scan_inputs(torch, fs, batch)
        consts = dict(dt=dt, steps=STEPS, g=1 / 16, ecn_k=64_000.0, mss=1000.0, history=True,
                      window=WINDOW)
        bare = {**consts, "window": None}
        args = [a[k] for k in SCAN_KEYS]
        out = fluid_scan(*args, **consts)
        ref = fluid_scan_plain(*args, **consts)
        hist_t = out["rate_hist"].transpose(-1, -2)
        k3_fluct, k3_mean = steady_scan(hist_t, WINDOW)
        # the window's stats against the plain detector over the same
        # history, the scan's own, at K3's bars (fluct's looser)
        win_fluct, win_mean = steady_scan_plain(hist_t, WINDOW)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for k, r in ref.items():
            if k == "win_mean":
                r, rtol, atol = win_mean, K3_TOL["rtol"], K3_TOL["atol"]
            elif k == "win_fluct":
                r, rtol, atol = win_fluct, K3_TOL["fluct_rtol"], 0.0
            else:
                rtol, atol = SCAN_RTOL, SCAN_ATOL.get(k, 0.0)
            abs_err, rel_err, k_ok = max_errs([out[k]], [r], rtol, atol)
            errs[k] = dict(max_abs_err=abs_err, max_rel_err=rel_err)
            ok = ok and k_ok
        bit_equal = all(torch.equal(out[k], ref[k]) for k in ref)
        fused_equal = (torch.equal(out["win_mean"], k3_mean)
                       and torch.equal(out["win_fluct"], k3_fluct))
        t = batched(a)
        # with and without the window, in turns: without, with, with, without
        times = [device_ms(torch, lambda t=t, c=c: fluid_scan_kernel(t, **c), n=20)[0]
                 for c in (bare, consts, consts, bare)]
        ms, ms_bare = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
        call_ms = host_ms(torch, lambda: fluid_scan(*args, **consts), n=5)
        plain_ms, _ = device_ms(torch, lambda: fluid_scan_plain(*args, **consts), n=3)
        B = batch or 1
        F, L = fs.incidence.shape
        nnz = B * int(fs.incidence.sum())
        # inputs once (M dense float32, 6 flow and 2 link vectors), outputs once
        # (4 flow and 2 link vectors, both histories, the window's 2 flow vectors);
        # the window adds 3 operations a flow a step and 4 a flow at the end
        nbytes = 4 * B * (F * L + 6 * F + 2 * L + 4 * F + 2 * L + STEPS * (F + L) + 2 * F)
        flops = scan_flops(B, F, L, nnz, STEPS) + B * F * (3 * WINDOW + 4)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        b_ms, b_by = bound(nbytes, flops)
        ws = workspace_bytes(F, L)
        row = dict(kernel="fluid_scan", case=name, B=B, F=F, L=L, steps=STEPS, dt=dt,
                   window=WINDOW, set_bits=nnz, errors=errs,
                   max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                   bit_equal_to_plain=bit_equal,
                   tolerance=dict(rtol=SCAN_RTOL, atol=SCAN_ATOL,
                                  window=dict(against="steady_scan_plain over the scan's "
                                              "rate history", **K3_TOL)), ok=ok,
                   ms=ms, ms_without_window=ms_bare, ns_per_step=ms / STEPS * 1e6,
                   host_ms_per_call=call_ms,
                   plain_ms=plain_ms, plain_note="plain PyTorch loop over steps, not a yardstick",
                   bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_bytes_ms=bytes_ms,
                   bound_flops=flops, bound_ops_ms=ops_ms,
                   latency_floor=f"{STEPS} steps x 2 block barriers",
                   workspace_bytes_per_block=ws,
                   workspace="shared memory" if ws <= 232_448 else "global scratch",
                   ptxas=ptxas)
        emit("kernels", **row)
        check(ok, f"fluid_scan disagrees with its plain version at {name}: {row}")
        rows[("fluid_scan", name)] = row
        # the detector's own bound: the window's rates read once, 2 outputs
        n_series = B * F
        k3_ms, k3_by = bound(4 * n_series * (WINDOW + 2), 3 * n_series * WINDOW + 4 * n_series)
        fused = dict(kernel="steady_scan", case=f"fused into fluid_scan, {name}", window=WINDOW,
                     bit_equal_to_k3=fused_equal, tolerance="bit-equal (torch.equal) to "
                     "steady_scan over the scan's rate history", ok=fused_equal,
                     ms=ms - ms_bare, scan_ms_with_window=ms, scan_ms_without_window=ms_bare,
                     scan_cost_share=(ms - ms_bare) / ms_bare, bound_ms=k3_ms, bound_by=k3_by,
                     note="ms is the scan's time with the window less without it")
        emit("kernels", **fused)
        check(fused_equal, f"fluid_scan's fused detector differs from steady_scan at {name}")
        rows[("steady_scan fused", name)] = fused


def phase_kernels(torch, scenarios, rng, ptxas: dict) -> dict:
    from repro_torch.kernels.steady_scan import steady_scan, steady_scan_plain
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    phases = {name: largest_phase(scn) for name, scn in scenarios.items()}
    cases = [(name, fs, None) for name, fs in phases.items()]
    cases.append(("moe@128 x16", phases["moe@128"], 16))
    fluid_scan_rows(torch, cases, rows, ptxas)
    cca_step_rows(torch, cases, rng, rows)

    k3_cases = [(f"[{STEPS}, {fs.incidence.shape[0]}] {name}",
                 rng.uniform(1e8, 1e10, (STEPS, fs.incidence.shape[0])), 20, 0.0, "time")
                for name, fs in phases.items()]
    k3_cases.append(("[16, 200, 128] batched", rng.uniform(1e8, 1e10, (16, STEPS, 128)),
                     20, 0.0, "time"))
    dead = np.zeros((130, 32))
    dead[1] = 1500.0
    dead[2] = rng.uniform(1e8, 1e10, 32)
    k3_cases.append(("[130, 32] atol dead band", dead, 32, 2000.0, "series"))
    # the reference's production monitor (src/repro/kernels/steady_scan/kernel.py:5):
    # 10^5 flows by 128 samples, series-major
    k3_cases.append(("[100000, 128] production monitor", rng.uniform(1e8, 1e10, (100_000, 128)),
                     32, 0.0, "series"))
    for name, h, window, atol, layout in k3_cases:
        ht = torch.from_numpy(h.astype(np.float32)).cuda()
        # the fluid engine's histories are time-major: scan their transpose
        hist = ht.transpose(-1, -2) if layout == "time" else ht
        out = steady_scan(hist, window, atol)
        ref = steady_scan_plain(hist, window, atol)
        torch.cuda.synchronize()
        fl_err = max_errs(out[:1], ref[:1], rtol=K3_TOL["fluct_rtol"], atol=0.0)
        abs_err, rel_err, ok = max_errs(out[1:], ref[1:], K3_TOL["rtol"], K3_TOL["atol"])
        ok = ok and fl_err[2]
        if atol:
            ok = ok and float(out[0][0]) == 0.0 and float(out[0][1]) == 0.0
        ms, host_ms = device_ms(torch, lambda: steady_scan(hist, window, atol))
        plain_ms, _ = device_ms(torch, lambda: steady_scan_plain(hist, window, atol))
        n_series = hist.numel() // hist.shape[-1]
        nbytes = 4 * n_series * (window + 2)
        flops = 3 * n_series * window + 4 * n_series
        b_ms, b_by = bound(nbytes, flops)
        row = dict(kernel="steady_scan", case=name, window=window, atol=atol,
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   fluct_max_rel_err=fl_err[1], tolerance=K3_TOL, ok=ok, ms=ms,
                   host_ms_per_call=host_ms, plain_ms=plain_ms,
                   plain_note="plain PyTorch version, not a yardstick",
                   bound_ms=b_ms, bound_by=b_by)
        emit("kernels", **row)
        check(ok, f"steady_scan disagrees with its plain version at {name}: {row}")
        rows[("steady_scan", name)] = row
    return rows


def attention_pairs(S: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that a head's attention computes: what this run's
    masks leave, not S * S."""
    i = np.arange(S)
    hi = i + 1 if causal else np.full(S, S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_kernels(torch, rows: dict) -> None:
    """K4 against its plain version on the card; SDPA timed beside it where
    it computes the same function (no window)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attention import attention_plain, flash_attention
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [  # tests/test_kernels.py:136-143 and :157-165, the serving path's prefill, more bf16
        ("f32 1x2/2x128x64 causal", (1, 2, 2, 128, 64), True, None, torch.float32),
        ("f32 2x4/2x256x64 GQA", (2, 4, 2, 256, 64), True, None, torch.float32),
        ("f32 1x8/1x128x128 MQA", (1, 8, 1, 128, 128), True, None, torch.float32),
        ("f32 1x4/4x200x64 ragged", (1, 4, 4, 200, 64), True, None, torch.float32),
        ("f32 1x4/2x256x64 window 128", (1, 4, 2, 256, 64), True, 128, torch.float32),
        ("f32 1x2/2x256x64 bidirectional", (1, 2, 2, 256, 64), False, None, torch.float32),
        ("bf16 1x4/2x128x64 causal", (1, 4, 2, 128, 64), True, None, torch.bfloat16),
        ("granite prefill bf16 4x32/8x2048x64 causal", (4, 32, 8, 2048, 64), True, None,
         torch.bfloat16),
        # mistral-nemo-12b's heads (src/repro_torch/configs/mistral_nemo_12b.py) at
        # granite's prefill batch and prompt: the tensor-core kernel at D = 128
        ("mistral-nemo prefill bf16 4x32/8x2048x128 causal", (4, 32, 8, 2048, 128), True,
         None, torch.bfloat16),
        ("bf16 1x4/2x256x64 window 128", (1, 4, 2, 256, 64), True, 128, torch.bfloat16),
        ("bf16 1x4/4x200x64 ragged", (1, 4, 4, 200, 64), True, None, torch.bfloat16),
    ]
    for name, (B, Hq, Hk, S, D), causal, window, dtype in cases:
        q = torch.randn(B, Hq, S, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, Hk, S, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, Hk, S, D, generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window)
        out = flash_attention(q, k, v, **kw)
        ref = attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = K4_TOL[str(dtype).removeprefix("torch.")]
        abs_err, rel_err, ok = max_errs([out.float()], [ref.float()], **tol)
        row = dict(kernel="flash_attention", case=name, shape=[B, Hq, Hk, S, D],
                   causal=causal, window=window, dtype=str(dtype), max_abs_err=abs_err,
                   max_rel_err=rel_err, tolerance=tol, ok=ok)
        if name.startswith("f32 1x2/2x128x64"):       # tests/test_kernels.py:168-176
            hull = (float(out.max()) <= float(v.max()) + 1e-4
                    and float(out.min()) >= float(v.min()) - 1e-4)
            row.update(convex_hull=hull)
            ok = ok and hull
        ms, host_ms = device_ms(torch, lambda: flash_attention(q, k, v, **kw))
        plain_ms, _ = device_ms(torch, lambda: attention_plain(q, k, v, **kw), n=5)
        library_ms = None
        if window is None:
            library_ms, _ = device_ms(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                                          enable_gqa=True))
        esize = q.element_size()
        nbytes = esize * (2 * B * Hq * S * D + 2 * B * Hk * S * D)
        flops = 4 * D * B * Hq * attention_pairs(S, causal, window)
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        b_ms, b_by = bound(nbytes, flops, rate)
        row.update(ms=ms, host_ms_per_call=host_ms, plain_ms=plain_ms,
                   plain_note="plain PyTorch version (materialises the logits), not a yardstick",
                   library_ms=library_ms,
                   library_call="scaled_dot_product_attention(enable_gqa=True)"
                   if library_ms is not None else "none: SDPA takes no window",
                   gflop=flops / 1e9, tflop_per_s=flops / ms / 1e9,
                   bound_ms=b_ms, bound_by=b_by,
                   bound_rate="bf16 tensor cores" if dtype == torch.bfloat16
                   else "float32 outside the tensor cores")
        emit("kernels", **row)
        check(ok, f"flash_attention disagrees with its plain version at {name}: {row}")
        rows[("flash_attention", name)] = row
        del q, k, v, out, ref
    torch.cuda.empty_cache()


def finite_fcts(res) -> bool:
    return bool(res.fcts) and all(np.isfinite(v) and v > 0 for v in res.fcts.values())


def compare_results(a, b, what: str) -> dict:
    check(set(a.fcts) == set(b.fcts), f"{what}: flow sets differ")
    errs = [abs(a.fcts[k] - b.fcts[k]) / b.fcts[k] for k in b.fcts]
    it_err = abs(a.iteration_time - b.iteration_time) / b.iteration_time
    check(finite_fcts(a), f"{what}: non-finite or non-positive FCTs")
    check(max(errs) <= E2E_RTOL and it_err <= E2E_RTOL,
          f"{what}: card vs CPU max FCT rel err {max(errs)}, iteration {it_err}")
    return dict(max_fct_rel_err=max(errs), iteration_rel_err=it_err)


def phase_e2e(torch, scenarios, launches: dict) -> dict:
    from repro_torch.api import run
    from repro_torch.kernels.cca_step import cca_step, fluid_scan
    from repro_torch.kernels.steady_scan import steady_scan
    iterations = {}
    for name, scn in scenarios.items():
        n_phases = sum(1 for ph in scn.build_phases() if ph.flows)
        cca_step.launches = fluid_scan.launches = steady_scan.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(scn, backend="fluid")             # the card is the default
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(fluid_scan=fluid_scan.launches, steady_scan=steady_scan.launches,
                      cca_step=cca_step.launches)
        for k in ("fluid_scan", "steady_scan"):
            launches[k] += counts[k]
        check(counts == dict(fluid_scan=n_phases, steady_scan=0, cca_step=0),
              f"{name}: launches {counts}, expected one scan per phase ({n_phases}) "
              "and no steady_scan (fused into the scan)")
        t0 = time.perf_counter()
        fluid_phases(scn)
        host_prep = time.perf_counter() - t0
        row = dict(scenario=name, phases_with_flows=n_phases, flows=len(res.fcts),
                   launches=counts, wall_s=wall, engine_wall_s=res.wall_time,
                   host_prep_s=host_prep,
                   iteration_time=res.iteration_time, device=res.extras["device"])
        if name != "moe@1024":          # the CPU reference at this width takes minutes
            t0 = time.perf_counter()
            cpu = run(scn, backend="fluid", device="cpu")
            row["cpu_wall_s"] = time.perf_counter() - t0
            row.update(compare_results(res, cpu, name))
        else:
            check(finite_fcts(res) and res.iteration_time > 0, f"{name}: bad FCTs")
        emit("e2e", **row)
        iterations[name] = res.iteration_time
    return iterations


def phase_profile(torch, name: str, scn) -> None:
    """One traced run: the device's busy share and its time by kernel.  The
    trace's own cost lengthens the traced wall, so the busy share is also
    given against the untraced wall of a second run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import run
    run(scn, backend="fluid")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(scn, backend="fluid")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(scn, backend="fluid")
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile", scenario=name, wall_s=wall, traced_wall_s=traced_wall,
         device_busy_s=busy if busy > 0 else "not measured",
         busy_share_of_wall=busy / wall if busy > 0 else "not measured",
         kernels=[dict(name=e.key[:60], count=e.count,
                       device_s=e.self_device_time_total / 1e6) for e in top])


def flow_scenarios(n: int, rng):
    from repro_torch.api import FlowSpec, Scenario, TopologySpec
    out = []
    for i in range(n):
        pairs = set()
        while len(pairs) < 16 + 8 * i:
            s, d = (int(x) for x in rng.integers(0, 64, 2))
            if s != d:
                pairs.add((s, d))
        flows = [FlowSpec(fid, s, d, size=float(rng.uniform(1e6, 1e8)),
                          start=float(rng.choice([0.0, 1e-3])))
                 for fid, (s, d) in enumerate(sorted(pairs))]
        out.append(Scenario(f"flows{i}", TopologySpec(
            "clos", {"n_hosts": 64, "leaf_down": 16, "n_spines": 4}), flows=flows))
    return out


def phase_batch(torch, rng) -> None:
    from repro_torch.api import run_many
    from repro_torch.kernels.cca_step import cca_step, fluid_scan
    from repro_torch.kernels.steady_scan import steady_scan
    scns = flow_scenarios(8, rng)
    cca_step.launches = fluid_scan.launches = steady_scan.launches = 0
    t0 = time.perf_counter()
    res = run_many(scns, backend="fluid")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fluid_scan=fluid_scan.launches, steady_scan=steady_scan.launches,
                  cca_step=cca_step.launches)
    check(counts == dict(fluid_scan=1, steady_scan=0, cca_step=0),
          f"batch: launches {counts}, expected one scan and no steady_scan")
    cpu = run_many(scns, backend="fluid", device="cpu")
    errs = [compare_results(a, b, a.scenario) for a, b in zip(res, cpu)]
    emit("batch", scenarios=len(scns), flows=sum(len(r.fcts) for r in res),
         launches=counts, wall_s=wall,
         max_fct_rel_err=max(e["max_fct_rel_err"] for e in errs))


def recording_table():
    """A FlowTable that keeps every solve's CSR paths, so the analytic
    engine's solves can be replayed through the dense solver."""
    from repro_torch.net.soa import FlowTable

    class RecordingTable(FlowTable):
        __slots__ = ("solves",)

        def __init__(self) -> None:
            super().__init__()
            self.solves = []

        def solve_rates(self, fids, link_bw):
            fids = list(fids)
            _, links, off = self.csr(fids)
            self.solves.append((links, off))
            return super().solve_rates(fids, link_bw)
    return RecordingTable()


def record_analytic(scn) -> dict:
    """The analytic run built by hand: simulator, workload driver and a
    recording flow table."""
    from repro_torch.api import AnalyticSim
    from repro_torch.workload.driver import WorkloadDriver
    topo = scn.build_topology()
    sim = AnalyticSim(topo)
    sim.flow_table = recording_table()
    driver = WorkloadDriver(sim, scn.build_phases())
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    check(driver.finished, f"{scn.name}: hand-built analytic run did not finish")
    return dict(sim=sim, driver=driver, solves=sim.flow_table.solves,
                link_bw=topo.link_bw, wall=wall)


def maxmin_cases(recorded: dict) -> list:
    """(name, inc, cap): the largest solve of each recorded analytic run,
    the reference's 10k-flow ceiling, and the degenerate cases."""
    from repro_torch.kernels.maxmin.ops import incidence_from_csr, paths_to_arrays
    cases = []
    for name, rec in recorded.items():
        links, off = max(rec["solves"], key=lambda lo: len(np.unique(lo[0])) * (len(lo[1]) - 1))
        cases.append((f"{name} largest solve", *incidence_from_csr(links, off, rec["link_bw"])))
    rng = np.random.default_rng(11)                # tests/test_maxmin.py's ceiling case
    F, L = 10_000, 128
    links = rng.random((F, L)).argpartition(3, axis=1)[:, :3].astype(np.int64).ravel()
    off = np.arange(0, 3 * (F + 1), 3, dtype=np.int64)
    cases.append(("10k x 128 ceiling", *incidence_from_csr(links, off, rng.uniform(1e9, 1e10, L))))
    # masks (4 MB) beyond a 16-CTA cluster's shared memory: the cooperative grid
    F, L = 16_384, 2048
    links = rng.random((F, L)).argpartition(4, axis=1)[:, :4].astype(np.int64).ravel()
    off = np.arange(0, 4 * (F + 1), 4, dtype=np.int64)
    cases.append(("16384 x 2048 grid regime",
                  *incidence_from_csr(links, off, rng.uniform(1e9, 1e10, L))))
    for name, paths, bw in [("zero-bandwidth link", {1: [0, 1], 2: [1]}, [5.0, 0.0]),
                            ("single flow", {1: [0]}, [7.0]),
                            ("no links", {1: [], 2: []}, [7.0])]:
        _, links, off = paths_to_arrays(paths)
        cases.append((name, *incidence_from_csr(links, off, bw)))
    return cases


def maxmin_kernels(torch, recorded: dict, rows: dict) -> None:
    from hopper_barriers import barrier_ns

    from repro_torch.kernels.maxmin import maxmin, maxmin_plain
    from repro_torch.kernels.maxmin.ops import maxmin_kernel, plan
    for name, inc_np, cap_np in maxmin_cases(recorded):
        inc = torch.from_numpy(inc_np).cuda()
        cap = torch.from_numpy(cap_np).cuda()
        F, L = inc.shape
        launches = maxmin.launches
        out, rounds = maxmin(inc, cap, with_rounds=True)
        ref, ref_rounds = maxmin_plain(inc, cap, with_rounds=True)
        torch.cuda.synchronize()
        launched = maxmin.launches - launches
        ok = torch.equal(out, ref) and int(rounds) == int(ref_rounds)
        ok = ok and launched == (1 if L else 0)
        row = dict(kernel="maxmin", case=name, F=F, L=L, set_bits=int(inc_np.sum()),
                   max_abs_err=float((out - ref).abs().max()) if F else 0.0,
                   tolerance="bit-equal (torch.equal), equal rounds", ok=ok,
                   effective_rounds=int(rounds), static_rounds=max(L, 1))
        if L:
            how = plan(F, L)
            ms, _ = device_ms(torch, lambda: maxmin_kernel(inc, cap))
            call_ms = host_ms(torch, lambda: maxmin(inc, cap))
            plain_ms, _ = device_ms(torch, lambda: maxmin_plain(inc, cap), n=3)
            # what these inputs need: inc read once, cap read and the rates
            # written once; the 0/1 test of every entry, and in each round that
            # froze flows a test of every set bit and 4 operations a link
            n_rounds = int(rounds)
            nbytes = 4 * (F * L + L + F)
            flops = F * L + n_rounds * (row["set_bits"] + 4 * L)
            b_ms, b_by = bound(nbytes, flops)
            # the rounds' latency floor: one barrier a round across the CTAs
            # (a cluster's, or the cooperative grid's), measured here
            kind, n_blocks = (("cluster", how["cluster"]) if how["regime"] == "cluster"
                              else ("grid", how["blocks"]))
            sync_ns = barrier_ns(kind, n_blocks, how["threads"])
            row.update(regime=how["regime"], cluster_ctas=how["cluster"],
                       global_links=how["global_links"],
                       kernels_per_solve=how["kernels"], smem_bytes_per_block=how["smem_bytes"],
                       ms=ms, us_per_round=ms * 1e3 / max(n_rounds, 1),
                       host_ms_per_call=call_ms, plain_ms=plain_ms,
                       note="ms times the launch alone; host_ms_per_call the wrapper, which "
                            "reads the 0/1 flag back (a sync)",
                       plain_note="plain PyTorch version (static L rounds), not a yardstick",
                       bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=flops,
                       barrier_ns=sync_ns, barrier=f"{kind} of {n_blocks} x {how['threads']}",
                       latency_floor_ms=n_rounds * sync_ns / 1e6,
                       latency_floor=f"{n_rounds} rounds x 1 {kind} barrier")
        else:
            row.update(ms=None, note="no links: the wrapper answers without a launch")
        emit("kernels", **row)
        check(ok, f"maxmin disagrees with its plain version at {name}: {row}")
        rows[("maxmin", name)] = row


def phase_analytic(torch, scenarios, recorded: dict, launches: dict) -> dict:
    from repro_torch.api import run
    from repro_torch.kernels.maxmin import maxmin, maxmin_rates_arrays, maxmin_rates_torch
    iterations = {}
    for name, scn in scenarios.items():
        t0 = time.perf_counter()
        res = run(scn, backend="analytic")
        wall = time.perf_counter() - t0
        rec = recorded[name]
        sim = rec["sim"]
        check({fid: r.fct for fid, r in sim.results.items()} == res.fcts
              and sim.events_processed == res.events_processed
              and rec["driver"].iteration_time == res.iteration_time,
              f"{name}: the hand-built analytic run differs from the engine's")
        check(finite_fcts(res) and res.iteration_time > 0, f"{name}: bad analytic FCTs")
        solves = rec["solves"]
        worst, t_replay = 0.0, 0.0
        maxmin.launches = 0
        for links, off in solves:
            t0 = time.perf_counter()
            got = maxmin_rates_torch(links, off, rec["link_bw"], impl="kernel")
            t_replay += time.perf_counter() - t0
            exact = maxmin_rates_arrays(links, off, rec["link_bw"])
            err = float(np.max(np.abs(got - exact) / np.maximum(np.abs(exact), 1e-30)))
            check(err <= K2_RTOL and got.shape == exact.shape,
                  f"{name}: replayed solve off the exact rates by {err}")
            worst = max(worst, err)
        n = maxmin.launches
        launches["maxmin"] += n
        check(n == len(solves), f"{name}: {n} maxmin launches for {len(solves)} solves")
        largest = max(solves, key=lambda lo: len(lo[1]))
        emit("analytic", scenario=name, flows=len(res.fcts), events=res.events_processed,
             solves=len(solves), maxmin_launches=n, host_wall_s=wall,
             engine_wall_s=res.wall_time, hand_built_wall_s=rec["wall"],
             iteration_time=res.iteration_time, largest_solve_flows=len(largest[1]) - 1,
             replay_wall_s=t_replay, worst_k2_rel_err_vs_exact=worst, tolerance=K2_RTOL)
        iterations[name] = res.iteration_time
    return iterations


def same_run(a, b) -> bool:
    """Two runs of one deterministic simulation, bar the wall clock."""
    return (a.fcts == b.fcts and list(a.fcts) == list(b.fcts)
            and a.events_processed == b.events_processed
            and a.iteration_time == b.iteration_time
            and a.kernel_report == b.kernel_report)


def phase_packet(torch, launches: dict, fluid_iters: dict, analytic_iters: dict) -> None:
    """The packet oracle, the Wormhole kernel and the hybrid engine on the
    card machine's CPU, beside the fluid engine on the card.  Event counts
    are this machine's own: they are held to the reference's by the CPU
    tests, not here."""
    from repro_torch.api import SimDB, compare, run, run_many, summarize_pair, training_scenario
    from repro_torch.kernels.cca_step import cca_step, fluid_scan
    from repro_torch.kernels.steady_scan import steady_scan
    t_phase = time.perf_counter()
    scn = training_scenario(n_gpus=128, scale=1 / 64)
    n_phases = sum(1 for ph in scn.build_phases() if ph.flows)
    cca_step.launches = fluid_scan.launches = steady_scan.launches = 0
    cmp = compare(scn, backends=("packet", "wormhole", "hybrid", "fluid", "analytic"),
                  backend_opts={"hybrid": {"fidelity": "auto"}})
    torch.cuda.synchronize()
    counts = dict(fluid_scan=fluid_scan.launches, steady_scan=steady_scan.launches,
                  cca_step=cca_step.launches)
    check(counts == dict(fluid_scan=n_phases, steady_scan=0, cca_step=0),
          f"compare: launches {counts}, expected one fluid_scan per phase ({n_phases})")
    launches["fluid_scan"] += counts["fluid_scan"]
    rows = comparison_rows(cmp)
    wh, hy, fl = rows["wormhole"], rows["hybrid"], rows["fluid"]
    check(wh["fct_err_mean"] < WORMHOLE_MEAN_ERR and wh["fct_err_max"] < WORMHOLE_MAX_ERR,
          f"wormhole vs packet: mean FCT err {wh['fct_err_mean']}, max {wh['fct_err_max']}")
    for b, row in (("hybrid", hy), ("fluid", fl)):
        check(np.isfinite(row["fct_err_mean"]) and np.isfinite(row["fct_err_max"]),
              f"{b} vs packet: FCT error not finite: {row}")
    g = cmp["hybrid"].extras["granularity"]
    hy.update(demotions=g["demotions"], promotions=g["promotions"],
              packet_lane_events=g["packet_lane_events"],
              flow_lane_events=g["flow_lane_events"])
    rows["fluid"]["device"] = cmp["fluid"].extras["device"]
    emit("packet", scenario=scn.name, what="compare", host="the card machine's CPU",
         flows=len(cmp["packet"].fcts), phases_with_flows=n_phases, launches=counts,
         backends=rows, bars=dict(wormhole_mean=WORMHOLE_MEAN_ERR, wormhole_max=WORMHOLE_MAX_ERR))

    full = training_scenario(n_gpus=128, scale=1.0)
    res = run(full, backend="wormhole")
    check(finite_fcts(res) and res.iteration_time > 0, "wormhole at scale 1.0: bad FCTs")
    rep = res.kernel_report
    emit("packet", scenario=full.name, what="wormhole at full message sizes",
         host="the card machine's CPU", flows=len(res.fcts), events=res.events_processed,
         wall_s=res.wall_time, parks=rep["parks"], replays=rep["replays"],
         skip_backs=rep["skip_backs"], est_events_skipped=rep["est_events_skipped"],
         db_hits=rep["db_hits"], db_lookups=rep["db_lookups"],
         iteration_time=res.iteration_time, fluid_iteration_time=fluid_iters["gpt@128"],
         analytic_iteration_time=analytic_iters["gpt@128"])
    for fidelity in ("flow", "auto"):
        hyb = run(full, backend="hybrid", fidelity=fidelity)
        check(finite_fcts(hyb) and set(hyb.fcts) == set(res.fcts),
              f"hybrid {fidelity} at scale 1.0: bad FCTs or another flow set")
        g = hyb.extras["granularity"]
        emit("packet", scenario=full.name, what=f"hybrid {fidelity} at full message sizes",
             host="the card machine's CPU", events=hyb.events_processed,
             wall_s=hyb.wall_time, iteration_time=hyb.iteration_time,
             demotions=g["demotions"], promotions=g["promotions"],
             packet_lane_events=g["packet_lane_events"],
             flow_lane_events=g["flow_lane_events"],
             fct_err_vs_wormhole=summarize_pair(res, hyb)["fct_err_mean"],
             wormhole_iteration_time=res.iteration_time,
             fluid_iteration_time=fluid_iters["gpt@128"],
             analytic_iteration_time=analytic_iters["gpt@128"])

    a = run(scn, backend="wormhole", db=SimDB())
    b = run(scn, backend="wormhole", db=SimDB())
    check(same_run(a, b), "two identical wormhole runs differ")
    warm = scn.variant(name=f"{scn.name}-x1.05", size_scale=1.05)
    sweep = run_many([scn, warm], backend="wormhole", shared_db=True)
    check(all(finite_fcts(r) for r in sweep), "warm sweep: bad FCTs")
    emit("packet", what="determinism and warm sweep", repeat_bit_identical=True,
         repeat_events=a.events_processed, repeat_walls_s=[a.wall_time, b.wall_time],
         sweep_events=[r.events_processed for r in sweep],
         sweep_run_db_hits=[r.kernel_report["run_db_hits"] for r in sweep],
         sweep_walls_s=[r.wall_time for r in sweep])

    phase_sharded(training_scenario(n_gpus=128, scale=1 / 256))
    wall = time.perf_counter() - t_phase
    emit("packet", what="phase", phase_wall_s=wall)
    check(wall < PACKET_PHASE_WALL_S, f"packet phase took {wall} s")


def comparison_rows(cmp) -> dict:
    """Each backend's events, wall and iteration time, and against the
    baseline its speedups and FCT errors; every backend must have finite
    FCTs for the baseline's flows."""
    from repro_torch.api import summarize_pair
    base = cmp[cmp.baseline]
    rows = {}
    for b, r in cmp.results.items():
        check(finite_fcts(r) and set(r.fcts) == set(base.fcts),
              f"compare: {b} has bad FCTs or another flow set than {cmp.baseline}")
        row = dict(events=r.events_processed, wall_s=r.wall_time,
                   iteration_time=r.iteration_time)
        if b != cmp.baseline:
            s = summarize_pair(base, r)
            row.update(event_speedup=s["event_speedup"], wall_speedup=s["wall_speedup"],
                       fct_err_mean=s["fct_err_mean"], fct_err_max=s["fct_err_max"])
        rows[b] = row
    return rows


_WORKER_PROBE = ("sorted(m for m in __import__('sys').modules if m.split('.')[0] "
                 "in ('torch', 'jax', 'repro', 'repro_torch'))")


def phase_sharded(scn) -> None:
    """``packet`` on the serial loop and on the partition-sharded loop at
    ``intra_workers`` 1 and 2: the same FCTs and events.  The lane-worker
    pool (``intra_workers - 1`` spawned processes, shared process-wide) is
    started and timed first, then asked what its worker imported."""
    from repro_torch.api import run
    from repro_torch.net.sharded_sim import _shared_pool, shutdown_pools
    serial = run(scn, backend="packet")
    check(finite_fcts(serial), "packet at scale 1/256: bad FCTs")
    t0 = time.perf_counter()
    pool = _shared_pool(1)
    pool.submit(int).result()
    pool_start_s = time.perf_counter() - t0
    walls, shards = {}, {}
    for iw in (1, 2):
        par = run(scn, backend="packet", parallel="partitions", intra_workers=iw)
        # equal FCTs; their dict order is the lanes' completion order, as
        # in the reference
        check(par.fcts == serial.fcts and par.events_processed == serial.events_processed
              and par.iteration_time == serial.iteration_time,
              f"sharded packet at intra_workers={iw} differs from the serial loop")
        walls[iw], shards[iw] = par.wall_time, par.extras["shard"]
    check(shards[2]["dispatches"] > 0, "intra_workers=2 dispatched no lane")
    worker_modules = pool.submit(eval, _WORKER_PROBE).result(timeout=60)
    shutdown_pools()
    check("repro_torch.net.sharded_sim" in worker_modules
          and all(m.split(".")[0] == "repro_torch" for m in worker_modules),
          f"the lane worker imported {worker_modules}")
    emit("packet", scenario=scn.name, what="sharded packet loop", host="the card machine's CPU",
         events=serial.events_processed, equal_to_serial=True, serial_wall_s=serial.wall_time,
         sharded_wall_s={f"intra_workers={k}": v for k, v in walls.items()},
         pool_start_s=pool_start_s, shard=shards[2], worker_torch_free=True)


# ---------------------------------------------------------------------- #
# the learned engine (benchmarks/learned_bench.py's loop, on the card)
# ---------------------------------------------------------------------- #
def wave_scenario(size_scale: float = 1.0, cca: str = "dctcp", n_hosts: int = 16,
                  name: str = "waves", base_size: float = 8e5):
    """Copy of ``benchmarks/learned_bench.py``'s ``wave_scenario``: two
    staggered 4-flow waves crossing a clos leaf boundary."""
    from repro_torch.api import FlowSpec, Scenario
    flows, fid = [], 0
    for wave, start in enumerate((0.0, 0.02)):
        for i in range(4):
            flows.append(FlowSpec(fid=fid, src=i, dst=8 + i + wave,
                                  size=base_size * size_scale, start=start,
                                  cca=cca, tag=f"w{wave}"))
            fid += 1
    return Scenario.from_dict({
        "name": name,
        "topology": {"kind": "clos", "params": {"n_hosts": n_hosts}},
        "flows": [f.__dict__ for f in flows], "kernel": {}, "sim": {}})


def wave_family(n_sizes: int = 16, ccas=("dctcp", "hpcc"), hosts=(16, 32),
                base_size: float = 8e5) -> list:
    """Copy of ``benchmarks/learned_bench.py``'s ``wave_family``: flow-size
    scales x CCAs x fabric widths (16 x 2 x 2 = 64 scenarios)."""
    return [wave_scenario(float(s), cca=cca, n_hosts=h, base_size=base_size,
                          name=f"waves-{cca}-h{h}-s{i}")
            for cca in ccas for h in hosts
            for i, s in enumerate(np.linspace(0.5, 2.0, n_sizes))]


def phase_learned(torch, launches: dict, camp_dir: pathlib.Path):
    """Returns the fit on the card; the ground truth's durable campaign
    stays at ``camp_dir`` for the campaign phase's CLI ``fit``."""
    import types

    from repro_torch.api import Campaign, compare, get_engine, run_key, scenario_fingerprint
    from repro_torch.kernels.cca_step import cca_step, fluid_scan
    from repro_torch.kernels.steady_scan import steady_scan
    from repro_torch.learned import build_dataset, encode, fit, flow_table, heldout_fct_error
    from repro_torch.learned import model as M
    from repro_torch.learned.engine import _violations

    family = wave_family()
    t0 = time.perf_counter()
    with Campaign.open(camp_dir) as camp:
        truth = camp.sweep(family, backend="wormhole")
        ds = camp.export_dataset()
    truth_wall = time.perf_counter() - t0
    # the same runs' records built by hand: the campaign's export must equal them
    records = [{"key": run_key(s, "wormhole", {}), "backend": "wormhole",
                "scenario_fingerprint": scenario_fingerprint(s),
                "scenario": s.to_dict(), "result": r.to_dict()}
               for s, r in zip(family, truth)]
    hand = build_dataset(types.SimpleNamespace(records=lambda: iter(records)))
    check(np.array_equal(ds.X, hand.X) and np.array_equal(ds.y, hand.y)
          and np.array_equal(ds.heldout, hand.heldout) and ds.record_key == hand.record_key,
          "the campaign's export_dataset differs from the hand-built dataset")

    fits, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits.append(fit(ds, seed=0, steps=1200))
        walls.append(time.perf_counter() - t0)
    params = fits[0]
    check(fits[1].fingerprint == params.fingerprint, "two fixed-seed fits on the card differ")
    err = heldout_fct_error(params, ds)
    check(err < LEARNED_HELDOUT_ERR, f"held-out mean FCT error {err} over {LEARNED_HELDOUT_ERR}")
    t0 = time.perf_counter()
    cpu_fit = fit(ds, seed=0, steps=1200, device="cpu")
    cpu_fit_wall = time.perf_counter() - t0
    drift = max(float(np.abs(a - b).max()) for wb0, wb1 in zip(params.weights, cpu_fit.weights)
                for a, b in zip(wb0, wb1))
    pred = M.predict(params, ds.X)
    pred_cpu = M.predict(params, ds.X, device="cpu")
    pred_err = float(np.abs(pred - pred_cpu).max())
    check(bool(np.all(np.abs(pred - pred_cpu)
                      <= PREDICT_TOL["atol"] + PREDICT_TOL["rtol"] * np.abs(pred_cpu))),
          f"predict: card vs CPU max abs err {pred_err}")
    train = params.meta["train"]
    emit("learned", what="fit", host_truth="wormhole on the card machine's CPU",
         truth="a durable campaign's sweep and export_dataset, equal to the hand-built dataset",
         scenarios=len(family), truth_wall_s=truth_wall, flows=len(ds),
         records=ds.n_records, heldout_records=ds.n_heldout_records,
         fit_walls_s=walls, device=torch.cuda.get_device_name(0),
         steps=train["steps"], best_step=train["best_step"], train_mse=train["train_mse"],
         heldout_mse=train["heldout_mse"], heldout_fct_err=err, bar=LEARNED_HELDOUT_ERR,
         fits_identical=True, cpu_fit_wall_s=cpu_fit_wall,
         cpu_fit_best_step=cpu_fit.meta["train"]["best_step"],
         cpu_fit_heldout_fct_err=heldout_fct_error(cpu_fit, ds, device="cpu"),
         card_vs_cpu_fit_max_weight_diff=drift, predict_max_abs_err=pred_err,
         predict_tol=PREDICT_TOL)

    rng = np.random.default_rng(0)
    queries = [wave_scenario(float(s), cca=("dctcp", "hpcc")[i % 2],
                             n_hosts=(16, 32)[(i // 2) % 2], name=f"q{i}")
               for i, s in enumerate(rng.uniform(0.55, 1.95, 1024))]
    engine = get_engine("learned")
    engine.run_batch(queries[:8], params=params)             # warm caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.run_batch(queries, params=params)
    batch_wall = time.perf_counter() - t0
    check(len(out) == len(queries) and all(finite_fcts(r) for r in out),
          "run_batch: bad FCTs")
    check(out[0].extras["device"] == torch.cuda.get_device_name(0), "run_batch left the card")
    t0 = time.perf_counter()
    X = np.concatenate([encode(flow_table(q), params.meta["cca_vocab"],
                               params.meta["topo_vocab"])[0] for q in queries])
    host_wall = time.perf_counter() - t0
    M.predict(params, X)                                      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M.predict(params, X)
    predict_wall = time.perf_counter() - t0
    emit("learned", what="what-if sweep", queries=len(out), flows=len(X),
         batch_wall_s=batch_wall, queries_per_s=len(out) / batch_wall,
         host_features_wall_s=host_wall, card_predict_wall_s=predict_wall)

    held_key = next(k for k, h in zip(ds.record_key, ds.heldout) if h)
    scn = next(s for s, rec in zip(family, records) if rec["key"] == held_key)
    table = flow_table(scn)
    X, unknown = encode(table, params.meta["cca_vocab"], params.meta["topo_vocab"])
    ood = "warn" if _violations(scn, table, unknown, params.meta) else "error"
    n_phases = sum(1 for ph in scn.build_phases() if ph.flows)
    cca_step.launches = fluid_scan.launches = steady_scan.launches = 0
    cmp = compare(scn, backends=LEARNED_BACKENDS,
                  backend_opts={"learned": {"params": params, "ood": ood}})
    torch.cuda.synchronize()
    counts = dict(fluid_scan=fluid_scan.launches, steady_scan=steady_scan.launches,
                  cca_step=cca_step.launches)
    check(counts == dict(fluid_scan=n_phases, steady_scan=0, cca_step=0),
          f"six-backend compare: launches {counts}, expected one fluid_scan per phase")
    launches["fluid_scan"] += counts["fluid_scan"]
    rows = comparison_rows(cmp)
    check(cmp["learned"].extras["device"] == torch.cuda.get_device_name(0),
          "the learned engine left the card")
    emit("learned", what="compare", scenario=scn.name, heldout=True, ood=ood,
         launches=counts, backends=rows)
    return params


# ---------------------------------------------------------------------- #
# the experiment layer: campaigns, workers, the store service, the CLI
# ---------------------------------------------------------------------- #
def make_scenario():
    """Copy of ``examples/quickstart.py``'s ``make_scenario``: two waves of
    four contending flows on a small leaf-spine clos."""
    from repro_torch.api import FlowSpec, Scenario, TopologySpec
    flows, fid = [], 0
    for wave_start in (0.0, 0.02):              # the second wave repeats the first
        for i in range(4):
            flows.append(FlowSpec(fid, i, 12 + (i % 2), size=8e6,
                                  start=wave_start, cca="dctcp",
                                  tag=f"wave@{wave_start}"))
            fid += 1
    return Scenario(name="quickstart",
                    topology=TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                   "n_spines": 2}),
                    flows=flows)


def sweep_kinds(camp, scenarios, **kw):
    """A campaign sweep with the kinds of its events, in order."""
    kinds = []
    cb = camp.subscribe(lambda e: kinds.append(e.kind))
    try:
        return camp.sweep(scenarios, **kw), kinds
    finally:
        camp.unsubscribe(cb)


def cli(*args, timeout: float = 300) -> subprocess.CompletedProcess:
    """``python -m repro_torch ARGS`` in a child process; fails on a non-zero exit."""
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch", *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    check(out.returncode == 0, f"python -m repro_torch {' '.join(args)} exited "
          f"{out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return out


def masked(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "wall_time"}


def ci_counter_check(counters: dict) -> dict:
    """The counters against ``artifacts/ci_baseline.json`` with its own
    tolerances (exact but for ``learned/heldout_err_ppm``)."""
    base = json.loads((ROOT / "artifacts" / "ci_baseline.json").read_text())
    rows = {}
    for name, new in counters.items():
        old = base["counters"][name]
        tol = base["tolerances"].get(name, base["default_tolerance"])
        allowed = max(tol.get("abs", 0), tol.get("rel", 0.0) * abs(old))
        check(abs(new - old) <= allowed, f"CI counter {name}: {new}, baseline {old} ± {allowed}")
        rows[name] = dict(port=new, baseline=old, allowed=allowed)
    return rows


def phase_campaign(torch, launches: dict, work: pathlib.Path, truth_dir: pathlib.Path,
                   params) -> None:
    """The experiment layer on the card: a durable fluid sweep at full width
    and its resume, spawn workers, the 10 campaign/learned CI counters, the
    store service between two hosts, and the CLI."""
    from repro_torch.api import (Campaign, RunResult, Scenario, StoreServer, run, run_key,
                                 run_many, training_scenario)
    from repro_torch.api.store import RunStore
    from repro_torch.kernels.cca_step import cca_step, fluid_scan
    from repro_torch.kernels.steady_scan import steady_scan
    from repro_torch.learned import fit, heldout_fct_error
    from repro_torch.learned import model as M
    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(0)

    # 1. a durable fluid sweep of gpt@128 at full width, then its resume
    full = training_scenario(n_gpus=128, scale=1.0)
    variants = [full.variant(name=f"gpt@128-x{s:g}", size_scale=s) for s in (1.0, 1.05, 1.1, 1.2)]
    fluid_scan.launches = 0
    plain = run_many(variants, backend="fluid")
    torch.cuda.synchronize()
    run_many_launches = fluid_scan.launches
    cdir = work / "fluid-sweep"
    cca_step.launches = fluid_scan.launches = steady_scan.launches = 0
    t0 = time.perf_counter()
    with Campaign.open(cdir) as camp:
        cold, kinds = sweep_kinds(camp, variants, backend="fluid")
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    counts = dict(fluid_scan=fluid_scan.launches, steady_scan=steady_scan.launches,
                  cca_step=cca_step.launches)
    check(counts == dict(fluid_scan=run_many_launches, steady_scan=0, cca_step=0)
          and run_many_launches > 0,
          f"durable fluid sweep: launches {counts}, run_many over the same 4: {run_many_launches}")
    launches["fluid_scan"] += counts["fluid_scan"]
    check(kinds.count("finished") == 4 and all(finite_fcts(r) for r in cold)
          and [r.fcts for r in cold] == [r.fcts for r in plain],
          f"durable fluid sweep: events {kinds}, or FCTs other than run_many's")
    fluid_scan.launches = 0
    t0 = time.perf_counter()
    with Campaign.open(cdir) as camp:
        warm, kinds = sweep_kinds(camp, variants, backend="fluid")
        stored = {rec["scenario"]["name"]: rec["result"] for rec in camp.records()}
    warm_wall = time.perf_counter() - t0
    check(kinds == ["cache_hit"] * 4 and fluid_scan.launches == 0,
          f"reopened fluid sweep: events {kinds}, {fluid_scan.launches} fluid_scan launches")
    check([r.to_dict() for r in warm] == [stored[v.name] for v in variants],
          "reopened fluid sweep: results differ from the stored records")
    emit("campaign", what="durable fluid sweep", scenario=full.name,
         variants=[v.name for v in variants], launches=counts,
         run_many_launches=run_many_launches, cold_wall_s=cold_wall,
         reopened_wall_s=warm_wall, reopened_events=kinds, reopened_launches=0,
         iteration_times=[r.iteration_time for r in cold], device=cold[0].extras["device"])

    # 2. spawn workers: wormhole, then the SimDB warm on reopen, then fluid
    small = training_scenario(n_gpus=128, scale=1 / 64)
    wv = [small.variant(name=f"gpt@128/64-x{s:g}", size_scale=s) for s in (1.0, 1.05, 1.1)]
    wdir = work / "wormhole-workers"
    t0 = time.perf_counter()
    with Campaign.open(wdir) as camp:
        par = camp.sweep(wv, backend="wormhole", workers=2)
        db_entries = len(camp.db)
    par_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = [run(s, backend="wormhole") for s in wv]
    serial_wall = time.perf_counter() - t0
    check(all(list(p.fcts.items()) == list(s.fcts.items())
              and p.events_processed == s.events_processed for p, s in zip(par, serial)),
          "wormhole workers=2: FCTs or events differ from serial run()")
    more = [small.variant(name=f"gpt@128/64-x{s:g}", size_scale=s) for s in (1.15, 1.2)]
    with Campaign.open(wdir) as camp:
        reopened_db = len(camp.db)
        warm_runs = camp.sweep(more, backend="wormhole")
    hits = [r.kernel_report["run_db_hits"] for r in warm_runs]
    check(reopened_db == db_entries > 0 and sum(hits) > 0,
          f"reopened campaign: SimDB {reopened_db} entries (saved {db_entries}), hits {hits}")
    two = variants[:2]
    t0 = time.perf_counter()
    fpar = Campaign.in_memory().sweep(two, backend="fluid", workers=2)
    fpar_wall = time.perf_counter() - t0
    fserial = [run(s, backend="fluid") for s in two]
    errs = [compare_results(p, s, f"fluid workers=2 {s.scenario}") for p, s in zip(fpar, fserial)]
    check(all(r.extras["device"] == card for r in fpar), "a fluid spawn worker left the card")
    emit("campaign", what="spawn workers", host="the card machine's CPU",
         wormhole=dict(scenario=small.name, variants=len(wv), workers=2, wall_s=par_wall,
                       serial_wall_s=serial_wall, events=[r.events_processed for r in par],
                       equal_to_serial=True, db_entries=db_entries),
         reopened=dict(db_entries=reopened_db, run_db_hits=hits,
                       events=[r.events_processed for r in warm_runs]),
         fluid=dict(scenario=full.name, variants=len(two), workers=2, wall_s=fpar_wall,
                    device=fpar[0].extras["device"],
                    max_fct_rel_err=max(e["max_fct_rel_err"] for e in errs),
                    bit_equal=[p.fcts == s.fcts for p, s in zip(fpar, fserial)]))

    # 3. the 10 campaign/* and learned/* counters of benchmarks/ci_regression.py
    q = make_scenario()
    qv = [q.variant(name=f"ci-{s:g}", size_scale=s) for s in (1.0, 1.05, 1.1)]
    with Campaign.open(work / "ci", name="ci") as camp:
        camp.sweep(qv, backend="wormhole")
        camp.sweep(qv, backend="wormhole")
        counters = {"campaign/store_hits": camp.store.hits,
                    "campaign/store_misses": camp.store.misses,
                    "campaign/runs_committed": len(camp.store),
                    "campaign/db_entries": len(camp.db)}
    family = [wave_scenario(float(s), base_size=4e5, name=f"ci-learned-{i}")
              for i, s in enumerate([0.5 + 0.08 * k for k in range(20)])]
    with Campaign.in_memory(name="ci-learned") as camp:
        camp.sweep(family, backend="wormhole")
        ds = camp.export_dataset()
    ci_fit = fit(ds, seed=0, steps=400)
    err = heldout_fct_error(ci_fit, ds)
    counters.update({
        "learned/train_records": ds.n_records - ds.n_heldout_records,
        "learned/heldout_records": ds.n_heldout_records,
        "learned/train_flows": int((~ds.heldout).sum()),
        "learned/heldout_flows": int(ds.heldout.sum()),
        "learned/heldout_err_ppm": -1 if err != err else int(round(err * 1e6)),
        "learned/err_under_10pct": int(err == err and err < 0.10)})
    emit("campaign", what="CI counters", fit_device=ci_fit.meta["train"]["device"],
         counters=ci_counter_check(counters))

    # 4. the store service: this process and a CLI child sweep overlapping sets
    server = StoreServer(work / "served", port=0).start()
    try:
        files = []
        for i in range(8):
            f = work / f"q{i}.json"
            f.write_text(q.variant(name=f"svc-{i}", size_scale=1.0 + 0.05 * i).to_json())
            files.append(f)
        env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"),
                   PYTHONUNBUFFERED="1")
        host_b = subprocess.Popen(
            [sys.executable, "-m", "repro_torch", "sweep", *map(str, files[2:]),
             "--backend", "wormhole", "--store", server.url],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            # B claims its whole set when its sweep starts; A starts after
            # that, so A runs only what B left and waits on B's claims
            b_first = host_b.stdout.readline()
            check("running" in b_first, f"host B did not start: {b_first!r}")
            mine = [Scenario.from_json(f.read_text()) for f in files[:6]]
            with Campaign.open(server.url) as camp:
                res_a, kinds_a = sweep_kinds(camp, mine, backend="wormhole", poll=0.05)
            b_out, b_err = host_b.communicate(timeout=300)
            b_out = b_first + b_out
            with server.lock:
                metrics = server.metrics_payload()
        finally:
            if host_b.poll() is None:
                host_b.kill()
                host_b.wait()
        check(host_b.returncode == 0, f"host B exited {host_b.returncode}: {b_err[-2000:]}")
        store = RunStore(work / "served" / "runs")
        everyone = [Scenario.from_json(f.read_text()) for f in files]
        keys = [run_key(s, "wormhole", {}) for s in everyone]
        check(sorted(store.keys()) == sorted(keys) and store.corrupt_keys() == [],
              f"served store holds {len(store.keys())} records, expected {len(keys)}")
        # whichever host ran a key, the other read its record: A's results
        # are the served records, so B's results (the records) are A's
        for s, key, a in zip(everyone, keys, res_a):
            check(masked(store.get(key)["result"])
                  == json.loads(json.dumps(masked(a.to_dict()))),
                  f"{s.name}: the served record differs from host A's result")
        check(all(finite_fcts(RunResult.from_dict(store.get(k)["result"])) for k in keys),
              "a served record has bad FCTs")
    finally:
        server.shutdown()
    emit("campaign", what="store service", hosts=2, records=len(keys),
         host_a_events={k: kinds_a.count(k) for k in ("started", "finished", "cache_hit")},
         host_b=b_out.strip().splitlines()[-1],
         metrics={k: metrics[k] for k in ("claim_creates", "claim_rejects", "claim_steals",
                                          "claim_releases", "dedup_hits", "store_hit_rate",
                                          "simdb_replay_rate", "runs", "db_entries")})

    # 5. the CLI on the card, each command a child process
    cdir = str(work / "cli")
    walls = {}
    for attempt in ("first", "second"):
        t0 = time.perf_counter()
        out = cli("run", "gpt@128", "--scale", "1", "--backend", "fluid", "-c", cdir)
        walls[f"run {attempt}"] = time.perf_counter() - t0
    check("cache hit" in out.stdout, f"the second CLI run was no cache hit:\n{out.stdout}")
    t0 = time.perf_counter()
    cmp_out = cli("compare", "gpt@128", "--scale", "1/64", "--backends",
                  "wormhole,fluid,analytic", "-c", cdir)
    walls["compare"] = time.perf_counter() - t0
    check(all(b in cmp_out.stdout for b in ("wormhole", "fluid", "analytic")),
          f"CLI compare printed no table:\n{cmp_out.stdout}")
    backends = cli("backends").stdout
    listed = cli("ls", "-c", cdir).stdout
    check("4 stored runs" in listed, f"CLI ls:\n{listed}")
    key = next(ln.split()[0] for ln in listed.splitlines() if " fluid " in ln)
    shown = json.loads(cli("show", key, "-c", cdir).stdout)
    check(shown["backend"] == "fluid" and shown["result"]["extras"]["device"] == card,
          f"CLI show: {shown['backend']} on {shown['result']['extras'].get('device')}")
    check("removed 1" in cli("rm", key, "-c", cdir).stdout
          and "3 stored runs" in cli("ls", "-c", cdir).stdout, "CLI rm")
    out_params = work / "params.json"
    t0 = time.perf_counter()
    fit_out = cli("fit", str(truth_dir), "--steps", "1200", "--out", str(out_params))
    walls["fit"] = time.perf_counter() - t0
    cli_params = M.load(out_params)
    truth = Campaign.open(truth_dir)
    ds = truth.export_dataset()
    truth.close()
    cli_err = heldout_fct_error(cli_params, ds)
    check(cli_params.meta["train"]["device"] == card,
          f"CLI fit ran on {cli_params.meta['train']['device']}, not the card")
    check(cli_err < LEARNED_HELDOUT_ERR, f"CLI fit: held-out error {cli_err}")
    served = run(wave_scenario(1.0, name="served-from-file"), backend="learned",
                 params=str(out_params), ood="warn")
    check(finite_fcts(served) and served.extras["device"] == card
          and served.extras["learned"]["params_fingerprint"] == cli_params.fingerprint,
          "the learned engine did not serve from the CLI's params on the card")
    emit("campaign", what="CLI", walls_s=walls,
         backends=[ln.split()[0] for ln in backends.splitlines()[1:]],
         fit=dict(line=[ln for ln in fit_out.stdout.splitlines() if ln.startswith("fit:")],
                  device=cli_params.meta["train"]["device"], heldout_fct_err=cli_err,
                  fingerprint=cli_params.fingerprint, in_process_fingerprint=params.fingerprint,
                  match=cli_params.fingerprint == params.fingerprint))

    wall = time.perf_counter() - t_phase
    emit("campaign", what="phase", phase_wall_s=wall)
    check(wall < CAMPAIGN_PHASE_WALL_S, f"campaign phase took {wall} s")


def normwise(a, b) -> dict:
    """Largest absolute error, and it over the reference's largest entry."""
    d = float((a.float().cpu() - b.float().cpu()).abs().max())
    return dict(max_abs_err=d, normwise_err=d / max(float(b.float().abs().max()), 1e-30))


def phase_serve(torch, launches: dict) -> None:
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate, grow_cache, seeded_prompt
    from repro_torch.models.api import build_model
    from repro_torch.models.params import leaves
    cfg = get(SERVE_ARCH)
    m = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = m.init(0)                                 # the card is the default
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = seeded_prompt(cfg.vocab, SERVE_B, SERVE_PROMPT, 1, "cuda")
    runs = []
    for _ in range(2):                                 # the first run is cold
        flash_attention.launches = 0
        res = generate(m, params, prompt, SERVE_NEW)
        n = flash_attention.launches
        check(res.kernel_launches == {"prefill": cfg.n_layers, "decode": 0} and n == cfg.n_layers,
              f"serve: flash_attention launches {res.kernel_launches}, expected "
              f"{cfg.n_layers} in prefill and none in decode")
        check(res.all_finite, "serve: non-finite logits")
        check(tuple(res.tokens.shape) == (SERVE_B, SERVE_NEW)
              and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
              f"serve: bad tokens {tuple(res.tokens.shape)}")
        runs.append(res)
        if len(runs) == 1:
            launches["flash_attention"] += n
    tokens = SERVE_B * (SERVE_PROMPT + SERVE_NEW)
    # the least time the card could take: prefill's operations on the bf16
    # tensor cores (every layer matrix over every prompt token, K4's causal
    # pairs, the last token's unembedding); decode's bytes per step (every
    # weight but the embedding table, and the whole cache, read once)
    matmul_params = sum(math.prod(s.shape) for s in leaves(m.specs["stage0"])
                        if len(s.shape) >= 3)
    prefill_flops = (2 * SERVE_B * SERVE_PROMPT * matmul_params
                     + cfg.n_layers * 4 * cfg.hd * SERVE_B * cfg.n_heads
                     * attention_pairs(SERVE_PROMPT, True, None)
                     + 2 * SERVE_B * cfg.d_model * cfg.vocab)
    cache_bytes = sum(math.prod(shape) * 2 for shape, _ in
                      leaves(m.cache_specs(SERVE_B, SERVE_PROMPT + SERVE_NEW + 8)))
    decode_bytes = 2 * (m.n_params - cfg.vocab * cfg.d_model) + cache_bytes
    emit("serve", arch=cfg.name, n_params=m.n_params, dtype=cfg.param_dtype, batch=SERVE_B,
         prompt=SERVE_PROMPT, new_tokens=SERVE_NEW, init_s=init_s,
         prefill_tflop=prefill_flops / 1e12,
         prefill_bound_s=prefill_flops / BF16_FLOP_PER_S,
         decode_gb_per_step=decode_bytes / 1e9,
         decode_bound_ms_per_token=decode_bytes / HBM_BYTES_PER_S * 1e3,
         prefill_s=[r.prefill_s for r in runs],
         prefill_tok_per_s=[SERVE_B * SERVE_PROMPT / r.prefill_s for r in runs],
         decode_ms_per_token=[r.decode_s / SERVE_NEW * 1e3 for r in runs],
         decode_tok_per_s=[SERVE_B * SERVE_NEW / r.decode_s for r in runs],
         tok_per_s=[tokens / (r.prefill_s + r.decode_s) for r in runs],
         flash_attention_launches=runs[0].kernel_launches,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         tokens_identical_across_runs=bool(torch.equal(runs[0].tokens, runs[1].tokens)),
         sampled=runs[0].tokens[0][:16].tolist())

    # where the time goes: one prefill and 4 decode steps, traced
    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
        return result, dict(
            traced_wall_s=wall, device_busy_s=busy if busy > 0 else "not measured",
            busy_share=busy / wall if busy > 0 else "not measured",
            kernels=[dict(name=e.key[:70], count=e.count,
                          device_s=e.self_device_time_total / 1e6) for e in top])
    out = {}
    (_, pcache), out["prefill"] = traced(lambda: m.prefill(params, {"tokens": prompt}))
    cache = grow_cache(m, pcache, SERVE_B, SERVE_PROMPT + SERVE_NEW + 8, "cuda")
    del pcache
    tok = prompt[:, -1:]
    _, out["decode_4_steps"] = traced(lambda: [m.decode_step(params, cache, tok, SERVE_PROMPT + i)
                                               for i in range(4)])
    emit("serve_profile", **out)
    del params, cache, runs, res
    torch.cuda.empty_cache()

    # decode after prefill == prefill over one more token, full width and
    # depth, float32 with TF32 off (tests/test_archs.py:105-128).  With the
    # reference's initialiser the model is chaotic: its fan-in for wq and wk
    # is the heads axis, so logits have a std of about 64 and float32
    # rounding grows from layer to layer (the JAX package itself misses this
    # bar by 8 % at 8 layers).  So the bar holds the same weights with wq
    # and wk scaled to a fan-in of d_model (logits of std about 1), and the
    # reference-init run is measured and held only to finite logits.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    m32 = build_model(cfg32)
    p32 = m32.init(2)
    toks = seeded_prompt(cfg.vocab, 1, 257, 3, "cuda")
    cont = {}
    for init in ("reference", "fan-in d_model"):
        if init != "reference":
            mixer = p32["stage0"]["b0"]["mixer"]
            mixer["wq"] *= (cfg.n_heads / cfg.d_model) ** 0.5
            mixer["wk"] *= (cfg.n_kv / cfg.d_model) ** 0.5
        ref_logits, _ = m32.prefill(p32, {"tokens": toks})
        _, cache = m32.prefill(p32, {"tokens": toks[:, :256]})
        cache = grow_cache(m32, cache, 1, 256 + 8, "cuda")
        logits, _ = m32.decode_step(p32, cache, toks[:, 256:], 256)
        _, _, ok = max_errs([logits], [ref_logits], CONTINUATION_TOL, CONTINUATION_TOL)
        finite = bool(torch.isfinite(logits).all() and torch.isfinite(ref_logits).all())
        cont[init] = dict(**normwise(logits, ref_logits), finite=finite,
                          within_tolerance=ok, tolerance=CONTINUATION_TOL,
                          gated="finite only" if init == "reference" else "tolerance")
        check(finite and (ok or init == "reference"),
              f"serve: decode after prefill off the longer prefill: {cont}")
    del p32, cache
    torch.cuda.empty_cache()

    # the card against the CPU (plain versions), full width, 2 layers, float32
    m2 = build_model(dataclasses.replace(cfg32, n_layers=2))
    p2 = m2.init(4)
    p2_cpu = _tree_to(p2, "cpu")
    toks = seeded_prompt(cfg.vocab, 1, 256, 5, "cuda")
    t0 = time.perf_counter()
    logits, cache = m2.prefill(p2, {"tokens": toks})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_logits, cpu_cache = m2.prefill(p2_cpu, {"tokens": toks.cpu()})
    cpu_s = time.perf_counter() - t0
    errs = {"logits": normwise(logits, cpu_logits),
            **{n: normwise(cache["stage0"]["b0"][n], cpu_cache["stage0"]["b0"][n])
               for n in ("k", "v")}}
    ok = all(e["normwise_err"] <= CARD_CPU_NORMWISE for e in errs.values())
    emit("serve_checks", continuation_f32=cont,
         card_vs_cpu_2_layers_f32=dict(errs=errs, tolerance_normwise=CARD_CPU_NORMWISE, ok=ok,
                                       card_prefill_s=card_s, cpu_prefill_s=cpu_s))
    check(ok, f"serve: card against CPU off by {errs}")


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.api import training_scenario
    from repro_torch.kernels.build import load

    smi = nvidia_smi()
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    emit("device", **device, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    import threading

    from hopper_barriers import library as barrier_library
    t0 = time.perf_counter()
    probe = threading.Thread(target=barrier_library)     # K2's barrier probe, beside
    probe.start()
    libs = load("cca_step", "steady_scan", "maxmin", "flash_attention")
    probe.join()
    barrier_library()                                     # raises if its build failed
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={n: [ln for ln in lib.log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling" in ln]
                for n, lib in libs.items()},
         flash_bf16=tensor_core_report(libs["flash_attention"]))

    rng = np.random.default_rng(0)
    scenarios = {"gpt@128": training_scenario(n_gpus=128, scale=1.0),
                 "moe@128": training_scenario(n_gpus=128, moe=True, scale=1.0),
                 "moe@1024": training_scenario(n_gpus=1024, moe=True, scale=1.0)}
    scan_ptxas = ptxas_report(libs["cca_step"], "fluid_scan_kernel")
    check(len(scan_ptxas) == 2, f"fluid_scan_kernel: no ptxas report for both forms: {scan_ptxas}")
    rows = phase_kernels(torch, scenarios, rng, scan_ptxas)
    recorded = {name: record_analytic(scn) for name, scn in scenarios.items()}
    maxmin_kernels(torch, recorded, rows)
    flash_kernels(torch, rows)

    launches = {"fluid_scan": 0, "steady_scan": 0, "maxmin": 0, "flash_attention": 0}
    fluid_iters = phase_e2e(torch, scenarios, launches)
    phase_batch(torch, rng)
    phase_profile(torch, "gpt@128", scenarios["gpt@128"])
    analytic_iters = phase_analytic(torch, scenarios, recorded, launches)
    phase_packet(torch, launches, fluid_iters, analytic_iters)
    with tempfile.TemporaryDirectory() as td:
        work = pathlib.Path(td)
        params = phase_learned(torch, launches, work / "truth")
        phase_campaign(torch, launches, work, work / "truth", params)
    phase_serve(torch, launches)

    k1 = rows[("fluid_scan", "moe@1024")]
    k3 = rows[("steady_scan", f"[{STEPS}, {k1['F']}] moe@1024")]
    k3_fused = rows[("steady_scan fused", "moe@1024")]
    k2 = rows[("maxmin", "moe@1024 largest solve")]
    k4 = rows[("flash_attention", "granite prefill bf16 4x32/8x2048x64 causal")]
    kernels = [
        dict(name="fluid_scan", route="cuda", source="src/repro_torch/csrc/cca_step.cu",
             replaces="src/repro/kernels/cca_step/kernel.py:27",
             launches=launches["fluid_scan"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="steady_scan", route="cuda", source="src/repro_torch/csrc/steady_scan.cu",
             replaces="src/repro/kernels/steady_scan/kernel.py:22",
             launches=launches["steady_scan"], max_abs_err=k3["max_abs_err"],
             ms=k3["ms"], plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=None, fused_into="fluid_scan",
             fused_ms=k3_fused["ms"], fused_bit_equal=k3_fused["bit_equal_to_k3"]),
        dict(name="maxmin", route="cuda", source="src/repro_torch/csrc/maxmin.cu",
             replaces="src/repro/kernels/maxmin/kernel.py:30",
             launches=launches["maxmin"], max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None, regime=k2["regime"],
             kernels_per_solve=k2["kernels_per_solve"],
             latency_floor_ms=k2["latency_floor_ms"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:28",
             launches=launches["flash_attention"], max_abs_err=k4["max_abs_err"],
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=k4["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
