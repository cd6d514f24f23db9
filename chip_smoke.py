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
            "fluid", "analytic"))`` with each backend's events, wall, speedups
            and FCT errors against the ``packet`` oracle (wormhole held to the
            reference's bars, mean under 1 % and max under 5 %; fluid, on the
            card with one fluid_scan per phase, only to finite errors); then
            ``wormhole`` on gpt@128 at ``scale=1.0`` (the paper's GPT-13B on
            128 GPUs) with its kernel report and iteration time beside the
            fluid and analytic ones; two identical wormhole runs with fresh
            SimDBs, which must be bit-identical; and a warm two-run
            ``run_many(..., shared_db=True)`` sweep;
9. serve    ``repro_torch.launch.serve.generate`` on granite-3-2b at full
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
    """The packet oracle and the Wormhole kernel on the card machine's CPU,
    beside the fluid engine on the card.  Event counts are this machine's
    own: they are held to the reference's by the CPU tests, not here."""
    from repro_torch.api import SimDB, compare, run, run_many, summarize_pair, training_scenario
    from repro_torch.kernels.cca_step import cca_step, fluid_scan
    from repro_torch.kernels.steady_scan import steady_scan
    t_phase = time.perf_counter()
    scn = training_scenario(n_gpus=128, scale=1 / 64)
    n_phases = sum(1 for ph in scn.build_phases() if ph.flows)
    cca_step.launches = fluid_scan.launches = steady_scan.launches = 0
    cmp = compare(scn, backends=("packet", "wormhole", "fluid", "analytic"))
    torch.cuda.synchronize()
    counts = dict(fluid_scan=fluid_scan.launches, steady_scan=steady_scan.launches,
                  cca_step=cca_step.launches)
    check(counts == dict(fluid_scan=n_phases, steady_scan=0, cca_step=0),
          f"compare: launches {counts}, expected one fluid_scan per phase ({n_phases})")
    launches["fluid_scan"] += counts["fluid_scan"]
    base = cmp["packet"]
    rows = {}
    for b, r in cmp.results.items():
        check(finite_fcts(r) and set(r.fcts) == set(base.fcts),
              f"compare: {b} has bad FCTs or another flow set than packet")
        row = dict(events=r.events_processed, wall_s=r.wall_time,
                   iteration_time=r.iteration_time)
        if b != cmp.baseline:
            s = summarize_pair(base, r)
            row.update(event_speedup=s["event_speedup"], wall_speedup=s["wall_speedup"],
                       fct_err_mean=s["fct_err_mean"], fct_err_max=s["fct_err_max"])
        rows[b] = row
    wh, fl = rows["wormhole"], rows["fluid"]
    check(wh["fct_err_mean"] < WORMHOLE_MEAN_ERR and wh["fct_err_max"] < WORMHOLE_MAX_ERR,
          f"wormhole vs packet: mean FCT err {wh['fct_err_mean']}, max {wh['fct_err_max']}")
    check(np.isfinite(fl["fct_err_mean"]) and np.isfinite(fl["fct_err_max"]),
          f"fluid vs packet: FCT error not finite: {fl}")
    rows["fluid"]["device"] = cmp["fluid"].extras["device"]
    emit("packet", scenario=scn.name, what="compare", host="the card machine's CPU",
         flows=len(base.fcts), phases_with_flows=n_phases, launches=counts, backends=rows,
         bars=dict(wormhole_mean=WORMHOLE_MEAN_ERR, wormhole_max=WORMHOLE_MAX_ERR))

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

    a = run(scn, backend="wormhole", db=SimDB())
    b = run(scn, backend="wormhole", db=SimDB())
    check(same_run(a, b), "two identical wormhole runs differ")
    warm = scn.variant(name=f"{scn.name}-x1.05", size_scale=1.05)
    sweep = run_many([scn, warm], backend="wormhole", shared_db=True)
    check(all(finite_fcts(r) for r in sweep), "warm sweep: bad FCTs")
    wall = time.perf_counter() - t_phase
    emit("packet", what="determinism and warm sweep", repeat_bit_identical=True,
         repeat_events=a.events_processed, repeat_walls_s=[a.wall_time, b.wall_time],
         sweep_events=[r.events_processed for r in sweep],
         sweep_run_db_hits=[r.kernel_report["run_db_hits"] for r in sweep],
         sweep_walls_s=[r.wall_time for r in sweep], phase_wall_s=wall)
    check(wall < PACKET_PHASE_WALL_S, f"packet phase took {wall} s")


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
