"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launch function, so
``nvcc`` builds it into a shared library in seconds (no PyTorch headers),
for Hopper (``sm_90a``).  Libraries go to ``build/repro_torch/`` at the
repository root, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  A missing
``nvcc`` or a failed build raises: the port never runs a CUDA tensor
through anything but its kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# no --use_fast_math: the parity bars need IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Library:
    """One loaded kernel library and how it came to be."""
    cdll: ctypes.CDLL
    path: pathlib.Path    # the shared library, for cuobjdump
    log: str              # nvcc's output, with -Xptxas -v's registers and spills
    build_seconds: float  # 0.0 when an earlier build of the same source was loaded


_loaded: dict[str, Library] = {}


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin``, else the CUDA
    toolkit's default prefix."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the port's CUDA kernels cannot be built")


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load(*names: str) -> dict[str, Library]:
    """Build (one ``nvcc`` per source, all started together) and load the
    named kernel libraries; already loaded ones are returned as they are."""
    todo = [n for n in names if n not in _loaded]
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        src, out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():   # wait for every nvcc first
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    for name in todo:
        _, out = _target(name)
        log_path = out.with_suffix(".log")
        _loaded[name] = Library(
            cdll=ctypes.CDLL(str(out)), path=out,
            log=log_path.read_text() if log_path.exists() else "",
            build_seconds=seconds if name in procs else 0.0)
    return {n: _loaded[n] for n in names}
