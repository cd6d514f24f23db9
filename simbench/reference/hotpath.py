"""The ``@hot_path`` marker.

A function carrying this decorator is on the per-packet/per-event path: the
``reprolint`` H-rules forbid logging, ``itertools.count``, closure/lambda
allocation, and attribute writes to un-slotted instances inside it (see
README "Static analysis gates").  The decorator itself is a zero-cost
identity — it exists so the performance contract is visible at the
definition and machine-checkable in CI, not buried in a PR description.

Frozen copy of ``src/repro/hotpath.py``, the JAX package's pure-Python
module (no JAX in it), which the port's tests hold the port to; part of
the benchmark's plain reference: its imports are rewritten to stay inside
``simbench``, and it imports neither the program nor the JAX package.
"""
from __future__ import annotations

from typing import TypeVar

F = TypeVar("F")


def hot_path(fn: F) -> F:
    """Mark ``fn`` as hot-path code.  Identity at runtime; reprolint keys
    its H-rules off the decorator name."""
    return fn
