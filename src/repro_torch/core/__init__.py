"""Wormhole — the paper's contribution: a user-transparent PLDES kernel that
memoizes unsteady-state transients (keyed on Flow Conflict Graphs) and
fast-forwards steady-states (identified by windowed rate fluctuation).

Copy of ``repro.core``, which the port may not import."""

from repro_torch.core import theory
from repro_torch.core.fcg import FCG, build_fcg
from repro_torch.core.memo import SimDB
from repro_torch.core.partition import PartitionIndex, network_partitioner
from repro_torch.core.steady import fluctuation, is_steady, rate_estimate
from repro_torch.core.wormhole import WormholeConfig, WormholeKernel
