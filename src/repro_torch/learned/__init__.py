"""repro_torch.learned — the learned flow-level engine (m4-style).

The port of ``repro.learned``, which the port may not import.  Stores of
packet-level runs are labeled datasets; this package closes the loop:
``build_dataset`` extracts per-flow (features, targets) arrays, ``fit``
trains a small MLP on them with ``torch.autograd`` on the CUDA card (or the
CPU when asked), ``model.save``/``load`` persist versioned params in the
reference's format, and ``LearnedEngine`` (registered as the sixth backend
family, ``"learned"``) serves batched what-if queries from the fit on the
card:

    camp = Campaign.open("experiments/truth")
    camp.sweep(variants, backend="wormhole")         # packet-level truth
    params = fit(camp.export_dataset(), seed=0)      # dataset -> model
    model.save(params, "artifacts/learned_params.json")
    compare(scn, backends=["learned"], params="artifacts/learned_params.json")

or, from the shell, ``python -m repro_torch fit DIR --out PATH`` (the card
unless ``--device cpu``; the params record the device that fitted them).
"""
from repro_torch.learned import model
from repro_torch.learned.dataset import (
    GROUND_TRUTH_BACKENDS,
    NUMERIC_FEATURES,
    Dataset,
    FlowTable,
    build_dataset,
    encode,
    flow_table,
    heldout_fraction_of,
)
from repro_torch.learned.engine import (
    DEFAULT_PARAMS_PATH,
    LearnedEngine,
    OutOfDistributionError,
    load_params,
)
from repro_torch.learned.fit import fct_error, fit, heldout_fct_error
from repro_torch.learned.model import PARAMS_VERSION, LearnedParams

__all__ = [
    "GROUND_TRUTH_BACKENDS",
    "NUMERIC_FEATURES",
    "Dataset",
    "FlowTable",
    "build_dataset",
    "encode",
    "flow_table",
    "heldout_fraction_of",
    "DEFAULT_PARAMS_PATH",
    "LearnedEngine",
    "OutOfDistributionError",
    "load_params",
    "fct_error",
    "fit",
    "heldout_fct_error",
    "PARAMS_VERSION",
    "LearnedParams",
    "model",
]
