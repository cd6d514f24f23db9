"""repro_torch.learned — the learned flow-level engine (m4-style).

The port of ``repro.learned``, which the port may not import.  Stores of
packet-level runs are labeled datasets; this package closes the loop:
``build_dataset`` extracts per-flow (features, targets) arrays, ``fit``
trains a small MLP on them with ``torch.autograd`` on the CUDA card (or the
CPU when asked), ``model.save``/``load`` persist versioned params in the
reference's format, and ``LearnedEngine`` (registered as the sixth backend
family, ``"learned"``) serves batched what-if queries from the fit on the
card.  The port has no run store or campaign yet, so ``build_dataset``
takes any object whose ``records()`` yields store records:

    records = [{"key": run_key(s, "hybrid", opts), "backend": "hybrid",
                "scenario_fingerprint": scenario_fingerprint(s),
                "scenario": s.to_dict(), "result": r.to_dict()}, ...]
    ds = build_dataset(types.SimpleNamespace(records=lambda: iter(records)))
    params = fit(ds, seed=0)                         # dataset -> model
    model.save(params, "artifacts/learned_params.json")
    compare(scn, backends=["learned"], params="artifacts/learned_params.json")
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
