"""Run keys: the content addresses of ``(scenario, backend, opts)`` triples.

Copy of the key functions of ``repro.api.store`` (``_dict_fingerprint``,
``scenario_fingerprint``, ``_key_form``, ``run_key``), which the port may
not import, hashed exactly as the reference hashes them.  The learned
dataset splits train from held-out on ``sha256(run_key)``
(``repro_torch.learned.dataset.heldout_fraction_of``), so the same record
lands on the same side of the split in both packages.  The rest of the
store (records, backends, claims) is not ported yet; when it is, it keeps
this hash and separates the two packages' records by its directory.
"""
from __future__ import annotations

import itertools
import json
from hashlib import sha256

from repro_torch.api.results import jsonify
from repro_torch.api.scenario import Scenario


def _dict_fingerprint(d: dict) -> str:
    return sha256(json.dumps(d, sort_keys=True,
                             separators=(",", ":")).encode()).hexdigest()


def scenario_fingerprint(scenario: Scenario) -> str:
    """Stable content hash of a scenario's canonical JSON form."""
    return _dict_fingerprint(scenario.to_dict())


# every submit carrying an opt with no canonical JSON form is its own
# experiment — see _key_form
_UNCACHEABLE = itertools.count(1)


def _key_form(x):
    """Canonical key form of an opt value: :func:`jsonify`, except objects
    with no canonical JSON form (live SimDB handles, open files) become a
    process-unique token instead of ``repr`` — a repr can truncate (large
    ndarrays) or embed a reusable memory address, either of which could
    collide two distinct experiments onto one store key.  Such opts are
    uncacheable: every submit keys uniquely."""
    return jsonify(x, fallback=lambda v:
                   f"<uncacheable {type(v).__name__} #{next(_UNCACHEABLE)}>")


def run_key(scenario: Scenario, backend: str, opts: dict) -> str:
    """The store's content address: ``(scenario fingerprint, backend,
    canonicalized opts)`` hashed into one stable hex key.  Opts with no
    canonical JSON form never dedup (each submit is its own experiment)."""
    blob = json.dumps({
        "scenario_fingerprint": scenario_fingerprint(scenario),
        "backend": backend,
        "opts": _key_form(opts),
    }, sort_keys=True, separators=(",", ":"))
    return sha256(blob.encode()).hexdigest()[:40]
