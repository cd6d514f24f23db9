"""The reference's lint gate (``tools/reprolint``) over the port.

The gate's determinism rules, hot classes and spawn-safety entries are
scoped to ``src/repro/`` (``tools/reprolint/config.py``), so the port's
copies of the hot path sat outside it.  Here the same rules run with those
scopes moved to ``src/repro_torch/`` (the config's ``dataclasses.replace``
pattern; the registered determinism rules re-scoped for the test only),
with ``torch`` among the imports a spawn worker may not reach.  The only
findings allowed are C304's: the committed schema fingerprint
(``artifacts/schema_fingerprint.json``) keys each hot class by the
reference's path, which the port's copies do not carry."""
import dataclasses
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from reprolint import Config, iter_py_files, run_lint  # noqa: E402
from reprolint.config import (BANNED_WORKER_IMPORTS, DETERMINISM_SCOPE,  # noqa: E402
                              HOT_CLASSES, WORKER_ENTRIES)
from reprolint.engine import FILE_RULES  # noqa: E402

PORT = "src/repro_torch"


def _port_path(rel: str) -> str:
    assert rel.startswith("src/repro/"), rel
    return PORT + rel[len("src/repro"):]


PORT_SCOPE = tuple(_port_path(p) for p in DETERMINISM_SCOPE)
PORT_HOT_CLASSES = tuple((_port_path(f), cls) for f, cls in HOT_CLASSES)
PORT_WORKER_ENTRIES = tuple("repro_torch" + m[len("repro"):] for m in WORKER_ENTRIES)


def _port_config() -> Config:
    return dataclasses.replace(Config(root=REPO), hot_classes=PORT_HOT_CLASSES,
                               worker_entries=PORT_WORKER_ENTRIES,
                               banned_worker_imports=(*BANNED_WORKER_IMPORTS, "torch"))


def test_port_scopes_exist():
    for rel in PORT_SCOPE + tuple(f for f, _ in PORT_HOT_CLASSES):
        assert (REPO / rel).exists(), rel
    for mod in PORT_WORKER_ENTRIES:
        assert (REPO / "src" / (mod.replace(".", "/") + ".py")).exists(), mod


def test_port_passes_the_reference_lint_rules(monkeypatch):
    rescoped = [rid for rid, info in FILE_RULES.items() if info.scope == DETERMINISM_SCOPE]
    assert sorted(rescoped) == ["D101", "D102", "D103", "D104"]
    for rid in rescoped:
        monkeypatch.setitem(FILE_RULES, rid,
                            dataclasses.replace(FILE_RULES[rid], scope=PORT_SCOPE))
    config = _port_config()
    files = iter_py_files([PORT], REPO, config.excludes)
    assert len(files) > 80
    _tree, findings, _suppressed = run_lint(files, config)
    fingerprint = [f for f in findings if f.rule == "C304"]
    assert fingerprint and all(f.path == config.fingerprint_path for f in fingerprint)
    assert [f.text() for f in findings if f.rule != "C304"] == []


def test_the_rescoped_rules_fire_on_the_port(monkeypatch, tmp_path):
    """The moved scopes are live: a builtin ``hash()`` in a copy of a port
    module under the determinism scope is found (D101), and a spawn entry
    that imports torch is found (S402)."""
    rid = "D101"
    monkeypatch.setitem(FILE_RULES, rid, dataclasses.replace(FILE_RULES[rid], scope=PORT_SCOPE))
    bad = tmp_path / PORT / "net" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\n\ndef key(x):\n    return hash(x)\n")
    config = dataclasses.replace(_port_config(), root=tmp_path,
                                 worker_entries=("repro_torch.net.bad",))
    _tree, findings, _ = run_lint(iter_py_files([PORT], tmp_path, ()), config)
    rules = {f.rule for f in findings if f.path.endswith("bad.py")}
    assert {"D101", "S402"} <= rules, findings
