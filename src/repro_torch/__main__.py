"""Command-line interface over the Campaign API.

    PYTHONPATH=src python -m repro_torch run gpt@64 --backend wormhole
    PYTHONPATH=src python -m repro_torch run scenario.json -c camp/ --backend hybrid
    PYTHONPATH=src python -m repro_torch sweep a.json b.json -c camp/ --workers 2
    PYTHONPATH=src python -m repro_torch compare gpt@32 --backends packet,hybrid \
        --opt hybrid:fidelity=auto
    PYTHONPATH=src python -m repro_torch serve -c camp/ --port 8321
    PYTHONPATH=src python -m repro_torch sweep a.json --store http://host:8321
    PYTHONPATH=src python -m repro_torch ls -c camp/
    PYTHONPATH=src python -m repro_torch show KEY -c http://host:8321
    PYTHONPATH=src python -m repro_torch rm KEY -c camp/        # or: rm --all
    PYTHONPATH=src python -m repro_torch backends
    PYTHONPATH=src python -m repro_torch fit camp/ --out artifacts/params.json
    PYTHONPATH=src python -m repro_torch lint src tests --format github

Scenarios are either a path to a ``Scenario`` JSON file (``to_json``) or a
training-preset shorthand ``gpt@N`` / ``moe@N`` (modified by ``--cca`` /
``--scale``).  ``-c/--campaign DIR`` makes the session durable: completed
runs commit to the campaign store as they finish, a re-invoked command
skips them (cache hits), and the campaign's SimDB keeps wormhole runs warm
across invocations.  ``-c`` also accepts a store-server URL
(``http://host:port``, see ``serve``) and ``--store URL`` attaches a
durable directory campaign to a shared server.  Without ``-c`` an
anonymous in-memory campaign is used.  ``--opt`` takes ``key=value`` for
every backend or ``backend:key=value`` for one backend only.  Every
command tears the spawn worker pools down before exiting.

Copy of ``repro.__main__``, which the port may not import.  ``fluid`` and
``learned`` run on the CUDA card unless ``--opt device=cpu`` is passed,
and ``fit`` on the card unless ``--device cpu`` is: with no card a command
that runs either exits 1 with the reason.  ``ls``, ``show``, ``rm``,
``serve`` and the host backends load no torch.  A campaign directory or a
store server of the JAX package ``repro`` is refused (the two packages
keep their run records apart).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.api import Campaign, Scenario, training_scenario
from repro_torch.api.campaign import RunEvent
from repro_torch.device import NoCardError
from repro_torch.net.sharded_sim import shutdown_pools


def _parse_scale(text: str) -> float:
    """Accept '1/256' (the paper's idiom) as well as plain floats."""
    if "/" in text:
        num, den = text.split("/", 1)
        return float(num) / float(den)
    return float(text)


def _load_scenario(spec: str, args) -> Scenario:
    if spec.endswith(".json"):
        try:
            with open(spec) as fh:
                return Scenario.from_json(fh.read())
        except FileNotFoundError:
            raise SystemExit(
                f"error: scenario file {spec!r} not found") from None
    family, sep, n = spec.partition("@")
    if sep and family in ("gpt", "moe") and n.isdigit():
        return training_scenario(n_gpus=int(n), moe=(family == "moe"),
                                 cca=args.cca,
                                 scale=_parse_scale(args.scale))
    raise SystemExit(
        f"error: scenario {spec!r} is neither a .json file nor a "
        f"'gpt@N'/'moe@N' preset")


def _parse_opts(pairs: list[str]) -> tuple[dict, dict]:
    """``--opt key=value`` engine opts; values parse as JSON when they can
    (``--opt fidelity=auto`` stays a string, ``--opt intra_workers=2`` an
    int).  ``--opt backend:key=value`` scopes the opt to one backend;
    returns ``(shared_opts, per_backend_opts)``."""
    opts: dict = {}
    per_backend: dict[str, dict] = {}
    for pair in pairs:
        key, sep, value = pair.partition("=")
        if not sep:
            raise SystemExit(f"error: --opt wants [backend:]key=value, "
                             f"got {pair!r}")
        try:
            val = json.loads(value)
        except json.JSONDecodeError:
            val = value
        backend, bsep, bkey = key.partition(":")
        if bsep:
            per_backend.setdefault(backend, {})[bkey] = val
        else:
            opts[key] = val
    return opts, per_backend


def _engine_opts(args) -> dict:
    """Merged opts for a single-backend command (run/sweep): shared opts
    plus the ones scoped to this backend; opts scoped to a backend the
    command will not run are an error, not a silent drop."""
    opts, per_backend = _parse_opts(args.opt)
    stray = sorted(set(per_backend) - {args.backend})
    if stray:
        raise SystemExit(
            f"error: --opt scoped to backend(s) {', '.join(stray)} but "
            f"this command runs {args.backend!r} (backend-scoped opts "
            f"fan out in `compare`)")
    return {**opts, **per_backend.get(args.backend, {})}


def _open_campaign(args) -> Campaign:
    store = getattr(args, "store", None)
    if getattr(args, "campaign", None):
        return Campaign.open(args.campaign, store=store)
    if store:
        return Campaign.open(store)
    return Campaign.in_memory()


def _progress(event: RunEvent) -> None:
    if event.kind == "started":
        print(f"[{event.backend}] {event.scenario}: running ...")
    elif event.kind == "finished":
        r = event.result
        print(f"[{event.backend}] {event.scenario}: {r.events_processed} "
              f"events in {r.wall_time:.2f}s")
    else:
        print(f"[{event.backend}] {event.scenario}: cache hit "
              f"({event.key[:12]})")


def _summary_line(rec_or_handle) -> str:
    if isinstance(rec_or_handle, dict):
        key, backend = rec_or_handle["key"], rec_or_handle["backend"]
        name = rec_or_handle["scenario"]["name"]
        res = rec_or_handle["result"]
        events, wall = res["events_processed"], res["wall_time"]
        flows = len(res["fcts"])
    else:
        h = rec_or_handle
        key, backend, name = h.key, h.backend, h.scenario
        events, wall = h.result.events_processed, h.result.wall_time
        flows = len(h.result.fcts)
    return (f"{key[:12]}  {backend:<9} {name:<28} {flows:>6} flows "
            f"{events:>10} events {wall:>8.2f}s")


# ---------------------------------------------------------------------- #
# subcommands
# ---------------------------------------------------------------------- #
def cmd_run(args) -> int:
    camp = _open_campaign(args)
    camp.subscribe(_progress)
    opts = _engine_opts(args)
    handle = camp.submit(_load_scenario(args.scenario, args),
                         backend=args.backend, **opts)
    r = handle.result
    print(_summary_line(handle))
    if r.iteration_time:
        print(f"iteration time: {r.iteration_time * 1e3:.3f} ms (scaled)")
    camp.close()
    return 0


def cmd_sweep(args) -> int:
    camp = _open_campaign(args)
    camp.subscribe(_progress)
    opts = _engine_opts(args)
    scenarios = [_load_scenario(s, args) for s in args.scenarios]
    # count from the event stream: intra-sweep duplicates surface as
    # cache_hit events but never touch the store's hit/miss counters
    kinds = []
    camp.subscribe(lambda e: kinds.append(e.kind))
    results = camp.sweep(scenarios, backend=args.backend,
                         workers=args.workers, **opts)
    print(f"sweep done: {len(results)} results "
          f"({kinds.count('cache_hit')} from the store, "
          f"{kinds.count('finished')} simulated)  "
          f"campaign: {len(camp)} stored runs")
    camp.close()
    return 0


def cmd_compare(args) -> int:
    camp = _open_campaign(args)
    camp.subscribe(_progress)
    opts, per_backend = _parse_opts(args.opt)
    backends = tuple(b for b in args.backends.split(",") if b)
    try:
        comparison = camp.compare(_load_scenario(args.scenario, args),
                                  backends=backends, baseline=args.baseline,
                                  backend_opts=per_backend, **opts)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        camp.close()
        return 1
    print(comparison)
    camp.close()
    return 0


def cmd_serve(args) -> int:
    from repro_torch.api.serve import run_server
    return run_server(args.campaign, host=args.host, port=args.port,
                      ttl=args.ttl, quiet=args.quiet)


def cmd_ls(args) -> int:
    camp = _open_campaign(args)
    records = list(camp.records(backend=args.backend or None))
    for rec in records:
        print(_summary_line(rec))
    print(f"{len(records)} stored runs in {camp.name!r}"
          + (f" (db: {len(camp.db)} memo entries)" if camp.db else ""))
    camp.close()
    return 0


def cmd_show(args) -> int:
    camp = _open_campaign(args)
    matches = [k for k in camp.store.keys() if k.startswith(args.key)]
    if not matches:
        print(f"error: no stored run with key prefix {args.key!r}",
              file=sys.stderr)
        camp.close()
        return 1
    if len(matches) > 1:
        print(f"error: key prefix {args.key!r} is ambiguous "
              f"({len(matches)} matches)", file=sys.stderr)
        camp.close()
        return 1
    print(json.dumps(camp.store.get(matches[0]), indent=1))
    camp.close()
    return 0


def cmd_rm(args) -> int:
    camp = _open_campaign(args)
    if args.all:
        keys = set(camp.store.keys())
    else:
        keys = set()
        for prefix in args.keys:
            # destructive, so exactly like `show`: an ambiguous prefix is
            # refused, never expanded
            matches = [k for k in camp.store.keys() if k.startswith(prefix)]
            if not matches:
                print(f"error: no stored run with key prefix {prefix!r}",
                      file=sys.stderr)
                camp.close()
                return 1
            if len(matches) > 1:
                print(f"error: key prefix {prefix!r} is ambiguous "
                      f"({len(matches)} matches); nothing removed",
                      file=sys.stderr)
                camp.close()
                return 1
            keys.add(matches[0])
    for key in sorted(keys):
        camp.store.delete(key)
    print(f"removed {len(keys)} stored runs from {camp.name!r}")
    camp.close()
    return 0


def cmd_backends(args) -> int:
    from repro_torch.api import available_backends, get_engine
    from repro_torch.api.engines import Engine
    print(f"{'backend':<10} {'uses_db':<8} {'run_batch':<10} description")
    for name in available_backends():
        engine = get_engine(name)
        batched = type(engine).run_batch is not Engine.run_batch
        doc = (type(engine).__doc__ or "").strip().splitlines()
        first = doc[0].rstrip(" .") if doc else ""
        print(f"{name:<10} {'yes' if engine.uses_db else 'no':<8} "
              f"{'batched' if batched else 'serial':<10} {first}")
    return 0


def cmd_lint(args) -> int:
    # tools/ is not a package on sys.path when repro_torch is imported from
    # src/; locate it relative to the repo root (walking up also covers
    # editable installs run from a subdirectory)
    from pathlib import Path
    here = Path(__file__).resolve()
    for cand in [here.parents[2], *Path.cwd().resolve().parents,
                 Path.cwd().resolve()]:
        tools = cand / "tools" / "reprolint"
        if tools.is_dir():
            sys.path.insert(0, str(tools.parent))
            break
    else:
        print("error: tools/reprolint not found (run from the repo)",
              file=sys.stderr)
        return 2
    from reprolint.cli import main as reprolint_main
    return reprolint_main(args.args)


def cmd_fit(args) -> int:
    from repro_torch.learned import fit, heldout_fct_error, model
    camp = Campaign.open(args.campaign)
    backends = tuple(args.backends.split(",")) if args.backends else None
    try:
        ds = camp.export_dataset(backends=backends,
                                 heldout_frac=args.heldout_frac)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        camp.close()
        return 1
    print(f"dataset: {len(ds)} flows from {ds.n_records} records "
          f"({ds.n_heldout_records} records / "
          f"{int(ds.heldout.sum())} flows held out)")
    hidden = tuple(int(h) for h in args.hidden.split(",") if h)
    params = fit(ds, seed=args.seed, hidden=hidden, steps=args.steps,
                 lr=args.lr, device=args.device)
    model.save(params, args.out)
    train = params.meta["train"]
    err = heldout_fct_error(params, ds, device=args.device)
    print(f"fit: {train['steps']} steps (best at {train['best_step']}) on "
          f"{train['device']}, train mse {train['train_mse']:.3e}")
    if err == err:    # not nan
        print(f"held-out mean FCT error: {err * 100:.2f}%")
    print(f"saved {params.fingerprint} -> {args.out}")
    camp.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Experiment campaigns over the engine registry")
    sub = ap.add_subparsers(dest="command", required=True)

    def scenario_args(p):
        p.add_argument("--backend", default="packet")
        p.add_argument("--cca", default="hpcc",
                       help="CCA for gpt@N/moe@N presets")
        p.add_argument("--scale", default="1/256",
                       help="flow-size scale for presets, e.g. 1/256")
        p.add_argument("--opt", action="append", default=[],
                       metavar="KEY=VALUE",
                       help="extra engine opt (repeatable); values parse "
                            "as JSON when possible")
        p.add_argument("-c", "--campaign", metavar="DIR|URL",
                       help="durable campaign directory or store-server "
                            "URL (default: anonymous in-memory session)")
        p.add_argument("--store", metavar="URL", default=None,
                       help="attach the campaign to a shared store server "
                            "(python -m repro_torch serve)")

    p = sub.add_parser("run", help="evaluate one scenario on one backend")
    p.add_argument("scenario", help="scenario .json file or gpt@N / moe@N")
    scenario_args(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sweep",
                       help="evaluate many scenarios, resumably")
    p.add_argument("scenarios", nargs="+",
                   help="scenario .json files and/or gpt@N / moe@N presets")
    scenario_args(p)
    p.add_argument("--workers", type=int, default=1,
                   help="fan uncached scenarios over N spawn processes")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("compare",
                       help="run one scenario on several backends and "
                            "tabulate speedups + FCT errors")
    p.add_argument("scenario", help="scenario .json file or gpt@N / moe@N")
    scenario_args(p)
    p.add_argument("--backends", default="packet,wormhole",
                   help="comma list of backends (default: packet,wormhole)")
    p.add_argument("--baseline", default=None,
                   help="error/speedup reference (default: first backend)")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("serve",
                       help="serve a campaign's store + memo DB over HTTP "
                            "for remote clients (-c URL / --store URL)")
    p.add_argument("-c", "--campaign", metavar="DIR", required=True,
                   help="campaign directory to serve (created if missing)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default: 127.0.0.1)")
    p.add_argument("--port", type=int, default=8321,
                   help="bind port; 0 picks an ephemeral port, printed "
                        "on the first line (default: 8321)")
    p.add_argument("--ttl", type=float, default=None,
                   help="expire run records older than TTL seconds "
                        "(background GC; default: keep forever)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress per-request logging")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("ls", help="list the campaign's stored runs")
    p.add_argument("-c", "--campaign", metavar="DIR|URL", required=True)
    p.add_argument("--backend", default=None, help="filter by backend")
    p.set_defaults(fn=cmd_ls)

    p = sub.add_parser("show", help="print one stored run record as JSON")
    p.add_argument("key", help="store key (any unambiguous prefix)")
    p.add_argument("-c", "--campaign", metavar="DIR|URL", required=True)
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("rm", help="remove stored runs")
    p.add_argument("keys", nargs="*",
                   help="store keys (unambiguous prefixes)")
    p.add_argument("--all", action="store_true",
                   help="remove every stored run")
    p.add_argument("-c", "--campaign", metavar="DIR|URL", required=True)
    p.set_defaults(fn=cmd_rm)

    p = sub.add_parser("backends",
                       help="list registered backends and capabilities")
    p.set_defaults(fn=cmd_backends)

    # `lint` is special-cased in main(): everything after it goes to
    # reprolint verbatim (argparse REMAINDER can't pass through leading
    # option flags like `lint --list-rules`).  The stub is only here so
    # the subcommand shows up in --help.
    p = sub.add_parser(
        "lint", help="run the reprolint static-analysis gates "
                     "(delegates to tools/reprolint)")
    p.add_argument("args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser(
        "fit", help="fit the learned engine on a campaign's stored runs")
    p.add_argument("campaign", metavar="DIR",
                   help="campaign directory holding ground-truth runs")
    p.add_argument("--out", default="artifacts/learned_params.json",
                   help="where to save fitted params (JSON + sibling .npz)")
    p.add_argument("--backends", default=None,
                   help="comma list of ground-truth backends to train on "
                        "(default: packet,wormhole,hybrid)")
    p.add_argument("--heldout-frac", type=float, default=0.25,
                   help="fraction of records held out (by run_key hash)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--hidden", default="64,64",
                   help="comma list of hidden layer widths")
    p.add_argument("--device", default=None,
                   help="where the fit runs: the CUDA card by default, or "
                        "'cpu' (recorded in the params' meta)")
    p.set_defaults(fn=cmd_fit)
    return ap


def main(argv=None) -> int:
    raw = list(sys.argv[1:] if argv is None else argv)
    if raw[:1] == ["lint"]:
        # bypass argparse so flags like `lint --list-rules` reach
        # reprolint untouched
        import types
        return cmd_lint(types.SimpleNamespace(args=raw[1:]))
    args = build_parser().parse_args(raw)
    if args.command == "rm" and not args.all and not args.keys:
        build_parser().error("rm wants keys or --all")
    try:
        return args.fn(args)
    except NoCardError as exc:
        # fluid/learned/fit with no card: the port never falls back to
        # the CPU on its own (--opt device=cpu / --device cpu ask for it)
        print(f"error: {exc} (--opt device=cpu for fluid/learned, --device "
              f"cpu for fit)", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0                      # e.g. `... ls | head` closed stdout
    finally:
        # spawn workers must never outlive a CLI invocation
        shutdown_pools()


if __name__ == "__main__":
    sys.exit(main())
