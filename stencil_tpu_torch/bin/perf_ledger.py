"""Perf ledger CLI: ingest benchmark artifacts, gate regressions.

Counterpart of ``scripts/perf_ledger.py``, with the same command line, over
``stencil_tpu_torch/telemetry/ledger.py`` (which imports no torch).  Besides
the JAX package's artifacts it ingests the port's: a drivers'
``roofline.json`` (``--profile-dir``) as ``roofline:<phase>:gbps`` /
``:gflops`` series and ``bin/bench_pack``'s printed lines saved to a file as
``bench_pack:<ext>:<dir>:gbps`` series.

    # normalize artifacts into the append-only ledger (idempotent)
    python -m stencil_tpu_torch.bin.perf_ledger --ledger ledger.jsonl ingest \\
        prof/roofline.json bench_pack.txt comms_roofline.json

    # the regression gate: newest value per series vs its trailing median
    python -m stencil_tpu_torch.bin.perf_ledger --ledger ledger.jsonl check --threshold 0.1 --window 5

    # the series table without gating
    python -m stencil_tpu_torch.bin.perf_ledger --ledger ledger.jsonl show

``check`` exits 1 when any series regressed.  The default ledger path is
``PERF_LEDGER.jsonl`` in the working directory, as in the JAX package's CLI;
pass ``--ledger`` to keep the port's series in a file of their own.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys

DEFAULT_LEDGER = "PERF_LEDGER.jsonl"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "perf_ledger", description="append-only perf ledger + regression gate"
    )
    p.add_argument(
        "--ledger",
        default=DEFAULT_LEDGER,
        metavar="PATH",
        help=f"ledger JSONL file (default: {DEFAULT_LEDGER})",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    ing = sub.add_parser("ingest", help="normalize artifacts into the ledger")
    ing.add_argument("artifacts", nargs="+",
                     help="BENCH_*.json / roofline.json / bench_pack lines / comms_roofline.json (globs ok)")
    chk = sub.add_parser("check", help="regression gate (exit 1 on regression)")
    chk.add_argument("--threshold", type=float, default=0.10,
                     help="flag drops past this fraction below the trailing median")
    chk.add_argument("--window", type=int, default=5,
                     help="trailing entries the median is taken over")
    chk.add_argument("--json", action="store_true", help="machine output")
    sub.add_parser("show", help="print the per-series table")
    return p


def _table(rows) -> str:
    lines = [
        "| series | newest | trailing median | ratio | n | |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        med = r["trailing_median"]
        lines.append(
            f"| `{r['key']}` | {r['value']:g} {r['unit']} | "
            f"{f'{med:g}' if med is not None else '—'} | "
            f"{r['ratio'] if r['ratio'] is not None else '—'} | {r['n']} | "
            f"{'REGRESSED' if r['regressed'] else ''} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from stencil_tpu_torch.telemetry import ledger

    if args.cmd == "ingest":
        paths = []
        for pat in args.artifacts:
            # sorted: ledger order IS series order (check_regressions), and
            # round artifacts sort by name (BENCH_r01 < ... < BENCH_r05)
            hits = sorted(glob.glob(pat))
            paths.extend(hits if hits else [pat])
        entries = []
        for path in paths:
            got = ledger.entries_from_artifact(path)
            if not got:
                print(f"{path}: no ledger series recognized", file=sys.stderr)
            entries.extend(got)
        n = ledger.append_entries(args.ledger, entries)
        print(
            f"ingested {n} new entries ({len(entries)} seen) into {args.ledger}",
            file=sys.stderr,
        )
        return 0

    entries = ledger.read_ledger(args.ledger)
    if not entries:
        print(f"ledger {args.ledger} is empty — ingest artifacts first", file=sys.stderr)
        return 2
    if args.cmd == "show":
        rows, _ = ledger.check_regressions(entries)
        print(_table(rows))
        return 0
    rows, regressions = ledger.check_regressions(
        entries, threshold=args.threshold, window=args.window
    )
    if args.json:
        print(json.dumps({"rows": rows, "regressions": regressions}, indent=2))
    else:
        print(_table(rows))
    if regressions:
        for r in regressions:
            print(
                f"REGRESSION: {r['key']} at {r['value']:g} {r['unit']} vs "
                f"trailing median {r['trailing_median']:g} "
                f"(ratio {r['ratio']})",
                file=sys.stderr,
            )
        return 1
    print("no regressions", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
