"""Flight-record report tool.

    PYTHONPATH=src python -m repro_torch.telemetry.report run.jsonl [--check]
        [--codes recovery,epoch] [--max-events 40] [--percentiles]
        [--spans trace.json]

Renders the timeline of a JSONL record stream
(:func:`repro_torch.telemetry.export.render_timeline`); ``--check`` additionally
rebuilds the summarize totals from the stream and exits non-zero when they
disagree with the embedded summary record — the CI round-trip smoke.
``--percentiles`` prints the decoded percentile tables of every ``hist``
record in the stream (p50/p95/p99 with error bounds); ``--spans OUT.json``
folds the stream into lifecycle spans and writes Chrome trace-event JSON
(open in Perfetto / ``chrome://tracing``).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.telemetry.export import cross_check, read_jsonl, render_timeline
from repro_torch.telemetry.spans import spans_from_records, write_chrome_trace


def _print_percentiles(records: list[dict]) -> None:
    hists = [r for r in records if r.get("type") == "hist"]
    if not hists:
        print("\nno hist records in stream (run with "
              "TelemetryConfig(hist=HistogramSpec(...)))")
        return
    for h in hists:
        dim = h.get("dim", "row")
        print(f"\n{h['name']} percentiles (per {dim}, "
              f"±err = one bucket width):")
        for i, row in enumerate(h.get("percentiles", [])):
            name = row.get("name", f"{dim}{i}")
            cells = "  ".join(
                f"{k}={row[k]:.3g}±{row[f'{k}_err']:.2g}"
                for k in sorted(row)
                if k.startswith("p") and not k.endswith("_err")
            )
            print(f"  {name:<16} n={row['count']:.1f}  {cells}")
    for r in records:
        if r.get("type") == "slo":
            print("\nSLO verdicts:")
            for v in r["verdicts"]:
                mark = "PASS" if v["ok"] else "FAIL"
                print(f"  {mark} {v['name']}: p{v['percentile']:g} = "
                      f"{v['estimate']:.3g}±{v['err']:.2g} "
                      f"vs target {v['target']:g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="JSONL record stream to render")
    ap.add_argument("--check", action="store_true",
                    help="cross-check stream totals against the embedded "
                         "summary record (exit 1 on mismatch)")
    ap.add_argument("--codes", default=None,
                    help="comma-separated event codes to show "
                         "(default: all)")
    ap.add_argument("--max-events", type=int, default=200)
    ap.add_argument("--percentiles", action="store_true",
                    help="print decoded percentile tables from the "
                         "stream's hist records")
    ap.add_argument("--spans", default=None, metavar="OUT.json",
                    help="write lifecycle spans as Chrome trace-event "
                         "JSON to OUT.json")
    args = ap.parse_args(argv)

    records = read_jsonl(args.path)
    codes = set(args.codes.split(",")) if args.codes else None
    print(render_timeline(records, codes=codes, max_events=args.max_events))

    if args.percentiles:
        _print_percentiles(records)

    if args.spans:
        spans = spans_from_records(records)
        write_chrome_trace(spans, args.spans)
        print(f"\nwrote {len(spans)} spans to {args.spans} "
              "(open in Perfetto / chrome://tracing)")

    if args.check:
        res = cross_check(records)
        status = "OK" if res["ok"] else "MISMATCH"
        print(f"\ncross-check [{status}] kind={res['kind']} "
              f"dropped={res['events_dropped']}")
        for name, c in res.get("checks", {}).items():
            mark = "✓" if c["ok"] else "✗"
            print(f"  {mark} {name:<15} stream={c['stream']:.6g} "
                  f"summary={c['summary']:.6g}")
        if "error" in res:
            print(f"  error: {res['error']}")
        return 0 if res["ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
