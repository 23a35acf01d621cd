"""Perf-regression sentinel over the committed bench trajectory.

  PYTHONPATH=src python -m repro_torch.telemetry.bench_check BENCH_sim.json

``BENCH_sim.json`` accumulates one entry per bench run (label, git sha,
backend, per-bench ``us_per_call``); this tool treats each
``(label, name)`` pair as a time series and flags the LATEST point when
it regresses against the trailing baseline. The detector is robust, not
parametric — container-to-container timing noise is heavy-tailed, so the
baseline is the median of the prior points and the scale is the MAD
(``sigma ≈ 1.4826 × MAD``, zero-floored at a fraction of the median):
a point is a regression only when its robust z-score exceeds ``--z``
AND its relative slowdown exceeds ``--min-rel`` — both gates, so a tiny
absolute wobble on a microbench can't page and a huge MAD can't mask a
2× cliff. Series shorter than ``--min-points`` are skipped (reported,
never failed): a fresh bench needs history before it can regress.

Exit status: 0 = no regressions (or nothing checkable), 1 = at least
one regression, 2 = unreadable input. The port's bench records
(:func:`repro_torch.benchmarks.common.write_record`) share the format.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

#: MAD -> sigma for a normal core; the usual robust-scale constant.
MAD_SIGMA = 1.4826


def load_series(path) -> dict[tuple[str, str], list[float]]:
    """``BENCH_sim.json`` -> ``{(label, name): [us_per_call, ...]}``.

    File order is run order (the writer appends and dedupes same-label
    snapshots in place), so each list is the bench's trajectory with the
    LATEST point last.
    """
    with open(path) as f:
        entries = json.load(f)
    series: dict[tuple[str, str], list[float]] = {}
    for entry in entries:
        label = str(entry.get("label", ""))
        for b in entry.get("benches", ()):
            key = (label, str(b["name"]))
            series.setdefault(key, []).append(float(b["us_per_call"]))
    return series


def check_series(values, z_max: float = 3.0, min_rel: float = 0.25,
                 min_points: int = 4, rel_floor: float = 0.05) -> dict:
    """Verdict for one trajectory (latest point vs trailing baseline).

    Returns ``{"status": "ok" | "regression" | "skipped", "z", "rel",
    "latest", "median", "sigma", "n"}``. ``sigma`` is the MAD-derived
    scale, floored at ``rel_floor × median`` so an eerily stable series
    (MAD ~ 0) doesn't turn measurement jitter into a 100-sigma page.
    """
    v = np.asarray(values, np.float64)
    n = v.size
    if n < min_points:
        return {"status": "skipped", "n": int(n), "latest": float(v[-1])
                if n else float("nan")}
    base, latest = v[:-1], float(v[-1])
    med = float(np.median(base))
    mad = float(np.median(np.abs(base - med)))
    sigma = max(MAD_SIGMA * mad, rel_floor * max(med, 1e-12))
    z = (latest - med) / sigma
    rel = latest / max(med, 1e-12) - 1.0
    status = "regression" if (z > z_max and rel > min_rel) else "ok"
    return {"status": status, "n": int(n), "latest": latest, "median": med,
            "sigma": sigma, "z": float(z), "rel": float(rel)}


def check_file(path, z_max: float = 3.0, min_rel: float = 0.25,
               min_points: int = 4, label: str | None = None) -> dict:
    """Run the sentinel over every (label, name) series in the file."""
    series = load_series(path)
    results = {}
    for (lbl, name), values in sorted(series.items()):
        if label is not None and lbl != label:
            continue
        results[f"{lbl}/{name}"] = check_series(
            values, z_max=z_max, min_rel=min_rel, min_points=min_points
        )
    regressions = [k for k, r in results.items()
                   if r["status"] == "regression"]
    return {"ok": not regressions, "regressions": regressions,
            "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fail when the latest bench entry regresses vs the "
                    "trailing median/MAD baseline")
    ap.add_argument("path", help="BENCH_sim.json")
    ap.add_argument("--z", type=float, default=3.0,
                    help="robust z-score gate (default 3)")
    ap.add_argument("--min-rel", type=float, default=0.25,
                    help="minimum relative slowdown gate (default 0.25)")
    ap.add_argument("--min-points", type=int, default=4,
                    help="series shorter than this are skipped (default 4)")
    ap.add_argument("--label", default=None,
                    help="check only series from this bench label")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    try:
        res = check_file(args.path, z_max=args.z, min_rel=args.min_rel,
                         min_points=args.min_points, label=args.label)
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        print(f"bench_check: cannot read {args.path}: {e}", file=sys.stderr)
        return 2

    n_ok = sum(r["status"] == "ok" for r in res["results"].values())
    n_skip = sum(r["status"] == "skipped" for r in res["results"].values())
    if not args.quiet:
        for key, r in res["results"].items():
            if r["status"] == "skipped":
                print(f"  SKIP {key}: only {r['n']} point(s)")
            else:
                mark = "FAIL" if r["status"] == "regression" else "  ok"
                print(f"  {mark} {key}: {r['latest']:.1f} us vs median "
                      f"{r['median']:.1f} (z={r['z']:+.1f}, "
                      f"rel={r['rel']:+.0%}, n={r['n']})")
        verdict = ("REGRESSION in: " + ", ".join(res["regressions"])
                   if res["regressions"] else "no regressions")
        print(f"bench_check: {verdict} "
              f"({n_ok} ok, {n_skip} skipped, "
              f"{len(res['regressions'])} failed)")
    return 1 if res["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
