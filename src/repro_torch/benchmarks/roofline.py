"""Aggregate the port's dry-run artifacts into the roofline table — the port
of the JAX package's ``benchmarks/roofline.py``.

Reads ``benchmarks/artifacts/dryrun_torch/*__<variant>.json``
(:mod:`repro_torch.launch.dryrun`), writes

  * ``benchmarks/artifacts/roofline_torch_<variant>.csv``
  * ``benchmarks/artifacts/roofline_torch_<variant>.md``

and emits one ``roofline_table_<variant>`` CSV line (µs 0.0, as the
reference's: the table is derived, not timed). The terms are one H100's
(:mod:`repro_torch.launch.roofline`).

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline [variant]
"""

from __future__ import annotations

import json

from repro_torch.benchmarks.common import ART, emit

DRY = ART / "dryrun_torch"
COLS = ["arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
        "dominant", "roofline_fraction", "useful_flops_ratio", "mfu_proxy",
        "args_gb_per_dev", "peak_gb_per_dev"]


def load(variant: str = "baseline") -> list[dict]:
    return [json.loads(p.read_text()) for p in sorted(DRY.glob(f"*__{variant}.json"))]


def fmt_row(r: dict) -> dict:
    if "skipped" in r:
        return {
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "status": f"skipped: {r['skipped']}",
        }
    rl = r["roofline"]
    hbm_gb = (r["memory"]["argument_bytes"] or 0) / 1e9
    frac = rl["roofline_fraction"] or 0.0
    useful = rl["useful_flops_ratio"] or 0.0
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
        "collective_s": rl["collective_s"], "dominant": rl["dominant"],
        "roofline_fraction": frac,
        "useful_flops_ratio": useful,
        # MFU proxy: useful model FLOPs / (chips × peak × step_time).
        "mfu_proxy": frac * useful,
        "args_gb_per_dev": hbm_gb,
        "peak_gb_per_dev": (r["memory"]["peak_bytes"] or 0) / 1e9,
        "status": "ok",
    }


def tabulate(variant: str = "baseline") -> tuple[list[dict], dict]:
    """Write the two tables; returns (the rows, the emitted record).
    Raises ``FileNotFoundError`` when no record is usable."""
    rows = [fmt_row(r) for r in load(variant)]
    ok = [r for r in rows if r["status"] == "ok"]
    if not ok:
        raise FileNotFoundError(
            f"no usable dry-run records under {DRY}/*__{variant}.json — "
            "run the dry-run sweep first; refusing to write empty tables"
        )

    with open(ART / f"roofline_torch_{variant}.csv", "w") as f:
        f.write(",".join(COLS) + "\n")
        for r in ok:
            f.write(",".join(
                f"{r[c]:.4e}" if isinstance(r[c], float) else str(r[c]) for c in COLS
            ) + "\n")
    with open(ART / f"roofline_torch_{variant}.md", "w") as f:
        f.write("| " + " | ".join(COLS) + " |\n")
        f.write("|" + "---|" * len(COLS) + "\n")
        for r in rows:
            if r["status"] != "ok":
                f.write(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        + " | ".join(["—"] * (len(COLS) - 4))
                        + f" | {r['status']} |\n")
                continue
            f.write("| " + " | ".join(
                f"{r[c]:.3e}" if isinstance(r[c], float) else str(r[c]) for c in COLS
            ) + " |\n")

    worst = min(ok, key=lambda r: r["roofline_fraction"] or 1.0)
    most_coll = max(ok, key=lambda r: r["collective_s"] / max(r["compute_s"], 1e-12))
    record = emit(f"roofline_table_{variant}", 0.0,
                  f"cells={len(ok)};worst_fraction={worst['arch']}×{worst['shape']}"
                  f"={worst['roofline_fraction']:.3f};"
                  f"most_collective={most_coll['arch']}×{most_coll['shape']}")
    return rows, record


def main(variant: str = "baseline") -> list[dict]:
    return tabulate(variant)[0]


if __name__ == "__main__":
    import sys
    main(sys.argv[1] if len(sys.argv) > 1 else "baseline")
