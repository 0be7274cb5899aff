"""Roofline aggregation (counterpart of `benchmarks/roofline.py`): read
results/dryrun/*.json, the records `python -m repro_torch.launch.dryrun`
writes, into one markdown table row per arch x shape x mesh.

    PYTHONPATH=src python -m repro_torch.bench.roofline

Records that carry a "mode" (the reference's hierarchical runs) have a
table of their own and are left out, as in the reference.
"""
from __future__ import annotations

import glob
import json
import os

RESULTS = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun"))


def load_records(tag="", results=None):
    recs = []
    for p in sorted(glob.glob(os.path.join(results or RESULTS, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if r.get("tag", "") == tag and "mode" not in r:
            recs.append(r)
    return recs


def fmt_float(x):
    return f"{x:.3e}" if isinstance(x, float) else str(x)


def markdown_table(recs, mesh=None):
    rows = ["| arch | shape | mesh | compute_s | memory_s | collective_s "
            "| bottleneck | MODEL/HLO flops | roofline frac | state GiB/dev |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if mesh and r["mesh"] != mesh:
            continue
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"skip: {r['reason']} |||||||")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR {r.get('error', '')[:60]} |||||||")
            continue
        rf = r["roofline"]
        ratio = rf.get("useful_flops_ratio")
        ratio_s = f"{ratio:.2f}" if ratio else "n/a"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {rf['compute_s']:.3e} | {rf['memory_s']:.3e} "
            f"| {rf['collective_s']:.3e} | {rf['bottleneck']} "
            f"| {ratio_s} | {rf['roofline_fraction']:.2f} "
            f"| {r['state_bytes_per_device'] / (1 << 30):.2f} |")
    return "\n".join(rows)


def report(mesh="pod16x16", results=None) -> str:
    """The table of `mesh`'s records, or the hint to run the dry run
    first when there are none (the reference's roofline section)."""
    recs = load_records(results=results)
    if not recs:
        return ("(no dry-run artifacts; run python -m "
                "repro_torch.launch.dryrun first)")
    return ("== Roofline (from dry-run artifacts) ==\n"
            + markdown_table(recs, mesh=mesh))


def main():
    print(markdown_table(load_records()))


if __name__ == "__main__":
    main()
