"""Roofline tables of the port's dry-run records (counterpart of
``repro.launch.report``), from results/dryrun_torch/*.json:

    PYTHONPATH=src python -m repro_torch.launch.report > results/roofline_tables_torch.md

The terms are a model of the card from its data sheet (``launch.roofline``),
not measurements.
"""
from __future__ import annotations

import glob
import json

RESULTS_DIR = "results/dryrun_torch"


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def load(mesh: str) -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(f"{RESULTS_DIR}/*__{mesh}.json")):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


MOVE_HINTS = {
    "memory": "cut HBM traffic (fuse flash chains / bf16 intermediates / "
    "chunk-size tuning / fewer resharding copies)",
    "collective": "reduce or overlap collectives (reshard once per layer, "
    "reduce-scatter instead of all-reduce, batch FSDP gathers)",
    "compute": "raise MFU (remove remat recompute via policy, larger "
    "microbatches, tensor-core-aligned tiles)",
}


def table(mesh: str) -> str:
    recs = load(mesh)
    out = [
        f"### Mesh {mesh} ({recs[0]['n_devices'] if recs else '?'} chips)",
        "",
        "| arch | shape | rules/mb | compile | peak GB | t_comp | t_mem "
        "(floor) | t_coll | bottleneck | useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        out.append(
            "| {arch} | {shape} | {rules}/{mb} | {c:.0f}s | {peak:.1f} | {tc} "
            "| {tm} ({tmm}) | {tl} | {b} | {u:.2f} | {rf:.3f} |".format(
                arch=r["arch"],
                shape=r["shape"],
                rules=r["rules"],
                mb=r["microbatches"],
                c=r["compile_s"],
                peak=r["memory"]["peak_live_gb"],
                tc=fmt_s(r["t_compute_s"]),
                tm=fmt_s(r["t_memory_s"]),
                tmm=fmt_s(r.get("t_memory_min_s", 0.0)),
                tl=fmt_s(r["t_collective_s"]),
                b=r["bottleneck"],
                u=r["useful_flops_ratio"],
                rf=r["roofline_fraction"],
            )
        )
    out.append("")
    return "\n".join(out)


def bottleneck_notes(mesh: str) -> str:
    recs = load(mesh)
    out = ["#### Dominant-term notes (one per cell)", ""]
    for r in recs:
        out.append(
            f"- **{r['arch']} × {r['shape']}**: {r['bottleneck']}-bound "
            f"(t={fmt_s(max(r['t_compute_s'], r['t_memory_s'], r['t_collective_s']))}); "
            f"to move it: {MOVE_HINTS[r['bottleneck']]}."
        )
    out.append("")
    return "\n".join(out)


def main():
    for mesh in ["pod16x16", "pod2x16x16"]:
        print(table(mesh))
    print(bottleneck_notes("pod16x16"))


if __name__ == "__main__":
    main()
