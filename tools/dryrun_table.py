#!/usr/bin/env python3
"""The dry run's production cells as one markdown table.

    python3 tools/dryrun_table.py results/dryrun_torch_mesh.json

Reads the cache that ``python -m repro_torch.launch.dryrun --all --mesh
both`` writes and prints a row for each (arch, shape) walked on both
production meshes, each column "16x16 / 2x16x16": the walk's counts for
rank 0, argument and peak GB a rank, matmul TFLOP a step, the number of
collectives and their GB a rank (the ring accounting) by group size: 2
(the pod axis), 16 (data or model) and any other (32: pod x data; 256 or
512: the world). Then the count of cells walked, skipped and failed.
Counts, not timings: they are the same on any device.
"""
from __future__ import annotations

import json
import sys


def _cols(rec: dict) -> list[str]:
    groups = rec["collectives"]["by_group_size"]
    other = ", ".join(f"{g}: {b / 1e9:.3g}" for g, b in sorted(
        groups.items(), key=lambda kv: int(kv[0])) if g not in ("2", "16")) or "-"
    return [f"{rec['argument_bytes'] / 1e9:.3f}", f"{rec['peak_bytes'] / 1e9:.2f}",
            f"{rec['flops_per_device'] / 1e12:.2f}", f"{rec['collectives']['n_ops']}",
            f"{groups.get('2', 0.0) / 1e9:.3f}", f"{groups.get('16', 0.0) / 1e9:.3f}", other]


def rows(results: dict) -> list[str]:
    out = ["| arch | shape | argument GB | peak GB | TFLOP | collectives | GB over 2 | "
           "GB over 16 | GB over others |",
           "| --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    cells = {}
    for rec in results.values():
        if rec.get("mesh") in ("single", "multi") and "skipped" not in rec \
                and "error" not in rec:
            cells.setdefault((rec["arch"], rec["shape"]), {})[rec["mesh"]] = rec
    for (arch, shape), recs in cells.items():
        if set(recs) != {"single", "multi"}:
            continue
        pairs = zip(_cols(recs["single"]), _cols(recs["multi"]))
        out.append(f"| {arch} | {shape} | " + " | ".join(f"{a} / {b}" for a, b in pairs) + " |")
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__.split("\n\n")[1].strip(), file=sys.stderr)
        return 2
    with open(argv[0]) as fh:
        results = json.load(fh)
    print("\n".join(rows(results)))
    errors = [k for k, v in results.items() if "error" in v]
    skipped = sum(1 for v in results.values() if "skipped" in v)
    print(f"\n{len(results)} cells: {len(results) - len(errors) - skipped} walked, "
          f"{skipped} skipped, {len(errors)} errors {errors}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
