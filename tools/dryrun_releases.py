"""The dry run's rows from two torch releases side by side, and each
against the reference's own grid, as markdown tables.

`repro_torch.launch.dryrun` counts what `DTensor`'s partitioning of the
tracing release runs on a device, and `launch.roofline` refuses to mix
releases in one table.  This script reads one or two row files (``A``,
e.g. the card's machine's, and ``B``, the CPU's), each of one release,
and the reference's grid (``--reference``, `results/dryrun_reference.json`
from `tools/dryrun_reference.py`).  With two files it prints one line per
(arch × shape), each value "16 × 16 / 2 × 16 × 16": the microbatches
traced of n (a train step of n > 2 microbatches traces two,
`dryrun._scaled_microbatches`), FLOPs a device on each release and A's
over B's, link bytes a device on each, `roofline.step_bound` on each (its
term on the H100's peaks: c compute, m the bytes floor, l the links) and
the trace seconds on each.  Then the reference's FLOPs a device and each
file's FLOPs, link bytes and memory a device over the reference's, each
ratio marked ``!`` where it breaks `chip_smoke.reference_bounds` (FLOPs
at most 1.5 or 2 times and at least 0.9 times where the reference splits
the step; a dense train step's memory at most 2 times), and per file a
count of the rows above 1.5 and 2 times and below 0.67 times.  A
failed cell prints its error.

    PYTHONPATH=src python3 tools/dryrun_releases.py results/dryrun_211.json \\
        results/dryrun_213.json
    PYTHONPATH=src python3 tools/dryrun_releases.py results/dryrun.json
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MESHES = ("16x16", "2x16x16")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
TERM = {"compute": "c", "memory": "m", "collective": "l"}  # m: the bytes floor


def load(path: str) -> tuple[str, dict]:
    """(the release, {(arch, shape, mesh): row}) of a row file of one
    release."""
    with open(path) as f:
        rows = json.load(f)
    releases = {r["torch"] for r in rows if "torch" in r}
    if len(releases) > 1:
        raise SystemExit(f"{path}: rows of {sorted(releases)}; one release a file")
    return (releases.pop() if releases else "?",
            {(r["arch"], r["shape"], r["mesh"]): r for r in rows})


def table(a: dict, b: dict, name_a: str, name_b: str) -> list[str]:
    from repro_torch.launch import roofline

    def each(row_of, fmt):
        return " / ".join("—" if r is None else ("error" if "error" in r else fmt(r))
                          for r in row_of)

    def bound(r):
        terms = roofline.bound_terms(r)
        term = max(terms, key=terms.get)
        return f"{terms[term]:.4g} {TERM[term]}"

    def micro(r):
        m = r.get("microbatches")
        return "—" if m is None else f"{m['traced']} of {m['n']}"

    def ratio(pair):
        ra, rb = pair
        if ra is None or rb is None or "error" in ra or "error" in rb:
            return "—"
        return f"{ra['cost']['flops'] / rb['cost']['flops']:.3f}"

    lines = [f"| arch | shape | microbatches | FLOPs a device, {name_a} | {name_b} | "
             f"{name_a} / {name_b} | link bytes a device, {name_a} | {name_b} | "
             f"step_bound s, {name_a} | {name_b} | trace s, {name_a} | {name_b} |",
             "|" + "---|" * 12]
    keys = sorted({k[:2] for k in (*a, *b)},
                  key=lambda k: (k[0], SHAPES.index(k[1]) if k[1] in SHAPES else 9))
    errors = []
    for arch, shape in keys:
        ra = [a.get((arch, shape, m)) for m in MESHES]
        rb = [b.get((arch, shape, m)) for m in MESHES]
        errors += [f"{name} {arch} {shape} {r['mesh']}: {r['error'][:200]}"
                   for name, rs in ((name_a, ra), (name_b, rb)) for r in rs
                   if r is not None and "error" in r]
        lines.append(
            f"| {arch} | {shape} | {each(ra, micro)} | "
            f"{each(ra, lambda r: format(r['cost']['flops'], '.4g'))} | "
            f"{each(rb, lambda r: format(r['cost']['flops'], '.4g'))} | "
            f"{' / '.join(ratio(p) for p in zip(ra, rb))} | "
            f"{each(ra, lambda r: format(r['collectives']['link_bytes_total'], '.4g'))} | "
            f"{each(rb, lambda r: format(r['collectives']['link_bytes_total'], '.4g'))} | "
            f"{each(ra, bound)} | {each(rb, bound)} | "
            f"{each(ra, lambda r: format(r['lower_s'], 'g'))} | "
            f"{each(rb, lambda r: format(r['lower_s'], 'g'))} |")
    return lines + errors


def against_reference(grids: list, ref: dict) -> list[str]:
    """One line per (arch × shape): the reference's FLOPs a device, and
    each grid's (``[(name, rows)]``) FLOPs, link bytes and memory a
    device over the reference's, "16 × 16 / 2 × 16 × 16"; then, per grid,
    the rows above 1.5 and 2 times and below 0.67 times."""
    import chip_smoke
    from repro_torch.launch import dryrun

    def ratio(rows, key, metric):
        r, f = rows.get(key), ref.get(key)
        if r is None or f is None or "error" in r or "error" in f:
            return "—"
        x = dryrun.against_reference(r, f)[metric]
        least, most = chip_smoke.reference_bounds(r, f).get(metric, (0.0, math.inf))
        return f"{x:.3f}{'' if least <= x <= most else '!'}"

    def flops(key):
        f = ref.get(key)
        return "—" if f is None or "error" in f else format(f["cost"]["flops"], ".4g")

    names = [name for name, _ in grids]
    lines = ["| arch | shape | FLOPs a device, reference | "
             + " | ".join(f"{metric}, {name} / reference" for metric in
                          ("FLOPs", "link bytes", "memory") for name in names) + " |",
             "|" + "---|" * (3 + 3 * len(grids))]
    keys = sorted({k[:2] for k in ref},
                  key=lambda k: (k[0], SHAPES.index(k[1]) if k[1] in SHAPES else 9))
    for arch, shape in keys:
        cells = [(arch, shape, m) for m in MESHES]
        lines.append(f"| {arch} | {shape} | {' / '.join(flops(k) for k in cells)} | " + " | ".join(
            " / ".join(ratio(rows, k, metric) for k in cells)
            for metric in ("flops", "link_bytes", "memory") for _, rows in grids) + " |")
    for name, rows in grids:
        x = [dryrun.against_reference(rows[k], ref[k])["flops"] for k in rows
             if k in ref and "error" not in rows[k] and "error" not in ref[k]]
        lines.append(f"{name}: {len(x)} rows beside the reference's; FLOPs a device above 1.5 "
                     f"times the reference's on {sum(v > 1.5 for v in x)}, above 2 times on "
                     f"{sum(v > 2 for v in x)}, below 0.67 times on {sum(v < 0.67 for v in x)}; "
                     f"a bound of `chip_smoke.reference_bounds` broken on "
                     f"{sum(bool(chip_smoke.reference_breaks(rows[k], ref[k])) for k in rows if k in ref and 'error' not in rows[k] and 'error' not in ref[k])}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("grids", nargs="+", metavar="ROWS",
                    help="rows of one release, then optionally another's (e.g. the card's "
                         "machine's, then the CPU's)")
    ap.add_argument("--reference", default=str(ROOT / "results" / "dryrun_reference.json"),
                    help="the reference's grid (tools/dryrun_reference.py)")
    args = ap.parse_args(argv)
    if len(args.grids) > 2:
        ap.error("one or two row files")
    grids = [load(path) for path in args.grids]
    print("; ".join(f"{name}: {sum('error' not in r for r in rows.values())}/{len(rows)} "
                    f"cells OK" for name, rows in grids))
    if len(grids) == 2:
        (name_a, a), (name_b, b) = grids
        print("\n".join(table(a, b, name_a, name_b)))
    from repro_torch.launch import dryrun

    ref = dryrun.reference_rows(args.reference)
    jax = sorted({r.get("jax", "?") for r in ref.values()})
    print(f"\nagainst the reference (jax {', '.join(jax)}); ! a bound of "
          f"`chip_smoke.reference_bounds` broken:")
    print("\n".join(against_reference(grids, ref)))


if __name__ == "__main__":
    main()
