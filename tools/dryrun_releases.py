"""The dry run's rows from two torch releases side by side, as a markdown table.

`repro_torch.launch.dryrun` counts what `DTensor`'s partitioning of the
tracing release runs on a device, and `launch.roofline` refuses to mix
releases in one table.  This script reads two row files (``A``, e.g. the
card's machine's, and ``B``, the CPU's), each of one release, and prints
one line per (arch × shape), each value "16 × 16 / 2 × 16 × 16": the
microbatches traced of n (a train step of n > 2 microbatches traces two,
`dryrun._scaled_microbatches`), FLOPs a device on each release and A's
over B's, link bytes a device on each, `roofline.step_bound` on each (its
term on the H100's peaks: c compute, m the bytes floor, l the links) and
the trace seconds on each.  A failed cell prints its error.

    PYTHONPATH=src python3 tools/dryrun_releases.py results/dryrun_211.json \\
        results/dryrun_213.json
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="rows of one release (e.g. the card's machine)")
    ap.add_argument("b", help="rows of another release (e.g. the CPU's)")
    args = ap.parse_args(argv)
    name_a, a = load(args.a)
    name_b, b = load(args.b)
    ok = {n: sum("error" not in r for r in rows.values()) for n, rows in ((name_a, a),
                                                                         (name_b, b))}
    print(f"{name_a}: {ok[name_a]}/{len(a)} cells OK; {name_b}: {ok[name_b]}/{len(b)} cells OK")
    print("\n".join(table(a, b, name_a, name_b)))


if __name__ == "__main__":
    main()
