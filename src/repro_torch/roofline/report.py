"""Render the dry-run tables from its records (twin of
`repro/roofline/report.py`).

  PYTHONPATH=src python -m repro_torch.roofline.report \
      --results results/dryrun [--write FILE]

The records keep the reference's keys (`launch.dryrun`), so the same
records render the reference's tables; the remedies (`FIX_NOTES`) and
the capacity in the summary are the card's. `render_table` is shared
with obs.report.
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch import hw

ARCH_ORDER = ["internlm2-1.8b", "qwen1.5-110b", "command-r-35b", "glm4-9b",
              "whisper-base", "grok-1-314b", "qwen2-moe-a2.7b",
              "zamba2-1.2b", "xlstm-350m", "internvl2-76b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

FIX_NOTES = {
    "memory": "dominant=memory: fuse the fp32 softmax + norm round-trips "
              "into a CUDA attention kernel (flash-style, scores in shared "
              "memory) or raise arithmetic intensity per HBM byte",
    "compute": "dominant=compute: near the roof — only algorithmic "
                "reductions (sparsity, distillation) move it",
    "collective": "dominant=collective: cut FSDP regather via larger "
                  "microbatches, overlap NCCL collectives with compute on "
                  "a side stream, or switch the MoE to expert parallelism "
                  "(all-to-all over NCCL)",
}

CAPACITY = f"{hw.TARGET.hbm_bytes / 1e9:.0f} GB/card"


def render_table(headers, rows):
    """Generic column-aligned markdown table (shared with obs.report)."""
    cells = [list(map(str, headers))] + [list(map(str, r)) for r in rows]
    widths = [max(len(row[i]) for row in cells)
              for i in range(len(headers))]

    def fmt(row):
        return "| " + " | ".join(c.ljust(w)
                                 for c, w in zip(row, widths)) + " |"
    sep = "|" + "|".join("-" * (w + 2) for w in widths) + "|"
    return "\n".join([fmt(cells[0]), sep] + [fmt(r) for r in cells[1:]])


def load(results: pathlib.Path, mesh: str):
    out = {}
    for f in results.glob(f"*__{mesh}.json"):
        r = json.loads(f.read_text())
        out[(r["arch"], r["shape"])] = r
    return out


def fmt_row(r):
    if r["status"] == "skip":
        return "SKIP (quadratic attention)", ""
    if r["status"] != "ok":
        return f"ERROR {r.get('error', '')[:40]}", ""
    t = r["roofline"]
    hbm = r["per_device_hbm_bytes"] / 2 ** 30
    fits = "yes" if r["fits_hbm"] else "NO"
    row = (f"{t['compute_s']:.3f} | {t['memory_s']:.3f} | "
           f"{t['collective_s']:.3f} | **{t['dominant']}** | "
           f"{t['useful_flops_ratio']:.3f} | {hbm:.1f} | {fits}")
    return row, FIX_NOTES[t["dominant"]]


def render_roofline(records):
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant |"
        " useful | HBM GiB/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    notes = []
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = records.get((arch, shape))
            if r is None:
                continue
            row, note = fmt_row(r)
            if r["status"] == "ok":
                lines.append(f"| {arch} | {shape} | {row} |")
                notes.append((arch, shape, r["roofline"]["dominant"]))
            else:
                lines.append(f"| {arch} | {shape} | {row} |  |  |  |  |  |")
    lines.append("")
    lines.append("Per-cell 'what moves the dominant term' (one line each):")
    for arch, shape, dom in notes:
        lines.append(f"* `{arch}` x `{shape}`: " + FIX_NOTES[dom])
    return "\n".join(lines)


def render_summary(single, multi):
    def count(recs):
        ok = sum(r["status"] == "ok" for r in recs.values())
        skip = sum(r["status"] == "skip" for r in recs.values())
        err = sum(r["status"] == "error" for r in recs.values())
        fit = sum(r.get("fits_hbm", False) for r in recs.values())
        return ok, skip, err, fit

    s = count(single)
    m = count(multi)
    return (
        f"Single-pod 16x16: {s[0]} compiled OK, {s[1]} skipped by design, "
        f"{s[2]} errors; {s[3]}/{s[0]} fit {CAPACITY}.\n"
        f"Multi-pod 2x16x16: {m[0]} compiled OK, {m[1]} skipped, "
        f"{m[2]} errors; {m[3]}/{m[0]} fit (the 'pod' axis shards the "
        f"global batch; only gradient/statistic reductions cross pods).")


def render_multipod(records):
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant |"
        " HBM GiB/dev | fits |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = records.get((arch, shape))
            if r is None or r["status"] != "ok":
                continue
            t = r["roofline"]
            hbm = r["per_device_hbm_bytes"] / 2 ** 30
            lines.append(
                f"| {arch} | {shape} | {t['compute_s']:.3f} | "
                f"{t['memory_s']:.3f} | {t['collective_s']:.3f} | "
                f"{t['dominant']} | {hbm:.1f} | "
                f"{'yes' if r['fits_hbm'] else 'NO'} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--write", default=None)
    args = ap.parse_args(argv)
    results = pathlib.Path(args.results)
    single = load(results, "pod16x16")
    multi = load(results, "pod2x16x16")

    summary = render_summary(single, multi)
    roof = render_roofline(single)
    mp = render_multipod(multi)
    if args.write:
        p = pathlib.Path(args.write)
        text = p.read_text()
        text = text.replace("<!-- DRYRUN_SUMMARY -->", summary)
        text = text.replace("<!-- ROOFLINE_TABLE -->", roof)
        text = text.replace("<!-- MULTIPOD_TABLE -->", mp)
        p.write_text(text)
        print(f"wrote tables into {p}")
    else:
        print(summary)
        print()
        print(roof)
        print()
        print(mp)


if __name__ == "__main__":
    main()
