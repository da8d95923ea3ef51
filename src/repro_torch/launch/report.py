"""The dry-run and roofline tables from ``results/dryrun_torch/*.json``:
the port of the JAX package's ``launch/report.py``.

  PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun_torch]

The tables keep the reference's columns.  The port has no compile step:
its ``lower+compile`` column is the trace seconds plus 0 (a record of the
reference's, with ``lower_s`` and ``compile_s``, prints as it does
there), and ``HLO/MODEL`` is the counted FLOPs of the eager step over
``MODEL_FLOPS``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import get_config
from . import roofline
from .dryrun import OUT_DIR


def fmt_bytes(b):
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def fmt_s(s):
    if s == 0:
        return "0"
    if s < 1e-3:
        return f"{s*1e6:.0f}µs"
    if s < 1:
        return f"{s*1e3:.1f}ms"
    return f"{s:.2f}s"


def load(dir_: str):
    recs = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _seconds(r) -> str:
    if "trace_s" in r:
        return f"{r['trace_s']:.0f}+0s"
    return f"{r['lower_s']:.0f}+{r['compile_s']:.0f}s"


def dryrun_table(recs, mesh: str) -> str:
    lines = [
        "| arch | shape | status | lower+compile | FLOPs/dev | bytes/dev | "
        "arg bytes/dev | temp bytes/dev | AG | AR | A2A | CP |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted((r for r in recs if r.get("mesh") == mesh
                     or (r["status"] == "SKIP" and mesh in r["cell"])),
                    key=lambda r: (r["cell"].split("_")[0],
                                   SHAPE_ORDER.index(next(
                                       s for s in SHAPE_ORDER
                                       if s in r["cell"])))):
        arch = r["cell"].split("_" + next(
            s for s in SHAPE_ORDER if s in r["cell"]))[0]
        shape = next(s for s in SHAPE_ORDER if s in r["cell"])
        if r["status"] != "OK":
            lines.append(f"| {arch} | {shape} | {r['status']} | — | — | — |"
                         f" — | — | — | — | — | — |")
            continue
        c = r["collectives"]
        lines.append(
            f"| {arch} | {shape} | OK | {_seconds(r)} "
            f"| {r['flops_per_device']:.3g} | "
            f"{fmt_bytes(r['bytes_per_device'])} | "
            f"{fmt_bytes(r['memory']['argument_bytes'])} | "
            f"{fmt_bytes(r['memory']['temp_bytes'])} | "
            f"{fmt_bytes(c['all-gather'])} | {fmt_bytes(c['all-reduce'])} | "
            f"{fmt_bytes(c['all-to-all'])} | "
            f"{fmt_bytes(c['collective-permute'])} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bound | "
        "MODEL_FLOPS | HLO/MODEL | roofline frac | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted((r for r in recs if r.get("status") == "OK"
                     and r.get("mesh") == "pod16x16"),
                    key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"]))):
        cfg = get_config(r["arch"])
        t = roofline.roofline_terms(r, cfg)
        waste = 1.0 / t["useful_fraction"] if t["useful_fraction"] else 0
        note = bottleneck_note(r, t)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {t['model_flops']:.3g} | "
            f"{waste:.1f}x | {t['roofline_fraction']:.1%} | {note} |")
    return "\n".join(lines)


def bottleneck_note(r, t) -> str:
    d = t["dominant"]
    if d == "memory":
        return ("shrink fusion-boundary traffic (attention scores bf16, "
                "flash-fusion kernel)")
    if d == "collective":
        if r["collectives"]["all-to-all"] > r["collectives"]["all-reduce"]:
            return "overlap a2a with expert compute; widen EP groups"
        return "reduce-scatter grads (ZeRO-1), int8 compression, overlap"
    return "already MXU-bound; raise per-chip batch or quantized matmul"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    recs = load(args.dir)
    ok = sum(r["status"] == "OK" for r in recs)
    skip = sum(r["status"] == "SKIP" for r in recs)
    fail = sum(r["status"] == "FAIL" for r in recs)
    out = []
    out.append(f"records: {ok} OK, {skip} SKIP, {fail} FAIL\n")
    out.append("### Single-pod mesh (data=16, model=16) = 256 ranks\n")
    out.append(dryrun_table(recs, "pod16x16"))
    out.append("\n### Multi-pod mesh (pod=2, data=16, model=16) = 512 ranks\n")
    out.append(dryrun_table(recs, "pod2x16x16"))
    out.append("\n### Roofline (single-pod)\n")
    out.append(roofline_table(recs))
    text = "\n".join(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
