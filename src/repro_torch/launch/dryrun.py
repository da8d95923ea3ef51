"""The dry run: every (arch × shape × mesh) cell's step counted on meta
tensors, the port of the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each cell's jitted step over 512 host
devices and reads XLA's analyses.  Here, per cell:

  1. the step bundle (``launch/steps.py``) of rank 0 of the production
     mesh (pod16x16, or pod2x16x16), built on ``launch.mesh.ShapeMesh``
     under the port's layout: this rank's abstract state and rows, all on
     the meta device, so nothing is allocated at any width;
  2. one call of its ``fn`` on those meta tensors under
     ``launch/op_analysis.py`` (``trace_s``, in place of the reference's
     lower + compile seconds);
  3. the record written to ``results/dryrun_torch/<arch>_<shape>_<mesh>.json``
     with the reference's keys: ``status`` OK / SKIP / FAIL,
     ``flops_per_device``, ``bytes_per_device`` (the eager program's
     traffic, no fusion), ``memory`` (``argument_bytes``,
     ``output_bytes``, ``temp_bytes``: the peak of the storages made
     inside the step, ``generated_code_bytes`` 0) and ``collectives`` (the
     shape-only mesh's per-class operand bytes); beside them the port's
     ``model_axis_collectives`` (those of the exchanges over 'model': the
     tensor-parallel all-reduces and gathers, the counterpart of the
     reference's ``roofline.collective_bytes``), ``layout`` (the
     bundle's, ``steps.layout_name``) and ``experts`` (how that layout
     cuts the expert banks: ``ep``, ``tp`` or None).  A failing cell is recorded with
     its traceback, never skipped.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

OUT_DIR = "results/dryrun_torch"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR, cfg=None, **step_kw) -> dict:
    """One cell's record (also written under ``out_dir``); ``cfg`` runs
    another config under the arch's name (the arch's own by default: a
    caller that cuts its depth says so beside the record)."""
    from ..configs import get_config
    from . import op_analysis, steps
    from .mesh import ShapeMesh, make_production_mesh
    from .specs import SHAPES, shape_applicable

    cfg = cfg or get_config(arch)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch}_{shape_name}_{mesh_name}"
    ok, reason = shape_applicable(cfg, shape_name)
    if not ok:
        rec = {"cell": cell, "status": "SKIP", "reason": reason}
        _write(out_dir, cell, rec)
        return rec

    t0 = time.time()
    try:
        spec = make_production_mesh(multi_pod=multi_pod)
        mesh = ShapeMesh(tuple(spec.shape.values()), spec.axis_names)
        bundle = steps.build_step(cfg, mesh, shape_name, **step_kw)
        t_build = time.time() - t0
        res = op_analysis.analyze(bundle.fn, *bundle.args)
        del res["out"]
        rec = {
            "cell": cell, "status": "OK", "arch": arch, "shape": shape_name,
            "mesh": mesh_name, "n_devices": int(mesh.size),
            "kind": SHAPES[shape_name]["kind"],
            "build_s": round(t_build, 1),
            "trace_s": round(time.time() - t0 - t_build, 1),
            "flops_per_device": res["flops"],
            "bytes_per_device": res["bytes"],
            "memory": {
                "argument_bytes": res["argument_bytes"],
                "output_bytes": res["output_bytes"],
                "temp_bytes": res["peak_bytes"],
                "generated_code_bytes": 0,
            },
            "collectives": res["collectives"],
            "model_axis_collectives": mesh.bytes_over("model"),
            "layout": bundle.describe()["layout"],
            "experts": bundle.describe().get("experts"),
            "ops": res["ops"],
            "kernels": res["kernels"],
            "step_kw": {k: str(v) for k, v in step_kw.items()},
        }
    except Exception as e:  # noqa: BLE001 -- a failed cell is a recorded bug
        rec = {"cell": cell, "status": "FAIL",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:],
               "elapsed_s": round(time.time() - t0, 1)}
    _write(out_dir, cell, rec)
    return rec


def _write(out_dir: str, cell: str, rec: dict):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell + ".json"), "w") as f:
        json.dump(rec, f, indent=2, default=float)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--serve-dtype", default="packed4",
                    choices=("packed4", "bf16"))
    args = ap.parse_args()

    from ..configs import list_configs
    from .specs import SHAPES

    archs = [args.arch] if args.arch else list_configs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    if args.all:
        archs = list_configs()
        shapes = list(SHAPES)
    pods = []
    if not args.multi_pod_only:
        pods.append(False)
    if not args.single_pod_only and (args.multi_pod or args.all
                                     or args.multi_pod_only):
        pods.append(True)

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                kw = ({"remat": args.remat}
                      if SHAPES[shape]["kind"] == "train"
                      else {"serve_dtype": args.serve_dtype})
                rec = run_cell(arch, shape, mp, out_dir=args.out, **kw)
                status = rec["status"]
                extra = (f" flops/dev={rec['flops_per_device']:.3g}"
                         if status == "OK" else
                         rec.get("reason", rec.get("error", ""))[:120])
                print(f"[{status:4s}] {rec['cell']}: {extra}", flush=True)
                failures += status == "FAIL"
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
