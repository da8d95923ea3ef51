"""Serve a frozen paper MLP through the port:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mlp-gsc --batch 64 --engine

Initialises the MLP from a seed, freezes it to the packed 4-bit pack,
resolves an ``ExecutionPlan`` (mode, row tile, int8 calibration, bucket ->
schedule bindings) and prints it before anything is timed, then serves
``--batch`` rows ``--iters`` times.  Times on the card come from CUDA
events; on ``--device cpu`` (the plain PyTorch versions) from the host
clock.  ``--engine`` re-serves the batch as single-row requests through
the micro-batcher and checks the result against the batch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs.paper_mlps import MLPS
from ..core import qat
from ..models import mlp as M
from ..serving import plans
from ..serving.batcher import MicroBatcher


def freeze_mlp_pack(cfg, *, seed: int = 0, device=None) -> dict:
    """Init + freeze one paper MLP to its packed-int4 serving pack."""
    params, bn = M.mlp_init(cfg, seed=seed, device=device)
    pack = M.freeze_mlp(params, qat.build_qstate(params), bn, lam=cfg.lam)
    n_w = sum(k * n for k, n in (l["shape"] for l in pack["layers"]))
    n_b = sum(l["packed"].numel() for l in pack["layers"])
    print(f"{cfg.name}: {len(pack['layers'])} layers, {n_w} weights frozen "
          f"to {n_b} packed bytes")
    return pack


def _timed(fn, iters: int, dev: torch.device) -> tuple:
    y = fn()                                   # warm-up: builds the kernels
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            y = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return y, start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        y = fn()
    return y, (time.perf_counter() - t0) * 1e3 / iters


def serve_mlp(args) -> torch.Tensor:
    dev = resolve_device(args.device)
    cfg = MLPS[args.arch]
    pack = freeze_mlp_pack(cfg, seed=args.seed, device=dev)
    g = torch.Generator().manual_seed(args.seed + 1)
    x = torch.randn((args.batch, cfg.d_in), generator=g).to(dev)
    plan = plans.build_plan(
        pack, mode="fused" if args.fused else "per_layer",
        act_dtype="int8" if args.int8 else "float32",
        double_buffer=args.double_buffer,
        calib_x=x if args.int8 else None, device=dev)

    desc = plan.describe()
    print(f"plan: requested {desc['requested_mode']}"
          f"{' +double-buffer' if args.double_buffer else ''}"
          f"{' +int8' if args.int8 else ''} -> resolved "
          f"{desc['resolved_mode']} on {desc['device']} (batch {args.batch}: "
          f"{plan.mode_label(args.batch)}; block_m {desc['block_m']} "
          f"[{desc['block_source']}], buckets {desc['bucket_sizes']})")
    print("plan: bucket -> schedule " + ", ".join(
        f"{b}:{desc['bucket_schedules'][b]}[bm={desc['bucket_block_m'][b]}]"
        for b in desc["bucket_sizes"]))
    for note in desc["notes"]:
        print(f"note: {note}")

    y, ms = _timed(lambda: plan.run(x), max(args.iters, 1), dev)
    clock = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    print(f"{plan.mode_label(args.batch)}: {ms:.4f} ms/batch ({clock}, "
          f"batch {args.batch})")
    print("logits[0]:", [round(float(v), 3) for v in y[0].cpu()])

    if args.engine:
        batcher = MicroBatcher(plan)
        ys = batcher.serve(list(x.cpu().numpy()))
        st = batcher.stats
        print(f"engine (ragged, {st['flushes']} flushes, bucket hist "
              f"{st['bucket_hist']}): {st['wall_compute_s'] * 1e3:.3f} ms "
              f"of launches")
        np.testing.assert_allclose(np.concatenate(ys), y.cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)
    return y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mlp-gsc", choices=sorted(MLPS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True, help="megakernel plan (--no-fused: chain)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 activations between layers (paper §VI-C)")
    ap.add_argument("--double-buffer", action="store_true")
    ap.add_argument("--engine", action="store_true",
                    help="also serve the batch as ragged requests")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return serve_mlp(ap.parse_args(argv))


if __name__ == "__main__":
    main()
