#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card's name and power limit, build the CUDA kernels from
   ``src/repro_torch/csrc`` and turn TF32 off.
2. Hold every kernel against its plain PyTorch version on the card: the
   MLP-GSC stack and a small odd-K stack, batches 1/8/64/256, fp32 and
   int8, through kernel 1 (the per-layer chain) and every fused schedule.
   Gates: fp32 ``atol=1e-3, rtol=1e-4``; int8 relative max-abs error
   ``< 5e-3``; and the port's own int8 outputs bitwise equal across the
   chain, batch_tiled, db, ws and stream.
3. The main path: a seeded MLP-GSC frozen with ``freeze_mlp`` and served
   through ``ExecutionPlan`` + ``MicroBatcher`` as ragged requests of 1-5
   rows (auto fp32 and int8 plans, a per-layer plan, a double-buffered plan
   and a plan whose shared-memory budget leaves only the stream schedule).
   Launch counters are zeroed just before and read just after; every
   kernel must have launched.  Each result must equal the same rows served
   alone, and the fp32 results must match the plain oracle.
4. Time each kernel, its plain version and a library yardstick
   (``torch.matmul`` on pre-decoded fp32 weights plus the epilogue) at the
   main-path shapes, with CUDA events around back-to-back calls (``ms``:
   the wrapper's host work included when it is the slower side), and the
   kernel's own device time from a torch.profiler trace (``device_ms``);
   print one ``kernels`` JSON line and
   one ``path`` JSON line, then the ``nvidia-smi`` line and the final
   ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FP32_ATOL, FP32_RTOL = 1e-3, 1e-4          # tests/test_serving_parity.py:82
INT8_REL = 5e-3                            # tests/test_serving_parity.py:134
BATCHES = (1, 8, 64, 256)
PEAK_FP32_FLOPS = 67e12                    # H100 SXM, CUDA cores, dense
PEAK_BYTES = 3.35e12                       # H100 SXM HBM3
GSC_DIMS = (512, 512, 512, 256, 256, 128, 128, 12)
ODD_DIMS = (33, 40, 24, 10)
TPU_KERNELS = "src/repro/kernels/"
SOURCE = "src/repro_torch/csrc/fantastic4.cu"
# the CUDA function each schedule launches (csrc/fantastic4.cu)
SYMBOLS = {"chain": "matmul_kernel", "batch_tiled": "tiled_kernel",
           "db": "tiled_kernel", "ws": "ws_kernel", "stream": "stream_kernel"}
KERNELS = {   # name -> (schedule, TPU kernel it replaces)
    "fantastic4_matmul": ("chain", TPU_KERNELS + "fantastic4_matmul.py:91"),
    "fantastic4_fused_mlp": ("batch_tiled",
                             TPU_KERNELS + "fantastic4_fused_mlp.py:256"),
    "fantastic4_fused_mlp_db": ("db",
                                TPU_KERNELS + "fantastic4_fused_mlp.py:256"),
    "fantastic4_fused_mlp_ws": ("ws",
                                TPU_KERNELS + "fantastic4_fused_mlp.py:447"),
    "fantastic4_fused_mlp_stream": (
        "stream", TPU_KERNELS + "fantastic4_fused_mlp.py:589"),
}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def rand_pack(dims, seed, device):
    """Frozen pack at BN-realistic magnitudes (activations O(1))."""
    import numpy as np
    import torch
    from repro_torch.core import bitplanes

    rng = np.random.default_rng(seed)
    layers = []
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        codes = rng.integers(0, 16, size=(k + (k % 2), n)).astype(np.uint8)
        if k % 2:
            codes[-1] = 0
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
        layers.append({
            "packed": bitplanes.pack_codes_rows(
                torch.from_numpy(codes).to(device)).contiguous(),
            "omega": t(rng.normal(size=4) / np.sqrt(k)),
            "alpha1": t(rng.normal(size=n) * 0.5),
            "bias": t(rng.normal(size=n) * 0.1),
            "alpha2": t(rng.uniform(0.5, 1.5)),
            "shape": (k, n),
            "activation": "relu" if i < len(dims) - 2 else None,
        })
    return {"layers": layers, "act_bits": None}


class Schedules:
    """Every kernel and its plain version over one pack and act dtype."""

    def __init__(self, pack, act_dtype, act_scales):
        from repro_torch.kernels import ops

        self.layers = pack["layers"]
        self.act_dtype = act_dtype
        self.act_scales = act_scales if act_dtype == "int8" else None
        self.shapes = tuple(tuple(l["shape"]) for l in self.layers)
        self.acts = tuple(l["activation"] for l in self.layers)
        self.alpha1s, self.scales = ops._epilogue_operands(
            self.layers, act_dtype, self.act_scales)
        self.stacked = ops._ws_stacked_operands(self.layers, act_dtype,
                                                self.act_scales)

    def kernel(self, name, x):
        from repro_torch.kernels import ops

        sched = KERNELS[name][0]
        if sched == "chain":
            if self.act_dtype == "int8":
                return ops.fantastic4_mlp_chain_int8(x, self.layers,
                                                     self.act_scales)
            return ops.fantastic4_mlp_chain(x, self.layers)
        return ops.fantastic4_mlp_fused(
            x, self.layers, schedule=sched, act_dtype=self.act_dtype,
            act_scales=self.act_scales,
            block_m=8 if sched == "stream" else None)

    def plain(self, name, x):
        from repro_torch.kernels import fantastic4_fused_mlp as ffm
        from repro_torch.kernels import ops

        sched = KERNELS[name][0]
        kw = dict(shapes=self.shapes, act_dtype=self.act_dtype)
        if sched == "chain":
            if self.act_dtype == "int8":
                return ops.fantastic4_mlp_chain_int8(
                    x, self.layers, self.act_scales, use_kernel=False)
            return ops.fantastic4_mlp_chain(x, self.layers, use_kernel=False)
        if sched in ("batch_tiled", "db"):
            return ffm.fantastic4_fused_mlp_plain(
                x, tuple(l["packed"] for l in self.layers),
                tuple(l["omega"] for l in self.layers), self.alpha1s,
                tuple(l["bias"] for l in self.layers), self.scales,
                activations=self.acts, **kw)
        if sched == "ws":
            return ffm.fantastic4_fused_mlp_ws_plain(x, *self.stacked, **kw)
        return ffm.fantastic4_fused_mlp_stream_plain(x, *self.stacked, **kw)


def check_kernels(dev):
    """Phase 2: gates per kernel; returns {name: max abs err (fp32)}."""
    import numpy as np
    import torch
    from repro_torch.serving.plans import calibrate_act_scales

    max_err = {name: 0.0 for name in KERNELS}
    max_rel8 = {name: 0.0 for name in KERNELS}
    for dims, seed in ((GSC_DIMS, 11), (ODD_DIMS, 12)):
        pack = rand_pack(dims, seed, dev)
        for batch in BATCHES:
            x = torch.from_numpy(np.random.default_rng(seed + batch).normal(
                size=(batch, dims[0])).astype(np.float32)).to(dev)
            scales = calibrate_act_scales(pack, x)["act_scales"]
            for act_dtype in ("float32", "int8"):
                s = Schedules(pack, act_dtype, scales)
                outs = {}
                for name in KERNELS:
                    got = s.kernel(name, x)
                    want = s.plain(name, x)
                    torch.cuda.synchronize(dev)
                    if got.shape != (batch, dims[-1]) or \
                            not torch.isfinite(got).all():
                        raise AssertionError(f"{name} {dims[0]}->..."
                                             f"{dims[-1]} b={batch}: shape "
                                             f"{tuple(got.shape)} or non-finite")
                    err = float((got - want).abs().max())
                    tag = f"{name} {act_dtype} stack {dims} batch {batch}"
                    if act_dtype == "float32":
                        tol = FP32_ATOL + FP32_RTOL * want.abs()
                        if not bool(((got - want).abs() <= tol).all()):
                            raise AssertionError(f"{tag}: max abs err {err}")
                        max_err[name] = max(max_err[name], err)
                    else:
                        rel = err / max(float(want.abs().max()), 1e-6)
                        if rel >= INT8_REL:
                            raise AssertionError(f"{tag}: rel err {rel}")
                        max_rel8[name] = max(max_rel8[name], rel)
                    outs[name] = got
                if act_dtype == "int8":
                    ref = outs["fantastic4_matmul"]
                    for name, got in outs.items():
                        if not torch.equal(got, ref):
                            raise AssertionError(
                                f"int8 {name} != chain bitwise ({dims}, "
                                f"batch {batch})")
    print("phase 2: every kernel within its gate; int8 bitwise equal "
          "across chain/batch_tiled/db/ws/stream")
    return max_err, max_rel8


def main_path(dev):
    """Phase 3: serve ragged requests through plans + micro-batchers."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_mlps import MLPS
    from repro_torch.core import qat
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
    from repro_torch.kernels import fantastic4_matmul as fm
    from repro_torch.models import mlp as M
    from repro_torch.serving.batcher import MicroBatcher
    from repro_torch.serving.plans import ExecutionPlan

    cfg = MLPS["mlp-gsc"]
    params, bn = M.mlp_init(cfg, seed=0, device=dev)
    pack = M.freeze_mlp(params, qat.build_qstate(params), bn, lam=cfg.lam)
    rng = np.random.default_rng(7)
    calib_x = rng.normal(size=(64, cfg.d_in)).astype(np.float32)
    reqs = [rng.normal(size=(int(rng.integers(1, 6)), cfg.d_in))
            .astype(np.float32) for _ in range(96)]
    plans = {
        "auto": ExecutionPlan(pack, device=dev),
        "auto_int8": ExecutionPlan(pack, act_dtype="int8", calib_x=calib_x,
                                   device=dev),
        "per_layer": ExecutionPlan(pack, mode="per_layer", device=dev),
        "db": ExecutionPlan(pack, double_buffer=True, device=dev),
        "stream": ExecutionPlan(pack, device=dev,
                                smem_budget_bytes=ffm.CORE_SMEM_BYTES + 1024),
    }
    for p in plans.values():
        p.warmup()
    torch.cuda.synchronize(dev)

    fm.LAUNCHES = 0
    ffm.reset_launches()
    served = {}
    for key, plan in plans.items():
        batcher = MicroBatcher(plan)
        ys = batcher.serve(reqs)
        # a few lone requests: flushed alone they land in the small buckets
        for r in reqs[:4]:
            rid = batcher.submit(r)
            batcher.flush()
            ys.append(batcher.result(rid).y)
        served[key] = (ys, dict(batcher.stats["bucket_hist"]))
    torch.cuda.synchronize(dev)
    launches = {"fantastic4_matmul": fm.LAUNCHES}
    for name, (sched, _) in KERNELS.items():
        if sched != "chain":
            launches[name] = ffm.LAUNCHES[sched]
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched {name}: "
                                 f"{launches}")

    oracle = ExecutionPlan(pack, mode="oracle", device=dev)
    alone_reqs = reqs + reqs[:4]
    for key, (ys, _) in served.items():
        plan = plans[key]
        for r, y in zip(alone_reqs, ys):
            alone = plan.run(torch.from_numpy(r).to(dev)).cpu().numpy()
            if y.shape != (r.shape[0], cfg.features[-1]) or \
                    not np.isfinite(y).all():
                raise AssertionError(f"{key}: bad result {y.shape}")
            if not np.array_equal(y, alone):
                raise AssertionError(f"{key}: batched result != served "
                                     "alone")
            if plan.act_dtype == "float32":
                want = oracle.run(torch.from_numpy(r).to(dev)).cpu().numpy()
                np.testing.assert_allclose(y, want, atol=FP32_ATOL,
                                           rtol=FP32_RTOL)
    path = {
        "requests_per_plan": len(alone_reqs),
        "rows_per_plan": int(sum(r.shape[0] for r in alone_reqs)),
        "plans": {k: {"bucket_schedules": {
            str(b): s for b, s in
            p.describe()["bucket_schedules"].items()},
            "bucket_hist": {str(b): n for b, n in served[k][1].items()}}
            for k, p in plans.items()},
        "launches": launches,
    }
    print(f"phase 3: {len(plans)} plans served {len(alone_reqs)} ragged "
          f"requests each; launches {launches}")
    return launches, path


def _time_ms(fn, dev, iters):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def _device_ms(fn, dev, iters, symbol):
    """Device time per call of the CUDA function ``symbol``, summed from a
    torch.profiler trace (None when the trace shows no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(dev)
    total_us = 0.0
    for evt in prof.key_averages():
        if symbol in evt.key:
            total_us += (getattr(evt, "device_time_total", 0.0)
                         or getattr(evt, "cuda_time_total", 0.0))
    return total_us / 1e3 / iters if total_us > 0 else None


def bound(batch, dims):
    """Least time for the stack's function: the larger of its FLOPs over
    the fp32 CUDA-core peak and its bytes (codes, epilogue vectors, x, y,
    each once) over HBM bandwidth."""
    pairs = list(zip(dims[:-1], dims[1:]))
    flops = 2 * batch * sum(k * n for k, n in pairs)
    nbytes = (sum((k + k % 2) // 2 * n for k, n in pairs)        # codes
              + sum(4 * 2 * n + 4 * 5 for _, n in pairs)        # α₁, b, ω, α₂
              + 4 * batch * (dims[0] + dims[-1]))                # x, y
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def timings(dev):
    """Phase 4: kernel, plain and library times at MLP-GSC batches."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref

    pack = rand_pack(GSC_DIMS, 21, dev)
    s = Schedules(pack, "float32", None)
    layers = pack["layers"]
    decoded = [ref.decode_weights(l["packed"], l["omega"]) for l in layers]

    def library(x):
        for l, w in zip(layers, decoded):
            x = torch.matmul(x, w) * l["alpha1"] + l["bias"]
            if l["activation"] == "relu":
                x = torch.relu(x)
            x = x * l["alpha2"]
        return x

    out = {name: {} for name in KERNELS}
    for batch in BATCHES:
        x = torch.from_numpy(np.random.default_rng(batch).normal(
            size=(batch, GSC_DIMS[0])).astype(np.float32)).to(dev)
        iters = 50 if batch <= 64 else 20
        lib_ms = _time_ms(lambda: library(x), dev, iters)
        b_ms, b_by = bound(batch, GSC_DIMS)
        for name, (sched, _) in KERNELS.items():
            out[name][batch] = {
                "ms": _time_ms(lambda: s.kernel(name, x), dev, iters),
                "device_ms": _device_ms(lambda: s.kernel(name, x), dev, 10,
                                        SYMBOLS[sched]),
                "plain_ms": _time_ms(lambda: s.plain(name, x), dev, iters),
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2

    gpu = smi_line()
    print(f"gpu: {gpu}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.load()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({build.library_path().name})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

    max_err, max_rel8 = check_kernels(dev)
    launches, path = main_path(dev)
    times = timings(dev)

    report = []
    for name, (sched, replaces) in KERNELS.items():
        per = times[name]
        head = per[64]
        report.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "schedule": sched,
            "launches": launches[name], "max_abs_err": max_err[name],
            "int8_max_rel_err": max_rel8[name],
            "ms": head["ms"], "kernel_ms": head["ms"],
            "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "at": "mlp-gsc batch 64 fp32",
            "by_batch": {str(b): v for b, v in per.items()}})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"path": path}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
