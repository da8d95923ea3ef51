"""Serve a frozen paper MLP, or a frozen 4-bit LM, through the port:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mlp-gsc --batch 64 --engine
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mlp-hr --batch 32 \
        --engine --async --multi lenet-300-100,mlp-gsc --verify-launch \
        --max-hot-models 2 --flip-rate 0.05 --streams 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --engine
    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b --layers 1
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b --smoke --device cpu

Initialises the MLP from a seed, freezes it to the packed 4-bit pack,
resolves an ``ExecutionPlan`` (mode, row tile, int8 calibration, bucket ->
schedule bindings) and prints it before anything is timed, then serves
``--batch`` rows ``--iters`` times.  Times on the card come from CUDA
events; on ``--device cpu`` (the plain PyTorch versions) from the host
clock.  ``--engine`` re-serves the batch as single-row requests through
the micro-batcher and checks the result against the batch; ``--engine
--async`` serves them through the threaded ``ServingFrontend`` instead,
``--multi`` co-serves more frozen packs, and the integrity, cold-tier,
fault-injection and stream flags follow the JAX package's launcher.

An LM arch of the dense or moe family (``--arch smollm-360m``,
``grok-1-314b``, ``deepseek-v3-671b`` with its latent attention;
``--smoke`` for the reduced config, ``--layers N`` to cut the depth at the
published widths) runs ``lm_init`` -> ``build_qstate`` -> ``freeze_tree``,
then a prefill of ``--batch`` prompts of ``--prompt-len`` ids and
``--max-new`` greedy tokens through ``lm_apply`` on the frozen tree, and
prints the prefill ms, the decode ms per token and the generated ids.
``--engine`` serves the same prompts through an ``LMProgram`` registered
in a ``ServingFrontend`` (each sequence prefilled, then lockstep decode
rows) and checks its tokens against ``LMProgram.generate`` bit for bit;
``LMProgram`` serves the dense family only, so a moe arch exits there
with its message, as the JAX launcher does.  The other families (ssm,
hybrid, vlm, audio) raise ``NotImplementedError`` (ROADMAP queue 1 item
8).

:func:`serve_lm_config` serves a config its caller hands it, such as one
card's share of an expert-parallel deployment
(``dataclasses.replace(cfg, experts_held=(first, count))``): a share is
set by a caller, not by a flag.  deepseek-v3-671b at its published widths
needs one on an 80 GB card: one MoE layer's 256 experts alone are 45 GB
of fp32 masters before the freeze (``chip_smoke.py`` phase 9 serves 8 of
them, one GPU's share of the DeepSeek-V3 report's EP32 prefill unit).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, list_configs
from ..configs.paper_mlps import MLPS
from ..core import qat
from ..models import lm as LM
from ..models import mlp as M
from ..nn import transformer as T
from ..nn.module import FP32_CTX
from .. import serving
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


def _once_ms(fn, dev: torch.device) -> tuple:
    """(fn(), its ms): CUDA events on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return y, start.elapsed_time(end)
    t0 = time.perf_counter()
    y = fn()
    return y, (time.perf_counter() - t0) * 1e3


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

    if args.engine and args.async_frontend:
        serve_mlp_async(args, cfg, plan, x, y)
    elif args.engine:
        batcher = MicroBatcher(plan)
        ys = batcher.serve(list(x.cpu().numpy()))
        st = batcher.stats
        print(f"engine (ragged, {st['flushes']} flushes, bucket hist "
              f"{st['bucket_hist']}): {st['wall_compute_s'] * 1e3:.3f} ms "
              f"of launches")
        np.testing.assert_allclose(np.concatenate(ys), y.cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)
    return y


def _per_model(opt, flag, names, cast):
    """Split a one-or-comma-separated flag across the registered models
    (order: [--arch] + --multi).  A single value broadcasts."""
    if not opt:
        return {n: None for n in names}
    vals = opt.split(",")
    if len(vals) == 1:
        vals = vals * len(names)
    if len(vals) != len(names):
        raise SystemExit(f"{flag}: expected 1 or {len(names)} "
                         f"comma-separated values, got {len(vals)}")
    try:
        return {n: cast(v) for n, v in zip(names, vals)}
    except ValueError as e:
        raise SystemExit(f"{flag}: {e}")


def _mode_kwargs(args) -> dict:
    return {"mode": "fused" if args.fused else "per_layer"}


def serve_mlp_async(args, cfg, plan, x, y_ref):
    """``--engine --async``: the ragged requests through the threaded
    ServingFrontend; ``--multi`` co-serves additional frozen packs."""
    dev = plan.device
    g = torch.Generator().manual_seed(args.seed + 2)
    models = {cfg.name: (plan, list(x.cpu().numpy()))}
    for arch in (a for a in (args.multi or "").split(",") if a):
        if arch not in MLPS:
            raise SystemExit(f"--multi: unknown paper MLP {arch!r} "
                             f"(have {sorted(MLPS)})")
        if MLPS[arch].name in models:
            raise SystemExit(f"--multi: {arch!r} duplicates --arch or an "
                             "earlier --multi entry")
        mcfg = MLPS[arch]
        mpack = freeze_mlp_pack(mcfg, seed=1, device=dev)
        mx = torch.randn((args.batch, mcfg.d_in), generator=g).to(dev)
        # co-served packs honor the same flags as the primary plan
        mplan = plans.build_plan(
            mpack, act_dtype="int8" if args.int8 else "float32",
            double_buffer=args.double_buffer,
            calib_x=mx if args.int8 else None, device=dev,
            **_mode_kwargs(args))
        models[mcfg.name] = (mplan, list(mx.cpu().numpy()))

    names = list(models)
    tiers = _per_model(args.tier, "--tier", names, serving.resolve_tier)
    delays = _per_model(args.max_delay, "--max-delay", names,
                        lambda v: float(v) / 1e3)    # flag is in ms

    # warm every model's request path untimed (kernel build and the
    # per-pack operand tables are not a serving number)
    for mplan, rows in models.values():
        MicroBatcher(mplan).serve(rows)
    cache = None
    if args.max_hot_models is not None or args.hot_bytes is not None:
        cache = serving.PackCache(max_hot=args.max_hot_models,
                                  hot_bytes=args.hot_bytes, device=dev)
        print(f"pack cache: hot budget "
              f"{args.max_hot_models if args.max_hot_models else '∞'} "
              f"models / "
              f"{args.hot_bytes if args.hot_bytes else '∞'} bytes — "
              "models registered compressed, decoded on first traffic")
    integrity = True if args.verify_launch else None
    frontend = serving.ServingFrontend(
        cache=cache, streams=args.streams,
        scrub_interval_s=(None if args.scrub_interval is None
                          else args.scrub_interval / 1e3))
    if args.verify_launch or args.scrub_interval is not None:
        print("integrity: "
              + ("per-launch checksum verification + output screen"
                 if args.verify_launch else "no launch guard")
              + (f", scrubber every {args.scrub_interval:.1f} ms"
                 if args.scrub_interval is not None else ""))
    if args.streams > 1:
        print(f"streams: {args.streams} stream workers, each on a CUDA "
              f"stream of its own on {dev}" if dev.type == "cuda" else
              f"streams: {args.streams} stream workers (threads on {dev})")
    for name, (mplan, _) in models.items():
        wrap = None
        if args.inject_fault > 0 or args.flip_rate > 0:
            def wrap(p):
                return serving.FaultInjector(p, rate=args.inject_fault,
                                             flip_rate=args.flip_rate)
        if cache is not None:
            # compressed-tier registration: the injector (if any) wraps
            # the cache handle and the guard wraps the injector, so
            # injected corruption is detected by the guard and recovered
            # from the verified cold tier.
            frontend.register_pack(
                name, mplan.pack,
                plan_kwargs={
                    **_mode_kwargs(args),
                    "act_dtype": "int8" if args.int8 else "float32",
                    "double_buffer": args.double_buffer,
                    "calib": ({"act_scales": list(mplan.act_scales)}
                              if mplan.act_scales is not None else None),
                },
                wrap=wrap, integrity=integrity,
                tier=tiers[name], max_delay=delays[name],
                max_queued_rows=args.max_queued)
            continue
        target = mplan if wrap is None else wrap(mplan)
        frontend.register(name, target, tier=tiers[name],
                          max_delay=delays[name],
                          max_queued_rows=args.max_queued,
                          integrity=integrity)
        if tiers[name] is not None or delays[name] is not None:
            b = frontend.registry.batcher(name)
            print(f"model [{name}]: tier {b.tier.name}, max_delay "
                  f"{b.max_delay * 1e3:.2f} ms"
                  + (f", queue bound {args.max_queued} rows"
                     if args.max_queued else ""))
    t0 = time.perf_counter()
    served, rejected = [], []
    with frontend:
        futs = [(name, i, frontend.submit(name, row))
                for name, (_, rows) in models.items()
                for i, row in enumerate(rows)]
        for name, i, f in futs:
            try:
                served.append((name, i, f.result(60.0)))
            except serving.Rejected as rej:
                rejected.append((name, i, rej.reason))
            except serving.InjectedFault as exc:
                rejected.append((name, i, f"fault: {exc}"))
            except serving.IntegrityError as exc:
                rejected.append((name, i, f"corrupted: {exc}"))
    dt = time.perf_counter() - t0
    n = len(served)
    for name in models:
        lats = [s.latency * 1e3 for m, _, s in served if m == name]
        st = frontend.stats["by_model"][name]
        line = (f"async frontend [{name}]: {st['requests']} requests in "
                f"{st['launches']} launches")
        if lats:
            line += (f", latency mean {np.mean(lats):.2f} ms / p95 "
                     f"{np.percentile(lats, 95):.2f} ms")
        if st["rejected"]:
            line += f", {st['rejected']} rejected"
        if st["quarantined"]:
            line += ", QUARANTINED"
        print(line)
    clock = "host clock" if dev.type == "cuda" else "host clock, CPU"
    print(f"async frontend: {n} served / {len(rejected)} rejected across "
          f"{len(models)} model(s) in {dt * 1e3:.2f} ms total ({clock}, "
          f"{frontend.stats['launches']} launches)")
    if args.streams > 1:
        for i, ss in enumerate(frontend.stats["streams"]):
            print(f"stream {i}: {ss['launches']} launches, "
                  f"{ss['busy_s'] * 1e3:.1f} ms busy"
                  + (", QUARANTINED" if ss["quarantined"] else ""))
    if args.inject_fault > 0 or rejected:
        fs = frontend.stats
        print(f"degradation: {fs['launch_failures']} launch failures, "
              f"{fs['retries']} retries, {fs['fallbacks']} chain "
              f"fallbacks, quarantined {fs['quarantined'] or 'none'}")
    if args.flip_rate > 0 or args.verify_launch \
            or args.scrub_interval is not None:
        it = frontend.stats["integrity"]
        sc = frontend.stats["scrub"]
        rec = (f", recovery p95 "
               f"{np.percentile(it['recovery_s'], 95) * 1e3:.2f} ms"
               if it["recovery_s"] else "")
        print(f"integrity: {it['detected']} corruptions detected, "
              f"{it['recovered']} recovered from cold tier{rec}; "
              f"scrubber {sc['cycles']} cycles / {sc['checked']} checks "
              f"({sc['deferred']} busy deferrals)")
    if cache is not None:
        d = cache.describe()
        print(f"pack cache: {d['resolves']} resolves / {d['hits']} hits "
              f"/ {d['evictions']} evictions; resident "
              f"{d['resident_bytes']} B (high water "
              f"{d['resident_high_water']} B), cold tier "
              f"{d['cold_bytes']} B for {d['models']} models "
              f"({d['fp32_bytes'] / max(d['cold_bytes'], 1):.1f}x vs "
              "fp32)")
    # validate whatever completed for the primary model row by row (under
    # --inject-fault/--max-queued some rows may be typed rejections).
    done = {i: s for m, i, s in served if m == cfg.name}
    if done:
        got = np.concatenate([done[i].y for i in sorted(done)])
        ref = y_ref.cpu().numpy()[sorted(done)]
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def lm_archs() -> list:
    """The registered archs the port's LM path serves: the dense and moe
    families, MLA included."""
    served = []
    for name in list_configs():
        try:
            T.check_supported(get_config(name))
        except NotImplementedError:
            continue
        served.append(name)
    return served


def lm_config(args):
    """The LM config the flags name: ``--arch``, ``--smoke``, the depth
    cut by ``--layers``."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    T.check_supported(cfg)
    if args.layers is not None:
        if args.layers > cfg.n_layers:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers; the flag only cuts")
        print(f"{cfg.name}: depth cut to {args.layers} layers (--layers; "
              f"the config has {cfg.n_layers})")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


@torch.no_grad()
def serve_lm_config(cfg, args) -> np.ndarray:
    """The direct LM path on ``cfg``: init, freeze, then prefill and greedy
    decode through ``lm_apply`` on the frozen tree (dense decode +
    ``torch.matmul``, no FantastIC4 kernel; a MoE layer's experts through
    ``torch.bmm``).  ``args`` gives the traffic (``--batch``,
    ``--prompt-len``, ``--max-new``), ``--seed``, ``--device`` and
    ``--engine``.  Returns the generated ids (batch, max_new)."""
    dev = resolve_device(args.device)
    params = T.lm_init(cfg, seed=args.seed, device=dev)
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    del params
    b, s, new = args.batch, args.prompt_len, args.max_new
    prompt = np.random.default_rng(args.seed).integers(0, cfg.vocab, (b, s))
    tokens = torch.from_numpy(prompt).to(dev)
    cache = T.init_cache(cfg, b, s + new, dtype=torch.float32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    (tok, cache), t_prefill = _once_ms(lambda: LM.greedy_step(
        frozen, 0, tokens, FP32_CTX, cfg, positions=pos, cache=cache), dev)

    def decode():
        nonlocal tok, cache
        out = [tok]
        for t in range(new - 1):
            p_t = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
            tok, cache = LM.greedy_step(frozen, 0, tok, FP32_CTX, cfg,
                                        positions=p_t, cache=cache)
            out.append(tok)
        return torch.cat(out, dim=1)

    gen, t_dec = _once_ms(decode, dev)
    gen = gen.cpu().numpy().astype(np.int64)
    clock = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    experts = (f", {cfg.n_experts} experts top-{cfg.top_k}"
               if cfg.family == "moe" else "")
    if cfg.experts_held is not None:
        first, count = cfg.experts_held
        experts += f" (experts {first}-{first + count - 1} held)"
    if cfg.mla is not None:
        experts += f", MLA (kv_lora {cfg.mla.kv_lora_rank})"
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}{experts}, vocab {cfg.vocab}, frozen to 4 bits on "
          f"{dev}")
    print(f"prefill: {t_prefill:.3f} ms  decode: "
          f"{t_dec / (new - 1) if new > 1 else 0.0:.3f} ms/token "
          f"({b} sequences, {clock})")
    print("generated ids[0]:", gen[0].tolist())
    if args.engine:
        serve_lm_engine(args, cfg, frozen, prompt, gen)
    return gen


def serve_lm_engine(args, cfg, frozen, prompt: np.ndarray,
                    gen_ref: np.ndarray) -> None:
    """``--engine`` on an LM arch: the same prompts through an
    ``LMProgram`` registered in a ``ServingFrontend`` (one stream: the
    program's sequence table is the dispatch thread's), every sequence
    prefilled, then lockstep decode steps as wire rows (each decode flush
    reaches the FFN as an ``m = n_seqs`` bucket)."""
    b, s, new = args.batch, args.prompt_len, args.max_new
    max_bucket = 1 << (max(s, b, 8) - 1).bit_length()
    dev = resolve_device(args.device)
    try:
        prog = serving.LMProgram(frozen, cfg, max_prompt=s, max_new=new,
                                 max_bucket=max_bucket, device=dev)
    except ValueError as e:
        raise SystemExit(f"--engine: {e}")
    prog.warmup()
    direct = prog.generate(prompt, new)

    sids = list(range(1000, 1000 + b))
    toks = []
    t0 = time.perf_counter()
    frontend = serving.ServingFrontend()
    with frontend:
        frontend.register(cfg.name, prog, max_delay=1e-3)
        futs = [frontend.submit(cfg.name,
                                prog.encode_prefill(sid, prompt[i])[None])
                for i, sid in enumerate(sids)]
        toks.append([int(f.result(60.0).y[0, 0]) for f in futs])
        t1 = time.perf_counter()
        for _ in range(new - 1):
            futs = [frontend.submit(cfg.name, prog.encode_decode(sid)[None])
                    for sid in sids]
            toks.append([int(f.result(60.0).y[0, 0]) for f in futs])
    t2 = time.perf_counter()
    for sid in sids:
        prog.release(sid)
    engine = np.asarray(toks, np.int64).T
    if not np.array_equal(engine, direct):
        raise AssertionError(
            "engine decode diverged from LMProgram.generate")
    st = frontend.stats
    match = np.array_equal(engine, gen_ref)
    print(f"engine (LM program): {b} seqs x {new} tokens in "
          f"{st['launches']} launches, {(t2 - t0) * 1e3:.1f} ms total, "
          f"{(t2 - t1) * 1e3 / max(new - 1, 1):.3f} ms per decode step "
          f"(host clock); decode bit-identical to the direct generate loop"
          + ("" if match else
             " (the lm_apply tokens differ: accumulation order)"))
    print("program schedules:", prog.describe(n_seqs=b)["ffn_schedules"])


def check_flags(args) -> None:
    """The JAX launcher's checks on the flags, with its messages."""
    if args.streams < 1:
        raise SystemExit(f"--streams must be >= 1, got {args.streams}")
    if args.streams > 1 and not args.async_frontend:
        raise SystemExit("--streams applies to the async frontend: add "
                         "--engine --async")
    if args.shard:
        raise SystemExit("--shard is not ported yet (ROADMAP queue 1: "
                         "scale-out)")
    if (args.tier or args.max_delay or args.max_queued is not None
            or args.inject_fault) and not args.async_frontend:
        raise SystemExit("--tier/--max-delay/--max-queued/--inject-fault "
                         "apply to the async frontend: add --engine --async")
    if (args.max_hot_models is not None or args.hot_bytes is not None):
        if not args.async_frontend:
            raise SystemExit("--max-hot-models/--hot-bytes apply to the "
                             "async frontend: add --engine --async")
    if (args.flip_rate > 0 or args.scrub_interval is not None
            or args.verify_launch) and not args.async_frontend:
        raise SystemExit("--flip-rate/--scrub-interval/--verify-launch "
                         "apply to the async frontend: add --engine "
                         "--async")
    if args.flip_rate > 0 and not args.verify_launch:
        raise SystemExit("--flip-rate corrupts live weights; add "
                         "--verify-launch so the corruption is caught "
                         "(and, with the pack cache flags, recovered)")
    if args.layers is not None and args.arch in MLPS:
        raise SystemExit("--layers applies to LM archs")
    if args.layers is not None and args.layers < 1:
        raise SystemExit(f"--layers must be >= 1, got {args.layers}")
    if args.multi and not (args.engine and args.async_frontend):
        raise SystemExit("--multi requires --engine --async")
    if args.async_frontend and not args.engine:
        raise SystemExit("--async requires --engine")


def parse_args(argv=None):
    """The launcher's flags, checked (:func:`check_flags`)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mlp-gsc",
                    choices=sorted(MLPS) + list_configs(),
                    help="a paper MLP or an LM arch; the port serves "
                    f"{', '.join(lm_archs())} (the others raise "
                    "NotImplementedError)")
    ap.add_argument("--smoke", action="store_true",
                    help="LM archs: the reduced same-family config")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="LM archs: serve the config cut to N layers "
                    "(the widths stay)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="LM archs: prompt ids per sequence")
    ap.add_argument("--max-new", type=int, default=16,
                    help="LM archs: greedy tokens per sequence")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True, help="megakernel plan (--no-fused: chain)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 activations between layers (paper §VI-C)")
    ap.add_argument("--double-buffer", action="store_true")
    ap.add_argument("--engine", action="store_true",
                    help="also serve the batch as ragged requests")
    ap.add_argument("--async", dest="async_frontend", action="store_true",
                    help="with --engine: drive the ragged requests "
                         "through the threaded ServingFrontend (real "
                         "clock, futures) instead of the inline flush")
    ap.add_argument("--multi", default=None, metavar="ARCH[,ARCH...]",
                    help="with --engine --async: co-serve additional "
                         "frozen paper-MLP packs from the same frontend")
    ap.add_argument("--tier", default=None, metavar="TIER[,TIER...]",
                    help="with --engine --async: per-model SLO tier "
                         f"({'|'.join(sorted(serving.TIERS))}); one value "
                         "broadcasts, a comma-separated list aligns to "
                         "[--arch] + --multi")
    ap.add_argument("--max-delay", default=None, metavar="MS[,MS...]",
                    help="with --engine --async: per-model coalescing "
                         "budget in ms (same alignment as --tier)")
    ap.add_argument("--max-queued", type=int, default=None, metavar="ROWS",
                    help="with --engine --async: bound every model's "
                         "queue; overflow is a typed serving.Rejected")
    ap.add_argument("--inject-fault", type=float, default=0.0,
                    metavar="RATE",
                    help="with --engine --async: wrap every plan in a "
                         "FaultInjector failing launches at RATE")
    ap.add_argument("--flip-rate", type=float, default=0.0, metavar="RATE",
                    help="with --engine --async: FaultInjector bit flips "
                         "of live plan operands at RATE per launch; "
                         "requires --verify-launch")
    ap.add_argument("--verify-launch", action="store_true",
                    help="with --engine --async: wrap every model in a "
                         "GuardedPlan (per-launch operand checksums + "
                         "NaN/Inf output screen)")
    ap.add_argument("--scrub-interval", type=float, default=None,
                    metavar="MS",
                    help="with --engine --async: background integrity "
                         "scrubber cadence in ms")
    ap.add_argument("--max-hot-models", type=int, default=None, metavar="N",
                    help="with --engine --async: register models "
                         "compressed through a PackCache and keep at most "
                         "N resolved plans resident (LRU)")
    ap.add_argument("--hot-bytes", type=int, default=None, metavar="BYTES",
                    help="with --engine --async: byte budget for the pack "
                         "cache's resident decoded plans")
    ap.add_argument("--streams", type=int, default=1, metavar="N",
                    help="with --engine --async: N stream workers, each "
                         "on a CUDA stream of its own")
    ap.add_argument("--shard", action="store_true",
                    help="column-shard the plan over several devices "
                         "(not ported yet)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    check_flags(args)
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.arch in MLPS:
        return serve_mlp(args)
    return serve_lm_config(lm_config(args), args)


if __name__ == "__main__":
    main()
