"""EC4T-train one of the paper's MLPs (then freeze and serve it), or a
transformer LM (the JAX package's ``launch/train.py``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mlp-gsc --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --arch mlp-hr --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \
        --device cpu --steps 25 --ckpt-dir /tmp/ckpt --export /tmp/export
    PYTHONPATH=src python -m repro_torch.launch.train --arch grok-1-314b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b --smoke \
        --device cpu --steps 3 --remat full
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --smoke \
        --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b --smoke \
        --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base --smoke \
        --device cpu --steps 3

**MLP branch** (``--arch mlp-gsc``, ``mlp-hr``, ``lenet-300-100``): the
MLP trainer of the JAX package (``benchmarks/common.py`` ``train_mlp``,
driven as ``examples/train_mlp_gsc.py`` drives it): batch 128 of the
synthetic classification task, λ ramped from 0 over ``--lam-ramp`` steps,
Adam with the global-norm clip.  At the end the CLI prints held-out
accuracy, sparsity and entropy and ms per step, freezes the net
(``freeze_mlp``), serves a held-out batch through ``mlp_serve`` and checks
it against the eval-mode forward (``atol=rtol=1e-2``, as
``examples/train_mlp_gsc.py:54``).

**LM branch** (every registered LM arch: the dense and moe families,
with GQA or MLA, the ssm (mamba2-1.3b), hybrid (hymba-1.5b), vlm
(qwen2-vl-2b) and audio (whisper-base) families, ``--smoke`` for the
reduced config; a MoE arch adds ``aux_loss_coef`` times its load-balance
loss, as the reference does): config → ``lm_init`` (``whisper_init`` for
audio) →
``ec4t.init_train_state`` → the EC4T step
(``launch/steps.py`` loss in bf16, λ ramped over ``--lam-ramp`` steps,
Adam with a warmup-cosine learning rate) → ``ShardedFeed`` (step-seeded
synthetic tokens, prefetched, pinned, copied without blocking) →
``FaultTolerantLoop`` (resume from the latest checkpoint under
``--ckpt-dir`` or start fresh; checkpoints every ``--ckpt-every`` steps,
SIGTERM/SIGINT checkpoint and stop, transient errors retried) →
``export_quantized`` to ``--export``.  It prints a ``step … loss … ce …
gnorm … lam …`` line every 10 steps and a ``finished:`` line, and
``main`` returns that history.  ``--remat`` rematerialises each layer
in the backward as the reference's ``jax.checkpoint`` of its scan body:
``none`` keeps every activation, ``full`` a layer's inputs only, ``dots``
also its projections' products; the loss and the gradients are bitwise
the same under all three.  Under autograd the online softmax keeps only
each KV chunk's inputs and carries, and re-forms the chunk's scores in
the backward (``nn/attention.py``).  An SSD block (``nn/ssm.py``) pads
a sequence to a multiple of its chunk (``ssm_chunk``, 256 at the
published widths) and computes the padding too, so ``--seq`` is best a
multiple of it.  A vlm batch holds the stubbed vision frontend's patch
embeddings (batch, seq, d_model) and labels, no tokens; an audio batch
adds the stubbed conv frontend's frame embeddings (batch, ``enc_len``,
d_model) to its decoder tokens, whose ``--seq`` may not pass whisper's
``MAX_TGT`` = 448 (:func:`lm_batch_fn`).  A published MoE arch trains
every expert on one device; one device's share of an expert-parallel
deployment (``ArchConfig.experts_held``) is set by a caller, not by a
flag.

In both branches every step's fake-quant forward and EMA probability
update each quantize every quantized tensor in one grouped call of the
ECL op (``kernels/ecl_quant.py``): on the card ⌈segments / 32⌉ launches
of the hand-written CUDA kernel (SmolLM-360M: 224 segments, 7 launches;
one card's share of a Grok-1 layer, q, k, v, o and 3 banks x 2 experts:
10 segments, 1 launch; one GPU's share of DeepSeek-V3 at depth 2, 28
segments, 1 launch; mamba2-1.3b's 48 x 2 projections, 3 launches;
hymba-1.5b's 32 x 9, 9 launches; qwen2-vl-2b's 28 x 7, 7 launches;
whisper-base's encoder and decoder, 6 x 6 + 6 x 10, 3 launches), on
``--device cpu`` its plain version.  Defaults differ by branch
(:data:`MLP_DEFAULTS`, :data:`LM_DEFAULTS`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device, tree
from ..checkpoint.manager import CheckpointManager, export_quantized
from ..configs import get_config
from ..configs.base import ArchConfig
from ..configs.paper_mlps import MLPS, MLPConfig
from ..core import qat
from ..data import pipeline, synthetic
from ..models import mlp as M
from ..models import whisper as W
from ..nn import transformer as T
from ..nn.module import QuantCtx
from ..optim import adam, ec4t, schedule
from ..runtime.fault import FaultTolerantLoop
from . import steps as steps_mod

BATCH = 128
EVAL_STEP0 = 10_000          # held-out batches are steps 10,000 + j
EVAL_BATCHES = 5
SERVE_STEP = 99_999          # the serving check's batch of 256
LM_METRICS_EVERY = 10
MLP_DEFAULTS = dict(steps=300, lam=0.3, lam_ramp=60, lr=5e-3, log_every=50)
LM_DEFAULTS = dict(steps=100, lam=0.05, lam_ramp=50, lr=1e-3, batch=8,
                   seq=64, ckpt_every=50, remat="none",
                   log_every=LM_METRICS_EVERY,
                   ckpt_dir=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
LM_ONLY = ("smoke", "batch", "seq", "ckpt_dir", "ckpt_every", "export",
           "remat")


def data_cfg(cfg: MLPConfig, seed: int, batch: int = BATCH
             ) -> synthetic.ClsDataCfg:
    return synthetic.ClsDataCfg(d_in=cfg.d_in, n_classes=cfg.features[-1],
                                batch=batch, margin=3.0, seed=seed)


def batch_tensors(dcfg: synthetic.ClsDataCfg, step: int, dev) -> tuple:
    b = synthetic.cls_batch(dcfg, step)
    return (torch.from_numpy(b["x"]).to(dev),
            torch.from_numpy(b["labels"]).to(torch.int64).to(dev))


def train_step(params, qstate, bn, opt, x, labels, lam, *, lr: float,
               quant: bool = True) -> tuple:
    """One EC4T step: fake-quant forward, backward, Adam, then the EMA
    probability update on the new weights.  Returns (params, qstate, bn,
    opt, loss)."""
    ctx = QuantCtx(quant=quant, lam=lam, compute_dtype=torch.float32)
    params = tree.map_(lambda p: p.detach().requires_grad_(), params)
    logits, bn = M.mlp_apply(params, qstate, bn, x, ctx, train=True)
    loss = M.cross_entropy(logits, labels)
    leaves = tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree.unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
    params, opt, _ = adam.apply(params, grads, opt, adam.AdamConfig(lr=lr))
    qstate = qat.update_qstate(params, qstate, lam)
    return params, qstate, bn, opt, loss.detach()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_mlp(cfg: MLPConfig, *, lam: float, steps: int = 250,
              lr: float = 5e-3, seed: int = 0, lam_ramp: int = 60,
              quant: bool = True, device=None, state=None,
              log_every: int = 0) -> tuple:
    """EC4T-train ``cfg`` on its synthetic task; returns (params, qstate,
    bn, metrics).  ``state`` = (params, qstate, bn, opt) starts from a
    given state instead of ``mlp_init(cfg, seed=seed)``.  ``metrics``
    holds the held-out accuracy (5 batches), sparsity, entropy, every
    step's loss and ms per step after the first (host clock around work
    that ends in a device synchronisation)."""
    dev = resolve_device(device)
    dcfg = data_cfg(cfg, seed)
    if state is None:
        params, bn = M.mlp_init(cfg, seed=seed, device=dev)
        qs = qat.build_qstate(params)
        opt = adam.init(params)
    else:
        params, qs, bn, opt = state
    losses = []
    t_first = None
    for i in range(steps):
        x, labels = batch_tensors(dcfg, i, dev)
        lam_t = float(schedule.lambda_ramp(i, lam=lam, ramp_steps=lam_ramp))
        params, qs, bn, opt, loss = train_step(params, qs, bn, opt, x, labels,
                                               lam_t, lr=lr, quant=quant)
        losses.append(loss)
        if i == 0:
            _sync(dev)
            t_first = time.perf_counter()
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d}  loss {float(loss):.4f}  λ {lam_t:.4f}")
    _sync(dev)
    ms = ((time.perf_counter() - t_first) * 1e3 / (steps - 1)
          if steps > 1 else None)

    ctx = QuantCtx(quant=quant, lam=lam, compute_dtype=torch.float32)
    with torch.no_grad():
        accs = []
        for j in range(EVAL_BATCHES):
            x, labels = batch_tensors(dcfg, EVAL_STEP0 + j, dev)
            logits, _ = M.mlp_apply(params, qs, bn, x, ctx, train=False)
            accs.append(float(M.accuracy(logits, labels)))
        st = qat.stats(params, qs, lam)
    metrics = {"acc": float(np.mean(accs)),
               "sparsity": float(st["sparsity"]),
               "entropy_bits": float(st["entropy_bits_per_weight"]),
               "losses": torch.stack(losses).cpu().tolist() if losses else [],
               "ms_per_step": ms}
    return params, qs, bn, metrics


def serving_check(cfg: MLPConfig, params, qstate, bn, pack, lam: float,
                  serve, *, seed: int = 0) -> float:
    """Serve the held-out batch of 256 with ``serve(x)`` and hold it to the
    eval-mode forward (``atol=rtol=1e-2``); returns the max abs error."""
    dev = pack["layers"][0]["packed"].device
    x, _ = batch_tensors(data_cfg(cfg, seed, batch=256), SERVE_STEP, dev)
    ctx = QuantCtx(quant=True, lam=lam, compute_dtype=torch.float32)
    with torch.no_grad():
        y_eval, _ = M.mlp_apply(params, qstate, bn, x, ctx, train=False)
    y_serve = serve(x)
    got, want = y_serve.cpu().numpy(), y_eval.cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"served {got.shape}, expected {want.shape} "
                             "finite logits")
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
    return float(np.abs(got - want).max())


# ------------------------------------------------------------ LM branch

def lm_config(arch: str, *, smoke: bool = False,
              lam: float = LM_DEFAULTS["lam"]) -> ArchConfig:
    """The arch's config (reduced with ``smoke``) at λ ``lam``."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, lam=lam)
    T.check_supported(cfg)
    return cfg


def lm_step_fn(cfg: ArchConfig, *, steps: int, lr: float, lam: float,
               lam_ramp: int, remat: str = "none",
               dtype: torch.dtype = torch.bfloat16) -> Callable:
    """The launcher's EC4T step: λ ramped from 0 over ``lam_ramp`` steps,
    Adam at ``lr`` scaled by a warmup-cosine schedule over ``steps``
    (warmup ``steps // 20``), both read from the device's step counter."""
    return ec4t.make_train_step(
        steps_mod._loss_fn(cfg, remat=remat, dtype=dtype),
        adam.AdamConfig(lr=lr),
        lam=lambda step: schedule.lambda_ramp(step, lam=lam,
                                              ramp_steps=lam_ramp),
        lr_schedule=lambda step: schedule.warmup_cosine(
            step, base_lr=1.0, warmup=max(steps // 20, 1), total=steps))


def lm_init(cfg: ArchConfig, *, seed: int = 0, device=None) -> dict:
    """The arch's parameters: ``whisper_init`` for the audio family,
    ``lm_init`` for every other."""
    init = W.whisper_init if cfg.family == "audio" else T.lm_init
    return init(cfg, seed=seed, device=device)


def lm_batch_fn(cfg: ArchConfig, *, batch: int, seq: int) -> Callable:
    """``step -> {"tokens", "labels"}`` (numpy int32 (batch, seq)) of the
    step-seeded synthetic LM stream, as the reference's launcher feeds
    them: a vlm batch swaps the tokens for patch embeddings (batch, seq,
    d_model), an audio batch adds frame embeddings (batch, ``enc_len``,
    d_model), both fp32 standard normals from a numpy generator seeded
    with the step (the reference draws them with ``jax.random``, so the
    values differ).  Raises ``ValueError`` for an audio ``seq`` past
    ``MAX_TGT``: the reference would train such positions on a clamped
    ``dec_pos`` row."""
    if cfg.family == "audio" and seq > W.MAX_TGT:
        raise ValueError(f"--seq {seq}: {cfg.name}'s decoder holds "
                         f"{W.MAX_TGT} positions (MAX_TGT); use --seq <= "
                         f"{W.MAX_TGT}")
    data_cfg = synthetic.LMDataCfg(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=batch)
    frames = {"audio": cfg.enc_len, "vlm": seq}.get(cfg.family)

    def batch_fn(step: int) -> dict:
        b = synthetic.lm_batch(data_cfg, step)
        out = {"tokens": b["tokens"], "labels": b["labels"]}
        if frames is not None:
            out["embeds"] = np.random.default_rng(step).standard_normal(
                (batch, frames, cfg.d_model), dtype=np.float32)
            if cfg.family == "vlm":
                del out["tokens"]
        return out
    return batch_fn


def train_lm(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
             lr: float, lam: float, lam_ramp: int, ckpt_dir: str,
             ckpt_every: int = 50, export: Optional[str] = None,
             remat: str = "none", device=None,
             metrics_every: int = LM_METRICS_EVERY, seed: int = 0,
             log: Callable = print) -> dict:
    """The LM branch: init (:func:`lm_init` with ``seed``), resume from the
    latest checkpoint under ``ckpt_dir`` if there is one, train through
    ``FaultTolerantLoop`` up to step ``steps``, and export to ``export``.
    Returns ``{"state", "history", "start", "last", "reason",
    "ms_per_step", "saves", "export", "export_s"}``: ``history`` holds
    every ``metrics_every``-th step's metrics, ``ms_per_step`` the host
    clock over the run (its last checkpoint included) per step taken,
    ``saves`` (step, seconds) of each checkpoint written, ``export`` the
    export's size report and ``export_s`` its seconds."""
    dev = resolve_device(device)
    batch_fn = lm_batch_fn(cfg, batch=batch, seq=seq)
    step_fn = lm_step_fn(cfg, steps=steps, lr=lr, lam=lam,
                         lam_ramp=lam_ramp, remat=remat)
    state = ec4t.init_train_state(lm_init(cfg, seed=seed, device=dev))
    history = []

    def on_metrics(step, m):
        rec = {"step": step, **{k: float(v) for k, v in m.items()}}
        history.append(rec)
        log(f"step {step:5d} loss {rec['loss']:.4f} ce {rec['ce']:.4f} "
            f"gnorm {rec['grad_norm']:.2f} lam {rec['lam']:.4f}")

    loop = FaultTolerantLoop(step_fn, CheckpointManager(ckpt_dir, keep=3),
                             ckpt_every=ckpt_every,
                             metrics_every=metrics_every,
                             on_metrics=on_metrics)
    state, start = loop.resume_or(state)
    feed = pipeline.ShardedFeed(batch_fn, start_step=start, device=dev)
    t0 = time.perf_counter()
    try:
        state, last, reason = loop.run(state, feed, start_step=start,
                                       total_steps=steps)
    finally:
        feed.close()
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(last - start, 1)
    log(f"finished: {reason} at step {last} ({ms:.0f} ms/step)")
    report = export_s = None
    if export:
        t0 = time.perf_counter()
        report = export_quantized(export, state["params"], state["qstate"],
                                  lam)
        export_s = time.perf_counter() - t0
        log(f"export: {report['compression_ratio']:.2f}x compression -> "
            f"{export}")
    return {"state": state, "history": history, "start": start,
            "last": last, "reason": reason, "ms_per_step": ms,
            "saves": list(loop.saves), "export": report,
            "export_s": export_s}


# ---------------------------------------------------------------- CLI

def _resolve(args, defaults: dict) -> None:
    for key, value in defaults.items():
        if getattr(args, key) is None:
            setattr(args, key, value)


def main(argv=None):
    """The CLI: the MLP branch returns its metrics dict, the LM branch the
    history of its ``step`` lines."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mlp-gsc",
                    help=f"one of {', '.join(sorted(MLPS))} or an LM arch "
                    "of any family (smollm-360m, grok-1-314b, "
                    "deepseek-v3-671b, mamba2-1.3b, hymba-1.5b, "
                    "qwen2-vl-2b, whisper-base, ...)")
    ap.add_argument("--steps", type=int, default=None,
                    help="MLP 300, LM 100")
    ap.add_argument("--lam", type=float, default=None, help="MLP 0.3, LM 0.05")
    ap.add_argument("--lam-ramp", type=int, default=None,
                    help="MLP 60, LM 50")
    ap.add_argument("--lr", type=float, default=None,
                    help="MLP 5e-3, LM 1e-3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=None,
                    help="print every N steps (MLP 50, LM 10)")
    lm_flags = ap.add_argument_group("LM branch only")
    lm_flags.add_argument("--smoke", action="store_true", default=None,
                          help="reduced config (CPU-sized)")
    lm_flags.add_argument("--batch", type=int, default=None, help="8")
    lm_flags.add_argument("--seq", type=int, default=None,
                          help="64; for ssm and hybrid archs best a "
                          "multiple of ssm_chunk (256 at the published "
                          "widths, 8 in --smoke): a shorter last chunk is "
                          "padded and computed; at most 448 for "
                          "whisper-base (its decoder's MAX_TGT)")
    lm_flags.add_argument("--ckpt-dir", default=None,
                          help="$TMPDIR/repro_torch_ckpt")
    lm_flags.add_argument("--ckpt-every", type=int, default=None, help="50")
    lm_flags.add_argument("--export", default=None,
                          help="directory for the 4-bit serving export")
    lm_flags.add_argument("--remat", default=None,
                          choices=T.REMAT,
                          help="none (keep every activation), full (keep "
                          "each layer's inputs) or dots (and its "
                          "projections' products); default none")
    args = ap.parse_args(argv)
    if args.arch not in MLPS:
        _resolve(args, LM_DEFAULTS)
        cfg = lm_config(args.arch, smoke=bool(args.smoke), lam=args.lam)
        return train_lm(cfg, steps=args.steps, batch=args.batch,
                        seq=args.seq, lr=args.lr, lam=args.lam,
                        lam_ramp=args.lam_ramp, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every, export=args.export,
                        remat=args.remat, device=args.device,
                        metrics_every=args.log_every,
                        seed=args.seed)["history"]
    given = [f"--{k.replace('_', '-')}" for k in LM_ONLY
             if getattr(args, k) is not None]
    if given:
        ap.error(f"{', '.join(given)}: LM branch only (--arch "
                 f"{args.arch} trains a paper MLP)")
    _resolve(args, MLP_DEFAULTS)
    dev = resolve_device(args.device)
    cfg = MLPS[args.arch]
    print(f"training {cfg.name} ({cfg.d_in}-"
          f"{'-'.join(map(str, cfg.features))}) with EC4T, λ={args.lam}, "
          f"{args.steps} steps on {dev}")
    params, qs, bn, metrics = train_mlp(
        cfg, lam=args.lam, steps=args.steps, lr=args.lr, seed=args.seed,
        lam_ramp=args.lam_ramp, device=dev, log_every=args.log_every)
    clock = "host clock, CUDA synchronised" if dev.type == "cuda" \
        else "host clock, CPU"
    ms = metrics["ms_per_step"]
    print(f"accuracy {metrics['acc']:.1%}  sparsity {metrics['sparsity']:.1%}"
          f"  entropy {metrics['entropy_bits']:.2f} bits/weight  "
          + (f"{ms:.3f} ms/step ({clock})" if ms is not None else ""))

    pack = M.freeze_mlp(params, qs, bn, lam=args.lam)
    err = serving_check(cfg, params, qs, bn, pack, args.lam,
                        lambda x: M.mlp_serve(pack, x, device=dev),
                        seed=args.seed)
    metrics["serve_max_abs_err"] = err
    print(f"frozen and served: max |serve - eval forward| = {err:.3g} "
          "(within atol=rtol=1e-2)")
    return metrics


if __name__ == "__main__":
    main()
