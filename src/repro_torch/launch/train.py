"""EC4T-train one of the paper's MLPs, then freeze and serve it:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mlp-gsc --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --arch mlp-hr --steps 20 --device cpu

The MLP trainer of the JAX package (``benchmarks/common.py`` ``train_mlp``,
driven as ``examples/train_mlp_gsc.py`` drives it): batch 128 of the
synthetic classification task, λ ramped from 0 over ``--lam-ramp`` steps,
Adam with the global-norm clip.  Every step's fake-quant forward and EMA
probability update each quantize every layer in one grouped call of the
ECL op (``kernels/ecl_quant.py``): one launch of the hand-written CUDA
kernel on the card, its plain version on ``--device cpu``.  At the end the CLI prints held-out accuracy, sparsity
and entropy and ms per step, freezes the net (``freeze_mlp``), serves a
held-out batch through ``mlp_serve`` and checks it against the eval-mode
forward (``atol=rtol=1e-2``, as ``examples/train_mlp_gsc.py:54``).

Only the paper MLPs train here; the JAX launcher's LM archs raise
``NotImplementedError`` (ROADMAP queue 1 item 5, LM training).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device, tree
from ..configs.paper_mlps import MLPS, MLPConfig
from ..core import qat
from ..data import synthetic
from ..models import mlp as M
from ..nn.module import QuantCtx
from ..optim import adam, schedule

BATCH = 128
EVAL_STEP0 = 10_000          # held-out batches are steps 10,000 + j
EVAL_BATCHES = 5
SERVE_STEP = 99_999          # the serving check's batch of 256


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mlp-gsc",
                    help=f"one of {', '.join(sorted(MLPS))}")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--lam-ramp", type=int, default=60)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=50)
    args = ap.parse_args(argv)
    if args.arch not in MLPS:
        raise NotImplementedError(
            f"--arch {args.arch}: the port trains the paper MLPs "
            f"({', '.join(sorted(MLPS))}); LM training (the LM branch of "
            "the JAX package's launch/train.py) is ROADMAP queue 1 item 5")
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
