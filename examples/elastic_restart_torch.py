"""Fault tolerance with the PyTorch port: train, get preempted, resume.

    PYTHONPATH=src python examples/elastic_restart_torch.py            # on the card
    PYTHONPATH=src python examples/elastic_restart_torch.py --device cpu

The port's counterpart of ``examples/elastic_restart.py``.  Phase 1
EC4T-trains the smoke config of SmolLM-360M for 25 steps with a
checkpoint every 10.  Phase 2 resumes from the latest checkpoint and is
preempted by a SIGTERM mid-run: the loop checkpoints at the next step
boundary and exits cleanly.  Phase 3 builds a fresh train state and
resumes from that checkpoint; the step-seeded feed skips ahead exactly,
so the run goes on as if nothing happened.
"""
import argparse
import os
import shutil
import signal
import tempfile
import threading

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline
from repro_torch.launch import train as T
from repro_torch.nn.transformer import lm_init
from repro_torch.optim import ec4t
from repro_torch.runtime.fault import FaultTolerantLoop
from repro_torch.tree import leaves

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = T.lm_config("smollm-360m", smoke=True, lam=0.05)
ckpt_dir = tempfile.mkdtemp(prefix="elastic_torch_")
batch_fn = T.lm_batch_fn(cfg, batch=8, seq=32)
step_fn = T.lm_step_fn(cfg, steps=100, lr=1e-3, lam=0.05, lam_ramp=50)


def make_loop():
    losses = []
    loop = FaultTolerantLoop(
        step_fn, CheckpointManager(ckpt_dir, keep=3), ckpt_every=10,
        metrics_every=5,
        on_metrics=lambda s, m: losses.append((s, float(m["loss"]))))
    return loop, losses


def fresh_state():
    return ec4t.init_train_state(lm_init(cfg, seed=0, device=dev))


def run(loop, state, start, total):
    feed = pipeline.ShardedFeed(batch_fn, start_step=start, device=dev)
    try:
        return loop.run(state, feed, start_step=start, total_steps=total)
    finally:
        feed.close()


print(f"phase 1: train 25 steps on {dev}")
loop, losses = make_loop()
state, step, reason = run(loop, fresh_state(), 0, 25)
print(f"  -> {reason} at step {step}; metrics {losses[-2:]}")
assert (reason, step) == ("done", 25)

print("phase 2: resume and get preempted mid-run")
loop2, losses2 = make_loop()
state2, start = loop2.resume_or(fresh_state())
print(f"  resumed at step {start}")
assert start == 25
killer = threading.Timer(1.0, lambda: os.kill(os.getpid(), signal.SIGTERM))
killer.start()
state2, step2, reason2 = run(loop2, state2, start, 10_000)
killer.join()
print(f"  -> {reason2} at step {step2} (checkpointed)")
assert reason2 == "preempted" and step2 > start

print("phase 3: a fresh train state resumes exactly")
loop3, losses3 = make_loop()
state3, start3 = loop3.resume_or(fresh_state())
assert start3 == step2, (start3, step2)
assert all(torch.equal(a, b) for a, b in zip(leaves(state3), leaves(state2)))
state3, step3, reason3 = run(loop3, state3, start3, start3 + 15)
print(f"  resumed from {start3}, finished {reason3} at {step3}; "
      f"metrics {losses3[-2:]}")
assert (reason3, step3) == ("done", start3 + 15)
shutil.rmtree(ckpt_dir)
print("elastic restart OK")
