#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card's name and power limit, build the CUDA kernels from
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel) and turn
   TF32 off.
2. Hold every kernel against its plain PyTorch version on the card: the
   MLP-GSC stack and a small odd-K stack, batches 1/3/8/9/17/33/64/255/256
   (ragged row tiles and clusters), and a stack with an 8192-wide input
   at batches 1/8/32 (the chain stages K in chunks there, stream takes
   fewer rows a tile, the cluster schedules fall back to the chain), fp32
   and int8, through kernel 1 (the per-layer chain) and every fused
   schedule.
   Gates: fp32 ``atol=1e-3, rtol=1e-4``; int8 relative max-abs error
   ``< 5e-3``; and the port's own int8 outputs bitwise equal across the
   chain, batch_tiled, db, ws and stream.  Kernel 5 (ecl_quant) at every
   MLP-GSC layer shape plus (37, 129) and (1, 5), λ ∈ {0, 0.02, 0.3}, one
   tensor a launch, and grouped: MLP-GSC's seven tensors, (37, 129),
   (1, 5), a (37, 129) view at an odd offset and a batched (3, 37, 129)
   with ω (3, 4) in one launch; codes and ŵ bitwise equal to its plain
   version.
3. The main path: a seeded MLP-GSC frozen with ``freeze_mlp`` and served
   through ``ExecutionPlan`` + ``MicroBatcher`` as ragged requests of 1-5
   rows (auto fp32 and int8 plans, a per-layer plan, a double-buffered plan
   and a plan whose shared-memory budget leaves only the stream schedule).
   Launch counters are zeroed just before and read just after; every
   kernel must have launched.  Each result must equal the same rows served
   alone, and the fp32 results must match the plain oracle.
3b. The training path: MLP-GSC from ``mlp_init(seed=0)`` EC4T-trained by
   ``launch.train.train_mlp`` for 300 steps (batch 128, λ 0.3 ramped over
   60 steps, Adam lr 5e-3), frozen with ``freeze_mlp`` and served through
   ``ExecutionPlan``.  Counters are zeroed just before and read just
   after; ecl_quant must have launched exactly 2 per step (one grouped
   launch in the fake-quant forward, one in the probability update) plus
   one per eval batch, stats, freeze and serving check.  Every loss finite,
   held-out accuracy ≥ 0.6, entropy ≤ 2.5 bits/weight, served logits
   within ``atol=rtol=1e-2`` of the eval forward, and 3 steps on the card
   (kernel) within ``rtol=1e-4`` of 3 on the CPU (plain version), loss by
   loss; prints one ``train`` JSON line.
3c. The request path over several packs, run after phase 4 so that its
   threads leave no state under the single-stream timings: MLP-GSC,
   MLP-HR and LeNet-300-100 frozen from seeds and phase 3b's trained
   MLP-GSC after an ``export_pack`` -> ``load_pack(verify=True)`` round
   trip, each on a schedule of its own.  Gates: compress -> decode serves
   bitwise at 1/8/64/256 rows with equal CRCs; ``PackCache(max_hot=2)``
   over the four packs makes >= 20 evictions, every reload is bitwise and
   device memory comes back within one pack's footprint; two stream
   launches on two CUDA streams stay bitwise (device ms ordered and
   unordered printed); ``ServingFrontend(streams=2)`` with
   ``verify_launch`` and a scrubber serves 2,000 ragged requests of 1-64
   rows in two tiers, every result within the fp32 gate and bitwise equal
   to the request served alone, rejections typed, every serving kernel
   launched (counters zeroed just before, read just after); a fault
   session (seeded launch failures, bit flips in the pack, in place in
   the copies the kernels read, and in the cold tier) returns no result
   that differs from the clean pack's; each hot flip its own launch ran
   on is detected by that launch, no launch returns a result from a
   corrupted pack or copy, recovered = detected - refused, and the cold
   flip quarantines the model.  Prints one ``frontend`` JSON line.
4. Time each kernel, its plain version and a library yardstick
   (``torch.matmul`` on pre-decoded fp32 weights plus the epilogue) at the
   main-path shapes, with CUDA events around back-to-back calls (``ms``:
   the wrapper's host work included when it is the slower side; the least
   of TIME_REPEATS blocks of calls, as the host is shared), with the
   calls queued behind a spin kernel so the host is out of the way
   (``queued_ms``, ``library_queued_ms``: the device's time per call,
   launch gaps included), and the device time from a torch.profiler
   trace: the kernel's own (``device_ms``, summed over the chain's seven
   launches; a kernel missing from the trace fails the run) and the sum of
   every kernel the yardstick launches (``library_device_ms``).  Each
   device time has a ``..._from`` key beside it: ``"trace"``, or
   ``"queued_events"`` when no trace of it was whole (no device event,
   or fewer of ecl_quant's records than its launches; the time is then
   ``_queued_ms``'s).  The
   cluster schedules (batch_tiled, db, ws) are also timed at 16 CTAs per
   cluster after an equality check against the default 8.  ecl_quant at
   every MLP-GSC layer shape one tensor a launch, and MLP-GSC's seven
   tensors in one grouped launch (``ms``, ``device_ms``, ``queued_ms``;
   no single PyTorch call computes it, so no library time), and the train
   step at batch 128 with its device-time breakdown.  Print one ``grid``
   JSON line (CTAs and shared memory of each launch at each timed batch
   -- the cluster size of the cluster kernels, PDL on or off for each of
   the chain's seven, the cooperative grid of stream -- and the
   dependent-FMA floor), one ``kernels`` (each kernel's launches by path:
   phase 3, phase 3b's serving check, phase 3c, phase 5, phase 6, phase
   7, phase 8, phase 9), one
   ``path``, one ``train``, one ``frontend``, one ``lm``, one
   ``lm_train``, one ``moe``, one ``moe_train`` and one ``mla`` JSON
   line.
5. The LM serving path at full width, run after phase 3c: SmolLM-360M
   (32 blocks of d_model 960, 15 heads, 5 KV heads, d_ff 2560, vocab
   49,152) from ``lm_init(seed=0)`` on the card, frozen with
   ``freeze_tree`` and served by ``LMProgram(max_prompt=16, max_new=16,
   max_bucket=64)`` after ``warmup()``, 4 prompts of 16 ids from a numpy
   seed.  Gates: ``freeze_tree`` makes exactly ⌈224 / 32⌉ = 7 ecl_quant
   launches, and block 0's and block 31's seven leaves equal the plain
   version on the same card tensors bit for bit; block 0's FFN shapes
   (960→2560, 2560→960) at rows 1/2/4/8/16/64 through the chain and
   every schedule that fits, each seen to launch, within the fp32 gate of
   the plain oracle; the engine's tokens (``ServingFrontend``, one
   stream) equal ``LMProgram.generate``'s bit for bit; teacher-forced
   over them, the program's logits at every step within 1e-3 of the
   largest |logit| of the direct ``lm_apply`` path on the same frozen
   tree (dense decode + ``torch.matmul``), each engine token's logit
   within that of the direct path's maximum; every schedule
   ``describe(n_seqs=4)["ffn_schedules"]`` names (each FFN matrix at a
   decode of the session's 4 sequences and at a prefill) launched in the
   engine session
   (counters zeroed just before, read just after), and every frozen
   leaf and sequence state on the card.  Prints one ``lm`` JSON line
   (sizes, freeze, build, prefill and decode ms, a decode step's device
   ms and idle share from one trace, the schedules and launches, the
   FFN shapes' and the freeze's kernel times against their bounds,
   device memory, one ``GuardedPlan.verify`` ms).
6. LM training at full width, run after phase 5: SmolLM-360M from
   ``lm_init(seed=0)`` on the card, EC4T-trained through the launcher's
   ``train_lm`` (``ShardedFeed`` -> ``FaultTolerantLoop`` -> export) for
   20 steps at batch 8 x seq 64 in bf16, λ 0.05 ramped over 50 steps, lr
   1e-3 with warmup-cosine, a checkpoint at step 20 into a temporary
   directory.  Counters are zeroed just before and read just after.
   Gates: exactly 14 ecl_quant launches a step (7 in the fake-quant
   forward, 7 in ``update_qstate``) plus 7 for the export, every pass over
   all 224 segments; in the first and the last step, block 0's and block
   31's seven ŵ and codes bitwise equal to ``ecl_quant_plain`` on the same
   card tensors; every loss finite and the mean of the last 5 below the
   first; a fresh state (another seed) restored by ``resume_or`` from the
   checkpoint bitwise equal to the trained one, and one more step from
   each giving the same loss bit for bit; ``load_quantized`` of the
   export giving ``freeze_tree``'s codes and ω; the ``--smoke`` config in
   fp32, 3 card steps within ``rtol=1e-4`` of 3 CPU steps.  Prints one
   ``lm_train`` JSON line (ms per step, one step's device ms, idle share
   and device operations from a trace, ecl_quant's device ms a step
   against its bound, the fake-quant backward's and Adam's device ms,
   the host synchronisations of a step, peak device memory, checkpoint
   bytes and save / restore ms, export bytes, ratio and write / load ms).

7. MoE serving at full width, run after phase 6: grok-1-314b at its
   published widths (d_model 6144, 48 heads, 8 KV heads, 8 experts of
   d_ff 32768, top-2 softmax gate, vocab 131,072) cut to one layer, the
   most one card holds through the freeze (~26 GB of fp32 masters, ~25 GB
   of codes and ŵ).  First the launcher a user runs (``launch.serve
   --arch grok-1-314b --layers 1``: init, ``freeze_tree``, 4 prompts of
   16 ids, 16 greedy tokens through ``lm_apply``), with the ecl_quant
   counter zeroed just before and read just after; then the same init,
   freeze and prompts again for the gates, whose tokens must equal the
   launcher's.  Gates: exactly ⌈28 / 32⌉ = 1
   ecl_quant launch in the freeze (4 attention segments + 3 banks x 8
   experts); codes of layer 0's q and of experts 0 and 7 of every bank
   bitwise equal to ``ecl_quant_plain`` on the card; ``route`` on the
   card against the CPU on the prefill's router logits and on the same
   rounded to integers (ties): ids bitwise, weights and aux within 1e-6;
   the last decode step's MoE output within 1e-4 relative of a per-token
   reference that decodes only each token's chosen experts; a forced-skew
   prefill (router column 0 solved so every token's expert-0 logit is 50:
   all 64 pick it, 24 are kept) whose dispatch equals the CPU's
   ``_dispatch_indices`` and whose output matches the kept-only reference
   within 1e-4; no decode step drops an assignment (C = 8); each
   sequence's last decode step's logits within 1e-4 relative of a
   re-prefill of its 31 tokens without a cache at capacity factor E / k
   (no drops; at the served factor the re-prefill drops by design, and
   the drops are counted); the smoke
   config card vs CPU, tokens equal and logits within 1e-5.  Prints the
   freeze's ms, device ms and bounds, prefill and decode ms, a decode
   step's device ms, operations and idle share, peak device memory of the
   freeze and the decode, and the skew run's drops, each beside the
   card's name and power limit, and one ``moe`` JSON line.

8. MoE training at published widths, run after phase 7: one card's share
   of grok-1-314b (``experts_held=(0, 2)``: experts 0-1 of 8, the router
   all 8 wide, top-2; vocabulary 32,768 of 131,072; one shard of a 4-wide
   expert-parallel 'model' axis, as the reference's ``moe_ffn`` picks
   ``moe_apply_ep`` there) at depth 1 from ``lm_init(seed=0)``, EC4T-
   trained through the launcher's functions (``lm_step_fn``,
   ``lm_batch_fn``, ``ShardedFeed``, ``FaultTolerantLoop``) for 6 steps at
   batch 8 x seq 64 in bf16 with phase 6's λ ramp and warmup-cosine: 3
   through the loop with its one checkpoint at step 3, 3 more in memory;
   then ``export_quantized``.  Counters are zeroed just before and read
   just after.  Gates: first, at the smoke width on the card, shares
   (0, 2) + (2, 2) of one layer equal the uncut layer within 1e-5
   relative, and a smoke share's fp32 loss and aux (1e-5) and gradients
   of the router ``w``, the down bank and its ω (1e-4 relative) equal the
   CPU's; the full-width share's gradients equal bit for bit when its
   backward runs twice; exactly 1 ecl_quant launch a pass over the 10
   segments (q, k, v, o, 3 banks x 2 experts), 12 in the 6 steps and 1 in
   the export; the first and the last step's fake-quant codes and ŵ of q
   and of expert 1 of down bitwise equal to ``ecl_quant_plain``; losses
   and aux finite, the first within 0.5 of ln 32768; ``bias_correction``
   bitwise unchanged; a fresh state restored from the checkpoint takes
   steps 4-6 with the same losses and leaf digests bit for bit;
   ``load_quantized`` of the export (Huffman decoded on the card; the
   attention q's 37.7 M codes also decoded on the host, timed, the same
   codes) turned into a serving tree equals ``freeze_tree`` leaf for
   leaf, and both
   serve the same 4 x (16 + 8) greedy tokens through ``lm_apply``; no
   host synchronisation inside a step (``set_sync_debug_mode``).
   Prints the reduced list and the deployment, ms a step, device ms,
   idle share and device operations (profiler), the ECL pass's and
   ``adam.apply``'s device ms against their byte bounds,
   ``FakeQuantGroup.backward``'s and ``update_qstate``'s, peak memory
   after the forward, the backward, Adam and the update, checkpoint and
   export bytes and ms, and the assignments dropped a step, each beside
   the card's name and power limit, and one ``moe_train`` JSON line.

9. MLA serving at published widths, run after phase 8 (whose state is
   freed first: the phase gates that at most 1 GiB is allocated when it
   starts): one GPU's share of deepseek-v3-671b (d_model 7168, 128
   heads, MLA with q_lora 1536, kv_lora 512, nope 128, rope 64, v 128;
   dense d_ff 18,432; 256 experts of d_ff 2048, sigmoid gate, top-8,
   routed scaling 2.5, a shared expert; vocabulary 129,280) at depth 4
   (the 3 leading dense layers and the first MoE layer) with experts 0-7
   of 256 held (``experts_held=(0, 8)``, one GPU of the DeepSeek-V3
   report's EP32 prefill unit), frozen to 4 bits and served through the
   direct ``lm_apply`` path: first by the launcher's
   ``serve_lm_config`` on the share (init, ``freeze_tree``, 2 prompts of
   8,192 ids from numpy seed 0, 16 greedy tokens), the ecl_quant counter
   zeroed just before and read just after; then the same init, freeze
   and prompts again for the gates, whose tokens must equal the
   launcher's.  Gates: exactly ⌈56 / 32⌉ = 2 ecl_quant launches (5 MLA
   + 3 FFN segments a dense layer, 5 MLA + 3 banks x 8 + 3 shared in
   the MoE layer); codes of layer 0's q_down and kv_up and of held
   experts 0 and 7 of every bank bitwise equal to ``ecl_quant_plain``;
   layer 0's MLA output in the prefill (the naive form, the latent
   decompressed a KV chunk at a time) within 1e-4 relative of a plain
   fp32 reference that decompresses K and V whole and runs
   ``dense_attention_ref`` 16 heads at a time (TF32 off; the tolerance
   covers the fp32 summation order over 192-wide dot products and 8,192
   keys); at the first decode step, from the same cache, the absorbed
   and the naive form within 1e-4 relative; each sequence's last decode
   step's logits within 1e-4 relative of a re-prefill of its 8,207
   tokens without a cache at capacity factor E / k (no drops; the drops
   at the served factor counted); the last decode step's MoE output,
   and the prefill's (its dropped assignments left out), within 1e-4
   relative of a per-token reference of the held experts chosen plus
   the shared expert; ``route`` card vs CPU on the prefill's router
   logits (and the same rounded: ties), ids bitwise, weights and aux
   within 1e-6; deepseek-v3's smoke config with MLA card vs CPU, tokens
   equal and logits within 1e-5; every frozen leaf and the cache on the
   card.  Prints the reduced list and the deployment, the freeze's ms,
   device ms and bounds, prefill ms and decode ms a step, one decode
   step's device ms, operations and idle share, peak device memory of
   the freeze, the prefill and the decode, the latent cache's bytes
   against the uncompressed K and V's, and the assignments dropped, each
   beside the card's name and power limit, and one ``mla`` JSON line.

The script ends with a line that counts the profiler traces taken and
retaken and the device times taken from queued CUDA events, the ``nvidia-smi`` line and the ``{"ok": true, ...}`` line.
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
BATCHES = (1, 8, 64, 256)                  # timed
CHECK_BATCHES = (1, 3, 8, 9, 17, 33, 64, 255, 256)   # gated: ragged tiles
CLUSTER_SCHEDULES = ("batch_tiled", "db", "ws")
WIDE_CLUSTER = 16                          # non-portable size, timed beside 8
FMA_LATENCY = 4                            # cycles of a dependent FFMA (Hopper)
SPIN_CYCLES = 200_000_000                  # ~0.1 s: the host enqueues meanwhile
TRACE_TRIES = 8                            # a trace now and then comes back empty
TRACES = {"taken": 0, "retried": 0, "events": 0}   # profiler traces, those
# retaken, and device times taken from CUDA events when no trace was whole
PEAK_FP32_FLOPS = 67e12                    # H100 SXM, CUDA cores, dense
PEAK_BYTES = 3.35e12                       # H100 SXM HBM3
GSC_DIMS = (512, 512, 512, 256, 256, 128, 128, 12)
ODD_DIMS = (33, 40, 24, 10)
WIDE_DIMS = (8192, 64, 10)                 # K past a block's shared memory
WIDE_BATCHES = (1, 8, 32)
TIME_REPEATS = 3
GSC_LAYERS = tuple(zip(GSC_DIMS[:-1], GSC_DIMS[1:]))
ECL_SHAPES = tuple(dict.fromkeys(GSC_LAYERS)) + ((37, 129), (1, 5))
ECL_LAMS = (0.0, 0.02, 0.3)
ECL_BYTES_PER_ELEM = 9                     # read w (4), write code (1), ŵ (4)
ECL_CODES_BYTES_PER_ELEM = 5               # a freeze keeps the codes only
TRAIN = dict(lam=0.3, steps=300, lr=5e-3, seed=0, lam_ramp=60)
TRAIN_MIN_ACC, TRAIN_MAX_ENTROPY = 0.6, 2.5
SERVE_TOL = 1e-2                           # examples/train_mlp_gsc.py:54
CARD_VS_CPU_RTOL, CARD_VS_CPU_STEPS = 1e-4, 3
TPU_KERNELS = "src/repro/kernels/"
SOURCE = "src/repro_torch/csrc/fantastic4.cu"
ECL_SOURCE = "src/repro_torch/csrc/ecl_quant.cu"
ECL_SYMBOL = "ecl_quant_group_kernel"
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
        self._tables = {}

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

    def cluster_kernel(self, name, x, cluster):
        """A cluster schedule launched with ``cluster`` CTAs per cluster
        (its own layer table; the serving ops use the default size)."""
        from repro_torch.kernels import fantastic4_fused_mlp as ffm

        sched = KERNELS[name][0]
        kind = "stacked" if sched == "ws" else "tiled"
        key = (kind, cluster)
        if key not in self._tables:
            if kind == "stacked":
                self._tables[key] = ffm.stacked_layer_table(
                    *self.stacked, shapes=self.shapes, cluster=cluster)
            else:
                self._tables[key] = ffm.tiled_layer_table(
                    *self._tiled_operands(), shapes=self.shapes,
                    activations=self.acts, act_dtype=self.act_dtype,
                    cluster=cluster)
        table = self._tables[key]
        if sched == "ws":
            return ffm.fantastic4_fused_mlp_ws(
                x, *self.stacked, shapes=self.shapes,
                act_dtype=self.act_dtype, table=table)
        return ffm.fantastic4_fused_mlp(
            x, *self._tiled_operands(), shapes=self.shapes,
            activations=self.acts, act_dtype=self.act_dtype,
            block_m=ffm.MAX_TILE_ROWS, double_buffer=sched == "db",
            table=table)

    def _tiled_operands(self):
        return (tuple(l["packed"] for l in self.layers),
                tuple(l["omega"] for l in self.layers), self.alpha1s,
                tuple(l["bias"] for l in self.layers), self.scales)

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
                x, *self._tiled_operands(), activations=self.acts, **kw)
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
    for dims, seed, batches in ((GSC_DIMS, 11, CHECK_BATCHES),
                                (ODD_DIMS, 12, CHECK_BATCHES),
                                (WIDE_DIMS, 13, WIDE_BATCHES)):
        pack = rand_pack(dims, seed, dev)
        for batch in batches:
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
    from repro_torch.serving.plans import STREAM_BLOCK_M, ExecutionPlan

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
        # a budget that holds the stream kernel's CTA and neither the
        # batch_tiled nor the ws kernel's
        "stream": ExecutionPlan(pack, device=dev, smem_budget_bytes=(
            ffm.stream_mlp_smem_bytes(GSC_LAYERS, rows=256,
                                      block_m=STREAM_BLOCK_M) + 1024)),
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


def ecl_case(shape, lam, seed, dev):
    """He-scaled weights, their init ω, seeded Dirichlet probs and the
    trainer's penalty, on ``dev``; ω and probs batched over the dims
    before the last two."""
    import numpy as np
    import torch
    from repro_torch.core import bitplanes, ecl

    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=shape) * np.sqrt(2.0 / shape[-2]))
                         .astype(np.float32)).to(dev)
    probs = torch.from_numpy(rng.dirichlet(np.ones(16), size=shape[:-2]
                                           or None).astype(np.float32)).to(dev)
    return (w, bitplanes.init_omega_from_weights(w),
            ecl.penalty(w, probs, lam))


def check_ecl_quant(dev):
    """Phase 2, kernel 5: codes and ŵ bitwise equal to the plain version;
    returns the max abs ŵ error (0.0 when bitwise)."""
    import torch
    from repro_torch.kernels import ecl_quant as eq

    max_err = 0.0
    for i, shape in enumerate(ECL_SHAPES):
        for lam in ECL_LAMS:
            w, omega, pen = ecl_case(shape, lam, 100 + i, dev)
            codes, w_hat = eq.ecl_quant_cuda(w, omega, pen)
            want_c, want_w = eq.ecl_quant_plain(w, omega, pen)
            torch.cuda.synchronize(dev)
            if not (torch.equal(codes, want_c) and torch.equal(w_hat, want_w)):
                n = int((codes != want_c).sum())
                raise AssertionError(f"ecl_quant {shape} λ={lam}: {n} codes "
                                     "differ from the plain version")
            max_err = max(max_err, float((w_hat - want_w).abs().max()))
        max_err = max(max_err, check_ecl_group(lam, dev))
    print(f"phase 2: ecl_quant bitwise equal to its plain version at "
          f"{len(ECL_SHAPES)} shapes x λ {ECL_LAMS}, one tensor a launch and "
          "grouped in one launch")
    return max_err


def check_ecl_group(lam, dev):
    """Every MLP-GSC tensor, the odd shapes, a view at an odd offset (the
    wrapper copies it to its outputs' alignment) and a batched (3, 37, 129) with ω
    (3, 4) in one grouped launch, segment by segment bitwise equal to the
    plain version; returns the max abs ŵ error."""
    import torch
    from repro_torch.kernels import ecl_quant as eq

    cases = [ecl_case(s, lam, 500 + i, dev) for i, s in
             enumerate(GSC_LAYERS + ECL_SHAPES[-2:] + ((3, 37, 129),))]
    w, omega, pen = ecl_case((37, 129), lam, 520, dev)
    flat = torch.cat([torch.zeros(1, device=dev), w.reshape(-1)])
    cases.append((flat[1:].view(37, 129), omega, pen))
    ws, omegas, pens = (list(c) for c in zip(*cases))
    before = eq.LAUNCHES
    outs = eq.ecl_quant_many(ws, omegas, pens)
    torch.cuda.synchronize(dev)
    if eq.LAUNCHES != before + 1:
        raise AssertionError(f"{len(ws)} tensors took "
                             f"{eq.LAUNCHES - before} launches, not 1")
    max_err = 0.0
    for w, omega, pen, (codes, w_hat) in zip(ws, omegas, pens, outs):
        segs = ([(w, omega, pen, codes, w_hat)] if omega.ndim == 1 else
                zip(w, omega, pen, codes, w_hat))
        for sw, so, sp, sc, sv in segs:
            want_c, want_w = eq.ecl_quant_plain(sw, so, sp)
            if not (torch.equal(sc, want_c) and torch.equal(sv, want_w)):
                n = int((sc != want_c).sum())
                raise AssertionError(f"grouped ecl_quant {tuple(sw.shape)} "
                                     f"λ={lam}: {n} codes differ from the "
                                     "plain version")
            max_err = max(max_err, float((sv - want_w).abs().max()))
    return max_err


def train_path(dev):
    """Phase 3b: EC4T-train MLP-GSC on the card, freeze, serve."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_mlps import MLPS
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
    from repro_torch.kernels import fantastic4_matmul as fm
    from repro_torch.launch import train as T
    from repro_torch.models import mlp as M
    from repro_torch.serving.plans import ExecutionPlan

    cfg = MLPS["mlp-gsc"]
    torch.cuda.synchronize(dev)
    eq.LAUNCHES = 0
    fm.LAUNCHES = 0
    ffm.reset_launches()
    t0 = time.perf_counter()
    params, qs, bn, m = T.train_mlp(cfg, device=dev, **TRAIN)
    pack = M.freeze_mlp(params, qs, bn, lam=TRAIN["lam"])
    plan = ExecutionPlan(pack, device=dev)
    err = T.serving_check(cfg, params, qs, bn, pack, TRAIN["lam"], plan.run,
                          seed=TRAIN["seed"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = eq.LAUNCHES
    serve_launches = {"fantastic4_matmul": fm.LAUNCHES, **ffm.LAUNCHES}
    # one grouped launch per step in the forward and one in the update,
    # one per eval batch, one for stats, freeze and the serving check's
    # eval forward: a per-leaf path would launch once per tensor
    need = 2 * TRAIN["steps"] + T.EVAL_BATCHES + 3
    if launches != need:
        raise AssertionError(f"training launched ecl_quant {launches} times, "
                             f"expected exactly {need}")
    if not np.isfinite(m["losses"]).all():
        raise AssertionError("a training loss is not finite")
    if m["acc"] < TRAIN_MIN_ACC or m["entropy_bits"] > TRAIN_MAX_ENTROPY:
        raise AssertionError(f"trained MLP-GSC: acc {m['acc']} (>= "
                             f"{TRAIN_MIN_ACC}), entropy {m['entropy_bits']}"
                             f" (<= {TRAIN_MAX_ENTROPY})")

    short = dict(TRAIN, steps=CARD_VS_CPU_STEPS)
    card = T.train_mlp(cfg, device=dev, **short)[3]["losses"]
    cpu = T.train_mlp(cfg, device="cpu", **short)[3]["losses"]
    np.testing.assert_allclose(card, cpu, rtol=CARD_VS_CPU_RTOL)
    card_vs_cpu = float(np.max(np.abs(np.subtract(card, cpu))
                               / np.abs(cpu)))
    print(f"phase 3b: trained {TRAIN['steps']} steps, acc {m['acc']:.4f}, "
          f"entropy {m['entropy_bits']:.4f}; served within {SERVE_TOL}; "
          f"card vs CPU losses within {CARD_VS_CPU_RTOL}")
    return pack, {"arch": cfg.name, "batch": T.BATCH, **TRAIN,
            "ms_per_step": m["ms_per_step"], "wall_s": wall_s,
            "final_loss": m["losses"][-1], "acc": m["acc"],
            "sparsity": m["sparsity"], "entropy_bits": m["entropy_bits"],
            "ecl_quant_launches": launches,
            "serve_launches": serve_launches,
            "serve_max_abs_err": err,
            "card_vs_cpu_losses": {"card": card, "cpu": cpu,
                                   "max_rel": card_vs_cpu}}


def _time_ms(fn, dev, iters):
    """ms per call over back-to-back calls: the least of TIME_REPEATS
    blocks of ``iters`` calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(TIME_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _queued_ms(fn, dev, iters):
    """Device ms per call with every launch queued ahead: a spin kernel
    holds the stream while the host enqueues the calls, so the time between
    the two events is the device's alone (launch gaps on the device
    included, host work not).  Raises if the spin ended before the host had
    enqueued everything."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_done = torch.cuda.Event()
    torch.cuda._sleep(SPIN_CYCLES)
    spin_done.record()
    start.record()
    for _ in range(iters):
        fn()
    # the spin must still hold the stream once every call is queued, or
    # host gaps would fall between the events
    if spin_done.query():
        raise AssertionError("the host fell behind the queued launches")
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def _trace(fn, dev, iters):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(dev)
    TRACES["taken"] += 1
    return prof.key_averages()


def _kernel_us(evt):
    return (getattr(evt, "self_device_time_total", 0.0)
            or getattr(evt, "self_cuda_time_total", 0.0))


def _is_kernel(evt):
    return "CUDA" in str(getattr(evt, "device_type", ""))


def _retrace(attempt):
    """A trace came back without the device time sought: count it and
    wait a little longer each time before the next."""
    TRACES["retried"] += 1
    time.sleep(0.5 * (attempt + 1))


def _device_time(fn, dev, iters, symbol=None, key="device_ms",
                 launches=None):
    """Device time per call as ``{key: ms, key + "_from": source}``.  From
    torch.profiler traces (source ``"trace"``): the CUDA function
    ``symbol``'s time, or with no symbol every kernel's (the library
    yardstick's many small kernels).  ``launches`` reads the wrapper's
    launch count: a trace must then hold one record of ``symbol`` for
    every launch it made.  A trace now and then comes back with no device
    event at all, or with too few of the kernel's records; such a trace
    is taken again, up to TRACE_TRIES times, and if none is whole the
    time comes from CUDA events with the calls queued behind a spin
    kernel (``_queued_ms``, source ``"queued_events"``).  The run fails
    when traces have device events but never the kernel's."""
    lost_only = True
    for attempt in range(TRACE_TRIES):
        before = launches() if launches else 0
        evts = _trace(fn, dev, iters)
        # _trace calls fn once more, untraced, before its iters
        want = ((launches() - before) // (iters + 1) * iters
                if launches else None)
        kernels = [e for e in evts if _is_kernel(e)]
        mine = [e for e in kernels if symbol is None or symbol in e.key]
        total_us = sum(_kernel_us(e) for e in mine)
        got = sum(e.count for e in mine)
        if total_us > 0 and want in (None, got):
            return {key: total_us / 1e3 / iters, f"{key}_from": "trace"}
        lost_only = lost_only and (bool(mine) or not kernels)
        print(f"trace without the device time of {symbol or 'fn'!r}: "
              f"{got} of its records (launched {want}); its kernels: "
              f"{sorted({e.key[:80] for e in kernels})}, host events "
              f"{len(evts) - len(kernels)}", file=sys.stderr)
        _retrace(attempt)
    if not lost_only:
        raise AssertionError(f"no device time for {symbol!r} in "
                             f"{TRACE_TRIES} traces")
    TRACES["events"] += 1
    print(f"no whole trace of {symbol!r} in {TRACE_TRIES}; its device time "
          "from CUDA events (queued calls)", file=sys.stderr)
    return {key: _queued_ms(fn, dev, iters), f"{key}_from": "queued_events"}


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
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
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

    from repro_torch.kernels import fantastic4_matmul as fm

    out = {name: {} for name in KERNELS}
    grid = []
    for batch in BATCHES:
        x = torch.from_numpy(np.random.default_rng(batch).normal(
            size=(batch, GSC_DIMS[0])).astype(np.float32)).to(dev)
        iters = 50 if batch <= 64 else 20
        lib_ms = _time_ms(lambda: library(x), dev, iters)
        lib_dev = _device_time(lambda: library(x), dev, 10,
                               key="library_device_ms")
        b_ms, b_by = bound(batch, GSC_DIMS)
        for name, (sched, _) in KERNELS.items():
            row = {
                "ms": _time_ms(lambda: s.kernel(name, x), dev, iters),
                **_device_time(lambda: s.kernel(name, x), dev, 10,
                               SYMBOLS[sched]),
                "queued_ms": _queued_ms(lambda: s.kernel(name, x), dev, 20),
                "plain_ms": _time_ms(lambda: s.plain(name, x), dev, iters),
                "library_ms": lib_ms, **lib_dev,
                "library_queued_ms": _queued_ms(lambda: library(x), dev, 20),
                "bound_ms": b_ms, "bound_by": b_by}
            if sched == "chain":
                fm.LAST_LAUNCHES = []
                try:
                    s.kernel(name, x)
                    grid.append({"schedule": sched, "batch": batch,
                                 "kernel": SYMBOLS[sched],
                                 "launches": fm.LAST_LAUNCHES})
                finally:
                    fm.LAST_LAUNCHES = None
            elif sched == "stream":
                ffm.LAST_LAUNCH.clear()
                s.kernel(name, x)
                grid.append({"schedule": sched, "batch": batch,
                             "kernel": SYMBOLS[sched],
                             **ffm.LAST_LAUNCH["stream"]})
            if sched in CLUSTER_SCHEDULES:
                wide, launch16 = _wide_cluster(s, name, x, dev)
                row.update(wide)
                ffm.LAST_LAUNCH.clear()
                s.kernel(name, x)
                (kind, launch), = ffm.LAST_LAUNCH.items()
                grid.append({"schedule": sched, "batch": batch,
                             "kernel": kind, **launch,
                             "cluster16": launch16})
            out[name][batch] = row
    return out, grid


def _wide_cluster(s, name, x, dev):
    """Device ms of a cluster schedule at WIDE_CLUSTER CTAs per cluster,
    after checking its output equals the default size's bit for bit (the
    same sums in the same order)."""
    import torch
    from repro_torch.kernels import fantastic4_fused_mlp as ffm

    want = s.kernel(name, x)
    ffm.LAST_LAUNCH.clear()
    got = s.cluster_kernel(name, x, WIDE_CLUSTER)
    torch.cuda.synchronize(dev)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} at cluster {WIDE_CLUSTER} differs from "
                             f"cluster {ffm.CLUSTER}")
    (_, launch), = ffm.LAST_LAUNCH.items()
    return _device_time(lambda: s.cluster_kernel(name, x, WIDE_CLUSTER),
                        dev, 10, SYMBOLS[KERNELS[name][0]],
                        key="device_ms_cluster16"), launch


def contract_floor(dev):
    """The dependent-FMA floor of one MLP-GSC output: sum K_l FMAs of
    FMA_LATENCY cycles at the SM clock nvidia-smi reports under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    sm, sm_max = (float(v) for v in out.stdout.strip().splitlines()[0]
                  .split(","))
    chain = sum(k for k, _ in GSC_LAYERS)
    return {"sum_k": chain, "fma_latency_cycles": FMA_LATENCY,
            "sm_clock_mhz": sm, "sm_clock_max_mhz": sm_max,
            "floor_ms_at_max_clock": chain * FMA_LATENCY / (sm_max * 1e3)}


def ecl_timings(dev):
    """Phase 4, kernel 5 (λ 0.3): every MLP-GSC layer shape one tensor a
    launch, their sum over the stack's seven layers, and the seven tensors
    in one grouped launch."""
    from repro_torch.kernels import ecl_quant as eq

    def row(fn, plain, n, iters):
        return {"ms": _time_ms(fn, dev, iters),
                **_device_time(fn, dev, 50, ECL_SYMBOL,
                               launches=lambda: eq.LAUNCHES),
                "queued_ms": _queued_ms(fn, dev, 50),
                "plain_ms": _time_ms(plain, dev, 20), "library_ms": None,
                "bound_ms": ECL_BYTES_PER_ELEM * n / PEAK_BYTES * 1e3,
                "bound_by": "bytes"}

    out = {}
    cases = {shape: ecl_case(shape, 0.3, 200 + i, dev)
             for i, shape in enumerate(dict.fromkeys(GSC_LAYERS))}
    for shape, (w, omega, pen) in cases.items():
        out[f"{shape[0]}x{shape[1]}"] = row(
            lambda: eq.ecl_quant_cuda(w, omega, pen),
            lambda: eq.ecl_quant_plain(w, omega, pen),
            shape[0] * shape[1], 200)
    per_layer = [out[f"{k}x{n}"] for k, n in GSC_LAYERS]
    whole = {key: sum(r[key] for r in per_layer)
             for key in ("ms", "device_ms", "queued_ms", "plain_ms",
                         "bound_ms")}
    whole["device_ms_from"] = "+".join(sorted(
        {r["device_ms_from"] for r in per_layer}))
    group = [cases[shape] for shape in GSC_LAYERS]
    before = eq.LAUNCHES
    for c in group:
        eq.ecl_quant_cuda(*c)
    out["mlp-gsc all 7 layers"] = {**whole, "library_ms": None,
                                   "bound_by": "bytes",
                                   "launches_per_call": eq.LAUNCHES - before}
    ws, omegas, pens = (list(c) for c in zip(*group))
    n = sum(w.numel() for w in ws)
    before = eq.LAUNCHES
    eq.ecl_quant_many(ws, omegas, pens)
    launches = eq.LAUNCHES - before
    grouped = row(lambda: eq.ecl_quant_many(ws, omegas, pens),
                  lambda: [eq.ecl_quant_plain(*c) for c in group], n, 100)
    out["mlp-gsc 7 tensors grouped"] = {**grouped, "elements": n,
                                        "launches_per_call": launches}
    return out


def train_step_timing(dev):
    """Phase 4: one MLP-GSC train step at batch 128, CUDA events over
    back-to-back steps, and the device time by kernel from a trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.paper_mlps import MLPS
    from repro_torch.core import qat
    from repro_torch.launch import train as T
    from repro_torch.models import mlp as M
    from repro_torch.optim import adam

    cfg = MLPS["mlp-gsc"]
    params, bn = M.mlp_init(cfg, seed=1, device=dev)
    st = [params, qat.build_qstate(params), bn, adam.init(params)]
    x, labels = T.batch_tensors(T.data_cfg(cfg, 0), 0, dev)

    def step():
        st[:] = T.train_step(*st, x, labels, TRAIN["lam"],
                             lr=TRAIN["lr"])[:4]
    ms = _time_ms(step, dev, 50)
    steps = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches, host = {}, 0, {}
    for evt in prof.key_averages():
        if "CUDA" in str(getattr(evt, "device_type", "")):
            t = (getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))
            kernels[evt.key] = kernels.get(evt.key, 0.0) + t / 1e3 / steps
            launches += evt.count
        elif evt.key.startswith("aten::"):
            host[evt.key] = evt.self_cpu_time_total / 1e3 / steps
    device_ms = sum(kernels.values())
    ecl_ms = sum(v for k, v in kernels.items() if ECL_SYMBOL in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    return {"ms": ms, "traced_wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms,
            "ecl_quant_device_ms_per_step": ecl_ms,
            "device_idle_share": 1.0 - device_ms / ms,
            "device_ops_per_step": launches / steps,
            "top_device_ms": [[k[:90], v] for k, v in top],
            "top_host_self_ms": [[k, v] for k, v in top_host]}


# ------------------------------------------------------------ phase 3c

FRONTEND_ARCHS = ("mlp-gsc", "mlp-hr", "lenet-300-100")   # seeds 100, 101, 102
COLD_ROWS = (1, 8, 64, 256)
HOT_MAX, HOT_ROUNDS, HOT_MIN_EVICTIONS = 2, 8, 20
FRONTEND = dict(requests=2000, max_rows=64, wave=64, streams=2,
                scrub_s=0.05)
TIERS = {"mlp-gsc": "latency", "mlp-hr": "standard",
         "lenet-300-100": "latency", "mlp-gsc-trained": "standard"}
# the fault session: mlp-hr behind a FaultInjector; seed 939 draws flips
# into the pack at launches 5, 11 and 21 and into the copies the kernels
# read at 10 and 14, injected failures at 7 and 12, and the first cold
# flip at launch 28 (the draws depend on the launch count only)
FAULT = dict(model="mlp-hr", seed=939, rate=0.05, flip_rate=0.1,
             waves=60, per_wave=4, max_rows=16, scrub_s=0.02)
COOP_ROWS, COOP_LAUNCHES = (8, 256), 40
VERIFY_REPS = 20


def plan_kwargs(shapes):
    """Each model of phase 3c takes a schedule of its own, so the frontend
    launches every kernel: mlp-gsc auto (ws ≤ 8 rows, batch_tiled above),
    mlp-hr double-buffered (db from 16 rows), LeNet-300-100 under a
    shared-memory budget only the stream kernel fits, and the trained
    MLP-GSC on the per-layer chain."""
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
    from repro_torch.serving.plans import STREAM_BLOCK_M

    return {
        "mlp-gsc": {},
        "mlp-hr": {"double_buffer": True},
        "lenet-300-100": {"smem_budget_bytes": ffm.stream_mlp_smem_bytes(
            shapes["lenet-300-100"], rows=256, block_m=STREAM_BLOCK_M)
            + 1024},
        "mlp-gsc-trained": {"mode": "per_layer"},
    }


def frontend_packs(dev, trained):
    """The paper MLPs frozen from seeds, and the trained MLP-GSC pack after
    an export_pack -> load_pack(verify=True) round trip on disk."""
    import tempfile
    from repro_torch.checkpoint.manager import export_pack, load_pack
    from repro_torch.configs.paper_mlps import MLPS
    from repro_torch.core import qat
    from repro_torch.models import mlp as M
    from repro_torch.serving.pack_cache import decode_pack

    packs = {}
    for i, arch in enumerate(FRONTEND_ARCHS):
        cfg = MLPS[arch]
        params, bn = M.mlp_init(cfg, seed=100 + i, device=dev)
        packs[arch] = M.freeze_mlp(params, qat.build_qstate(params), bn,
                                   lam=cfg.lam)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mlp-gsc-trained")
        report = export_pack(path, trained, meta={"arch": "mlp-gsc"})
        packs["mlp-gsc-trained"] = decode_pack(load_pack(path, verify=True),
                                               dev)
    return packs, report


def _x(rows, d, seed):
    import numpy as np
    return np.random.default_rng(seed).normal(size=(rows, d)).astype(
        np.float32)


def cold_tier(dev, packs, kw, trained):
    """compress_pack -> decode_pack of every pack, served at COLD_ROWS:
    bitwise equal to the original pack, CRCs equal; the trained pack read
    back from disk serves what the trained pack serves, bit for bit."""
    import torch
    from repro_torch.runtime.integrity import hot_layer_crc
    from repro_torch.serving.pack_cache import compress_pack, decode_pack
    from repro_torch.serving.plans import ExecutionPlan

    out = {}
    pairs = dict(packs, **{"mlp-gsc-trained (from disk)": None})
    for name in pairs:
        m = name.split(" ")[0]
        orig = trained if pairs[name] is None else packs[m]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if pairs[name] is None:
            dec = packs[m]                  # decoded from the artifact
            cold = None
        else:
            cold = compress_pack(orig)
            dec = decode_pack(cold, dev)
        plan_d = ExecutionPlan(dec, device=dev, **kw[m])
        torch.cuda.synchronize(dev)
        decode_ms = (time.perf_counter() - t0) * 1e3
        plan_o = ExecutionPlan(orig, device=dev, **kw[m])
        for rows in COLD_ROWS:
            x = torch.from_numpy(_x(rows, plan_o.d_in, rows)).to(dev)
            if not torch.equal(plan_d.run(x), plan_o.run(x)):
                raise AssertionError(f"{name}: decoded pack serves other "
                                     f"bits than the original at {rows} rows")
        want = [hot_layer_crc(l) for l in orig["layers"]]
        got = [l["crc"] for l in dec["layers"]]
        if got != want or [hot_layer_crc(l) for l in dec["layers"]] != want:
            raise AssertionError(f"{name}: CRCs {got} != {want}")
        out[name] = {"decode_and_plan_ms": decode_ms,
                     "formats": [l["format"] for l in dec["layers"]]}
        if cold is not None:
            out[name].update(cold_bytes=cold.size_bytes,
                             fp32_bytes=cold.fp32_bytes)
    print(f"phase 3c: cold tier bitwise at rows {COLD_ROWS} for "
          f"{len(out)} packs; CRCs equal")
    return out


def footprint(plan):
    """Device bytes of a resolved plan: its layer tensors and every
    memoized kernel operand built from them (``ops.pack_operand_bytes``:
    slice-major code copies, ws stacks, layer tables, folded int8
    epilogues), each storage once, in the allocator's 512-byte blocks."""
    from repro_torch.kernels import ops

    own = {}
    for l in plan.layers:
        for k in ("packed", "omega", "alpha1", "bias", "alpha2"):
            st = l[k].untyped_storage()
            own[st.data_ptr()] = st.nbytes()
    return (sum(-(-n // 512) * 512 for n in own.values())
            + ops.pack_operand_bytes(plan.layers))


def hot_tier(dev, packs, kw):
    """PackCache(max_hot=2) over the four packs, round robin: every
    request after the first two evicts.  Every result after a reload is
    bitwise equal to the model's first result, and device memory after the
    script is back at its level after the first load, within one pack's
    footprint (plan tensors + memoized operands)."""
    import gc
    import torch
    from repro_torch.serving.pack_cache import PackCache, plan_resident_bytes

    gc.collect()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    cache = PackCache(max_hot=HOT_MAX, device=dev)
    for m, p in packs.items():
        cache.add(m, p, plan_kwargs=kw[m])
    xs = {m: torch.from_numpy(_x(7, p["layers"][0]["shape"][0], 5)).to(dev)
          for m, p in packs.items()}
    first, feet, resident = {}, {}, {}
    mem_first = None
    for j, m in enumerate(list(packs) * HOT_ROUNDS):
        plan = cache.plan(m)
        y = plan.run(xs[m])
        torch.cuda.synchronize(dev)
        feet[m] = max(feet.get(m, 0), footprint(plan))
        resident[m] = plan_resident_bytes(plan)
        del plan
        if mem_first is None:
            gc.collect()
            mem_first = torch.cuda.memory_allocated(dev)
        if m not in first:
            first[m] = y
        elif not torch.equal(y, first[m]):
            raise AssertionError(f"hot tier: {m} after a reload differs "
                                 "from before its eviction")
    del y
    gc.collect()
    torch.cuda.synchronize(dev)
    mem_after = torch.cuda.memory_allocated(dev)
    evictions = cache.stats["evictions"]
    allow = max(feet.values())
    if evictions < HOT_MIN_EVICTIONS:
        raise AssertionError(f"hot tier: {evictions} evictions, need "
                             f">= {HOT_MIN_EVICTIONS}")
    if mem_after - mem_first > allow:
        raise AssertionError(f"hot tier: memory {mem_after} after the "
                             f"script, {mem_first} after the first load: "
                             f"more than one pack's {allow} bytes apart")
    cache.evict_all()
    gc.collect()
    torch.cuda.synchronize(dev)
    mem_empty = torch.cuda.memory_allocated(dev)
    if mem_empty - base > allow:
        raise AssertionError(f"hot tier: {mem_empty - base} bytes stay "
                             "allocated with every plan evicted")
    print(f"phase 3c: hot tier {evictions} evictions, reloads bitwise; "
          f"memory {mem_after - base} B above base after the script "
          f"({mem_first - base} B after the first load, allowance "
          f"{allow} B), {mem_empty - base} B with every plan evicted")
    return {"max_hot": HOT_MAX, "requests": len(packs) * HOT_ROUNDS,
            "evictions": evictions, "resolves": cache.stats["resolves"],
            "decode_and_plan_ms_mean": 1e3 * float(
                sum(cache.stats["cold_start_s"])
                / max(len(cache.stats["cold_start_s"]), 1)),
            "mem_base": base, "mem_after_first_load": mem_first,
            "mem_after_script": mem_after, "mem_all_evicted": mem_empty,
            "allowance_bytes": allow, "footprint_bytes": feet,
            "plan_resident_bytes": resident}


def coop_probe(dev, pack):
    """Two stream-schedule launches in flight on two CUDA streams: device
    ms of 2n launches on one stream against n + n on two streams that
    start behind one event, launched without the cross-stream order (the
    card's own behaviour: the kernel's launch alone) and with it (what
    serving does); outputs must stay bitwise equal."""
    import torch
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
    from repro_torch.kernels import ops

    layers = pack["layers"]
    shapes = tuple(tuple(l["shape"]) for l in layers)

    def launch(x):
        return ops.fantastic4_mlp_fused(x, layers, schedule="stream",
                                        block_m=8)

    table = ops._layer_table(layers, "float32", None, "stream")

    def unordered(x):
        return ffm._stream_kernel(x, shapes, 8, table, ffm.SMEM_BUDGET_BYTES)

    out = {}
    s0, s1, s2 = (torch.cuda.Stream(dev) for _ in range(3))
    for rows in COOP_ROWS:
        x = torch.from_numpy(_x(rows, layers[0]["shape"][0], 9)).to(dev)
        want = launch(x)
        row = {"ctas": None}
        for key, fn in (("unordered", unordered), ("ordered", launch)):
            times = {}
            for split in (1, 2):
                torch.cuda.synchronize(dev)
                gate = torch.cuda.Event(enable_timing=True)
                spin_done = torch.cuda.Event()
                with torch.cuda.stream(s0):
                    torch.cuda._sleep(SPIN_CYCLES)
                    spin_done.record()
                    gate.record()
                ends, ys = [], []
                for st in ((s1,) if split == 1 else (s1, s2)):
                    st.wait_event(gate)
                    with torch.cuda.stream(st):
                        for _ in range(2 * COOP_LAUNCHES // split):
                            ys.append(fn(x))
                        e = torch.cuda.Event(enable_timing=True)
                        e.record()
                        ends.append(e)
                if spin_done.query():
                    raise AssertionError("the host fell behind the "
                                         "queued stream launches")
                torch.cuda.synchronize(dev)
                times[split] = max(gate.elapsed_time(e) for e in ends) \
                    / (2 * COOP_LAUNCHES)
                if not all(torch.equal(y, want) for y in ys):
                    raise AssertionError("stream schedule on two "
                                         "streams changed its output")
            row[f"ms_one_stream_{key}"] = times[1]
            row[f"ms_two_streams_{key}"] = times[2]
            row[f"two_over_one_{key}"] = times[2] / times[1]
        ffm.LAST_LAUNCH.clear()
        launch(x)
        row["ctas"] = ffm.LAST_LAUNCH["stream"]["ctas"]
        out[str(rows)] = row
    return out


def _served_checks(dev, packs, kw, done):
    """Every served result within the fp32 gate of the oracle and bitwise
    equal to the same request served alone through the model's plan."""
    import numpy as np
    import torch
    from repro_torch.serving.plans import ExecutionPlan

    alone = {m: ExecutionPlan(p, device=dev, **kw[m]) for m, p in
             packs.items()}
    oracle = {m: ExecutionPlan(p, mode="oracle", device=dev) for m, p in
              packs.items()}
    for m, x, s in done:
        xt = torch.from_numpy(x).to(dev)
        y_alone = alone[m].run(xt).cpu().numpy()
        if s.y.shape != y_alone.shape or not np.array_equal(s.y, y_alone):
            raise AssertionError(f"frontend {m}: a served result differs "
                                 "from the request served alone")
        np.testing.assert_allclose(s.y, oracle[m].run(xt).cpu().numpy(),
                                   atol=FP32_ATOL, rtol=FP32_RTOL)


def _drain(futs, allowed):
    """(served, rejected) of the futures; every one must resolve, and a
    failure only with a typed cause from ``allowed``."""
    served, rejected = [], []
    for m, x, f in futs:
        try:
            served.append((m, x, f.result(120.0)))
        except allowed as exc:
            rejected.append((m, type(exc).__name__,
                             getattr(exc, "reason", None)))
    return served, rejected


def _pcts(vals):
    import numpy as np
    return ({"p50_ms": float(np.percentile(vals, 50)) * 1e3,
             "p99_ms": float(np.percentile(vals, 99)) * 1e3}
            if vals else {"p50_ms": None, "p99_ms": None})


def frontend_session(dev, packs, kw):
    """ServingFrontend(streams=2) with verify_launch and a scrubber over
    the four models, two tiers, FRONTEND['requests'] ragged requests of
    1-64 rows in waves; launch counters zeroed just before, read after."""
    import numpy as np
    import torch
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
    from repro_torch.kernels import fantastic4_matmul as fm
    from repro_torch.kernels import staged
    from repro_torch.runtime.integrity import (GuardedPlan, entry_layers,
                                               unwrap_chain)
    from repro_torch.serving import (PackCache, Rejected, ServingFrontend)

    rng = np.random.default_rng(33)
    names = list(packs)
    reqs = [(m, rng.normal(size=(int(rng.integers(1, FRONTEND["max_rows"]
                                                  + 1)),
                                 packs[m]["layers"][0]["shape"][0]))
             .astype(np.float32))
            for m in (names[int(i)] for i in
                      rng.integers(0, len(names), FRONTEND["requests"]))]
    cache = PackCache(device=dev)
    fe = ServingFrontend(cache=cache, streams=FRONTEND["streams"],
                         scrub_interval_s=FRONTEND["scrub_s"])
    batchers = {m: fe.register_pack(m, packs[m], plan_kwargs=kw[m],
                                    integrity=True, tier=TIERS[m])
                for m in names}
    torch.cuda.synchronize(dev)
    mem_before = torch.cuda.memory_allocated(dev)
    fm.LAUNCHES = 0
    ffm.reset_launches()
    with fe:
        # first traffic decodes each model and builds its operands
        _drain([(m, None, fe.submit(m, _x(1, packs[m]["layers"][0]
                                          ["shape"][0], 0)))
                for m in names], (Rejected,))
        t0 = time.perf_counter()
        done, rejected = [], []
        for w in range(0, len(reqs), FRONTEND["wave"]):
            futs = [(m, x, fe.submit(m, x))
                    for m, x in reqs[w:w + FRONTEND["wave"]]]
            d, r = _drain(futs, (Rejected,))
            done += d
            rejected += r
        wall_s = time.perf_counter() - t0
        verify_idle, verify_busy, verify_launch = {}, {}, {}
        for m in names:
            guard = next(p for p in unwrap_chain(batchers[m].plan)
                         if isinstance(p, GuardedPlan))
            # the verifies while serving ran beside the other stream's
            # launches, the dispatch thread and the scrubber
            verify_busy[m] = 1e3 * guard.stats["verify_s"] / max(
                guard.stats["verifies"], 1)
            t1 = time.perf_counter()
            for _ in range(VERIFY_REPS):
                guard.verify()          # every sealed copy, as a scrub
            verify_idle[m] = (time.perf_counter() - t1) * 1e3 / VERIFY_REPS
            # a launch's verify: the pack and the copies one launch of the
            # top bucket read
            plan = guard.plan.resolve()
            top = max(plan.bucket_sizes)
            fn = plan.entry(top)
            with staged.reads() as read:
                fn(torch.zeros((top, plan.d_in), device=dev))
            t1 = time.perf_counter()
            for _ in range(VERIFY_REPS):
                guard.verify(entry_layers(fn), read)
            verify_launch[m] = (time.perf_counter() - t1) * 1e3 / VERIFY_REPS
        scrub_ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            rep = fe.scrub_once()
            scrub_ms.append((time.perf_counter() - t1) * 1e3)
            if rep["detected"]:
                raise AssertionError(f"scrub found corruption: {rep}")
    torch.cuda.synchronize(dev)
    launches = {"fantastic4_matmul": fm.LAUNCHES,
                **{n: ffm.LAUNCHES[s] for n, (s, _) in KERNELS.items()
                   if s != "chain"}}
    mem_after = torch.cuda.memory_allocated(dev)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the frontend never launched {name}: "
                                 f"{launches}")
    if len(done) + len(rejected) != len(reqs):
        raise AssertionError("a request was lost")
    if len(done) < len(reqs) // 2:
        raise AssertionError(f"only {len(done)} of {len(reqs)} served")
    if fe.stats["quarantined"] or fe.stats["launch_failures"]:
        raise AssertionError(f"clean session failed launches: "
                             f"{fe.stats['launch_failures']}, quarantined "
                             f"{fe.stats['quarantined']}")
    _served_checks(dev, packs, kw, done)
    per = {}
    for m in names:
        guard = next(p for p in unwrap_chain(batchers[m].plan)
                     if isinstance(p, GuardedPlan))
        gs = guard.stats
        st = fe.stats["by_model"][m]
        per[m] = {"tier": TIERS[m], "requests": st["requests"],
                  "served": sum(1 for d in done if d[0] == m),
                  "rejected": st["rejected"], "launches": st["launches"],
                  "flushes": batchers[m].stats["flushes"],
                  "rows": batchers[m].stats["rows"],
                  **_pcts([s.latency for mm, _, s in done if mm == m]),
                  "verifies": gs["verifies"],
                  "verify_ms_serving": verify_busy[m],
                  "verify_ms_idle": verify_idle[m],
                  "launch_verify_ms_idle": verify_launch[m],
                  "schedules": sorted(set(
                      cache.plan(m).describe()["bucket_schedules"]
                      .values()))}
    print(f"phase 3c: frontend served {len(done)} of {len(reqs)} ragged "
          f"requests ({len(rejected)} rejected, typed) on "
          f"{FRONTEND['streams']} streams in {wall_s:.2f} s; launches "
          f"{launches}")
    return {"streams": FRONTEND["streams"], "requests": len(reqs),
            "served": len(done), "rejected": len(rejected),
            "rejected_reasons": sorted({r[2] for r in rejected if r[2]}),
            "wall_s": wall_s, "launches": launches,
            "stream_launches": [s["launches"]
                                for s in fe.stats["streams"]],
            "scrub_cycle_ms": scrub_ms,
            "scrub_background_cycles": fe.stats["scrub"]["cycles"],
            "scrub_deferred": fe.stats["scrub"]["deferred"],
            "mem_before": mem_before, "mem_after": mem_after,
            "models": per}


class LaunchAudit:
    """Outermost proxy on the fault session's model: for each launch, the
    fault injector's index of it, the layers it ran on, the sealed copies
    it read (``kernels.staged``) and how it ended -- "returned",
    "detected" (an IntegrityError), "failed" (an injected failure: no
    kernel ran) or "error"."""

    def __init__(self, plan, injector):
        import threading

        self._plan = plan
        self.injector = injector
        self.lock = threading.Lock()
        self.launches = {}

    @property
    def plan(self):
        return self._plan

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def _audit(self, call, layers):
        from repro_torch.kernels import staged
        from repro_torch.runtime.fault import InjectedFault
        from repro_torch.runtime.integrity import IntegrityError

        before = self.injector.last_launch()
        outcome = "returned"
        with staged.reads() as read:
            try:
                return call()
            except IntegrityError:
                outcome = "detected"
                raise
            except InjectedFault:
                outcome = "failed"
                raise
            except Exception:
                outcome = "error"
                raise
            finally:
                idx = self.injector.last_launch()
                if idx is not None and idx != before:
                    with self.lock:
                        self.launches[idx] = (layers, list(read), outcome)

    def entry(self, bucket):
        from repro_torch.runtime.integrity import entry_layers

        inner = self._plan.entry(bucket)
        layers = entry_layers(inner)

        def audited(xb):
            return self._audit(lambda: inner(xb), layers)

        audited.layers = layers
        return audited

    def run(self, x):
        return self._audit(lambda: self._plan.run(x), self._plan.layers)


def flip_audit(injector, audit):
    """Each hot flip against the launches that ran on it.  A "packed" or
    "epilogue" flip (or a "staged" one that landed in a pack's own codes)
    corrupts the layers of the launch it came with; a "staged" flip the
    sealed copy of those layers that it landed in (the copy of that name
    whose bytes no longer match their seal).  A launch at or after the
    flip that ran a kernel on the corrupted object must have raised
    IntegrityError.  Returns (flips whose own launch ran on them, of those
    detected by that launch, later launches that ran on a flip, escapes:
    launches that returned a result from a corrupted object)."""
    from repro_torch.runtime.integrity import live_crcs

    def corrupt(s):
        return tuple(live_crcs([], [s])[1]) != s.seal

    own = own_detected = later = 0
    escapes = []
    for flip in injector.flips:
        i, target, _, what = flip[:4]
        if target == "cold":
            continue
        if i not in audit.launches:
            raise AssertionError(f"flip {flip}: launch {i} not audited")
        layers = audit.launches[i][0]
        if target == "staged" and not what.endswith("packed"):
            bad = {id(s) for _, (l, reads, _) in audit.launches.items()
                   if l is layers for s in reads
                   if s.what == what and corrupt(s)}

            def ran_on(rec, bad=bad):
                return any(id(s) in bad for s in rec[1])
        else:
            def ran_on(rec, layers=layers):
                return rec[0] is layers
        for j, rec in sorted(audit.launches.items()):
            if j < i or rec[2] == "failed" or not ran_on(rec):
                continue
            if j == i:
                own += 1
                own_detected += rec[2] == "detected"
            else:
                later += 1
            if rec[2] == "returned":
                escapes.append((flip, j))
    return own, own_detected, later, escapes


def fault_session(dev, packs, kw):
    """One model behind a FaultInjector (launch failures, hot and cold
    flips) with verify_launch and a scrubber, beside a clean model.  No
    returned result may differ from the clean pack's; every flip is
    accounted for; recovery is bitwise."""
    import numpy as np
    import torch
    from repro_torch.runtime.fault import FaultInjector, InjectedFault
    from repro_torch.runtime.integrity import (GuardedPlan, IntegrityError,
                                               unwrap_chain)
    from repro_torch.serving import (PackCache, Rejected, ServingFrontend,
                                     verify_cold_pack)

    fm_name, clean = FAULT["model"], "lenet-300-100"
    holder = {}

    def wrap(p):
        holder["inj"] = FaultInjector(
            p, rate=FAULT["rate"], seed=FAULT["seed"],
            flip_rate=FAULT["flip_rate"],
            flip_targets=("packed", "epilogue", "staged", "cold"))
        return holder["inj"]

    fe = ServingFrontend(cache=PackCache(device=dev), streams=2,
                         scrub_interval_s=FAULT["scrub_s"])
    fb = fe.register_pack(fm_name, packs[fm_name], plan_kwargs=kw[fm_name],
                          wrap=wrap, integrity=True, max_delay=1e-3)
    fe.register_pack(clean, packs[clean], plan_kwargs=kw[clean],
                     integrity=True, max_delay=1e-3)
    inj = holder["inj"]
    guard = next(p for p in unwrap_chain(fb.plan)
                 if isinstance(p, GuardedPlan))
    fb.plan = audit = LaunchAudit(fb.plan, inj)
    cold_ref = fe.registry.cache.cold(fm_name)
    rng = np.random.default_rng(44)
    done, rejected = [], []
    with fe:
        for _ in range(FAULT["waves"]):
            futs = []
            for m in (fm_name, clean):
                for _ in range(FAULT["per_wave"]):
                    x = rng.normal(size=(int(rng.integers(
                        1, FAULT["max_rows"] + 1)),
                        packs[m]["layers"][0]["shape"][0])).astype(
                            np.float32)
                    futs.append((m, x, fe.submit(m, x)))
            d, r = _drain(futs, (Rejected, IntegrityError, InjectedFault))
            done += d
            rejected += r
        final_scrub = fe.scrub_once()
    quarantined = fm_name in fe.stats["quarantined"]
    hot = [f for f in inj.flips if f[1] != "cold"]
    cold = [f for f in inj.flips if f[1] == "cold"]
    it = fe.stats["integrity"]
    if any(m == clean for m, _, _ in rejected):
        raise AssertionError(f"the clean model lost requests: {rejected}")
    if not hot or not cold or not inj.failures:
        raise AssertionError(f"fault schedule did not fire: flips "
                             f"{inj.flips}, failures {inj.failures}")
    own, own_detected, later, escapes = flip_audit(inj, audit)
    if escapes:
        raise AssertionError(f"results returned from corrupted operands "
                             f"(flip, launch): {escapes}")
    if own < 1 or own_detected != own:
        raise AssertionError(f"{own} hot flips ran on by their own launch, "
                             f"{own_detected} detected there")
    if guard.stats["detected"] < own_detected:
        raise AssertionError(f"guard detections {guard.stats['detected']}"
                             f" < {own_detected} flips detected at launch")
    if it["recovered"] < 1 or \
            it["recovered"] != it["detected"] - it["recovery_failed"]:
        raise AssertionError(f"recovered {it['recovered']}, expected "
                             f"detected {it['detected']} - refused "
                             f"{it['recovery_failed']}")
    # every cold flip is caught: the model is quarantined as corrupted,
    # and its cold copy really fails verification
    try:
        verify_cold_pack(cold_ref)
        cold_real = False
    except IntegrityError:
        cold_real = True
    if not (quarantined and cold_real and
            fe._quarantine_reasons.get(fm_name) == "corrupted"):
        raise AssertionError(f"cold flip not caught: quarantined "
                             f"{quarantined}, cold fails {cold_real}, "
                             f"reasons {fe._quarantine_reasons}")
    if fe.stats["fallbacks"]:
        raise AssertionError("a fault demoted a bucket in the fault session")
    _served_checks(dev, packs, kw, done)
    n_fault = sum(1 for m, _, _ in done if m == fm_name)
    print(f"phase 3c: faults {len(hot)} hot and {len(cold)} cold flips, "
          f"{inj.injected} launch failures; {own} hot flips ran on by "
          f"their own launch, {own_detected} detected there (expected "
          f"{own}); {later} later launches ran on a flip, 0 returned; "
          f"guard detections {guard.stats['detected']} (expected >= "
          f"{own_detected}); {it['detected']} detected, "
          f"{it['recovered']} recovered bitwise (expected "
          f"{it['detected']} - {it['recovery_failed']} refused: corrupt "
          f"cold tier); {n_fault} faulty-model results all equal to the "
          f"clean pack's")
    return {"model": fm_name, "seed": FAULT["seed"], "rate": FAULT["rate"],
            "flip_rate": FAULT["flip_rate"], "launches": inj.launches,
            "injected_failures": inj.injected,
            "hot_flips": len(hot), "cold_flips": len(cold),
            "flips": [list(f) for f in inj.flips],
            "flips_run_on_by_own_launch": own,
            "detected_by_own_launch": own_detected,
            "later_launches_on_a_flip": later,
            "detected": it["detected"],
            "detected_by_launch_verify": guard.stats["detected"],
            "recovered": it["recovered"],
            "recovery_failed": it["recovery_failed"],
            "recovery_ms": [1e3 * s for s in it["recovery_s"]],
            "scrub": dict(fe.stats["scrub"]), "final_scrub": final_scrub,
            "retries": fe.stats["retries"],
            "quarantined": quarantined,
            "quarantine_reason": fe._quarantine_reasons.get(fm_name),
            "served_faulty_model": n_fault,
            "rejected": len(rejected),
            "rejected_kinds": sorted({r[1] for r in rejected})}


def frontend_path(dev, trained):
    """Phase 3c: the request path over several packs at full width."""
    t0 = time.perf_counter()
    packs, report = frontend_packs(dev, trained)
    shapes = {m: tuple(tuple(l["shape"]) for l in p["layers"])
              for m, p in packs.items()}
    kw = plan_kwargs(shapes)
    cold = cold_tier(dev, packs, kw, trained)
    hot = hot_tier(dev, packs, kw)
    coop = coop_probe(dev, packs["mlp-gsc"])
    session = frontend_session(dev, packs, kw)
    faults = fault_session(dev, packs, kw)
    wall_s = time.perf_counter() - t0
    print(f"phase 3c: done in {wall_s:.1f} s")
    return {"wall_s": wall_s, "export_report": report, "cold_tier": cold,
            "hot_tier": hot, "cooperative_two_streams": coop,
            "session": session, "faults": faults}

# ------------------------------------------------------------- phase 5

LM = dict(arch="smollm-360m", seed=0, prompts=4, prompt_len=16, max_new=16,
          max_bucket=64, prompt_seed=5, max_delay=2e-3)
LM_ROWS = (1, 2, 4, 8, 16, 64)             # each FFN shape gated here
LM_LOGIT_REL = 1e-3                        # of the direct path's max |logit|
LM_LEAVES = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
             ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"))
# the FFN matrices checked and timed (gate and up share a shape) at the
# row counts of a decode of 1 and 4 sequences, a 16-token prefill and the
# top bucket
LM_TIMED = {"gate": (1, 4, 16, 64), "down": (1, 4, 16, 64)}
SCHED_KERNEL = {sched: name for name, (sched, _) in KERNELS.items()}


def _lm_freeze(dev, cfg):
    """Init on the card, then ``freeze_tree`` with the ecl_quant counter
    zeroed just before and read just after; block 0's and the last
    block's codes of every leaf against the plain version on the same
    card tensors (the penalty ``freeze_tree`` computed)."""
    import torch
    from repro_torch.core import bitplanes, ecl, qat
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.nn import transformer as T

    params = T.lm_init(cfg, seed=LM["seed"], device=dev)
    qstate = qat.build_qstate(params)
    torch.cuda.synchronize(dev)
    eq.LAUNCHES = 0
    t0 = time.perf_counter()
    frozen = qat.freeze_tree(params, qstate, cfg.lam)
    torch.cuda.synchronize(dev)
    freeze_ms = (time.perf_counter() - t0) * 1e3
    launches = eq.LAUNCHES
    segments = len(LM_LEAVES) * cfg.n_layers
    if launches != -(-segments // eq.MAX_SEGMENTS):
        raise AssertionError(f"freeze_tree made {launches} ecl_quant "
                             f"launches for {segments} segments")
    sp, sq = params["stacks"]["dense"], qstate["stacks"]["dense"]
    sf = frozen["stacks"]["dense"]
    n_quant = packed = 0
    ws, omegas, probs = [], [], []
    for grp, name in LM_LEAVES:
        node = sp[grp][name]["kernel"]
        pr = sq[grp][name]["kernel"]["probs"]
        pen = ecl.penalty(node["w"], pr, cfg.lam)
        for l in (0, cfg.n_layers - 1):
            want, _ = eq.ecl_quant_plain(node["w"][l], node["omega"][l],
                                         pen[l])
            got = bitplanes.unpack_codes_rows(
                sf[grp][name]["kernel"]["packed"][l])
            if not torch.equal(got, want):
                raise AssertionError(f"freeze codes of block {l} {grp}."
                                     f"{name} != the plain version")
        n_quant += node["w"].numel()
        packed += sf[grp][name]["kernel"]["packed"].numel()
        ws.append(node["w"])
        omegas.append(node["omega"])
        probs.append(pr)
    # kernel 5 at the SmolLM shapes: the freeze's grouped assignment,
    # and its plain version over the same 224 segments
    pens = [ecl.penalty(w, pr, cfg.lam) for w, pr in zip(ws, probs)]

    def plain_all():
        return [eq.ecl_quant_plain(w[l], om[l], pen[l])
                for w, om, pen in zip(ws, omegas, pens)
                for l in range(cfg.n_layers)]

    def grouped():
        return ecl.assign_many(ws, omegas, probs, cfg.lam)

    ecl_row = {
        "ms": _time_ms(grouped, dev, 3),
        **_device_time(grouped, dev, 2, ECL_SYMBOL,
                       launches=lambda: eq.LAUNCHES),
        "plain_ms": _time_ms(plain_all, dev, 1),
        "bound_ms": ECL_BYTES_PER_ELEM * n_quant / PEAK_BYTES * 1e3,
        # assign_many throws ŵ away: the bytes the freeze itself needs
        "codes_only_bound_ms":
            ECL_CODES_BYTES_PER_ELEM * n_quant / PEAK_BYTES * 1e3,
        "bound_by": "bytes", "library_ms": None, "elements": n_quant,
        "segments": segments, "launches_per_call": launches}
    freeze = {"ms": freeze_ms, "ecl_quant_launches": launches,
              "segments": segments, "quant_weights": n_quant,
              "packed_bytes": packed, "fp32_bytes": 4 * n_quant,
              "embed_fp32_bytes": 4 * frozen["embed"]["table"].numel()}
    return frozen, freeze, ecl_row


def _lm_ffn_checks(dev, prog):
    """Block 0's FFN shapes at LM_ROWS through the chain and every
    schedule that fits (each launch seen on its counter), within the fp32
    gate of the plain oracle; then the timed rows (device, plain, library
    and bound) of the schedules the program binds."""
    import numpy as np
    import torch
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
    from repro_torch.kernels import fantastic4_matmul as fm
    from repro_torch.kernels import ops, ref

    checks, timed = {}, {}
    for name, rows_timed in LM_TIMED.items():
        plan = prog._plans[0][name]
        layers = plan.layers
        s = Schedules({"layers": layers}, "float32", None)
        k, n = layers[0]["shape"]
        label = f"{name} {k}x{n}"
        w = ref.decode_weights(layers[0]["packed"], layers[0]["omega"])
        l0 = layers[0]

        def library(x):
            return (torch.matmul(x, w) * l0["alpha1"] + l0["bias"]) \
                * l0["alpha2"]

        per = {}
        for rows in LM_ROWS:
            x = torch.from_numpy(np.random.default_rng(rows).normal(
                size=(rows, k)).astype(np.float32)).to(dev)
            want = ops.fantastic4_mlp_chain(x, layers, use_kernel=False)
            errs = {}
            for sched in ("chain",) + plan._eligible_schedules(rows):
                before = (fm.LAUNCHES, dict(ffm.LAUNCHES))
                got = s.kernel(SCHED_KERNEL[sched], x)
                torch.cuda.synchronize(dev)
                ran = fm.LAUNCHES > before[0] if sched == "chain" else \
                    ffm.LAUNCHES[sched] > before[1][sched]
                if not ran:
                    raise AssertionError(f"{label} rows {rows}: {sched} "
                                         "did not launch")
                tol = FP32_ATOL + FP32_RTOL * want.abs()
                if not bool(((got - want).abs() <= tol).all()):
                    raise AssertionError(
                        f"{label} rows {rows} {sched}: max abs err "
                        f"{float((got - want).abs().max())}")
                errs[sched] = float((got - want).abs().max())
            per[str(rows)] = {"bound": plan.schedule_for(rows),
                              "max_abs_err": errs}
        checks[label] = per
        for rows in rows_timed:
            sched = plan.schedule_for(rows)
            kname = SCHED_KERNEL[sched]
            x = torch.from_numpy(np.random.default_rng(rows).normal(
                size=(rows, k)).astype(np.float32)).to(dev)
            b_ms, b_by = bound(rows, (k, n))
            timed[f"{label} rows {rows}"] = {
                "schedule": sched, "rows": rows,
                "ms": _time_ms(lambda: s.kernel(kname, x), dev, 50),
                **_device_time(lambda: s.kernel(kname, x), dev, 10,
                               SYMBOLS[sched]),
                "plain_ms": _time_ms(lambda: s.plain(kname, x), dev, 10),
                "library_ms": _time_ms(lambda: library(x), dev, 50),
                "bound_ms": b_ms, "bound_by": b_by}
    return checks, timed


def _lm_direct(dev, cfg, frozen, prompts, new, tokens=None):
    """The direct path on a frozen tree (``lm_apply``: dense decode +
    ``torch.matmul``, no FantastIC4 kernel): a prefill, then ``new - 1``
    decode steps fed ``tokens`` (teacher forcing) or, without them, each
    step's greedy pick.  Returns the greedy picks (B, new), each step's
    last-position logits (B, new, vocab) and the cache; on the card also
    prefill ms and decode ms a step (CUDA events) and the prefill's and
    the decode steps' peak device memory."""
    import torch
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX

    b, s = prompts.shape
    on_card = dev.type == "cuda"
    cache = T.init_cache(cfg, b, s + new, dtype=torch.float32, device=dev)
    tok = torch.from_numpy(prompts).to(dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    tf = None if tokens is None else torch.from_numpy(tokens).to(dev)
    clock = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
        if on_card else None
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        clock[0].record()
    with torch.no_grad():
        logits, cache, _ = T.lm_apply(frozen, 0, tok, FP32_CTX, cfg,
                                      positions=pos, cache=cache)
        if on_card:
            clock[1].record()
            torch.cuda.synchronize(dev)
            prefill_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        steps = [logits[:, -1, :cfg.vocab]]
        toks = [torch.argmax(steps[-1], dim=-1)]
        for t in range(new - 1):
            p_t = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
            fed = toks[-1][:, None] if tf is None else tf[:, t:t + 1]
            logits, cache, _ = T.lm_apply(frozen, 0, fed, FP32_CTX, cfg,
                                          positions=p_t, cache=cache)
            steps.append(logits[:, -1, :cfg.vocab])
            toks.append(torch.argmax(steps[-1], dim=-1))
        if on_card:
            clock[2].record()
            torch.cuda.synchronize(dev)
    out = {"tokens": torch.stack(toks, dim=1).cpu().numpy(),
           "logits": torch.stack(steps, dim=1), "cache": cache}
    if on_card:
        out.update(prefill_ms=clock[0].elapsed_time(clock[1]),
                   decode_ms=clock[1].elapsed_time(clock[2]) / max(new - 1, 1),
                   prefill_peak_bytes=prefill_peak,
                   decode_peak_bytes=torch.cuda.max_memory_allocated(dev))
    return out


def _step_trace(fn, dev, steps):
    """``fn`` (one serving step) run ``steps`` times: its wall ms a step,
    and from one torch.profiler trace over as many runs its device ms and
    device operations a step; the idle share is the part of the wall time
    the device is not busy.  Returns (that dict, device ms a step by
    kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    for attempt in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize(dev)
            traced_ms = (time.perf_counter() - t0) * 1e3 / steps
        TRACES["taken"] += 1
        kernels, ops_n = {}, 0
        for evt in prof.key_averages():
            if _is_kernel(evt):
                kernels[evt.key] = kernels.get(evt.key, 0.0) + \
                    _kernel_us(evt) / 1e3 / steps
                ops_n += evt.count
        if kernels:
            break
        _retrace(attempt)
    else:
        raise AssertionError(f"no device time in {TRACE_TRIES} traces of "
                             "a serving step")
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms_per_step": wall_ms,
            "traced_wall_ms_per_step": traced_ms,
            "device_ms_per_step": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "device_ops_per_step": ops_n / steps,
            "top_device_ms": [[k[:80], v] for k, v in top]}, kernels


def _lm_decode_trace(dev, prog, prompts, steps=4):
    """A decode step at len(prompts) sequences (the rows the frontend
    hands the program), traced by :func:`_step_trace`, with the FantastIC4
    kernels' share of its device time."""
    import numpy as np

    sids = [prog.prefill(p)[0] for p in prompts]
    rows = np.stack([prog.encode_decode(sid) for sid in sids])
    trace, kernels = _step_trace(lambda: prog.run(rows), dev, steps)
    for sid in sids:
        prog.release(sid)
    trace["fantastic4_kernels_device_ms"] = sum(
        v for k, v in kernels.items()
        if any(sym in k for sym in set(SYMBOLS.values())))
    return trace


def lm_path(dev):
    """Phase 5: SmolLM-360M at its published width, frozen to 4 bits on the
    card and served through LMProgram under the frontend."""
    import numpy as np
    import torch
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
    from repro_torch.kernels import fantastic4_matmul as fm
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    cfg = get_config(LM["arch"])
    frozen, freeze, ecl_row = _lm_freeze(dev, cfg)
    torch.cuda.empty_cache()
    if not all(t.device.type == dev.type for t in leaves(frozen)
               if isinstance(t, torch.Tensor)):
        raise AssertionError("a frozen leaf is off the card")
    t0 = time.perf_counter()
    prog = serving.LMProgram(frozen, cfg, max_prompt=LM["prompt_len"],
                             max_new=LM["max_new"],
                             max_bucket=LM["max_bucket"], device=dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    prog.warmup()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    memory = torch.cuda.memory_allocated(dev)
    checks, timed = _lm_ffn_checks(dev, prog)

    b, s, new = LM["prompts"], LM["prompt_len"], LM["max_new"]
    desc = prog.describe(n_seqs=b)
    prompts = np.random.default_rng(LM["prompt_seed"]).integers(
        0, cfg.vocab, (b, s))
    sids = list(range(1000, 1000 + b))
    toks, step_ms = [], []
    on_card = True
    fm.LAUNCHES = 0
    ffm.reset_launches()
    frontend = serving.ServingFrontend()
    with frontend:
        frontend.register(cfg.name, prog, max_delay=LM["max_delay"])
        t0 = time.perf_counter()
        futs = [frontend.submit(cfg.name,
                                prog.encode_prefill(sid, prompts[i])[None])
                for i, sid in enumerate(sids)]
        toks.append([int(f.result(120.0).y[0, 0]) for f in futs])
        prefill_ms = (time.perf_counter() - t0) * 1e3
        on_card = all(t.device.type == dev.type
                      for t in prog.sequence_tensors())
        for _ in range(new - 1):
            t0 = time.perf_counter()
            futs = [frontend.submit(cfg.name, prog.encode_decode(sid)[None])
                    for sid in sids]
            toks.append([int(f.result(120.0).y[0, 0]) for f in futs])
            step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize(dev)
    launches = {"fantastic4_matmul": fm.LAUNCHES,
                **{name: ffm.LAUNCHES[sched]
                   for name, (sched, _) in KERNELS.items()
                   if sched != "chain"}}
    by_sched = {"chain": fm.LAUNCHES, **ffm.LAUNCHES}
    for sid in sids:
        prog.release(sid)
    engine = np.asarray(toks, np.int64).T
    if not on_card:
        raise AssertionError("a sequence's state is off the card")
    named = {sch for phase in desc["ffn_schedules"].values()
             for sch in phase.values()}
    missing = sorted(sch for sch in named if by_sched[sch] == 0)
    if missing or not {"ws", "stream"} <= named:
        raise AssertionError(f"LM session: schedules {sorted(named)} named, "
                             f"{missing} never launched ({by_sched})")
    stats = dict(frontend.stats)

    direct_tokens, logits = prog.generate(prompts, new, return_logits=True)
    if not np.array_equal(engine, direct_tokens):
        raise AssertionError("engine tokens != LMProgram.generate")
    direct = _lm_direct(dev, cfg, frozen, prompts, new, tokens=engine)
    want = direct.pop("logits")
    del direct["cache"]
    worst = 0.0
    for t in range(new):
        scale = float(want[:, t].abs().max())
        err = float((logits[:, t] - want[:, t]).abs().max())
        worst = max(worst, err / scale)
        picked = want[:, t].gather(1, torch.from_numpy(
            engine[:, t:t + 1]).to(dev))[:, 0]
        if err > LM_LOGIT_REL * scale or bool(
                (picked < want[:, t].amax(-1) - LM_LOGIT_REL * scale).any()):
            raise AssertionError(f"LM step {t}: program logits off the "
                                 f"direct path by {err} (max |logit| "
                                 f"{scale})")
    trace = _lm_decode_trace(dev, prog, prompts)
    guard = serving.GuardedPlan(prog, model_id=cfg.name)
    t0 = time.perf_counter()
    guard.verify()
    verify_ms = (time.perf_counter() - t0) * 1e3

    lm = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "freeze": freeze,
        "program_build_ms": build_ms, "warmup_ms": warmup_ms,
        "device_memory_after_build_bytes": memory,
        "prefill_ms_per_sequence_engine": prefill_ms / b,
        "direct_prefill_ms_4_sequences": direct["prefill_ms"],
        "decode_ms_per_step_engine": float(np.median(step_ms)),
        "decode_ms_per_step_engine_all": step_ms,
        "decode_ms_per_step_direct": direct["decode_ms"],
        "decode_step_trace": trace,
        "engine_launches": stats["launches"],
        "kernel_launches": launches,
        "ffn_schedules": desc["ffn_schedules"],
        "ffn_bucket_schedules": {k: {str(bk): v for bk, v in d.items()}
                                 for k, d in
                                 desc["ffn_bucket_schedules"].items()},
        "ffn_checks": checks, "ffn_timed": timed, "ecl_quant": ecl_row,
        "max_rel_logit_err": worst, "tokens_0": engine[0].tolist(),
        "verify_ms": verify_ms, "wall_s": time.perf_counter() - t_phase}
    print(f"phase 5: {cfg.name} ({cfg.n_layers}x{cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}) frozen in "
          f"{freeze['ecl_quant_launches']} ecl_quant launches, program "
          f"built in {build_ms:.0f} ms; engine == generate bitwise, logits "
          f"within {worst:.2e} of the direct path; decode "
          f"{lm['decode_ms_per_step_engine']:.2f} ms/step (engine), "
          f"{direct['decode_ms']:.2f} ms/step (direct); launches {launches}; "
          f"done in {lm['wall_s']:.1f} s")
    prog.forget()
    return lm


# ------------------------------------------------------------- phase 6

LM_TRAIN = dict(arch="smollm-360m", seed=0, steps=20, batch=8, seq=64,
                lr=1e-3, lam=0.05, lam_ramp=50, ckpt_every=20)
LM_TRAIN_TIMED_STEPS = 5
LM_TRAIN_TRACED_STEPS = 2
ECL_PASSES_PER_STEP = 2        # the fake-quant forward, update_qstate
# quantize_many calls whose block slices are held against the plain
# version: the first step's two passes (λ 0) and the last step's (λ > 0)
LM_TRAIN_CHECKED_CALLS = (0, 1, 2 * LM_TRAIN["steps"] - 2,
                          2 * LM_TRAIN["steps"] - 1)


class _EclRecorder:
    """Wraps ``core.ecl.quantize_many`` (every grouped ECL pass of a
    forward, an update, a freeze or an export goes through it): counts
    each call's kernel launches, and for the calls in ``keep`` copies the
    inputs and outputs of blocks ``blocks`` of every leaf, or with
    ``picks`` [(tensor index, lead index)] holds those segments' codes and
    ŵ against ``check`` during the call and keeps the verdicts."""

    def __init__(self, ecl_mod, eq_mod, keep, blocks, picks=None,
                 check=None):
        self.ecl, self.eq = ecl_mod, eq_mod
        self.keep, self.blocks, self.picks = set(keep), blocks, picks
        self.check = check
        self.calls = []
        self.orig = ecl_mod.quantize_many

    def __enter__(self):
        self.ecl.quantize_many = self._call
        return self

    def __exit__(self, *exc):
        self.ecl.quantize_many = self.orig

    def _call(self, ws, omegas, pens):
        before = self.eq.LAUNCHES
        outs = self.orig(ws, omegas, pens)
        entry = {"launches": self.eq.LAUNCHES - before,
                 "segments": sum(o[..., 0].numel() for o in omegas)}
        if len(self.calls) in self.keep and self.picks is None:
            entry["blocks"] = [
                (l, *(t[l].detach().clone() for t in (w, om, pen, c, wh)))
                for w, om, pen, (c, wh) in zip(ws, omegas, pens, outs)
                for l in self.blocks]
        elif len(self.calls) in self.keep:
            # each picked segment held against ``check`` (w, ω, penalty)
            # -> (codes, ŵ) at once, so no copy outlives the call
            import torch
            entry["equal"] = []
            for i, idx in self.picks:
                w, om, pen, (c, wh) = ws[i], omegas[i], pens[i], outs[i]
                want_c, want_w = self.check(w[idx], om[idx], pen[idx])
                entry["equal"].append(
                    ((i, idx), bool(torch.equal(c[idx], want_c)
                                    and torch.equal(wh[idx], want_w))))
        self.calls.append(entry)
        return outs


def _state_equal(a, b):
    """Same leaves, dtypes and devices, bit for bit."""
    import torch
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        for x, y in zip(la, lb))


def _lm_train_trace(dev, step_fn, holder, batch,
                    timed=LM_TRAIN_TIMED_STEPS):
    """Device ms, idle share and device operations of LM train steps from
    one torch.profiler trace, with the ECL kernel's, the fake-quant
    backward's, Adam's and the probability update's device ms a step;
    host ms a step (CUDA synchronised) over ``timed`` back-to-back steps;
    the host synchronisations one step makes, named by where they happen,
    and that step's peak device memory (the trained state included) after
    its forward, its backward, Adam and the probability update.  The steps
    chain from ``holder[0]``, each replacing it, so no earlier state stays
    alive unless the caller holds it."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import qat
    from repro_torch.models import lm as lm_model
    from repro_torch.optim import adam

    def steps(n):
        m = None
        for _ in range(n):
            holder[0], m = step_fn(holder[0], batch)
        return m

    steps(1)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    steps(timed)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / timed

    # peak memory at the end of each stage of one step: patched where the
    # step looks the functions up, read on the host (no synchronisation)
    peaks = {}

    def marked(fn, before, after):
        def call(*a, **k):
            if before:
                peaks[before] = torch.cuda.max_memory_allocated(dev)
            out = fn(*a, **k)
            peaks[after] = torch.cuda.max_memory_allocated(dev)
            return out
        return call
    stages = ((lm_model, "lm_forward_loss", None, "forward"),
              (adam, "apply", "backward", "adam"),
              (qat, "update_qstate", None, "update_qstate"))
    originals = [getattr(mod, attr) for mod, attr, _, _ in stages]
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for (mod, attr, before, after), fn in zip(stages, originals):
            setattr(mod, attr, marked(fn, before, after))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            steps(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for (mod, attr, _, _), fn in zip(stages, originals):
            setattr(mod, attr, fn)
    torch.cuda.synchronize(dev)
    step_peak = torch.cuda.max_memory_allocated(dev)
    syncs = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}: "
             f"{str(w.message).splitlines()[0][:120]}" for w in caught
             if "synchroniz" in str(w.message)]

    # spans whose device time the trace reports: two functions annotated
    # for the trace, and the fake-quant's backward (an autograd node)
    annotate = ((adam, "apply", "adam.apply"),
                (qat, "update_qstate", "qat.update_qstate"))
    names = tuple(label for _, _, label in annotate) + \
        ("FakeQuantGroupBackward",)

    def annotated(fn, label):
        def call(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return call

    n = LM_TRAIN_TRACED_STEPS
    for attempt in range(TRACE_TRIES):
        originals = [getattr(mod, attr) for mod, attr, _ in annotate]
        for (mod, attr, label), fn in zip(annotate, originals):
            setattr(mod, attr, annotated(fn, label))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                steps(n)
                torch.cuda.synchronize(dev)
        finally:
            for (mod, attr, _), fn in zip(annotate, originals):
                setattr(mod, attr, fn)
        TRACES["taken"] += 1
        kernels, ops_n, spans = {}, 0, {}
        for evt in prof.key_averages():
            if _is_kernel(evt) and evt.key not in names:
                kernels[evt.key] = kernels.get(evt.key, 0.0) + \
                    _kernel_us(evt) / 1e3 / n
                ops_n += evt.count
            elif not _is_kernel(evt):
                span = next((k for k in names if evt.key.endswith(k)), None)
                if span is not None:
                    total = (getattr(evt, "device_time_total", 0.0)
                             or getattr(evt, "cuda_time_total", 0.0))
                    spans[span] = max(spans.get(span, 0.0), total / 1e3 / n)
        if kernels:
            break
        _retrace(attempt)
    else:
        raise AssertionError(f"no device time in {TRACE_TRIES} traces of "
                             "an LM train step")
    device_ms = sum(kernels.values())
    ecl_ms = sum(v for k, v in kernels.items() if ECL_SYMBOL in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"ms_per_step": ms, "device_ms_per_step": device_ms,
            "device_idle_share": 1.0 - device_ms / ms,
            "device_ops_per_step": ops_n / n,
            "ecl_quant_device_ms_per_step": ecl_ms,
            "fake_quant_backward_device_ms_per_step":
                spans.get("FakeQuantGroupBackward"),
            "adam_apply_device_ms_per_step": spans.get("adam.apply"),
            "update_qstate_device_ms_per_step":
                spans.get("qat.update_qstate"),
            "host_syncs_per_step": syncs,
            "peak_device_memory_bytes_one_step": step_peak,
            "peak_device_memory_bytes_by_stage": peaks,
            "top_device_ms": [[k[:240], v] for k, v in top]}


def _lm_smoke_card_vs_cpu(dev):
    """The ``--smoke`` config in fp32: CARD_VS_CPU_STEPS steps on the card
    and on the CPU from one init, loss by loss within CARD_VS_CPU_RTOL."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.nn import transformer as TT
    from repro_torch.optim import ec4t

    cfg = T.lm_config(LM_TRAIN["arch"], smoke=True, lam=LM_TRAIN["lam"])
    params = TT.lm_init(cfg, seed=LM_TRAIN["seed"], device="cpu")
    batch_fn = T.lm_batch_fn(cfg, batch=LM_TRAIN["batch"],
                             seq=LM_TRAIN["seq"])
    losses = {}
    for where in (dev, torch.device("cpu")):
        step_fn = T.lm_step_fn(cfg, steps=LM_TRAIN["steps"], lr=LM_TRAIN["lr"],
                               lam=LM_TRAIN["lam"],
                               lam_ramp=LM_TRAIN["lam_ramp"],
                               dtype=torch.float32)
        state = ec4t.init_train_state(
            tree.map_(lambda t: t.to(where), params))
        out = []
        for i in range(CARD_VS_CPU_STEPS):
            state, m = step_fn(state, pipeline.place(batch_fn(i),
                                                     device=where))
            out.append(float(m["loss"]))
        losses[where.type] = out
    np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                               rtol=CARD_VS_CPU_RTOL)
    return {"card": losses["cuda"], "cpu": losses["cpu"],
            "max_rel": float(np.max(np.abs(np.subtract(
                losses["cuda"], losses["cpu"])) / np.abs(losses["cpu"])))}


def lm_train_path(dev):
    """Phase 6: EC4T-train SmolLM-360M at its published width on the card
    through the launcher's functions, checkpoint, resume and export."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint.manager import (SEP, CheckpointManager,
                                                load_quantized)
    from repro_torch.core import bitplanes, ecl, qat
    from repro_torch.data import pipeline
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import train as T
    from repro_torch.nn import transformer as TT
    from repro_torch.optim import ec4t
    from repro_torch.runtime.fault import FaultTolerantLoop

    t_phase = time.perf_counter()
    cfg = T.lm_config(LM_TRAIN["arch"], lam=LM_TRAIN["lam"])
    steps = LM_TRAIN["steps"]
    blocks = (0, cfg.n_layers - 1)
    segments = len(LM_LEAVES) * cfg.n_layers
    per_pass = -(-segments // eq.MAX_SEGMENTS)
    log_lines = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        export_dir = os.path.join(tmp, "export")
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eq.LAUNCHES = 0
        with _EclRecorder(ecl, eq, LM_TRAIN_CHECKED_CALLS, blocks) as rec:
            run = T.train_lm(cfg, steps=steps, batch=LM_TRAIN["batch"],
                             seq=LM_TRAIN["seq"], lr=LM_TRAIN["lr"],
                             lam=LM_TRAIN["lam"],
                             lam_ramp=LM_TRAIN["lam_ramp"],
                             ckpt_dir=ckpt_dir,
                             ckpt_every=LM_TRAIN["ckpt_every"],
                             export=export_dir, device=dev,
                             metrics_every=1, seed=LM_TRAIN["seed"],
                             log=log_lines.append)
        torch.cuda.synchronize(dev)
        launches = eq.LAUNCHES
        peak = torch.cuda.max_memory_allocated(dev)
        state = run["state"]
        # exactly 14 launches a step (7 + 7) and 7 for the export
        want_calls = ECL_PASSES_PER_STEP * steps + 1
        per_call = [c["launches"] for c in rec.calls]
        if (run["reason"], run["last"]) != ("done", steps):
            raise AssertionError(f"LM training ended {run['reason']} at step "
                                 f"{run['last']}")
        if per_call != [per_pass] * want_calls or \
                launches != per_pass * want_calls:
            raise AssertionError(
                f"LM training: ecl_quant launches per grouped pass "
                f"{per_call} (total {launches}); expected {want_calls} "
                f"passes of {per_pass}")
        if any(c["segments"] != segments for c in rec.calls):
            raise AssertionError("an ECL pass did not take all "
                                 f"{segments} segments")
        checked = 0
        for i in LM_TRAIN_CHECKED_CALLS:
            for l, w, om, pen, codes, w_hat in rec.calls[i]["blocks"]:
                want_c, want_w = eq.ecl_quant_plain(w, om, pen)
                if not (torch.equal(codes, want_c)
                        and torch.equal(w_hat, want_w)):
                    raise AssertionError(f"ECL pass {i}, block {l}: codes "
                                         "or ŵ != the plain version")
                checked += 1
        losses = [h["loss"] for h in run["history"]]
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"LM losses {losses}")
        if not np.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"LM losses did not fall: {losses}")
        if not all(t.device.type == dev.type for t in tree.leaves(state)):
            raise AssertionError("a train-state tensor is off the card")

        # resume: a fresh state restored from the step-20 checkpoint
        step_fn = T.lm_step_fn(cfg, steps=steps, lr=LM_TRAIN["lr"],
                               lam=LM_TRAIN["lam"],
                               lam_ramp=LM_TRAIN["lam_ramp"])
        mgr = CheckpointManager(ckpt_dir)
        ckpt_bytes = os.path.getsize(os.path.join(
            ckpt_dir, f"step_{steps:08d}", "state.npz"))
        fresh = ec4t.init_train_state(TT.lm_init(
            cfg, seed=LM_TRAIN["seed"] + 1, device=dev))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        restored, start = FaultTolerantLoop(step_fn, mgr).resume_or(fresh)
        torch.cuda.synchronize(dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
        del fresh
        if start != steps or not _state_equal(restored, state):
            raise AssertionError(f"resume at step {start}: the restored "
                                 "state differs from the trained one")
        batch = pipeline.place(T.lm_batch_fn(
            cfg, batch=LM_TRAIN["batch"], seq=LM_TRAIN["seq"])(steps),
            device=dev)
        _, m_mem = step_fn(state, batch)
        _, m_res = step_fn(restored, batch)
        if not torch.equal(m_mem["loss"], m_res["loss"]):
            raise AssertionError("one step from the restored state gave "
                                 f"{float(m_res['loss'])}, from the "
                                 f"trained state {float(m_mem['loss'])}")
        del restored

        # export: codes and ω equal to freeze_tree's on the same state
        # (Huffman streams decoded on the card)
        t0 = time.perf_counter()
        loaded = load_quantized(export_dir, device=dev)
        load_ms = (time.perf_counter() - t0) * 1e3
        frozen = qat.freeze_tree(state["params"], state["qstate"], cfg.lam)
        sf = frozen["stacks"]["dense"]
        for grp, name in LM_LEAVES:
            key = SEP.join(("stacks", "dense", grp, name, "kernel"))
            want = bitplanes.unpack_codes_rows(
                sf[grp][name]["kernel"]["packed"])
            if not (torch.equal(loaded[key]["codes"], want)
                    and torch.equal(loaded[key]["omega"],
                                    sf[grp][name]["kernel"]["omega"])):
                raise AssertionError(f"export {key}: codes or ω != "
                                     "freeze_tree's")
        del frozen, loaded
        export_bytes = os.path.getsize(os.path.join(export_dir,
                                                    "export.npz"))

    trace = _lm_train_trace(dev, step_fn, [state], batch)
    card_vs_cpu = _lm_smoke_card_vs_cpu(dev)
    # one grouped ECL pass of a train step (the fake-quant forward's:
    # codes and ŵ of all 224 segments), its plain version, its bound
    sp, sq = state["params"]["stacks"]["dense"], \
        state["qstate"]["stacks"]["dense"]
    ws = [sp[g][n]["kernel"]["w"] for g, n in LM_LEAVES]
    omegas = [sp[g][n]["kernel"]["omega"] for g, n in LM_LEAVES]
    pens = [ecl.penalty(w, sq[g][n]["kernel"]["probs"], cfg.lam)
            for w, (g, n) in zip(ws, LM_LEAVES)]
    n_quant = sum(w.numel() for w in ws)
    pass_bound = ECL_BYTES_PER_ELEM * n_quant / PEAK_BYTES * 1e3

    def ecl_pass():
        return ecl.quantize_many(ws, omegas, pens)

    def ecl_plain():
        return [eq.ecl_quant_plain(w[l], om[l], pen[l])
                for w, om, pen in zip(ws, omegas, pens)
                for l in range(cfg.n_layers)]
    ecl_row = {"ms": _time_ms(ecl_pass, dev, 3),
               **_device_time(ecl_pass, dev, 2, ECL_SYMBOL,
                              launches=lambda: eq.LAUNCHES),
               "queued_ms": _queued_ms(ecl_pass, dev, 3),
               "plain_ms": _time_ms(ecl_plain, dev, 1),
               "bound_ms": pass_bound, "bound_by": "bytes",
               "library_ms": None, "segments": segments,
               "launches_per_call": per_pass}
    out = {
        **LM_TRAIN, "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "compute_dtype": "bfloat16", "quant_weights": n_quant,
        "losses": losses, "loop_ms_per_step": run["ms_per_step"],
        "ecl_quant_launches": launches, "ecl_quant_passes": len(rec.calls),
        "ecl_quant_launches_per_pass": per_pass,
        "ecl_blocks_checked": checked,
        **trace,
        "ecl_quant_bound_ms_per_pass": pass_bound,
        "ecl_quant_bound_ms_per_step": ECL_PASSES_PER_STEP * pass_bound,
        "ecl_quant_pass": ecl_row,
        "peak_device_memory_bytes": peak,
        "checkpoint_bytes": ckpt_bytes,
        "checkpoint_save_ms": [s * 1e3 for _, s in run["saves"]],
        "checkpoint_restore_ms": restore_ms,
        "export_bytes": export_bytes,
        "export_compressed_bytes": run["export"]["compressed_bytes"],
        "export_compression_ratio": run["export"]["compression_ratio"],
        "export_ms": run["export_s"] * 1e3, "export_load_ms": load_ms,
        "export_formats": sorted({t["format"] for t in
                                  run["export"]["tensors"].values()}),
        "card_vs_cpu_smoke_fp32": card_vs_cpu,
        "wall_s": time.perf_counter() - t_phase}
    print(f"phase 6: {cfg.name} EC4T-trained {steps} steps at batch "
          f"{LM_TRAIN['batch']} x seq {LM_TRAIN['seq']} (bf16): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {launches} ecl_quant "
          f"launches ({per_pass} a pass); resume bitwise; export == "
          f"freeze_tree; {trace['ms_per_step']:.1f} ms/step; done in "
          f"{out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------- phase 7

MOE = dict(arch="grok-1-314b", layers=1, seed=0, prompts=4, prompt_len=16,
           max_new=16)
MOE_REL = 1e-4            # MoE output and re-prefill: of the largest |value|
ROUTE_TOL = 1e-6          # routing weights and aux, card vs CPU
MOE_SMOKE_TOL = 1e-5      # the smoke config's logits, card vs CPU
MOE_BANKS = ("gate", "up", "down")
MOE_SKEW_LOGIT = 50.0     # expert 0's logit for every token of the skew run
PLAIN_CHUNK = 1 << 24     # elements a plain-version call (its cost tensor)


def _moe_cfg():
    """grok-1-314b at its published widths, cut to MOE["layers"] layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE["arch"]),
                               n_layers=MOE["layers"])


def _plain_codes(w, omega, pen):
    """``ecl_quant_plain`` of one segment, PLAIN_CHUNK elements a call (the
    function is elementwise, so the chunks give its codes bitwise)."""
    import torch
    from repro_torch.kernels import ecl_quant as eq
    rows = max(1, PLAIN_CHUNK // w.shape[-1])
    return torch.cat([eq.ecl_quant_plain(w[r:r + rows], omega, pen)[0]
                      for r in range(0, w.shape[0], rows)])


def _moe_freeze(dev, cfg):
    """Phase 7's freeze (:func:`_gated_freeze`): grok's q/k/v/o and 3
    banks x 8 experts a layer; codes of layer 0's q and of the first and
    last expert of every bank checked."""
    checks = [("moe", ("attn", "q", "kernel"), (0,))] + [
        ("moe", ("moe", "experts", b), (0, e)) for b in MOE_BANKS
        for e in (0, cfg.n_experts - 1)]
    want = cfg.n_layers * (4 + len(MOE_BANKS) * cfg.n_experts)
    return _gated_freeze(dev, cfg, MOE["seed"], want,
                         "q/k/v/o + 3 banks x "
                         f"{cfg.n_experts} experts a layer", checks)


def _gated_freeze(dev, cfg, seed, want_segments, layout, checks):
    """Init on the card and ``freeze_tree`` with the ecl_quant counter
    zeroed just before and read just after: the segment count ``layout``
    names, the exact launch count the segments give, the codes of each
    ``(stack, path, index)`` of ``checks`` bitwise equal to the plain
    version on the same card tensors, the grouped pass timed against its
    bounds, peak device memory."""
    import torch
    from repro_torch.core import bitplanes, ecl, qat
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.nn import transformer as T
    from repro_torch.tree import leaves

    params = T.lm_init(cfg, seed=seed, device=dev)
    qstate = qat.build_qstate(params)
    nodes = list(qat._quant_leaves(params, qstate))     # (leaf, its state)
    segments = sum(n["omega"][..., 0].numel() for n, _ in nodes)
    elements = sum(n["w"].numel() for n, _ in nodes)
    if segments != want_segments:
        raise AssertionError(f"{segments} ECL segments, expected "
                             f"{want_segments} ({layout})")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eq.LAUNCHES = 0
    t0 = time.perf_counter()
    frozen = qat.freeze_tree(params, qstate, cfg.lam)
    torch.cuda.synchronize(dev)
    freeze_ms = (time.perf_counter() - t0) * 1e3
    launches = eq.LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != -(-segments // eq.MAX_SEGMENTS):
        raise AssertionError(f"freeze_tree made {launches} ecl_quant "
                             f"launches for {segments} segments")

    for stack, path, idx in checks:
        node, qs, fnode = (t["stacks"][stack] for t in (params, qstate,
                                                        frozen))
        for k in path:
            node, qs, fnode = node[k], qs[k], fnode[k]
        pen = ecl.penalty(node["w"], qs["probs"], cfg.lam)
        got = bitplanes.unpack_codes_rows(fnode["packed"][idx])
        want = _plain_codes(node["w"][idx], node["omega"][idx], pen[idx])
        if not torch.equal(got, want):
            raise AssertionError(f"freeze codes of {'.'.join(path)}{idx} "
                                 "!= the plain version")

    ws = [n["w"] for n, _ in nodes]
    oms = [n["omega"] for n, _ in nodes]
    prs = [qs["probs"] for _, qs in nodes]

    def grouped():
        return ecl.assign_many(ws, oms, prs, cfg.lam)

    pens = [ecl.penalty(w, p, cfg.lam) for w, p in zip(ws, prs)]

    def plain_all():
        return [_plain_codes(w3[i], om3[i], pn3[i])
                for w, om, pn in zip(ws, oms, pens)
                for w3, om3, pn3 in [(w.reshape(-1, *w.shape[-2:]),
                                      om.reshape(-1, 4), pn.reshape(-1, 16))]
                for i in range(w3.shape[0])]

    row = {
        "ms": _time_ms(grouped, dev, 1),
        **_device_time(grouped, dev, 1, ECL_SYMBOL,
                       launches=lambda: eq.LAUNCHES),
        "plain_ms": _once_ms(plain_all, dev),
        "bound_ms": ECL_BYTES_PER_ELEM * elements / PEAK_BYTES * 1e3,
        "codes_only_bound_ms":
            ECL_CODES_BYTES_PER_ELEM * elements / PEAK_BYTES * 1e3,
        "bound_by": "bytes", "library_ms": None, "elements": elements,
        "segments": segments, "launches_per_call": launches}
    freeze = {"ms": freeze_ms, "ecl_quant_launches": launches,
              "segments": segments, "quant_weights": elements,
              "peak_device_bytes": peak,
              "packed_bytes": sum(t.numel() for t in leaves(frozen)
                                  if t.dtype == torch.uint8),
              "codes_checked": [".".join((st,) + p) + str(list(i))
                                for st, p, i in checks]}
    return frozen, freeze, row


def _once_ms(fn, dev):
    """ms of one call (CUDA events), for a call too long to repeat."""
    import torch
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end)


class _MoeRecorder:
    """Records each ``moe_ffn`` call's input and output while in use (the
    transformer looks ``moe_ffn`` up on its module at every call)."""

    def __enter__(self):
        from repro_torch.nn import moe
        self.calls, self._orig = [], moe.moe_ffn

        def record(p, q, x, ctx, **kw):
            y, aux = self._orig(p, q, x, ctx, **kw)
            self.calls.append((x.detach().clone(), y.detach().clone()))
            return y, aux
        moe.moe_ffn = record
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import moe
        moe.moe_ffn = self._orig


def _moe_dense_ref(p, x, cfg, keep=None):
    """The port's mirror of tests/test_moe.py::_dense_ref on the card, in
    plain fp32 PyTorch: per token, each chosen expert that the layer holds
    (all, or the share ``cfg.experts_held``), decoded from that expert's
    codes alone and weighted, added in assignment order, then the shared
    expert where the layer has one; ``keep`` (N, k) leaves dropped
    assignments out.  Returns (output, ids)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import qat
    from repro_torch.nn import moe

    xt = x.reshape(-1, x.shape[-1]).to(torch.float32)
    ids, w, _ = moe.route(xt @ p["router"]["w"], p["router"]["bias_correction"],
                          top_k=cfg.top_k, gate=cfg.moe_gate,
                          routed_scaling=cfg.routed_scaling)
    first, count = moe.held_experts(cfg.experts_held, cfg.n_experts)
    parts = torch.zeros((cfg.top_k,) + xt.shape, dtype=torch.float32,
                        device=xt.device)
    for e in range(first, first + count):
        hit = ids == e
        if keep is not None:
            hit &= keep
        tok, j = hit.nonzero(as_tuple=True)
        if not tok.numel():
            continue
        bank = {n: qat.decode_frozen(
            {"packed": p["experts"][n]["packed"][e - first],
             "omega": p["experts"][n]["omega"][e - first]})
            for n in MOE_BANKS}
        xe = xt[tok]
        hid = F.silu(xe @ bank["gate"]) * (xe @ bank["up"])
        parts[j, tok] = w[tok, j, None] * (hid @ bank["down"])
        del bank
    out = torch.zeros_like(xt)
    for j in range(cfg.top_k):
        out = out + parts[j]
    if "shared" in p:
        sh = {n: qat.decode_frozen(p["shared"][n]["kernel"])
              for n in MOE_BANKS}
        out = out + (F.silu(xt @ sh["gate"]) * (xt @ sh["up"])) @ sh["down"]
    return out.reshape(x.shape), ids


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _moe_route_checks(dev, cfg, p, x):
    """``route`` on the card against the CPU on the same logits tensor
    (the prefill's router logits, and the same rounded to integers, full
    of ties): ids bitwise, weights and aux within ROUTE_TOL."""
    import torch
    from repro_torch.nn import moe

    logits = x.reshape(-1, x.shape[-1]) @ p["router"]["w"]
    worst = 0.0
    for name, lg in (("prefill", logits), ("ties", logits.round())):
        kw = dict(top_k=cfg.top_k, gate=cfg.moe_gate,
                  routed_scaling=cfg.routed_scaling)
        ids, w, aux = moe.route(lg, p["router"]["bias_correction"], **kw)
        hids, hw, haux = moe.route(lg.cpu(),
                                   p["router"]["bias_correction"].cpu(), **kw)
        err = max(float((w.cpu() - hw).abs().max()),
                  abs(float(aux) - float(haux)))
        if not torch.equal(ids.cpu(), hids) or err > ROUTE_TOL:
            raise AssertionError(f"route ({name}) card != CPU: ids equal "
                                 f"{torch.equal(ids.cpu(), hids)}, err {err}")
        worst = max(worst, err)
    return worst


def _moe_skew(dev, cfg, p, x):
    """A forced-skew prefill: router column 0 solved so that expert 0's
    logit is MOE_SKEW_LOGIT for every token of ``x``, so all of them pick
    it first and only its first C slots are kept.  The card's dispatch
    equals the CPU's ``_dispatch_indices`` on the same ids, and the layer's
    output matches the kept-only reference."""
    import torch
    from repro_torch.nn import moe
    from repro_torch.nn.module import FP32_CTX

    xt = x.reshape(-1, x.shape[-1])
    h = xt.cpu().double()
    col = torch.linalg.pinv(h) @ torch.full((h.shape[0],), MOE_SKEW_LOGIT,
                                            dtype=torch.float64)
    w = p["router"]["w"].clone()
    w[:, 0] = col.to(torch.float32).to(dev)
    ps = {**p, "router": {**p["router"], "w": w}}
    y, _ = moe.moe_apply(ps, 0, x, FP32_CTX, top_k=cfg.top_k,
                         gate=cfg.moe_gate,
                         capacity_factor=cfg.capacity_factor,
                         routed_scaling=cfg.routed_scaling)
    ids, _, _ = moe.route(xt @ w, p["router"]["bias_correction"],
                          top_k=cfg.top_k, gate=cfg.moe_gate,
                          routed_scaling=cfg.routed_scaling)
    if not bool((ids[:, 0] == 0).all()):
        raise AssertionError("skew run: a token did not pick expert 0 first")
    n = xt.shape[0]
    cap = moe._capacity(n * cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    slot, keep = moe._dispatch_indices(ids.reshape(-1), cfg.n_experts, cap)
    hslot, hkeep = moe._dispatch_indices(ids.reshape(-1).cpu(),
                                         cfg.n_experts, cap)
    if not (torch.equal(slot.cpu(), hslot) and torch.equal(keep.cpu(), hkeep)):
        raise AssertionError("skew run: the card's dispatch != the CPU's")
    want, _ = _moe_dense_ref(ps, x, cfg, keep=keep.view(n, cfg.top_k))
    rel = _rel(y, want)
    if rel > MOE_REL:
        raise AssertionError(f"skew run: output off the kept-only "
                             f"reference by {rel} relative")
    kept0 = int(keep.view(n, cfg.top_k)[:, 0].sum())
    if kept0 != min(n, cap):
        raise AssertionError(f"skew run: expert 0 kept {kept0} of {n}, "
                             f"capacity {cap}")
    return {"tokens": n, "capacity": cap, "kept_expert_0": kept0,
            "dropped": int((~keep).sum()), "max_rel_err": rel}


def _dispatch_of(p, x, cfg):
    """(ids (N, k), keep (N, k), capacity) of the MoE layer ``p`` on the
    tokens of ``x`` at ``cfg``'s capacity factor."""
    from repro_torch.nn import moe

    xt = x.reshape(-1, x.shape[-1])
    ids, _, _ = moe.route(xt @ p["router"]["w"], p["router"]["bias_correction"],
                          top_k=cfg.top_k, gate=cfg.moe_gate,
                          routed_scaling=cfg.routed_scaling)
    cap = moe._capacity(xt.shape[0] * cfg.top_k, cfg.n_experts,
                        cfg.capacity_factor)
    _, keep = moe._dispatch_indices(ids.reshape(-1), cfg.n_experts, cap)
    return ids, keep.view(-1, cfg.top_k), cap


def _moe_re_prefill(dev, cfg, frozen, tokens, last):
    """Each sequence's last decode step's logits against a prefill of its
    same tokens without a cache, at capacity factor E / k: an expert's
    capacity then covers every token and no assignment drops (a decode
    step of 4 tokens drops none either: C = 8).  At the served factor a
    re-prefill drops assignments (counted), and a dropped token's logits
    differ by design.  Returns (max relative error, drops at the served
    factor)."""
    import dataclasses
    import torch
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX

    no_drop = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    p = _layer0(frozen["stacks"]["moe"]["moe"])
    worst, served_drops = 0.0, 0
    for b in range(tokens.shape[0]):
        seq = torch.from_numpy(tokens[b:b + 1]).to(dev)
        with torch.no_grad(), _MoeRecorder() as rec:
            full, none, _ = T.lm_apply(frozen, 0, seq, FP32_CTX, no_drop)
        if none is not None:
            raise AssertionError("lm_apply without a cache returned one")
        x = rec.calls[0][0]
        if not bool(_dispatch_of(p, x, no_drop)[1].all()):
            raise AssertionError(f"re-prefill of sequence {b} dropped an "
                                 "assignment at capacity factor E / k")
        served_drops += int((~_dispatch_of(p, x, cfg)[1]).sum())
        rel = _rel(last[b], full[0, -1, :cfg.vocab])
        if rel > MOE_REL:
            raise AssertionError(f"sequence {b}: the last decode step's "
                                 f"logits off the re-prefill by {rel}")
        worst = max(worst, rel)
    return worst, served_drops


def _layer0(tree):
    from repro_torch import tree as tr
    return tr.map_(lambda a: a[0], tree)


def _moe_smoke_card_vs_cpu(dev, arch=MOE["arch"]):
    """``arch``'s smoke config from one CPU init, frozen on each device
    (the kernel on the card, the plain version on the CPU), then the same
    prompts served greedily: tokens equal, logits within MOE_SMOKE_TOL."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import qat
    from repro_torch.nn import transformer as T

    cfg = get_config(arch).smoke()
    params = T.lm_init(cfg, seed=MOE["seed"], device="cpu")
    prompts = np.random.default_rng(MOE["seed"]).integers(
        0, cfg.vocab, (MOE["prompts"], MOE["prompt_len"]))
    runs = {}
    for where in (dev, torch.device("cpu")):
        p = tree.map_(lambda t: t.to(where), params)
        frozen = qat.freeze_tree(p, qat.build_qstate(p), cfg.lam)
        runs[where.type] = _lm_direct(where, cfg, frozen, prompts,
                                      MOE["max_new"])
    card, cpu = runs["cuda"], runs["cpu"]
    if not np.array_equal(card["tokens"], cpu["tokens"]):
        raise AssertionError(f"{cfg.name}: card tokens != CPU tokens")
    got, want = card["logits"].cpu(), cpu["logits"]
    if not torch.allclose(got, want, atol=MOE_SMOKE_TOL, rtol=MOE_SMOKE_TOL):
        raise AssertionError(f"{cfg.name}: logits off the CPU's by "
                             f"{float((got - want).abs().max())}")
    return {"tokens_equal": True,
            "max_abs_logit_err": float((got - want).abs().max())}


def moe_path(dev, gpu):
    """Phase 7: grok-1-314b at its published widths, cut to one layer,
    frozen to 4 bits on the card and served through the direct
    ``lm_apply`` path, first by the launcher a user runs."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _moe_cfg()
    b, s, new = MOE["prompts"], MOE["prompt_len"], MOE["max_new"]

    # the main path, as a user runs it
    argv = ["--arch", MOE["arch"], "--layers", str(MOE["layers"]),
            "--batch", str(b), "--prompt-len", str(s), "--max-new",
            str(new), "--seed", str(MOE["seed"])]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eq.LAUNCHES = 0
    t0 = time.perf_counter()
    gen = serve.main(argv)
    torch.cuda.synchronize(dev)
    launcher = {"argv": argv, "wall_s": time.perf_counter() - t0,
                "ecl_quant_launches": eq.LAUNCHES,
                "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    if gen.shape != (b, new) or not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"launcher returned ids of shape {gen.shape}")
    gc.collect()
    torch.cuda.empty_cache()

    frozen, freeze, ecl_row = _moe_freeze(dev, cfg)
    if launcher["ecl_quant_launches"] != freeze["ecl_quant_launches"]:
        raise AssertionError(f"the launcher made "
                             f"{launcher['ecl_quant_launches']} ecl_quant "
                             f"launches, the freeze "
                             f"{freeze['ecl_quant_launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(dev)

    # the launcher's prompts (seeded as it seeds them): the same tokens
    prompts = np.random.default_rng(MOE["seed"]).integers(
        0, cfg.vocab, (b, s))
    with _MoeRecorder() as rec:
        run = _lm_direct(dev, cfg, frozen, prompts, new)
    if not bool(torch.isfinite(run["logits"]).all()):
        raise AssertionError("non-finite logits")
    if not np.array_equal(run["tokens"], gen):
        raise AssertionError("the gated run's tokens != the launcher's")
    p = _layer0(frozen["stacks"]["moe"]["moe"])
    x_pre, _ = rec.calls[0]
    x_dec, y_dec = rec.calls[-1]
    if len(rec.calls) != new or x_pre.shape != (b, s, cfg.d_model) \
            or x_dec.shape != (b, 1, cfg.d_model):
        raise AssertionError(f"{len(rec.calls)} MoE calls recorded")
    route_err = _moe_route_checks(dev, cfg, p, x_pre)
    want, _ = _moe_dense_ref(p, x_dec, cfg)
    decode_rel = _rel(y_dec, want)
    if decode_rel > MOE_REL:
        raise AssertionError(f"decode step: MoE output off the per-token "
                             f"reference by {decode_rel} relative")
    skew = _moe_skew(dev, cfg, p, x_pre)
    seqs = np.concatenate([prompts, run["tokens"][:, :-1]], axis=1)
    re_prefill, re_prefill_drops = _moe_re_prefill(
        dev, cfg, frozen, seqs, run["logits"][:, -1])
    _, keep_pre, cap_pre = _dispatch_of(p, x_pre, cfg)
    _, keep_dec, _ = _dispatch_of(p, x_dec, cfg)
    if not bool(keep_dec.all()):
        raise AssertionError("a decode step dropped an assignment")

    step_tok = torch.from_numpy(run["tokens"][:, -1:]).to(dev)
    step_pos = torch.full((b, 1), s + new - 1, dtype=torch.int32, device=dev)

    def decode_step():
        from repro_torch.nn import transformer as T
        from repro_torch.nn.module import FP32_CTX
        with torch.no_grad():
            return T.lm_apply(frozen, 0, step_tok, FP32_CTX, cfg,
                              positions=step_pos, cache=run["cache"])

    trace, _ = _step_trace(decode_step, dev, 3)
    smoke = _moe_smoke_card_vs_cpu(dev)

    moe = {
        "arch": cfg.name, "layers": cfg.n_layers,
        "published_layers": get_config(MOE["arch"]).n_layers,
        "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "n_experts": cfg.n_experts, "top_k": cfg.top_k, "vocab": cfg.vocab,
        "sequences": b, "prompt_len": s, "max_new": new,
        "launcher": launcher, "freeze": freeze, "ecl_quant": ecl_row,
        "resident_device_bytes": resident,
        "prefill_ms": run["prefill_ms"],
        "decode_ms_per_step": run["decode_ms"],
        "decode_peak_device_bytes": run["decode_peak_bytes"],
        "decode_step_trace": trace,
        "route_max_err_card_vs_cpu": route_err,
        "decode_moe_max_rel_err": decode_rel, "skew": skew,
        "re_prefill_max_rel_err": re_prefill,
        "re_prefill_dropped_at_served_capacity": re_prefill_drops,
        "prefill_capacity": cap_pre,
        "prefill_dropped": int((~keep_pre).sum()),
        "smoke_card_vs_cpu": smoke,
        "tokens_0": run["tokens"][0].tolist(), "gpu": gpu,
        "wall_s": time.perf_counter() - t_phase}
    gb = 1e-9
    print(f"phase 7: {cfg.name} at depth {cfg.n_layers} (published "
          f"{moe['published_layers']}), {cfg.n_experts} experts of "
          f"{cfg.d_model}x{cfg.d_ff}: frozen in {freeze['ms']:.1f} ms "
          f"({freeze['ecl_quant_launches']} ecl_quant launch, "
          f"{freeze['segments']} segments; ECL device "
          f"{ecl_row['device_ms']:.2f} ms against a {ecl_row['bound_ms']:.2f}"
          f" ms byte bound, {ecl_row['codes_only_bound_ms']:.2f} codes-only), "
          f"peak {freeze['peak_device_bytes'] * gb:.1f} GB ({gpu})")
    print(f"phase 7: prefill {run['prefill_ms']:.2f} ms, decode "
          f"{run['decode_ms']:.2f} ms/step at {b} sequences, device "
          f"{trace['device_ms_per_step']:.2f} ms/step, "
          f"{trace['device_ops_per_step']:.0f} device ops, idle "
          f"{trace['device_idle_share']:.3f}; decode peak "
          f"{run['decode_peak_bytes'] * gb:.1f} GB ({gpu})")
    print(f"phase 7: skew run dropped {skew['dropped']} of "
          f"{skew['tokens'] * cfg.top_k} assignments (capacity "
          f"{skew['capacity']}), the served prefill "
          f"{moe['prefill_dropped']} (capacity {cap_pre}); MoE output "
          f"within {decode_rel:.2e}, "
          f"re-prefill within {re_prefill:.2e}, smoke card vs CPU "
          f"{smoke['max_abs_logit_err']:.2e}; done in {moe['wall_s']:.1f} s "
          f"({gpu})")
    del frozen, run
    return moe


# ------------------------------------------------------------- phase 8

MOE_TRAIN = dict(arch="grok-1-314b", layers=1, experts_held=(0, 2),
                 vocab=32768, seed=0, steps=6, ckpt_at=3, batch=8, seq=64,
                 lr=1e-3, lam=0.05, lam_ramp=50, prompts=4, prompt_len=16,
                 max_new=8)
MOE_TRAIN_AXIS = 4        # the 'model' axis width the share is one shard of
# ECL passes whose q segment and expert 1 of down are held against the
# plain version: the first step's forward and the last step's
MOE_TRAIN_CHECKED_CALLS = (0, 2 * MOE_TRAIN["steps"] - 2)
MOE_SHARE_REL = 1e-5      # shares (0, 2) + (2, 2) vs the uncut layer, smoke
MOE_CARD_CPU_FWD = 1e-5   # smoke share: loss and aux, card vs CPU
MOE_CARD_CPU_GRAD = 1e-4  # smoke share: router w, a bank and its ω
MOE_LOSS0_TOL = 0.5       # the first loss within this of ln(vocab)
ADAM_BYTES_PER_PARAM = 28  # read p, g, m, v; write p, m, v (fp32)
CKPT_ROOM = 1.1           # free disk wanted over the state's bytes


def _ms(value):
    return "not measured" if value is None else f"{value:.2f}"


def _moe_train_cfg():
    """grok-1-314b at published widths, one shard's share of a 4-wide
    expert-parallel 'model' axis, cut to MOE_TRAIN["layers"] layers."""
    import dataclasses
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as T
    cfg = dataclasses.replace(
        T.lm_config(MOE_TRAIN["arch"], lam=MOE_TRAIN["lam"]),
        n_layers=MOE_TRAIN["layers"],
        experts_held=MOE_TRAIN["experts_held"], vocab=MOE_TRAIN["vocab"])
    steps_mod.check_trainable(cfg)
    return cfg


def _plain_pair(w, omega, pen):
    """``ecl_quant_plain`` of one segment (codes, ŵ), PLAIN_CHUNK elements
    a call (elementwise, so bitwise the whole segment's)."""
    import torch
    from repro_torch.kernels import ecl_quant as eq
    rows = max(1, PLAIN_CHUNK // w.shape[-1])
    parts = [eq.ecl_quant_plain(w[r:r + rows], omega, pen)
             for r in range(0, w.shape[0], rows)]
    return (torch.cat([c for c, _ in parts]),
            torch.cat([h for _, h in parts]))


def _digest(tree):
    """Two int64 sums over every leaf's bits (plain and position-weighted,
    taken on the card in chunks): equal digests for bitwise equal
    trees."""
    import torch
    from repro_torch.tree import leaves
    views = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
    out = []
    for t in leaves(tree):
        flat = t.detach().reshape(-1)
        flat = flat.view(views[flat.element_size()])
        acc = torch.zeros(2, dtype=torch.int64, device=flat.device)
        for i in range(0, flat.numel(), PLAIN_CHUNK):
            v = flat[i:i + PLAIN_CHUNK].to(torch.int64)
            pos = torch.arange(i, i + v.numel(), dtype=torch.int64,
                               device=v.device) % 1_000_003 + 1
            acc += torch.stack([v.sum(), (v * pos).sum()])
        out.append(acc)
    return torch.stack(out).cpu()


class _DropCounter:
    """Wraps ``moe_ffn`` while in use: for each call, on the device and
    without a host synchronisation, the assignments the capacity dropped
    over all experts, and those kept for the held experts."""

    def __init__(self, cfg):
        self.cfg, self.counts = cfg, []

    def __enter__(self):
        import torch
        from repro_torch.nn import moe
        self._orig, cfg = moe.moe_ffn, self.cfg
        first, count = moe.held_experts(cfg.experts_held, cfg.n_experts)

        def count_drops(p, q, x, ctx, **kw):
            with torch.no_grad():
                xt = x.reshape(-1, x.shape[-1]).to(torch.float32)
                ids, _, _ = moe.route(xt @ p["router"]["w"],
                                      p["router"]["bias_correction"],
                                      top_k=cfg.top_k, gate=cfg.moe_gate,
                                      routed_scaling=cfg.routed_scaling)
                cap = moe._capacity(xt.shape[0] * cfg.top_k, cfg.n_experts,
                                    cfg.capacity_factor)
                flat = ids.reshape(-1)
                _, keep = moe._dispatch_indices(flat, cfg.n_experts, cap)
                held = (flat >= first) & (flat < first + count)
                self.counts.append(torch.stack([
                    (~keep).sum(), (held & keep).sum(), held.sum()]))
            return self._orig(p, q, x, ctx, **kw)
        moe.moe_ffn = count_drops
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import moe
        moe.moe_ffn = self._orig


def _moe_train_smoke_checks(dev):
    """At grok's smoke width on the card: the shares (0, 2) and (2, 2) of
    one uncut layer add up to it (no shared expert in grok), and a
    share's fp32 loss, aux and the gradients of the router ``w``, the
    ``down`` bank and its ω equal the CPU's from the same init."""
    import dataclasses
    import torch
    from repro_torch import convert, tree
    from repro_torch.configs import get_config
    from repro_torch.core import qat
    from repro_torch.data import pipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as T
    from repro_torch.nn import moe
    from repro_torch.nn import transformer as TT
    from repro_torch.nn.module import FP32_CTX

    cfg = get_config(MOE_TRAIN["arch"]).smoke()
    layer = tree.map_(lambda t: t.to(dev), _layer0(TT.lm_init(
        cfg, seed=MOE_TRAIN["seed"], device="cpu")["stacks"]["moe"]["moe"]))
    x = torch.randn((MOE_TRAIN["batch"], MOE_TRAIN["seq"], cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    kw = dict(top_k=cfg.top_k, gate=cfg.moe_gate,
              capacity_factor=cfg.capacity_factor,
              routed_scaling=cfg.routed_scaling)
    half = cfg.n_experts // 2
    with torch.no_grad():
        whole, _ = moe.moe_apply(layer, 0, x, FP32_CTX, **kw)
        parts = [moe.moe_apply(convert.take_experts(layer, f, half, axis=0),
                               0, x, FP32_CTX, experts_held=(f, half), **kw)[0]
                 for f in (0, half)]
    share_rel = _rel(parts[0] + parts[1], whole)
    if share_rel > MOE_SHARE_REL:
        raise AssertionError(f"smoke shares off the uncut layer by "
                             f"{share_rel} relative")

    scfg = dataclasses.replace(cfg, experts_held=(0, half),
                               lam=MOE_TRAIN["lam"])
    params = TT.lm_init(scfg, seed=MOE_TRAIN["seed"], device="cpu")
    batch = T.lm_batch_fn(scfg, batch=MOE_TRAIN["batch"],
                          seq=MOE_TRAIN["seq"])(0)
    loss_fn = steps_mod._loss_fn(scfg, dtype=torch.float32)
    runs = []
    for where in (dev, torch.device("cpu")):
        p = tree.map_(lambda t: t.to(where).detach().requires_grad_()
                      if t.is_floating_point() else t.to(where), params)
        loss, m = loss_fn(p, qat.build_qstate(p),
                          pipeline.place(batch, device=where), scfg.lam)
        lp = p["stacks"]["moe"]["moe"]
        picked = (lp["router"]["w"], lp["experts"]["down"]["w"],
                  lp["experts"]["down"]["omega"])
        grads = torch.autograd.grad(loss, picked)
        runs.append((float(loss.detach()), float(m["aux"].detach()),
                     [g.cpu() for g in grads]))
    (lc, ac, gc), (lh, ah, gh) = runs
    fwd_rel = max(abs(lc - lh) / abs(lh), abs(ac - ah) / abs(ah))
    grad_rel = [_rel(a, b) for a, b in zip(gc, gh)]
    if fwd_rel > MOE_CARD_CPU_FWD or max(grad_rel) > MOE_CARD_CPU_GRAD:
        raise AssertionError(f"smoke share card vs CPU: loss/aux "
                             f"{fwd_rel}, gradients {grad_rel}")
    return {"shares_vs_uncut_max_rel": share_rel,
            "card_vs_cpu_loss_aux_max_rel": fwd_rel,
            "card_vs_cpu_grad_max_rel": dict(zip(
                ("router_w", "down_w", "down_omega"), grad_rel)),
            "loss_card": lc, "loss_cpu": lh}


def _moe_backward_twice(dev, cfg, state, batch):
    """The share's full-width loss differentiated twice from one state on
    the card: every gradient equal bit for bit."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import steps as steps_mod

    loss_fn = steps_mod._loss_fn(cfg)

    def grads():
        leaves = [t.detach().requires_grad_() if t.is_floating_point()
                  else t for t in tree.leaves(state["params"])]
        loss, _ = loss_fn(tree.unflatten(state["params"], leaves),
                          state["qstate"], batch, cfg.lam)
        wants = [t for t in leaves if t.requires_grad]
        return [g for g in torch.autograd.grad(loss, wants,
                                               allow_unused=True)
                if g is not None]
    first = grads()
    second = grads()
    differ = sum(not torch.equal(a, b) for a, b in zip(first, second))
    if len(first) != len(second) or differ:
        raise AssertionError(f"the MoE backward twice: {differ} of "
                             f"{len(first)} gradients differ")
    return len(first)


def _host_vs_card_decode(formats, export_dir: str, prefix: str,
                         dev) -> dict:
    """One tensor of an export decoded by the host codec and on the card,
    each timed, the codes compared: what decoding the export on the card
    saves at this size."""
    import numpy as np
    import torch
    sep = "//"
    with np.load(os.path.join(export_dir, "export.npz")) as z:
        fmt = z[prefix + sep + "format"].tobytes().decode()
        shape = tuple(int(d) for d in z[prefix + sep + "shape"])
        meta = {"format", "shape", "omega"}
        payload = {k[len(prefix + sep):]: z[k] for k in z.files
                   if k.startswith(prefix + sep)
                   and k[len(prefix + sep):] not in meta}
    ct = formats.CompressedTensor(fmt, (int(np.prod(shape[:-1])), shape[-1]),
                                  payload)
    t0 = time.perf_counter()
    host = formats.decode(ct)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    card = formats.decode(ct, dev)
    torch.cuda.synchronize(dev)
    card_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(card.cpu().numpy(), host):
        raise AssertionError(f"{prefix}: the card's decode != the host's")
    return {"tensor": prefix, "format": fmt, "codes": int(host.size),
            "host_ms": host_ms, "card_ms": card_ms}


def moe_train_path(dev, gpu):
    """Phase 8: EC4T-train one device's share of grok-1-314b at published
    widths (experts 0-1 of 8 and ids 0-32,767 of the vocabulary, one
    shard of a 4-wide expert-parallel 'model' axis) at depth 1 through the
    launcher's functions: 3 steps through ``FaultTolerantLoop`` and a
    checkpoint, 3 more in memory; a fresh state restored from the
    checkpoint takes the same 3 bit for bit; the 4-bit export, loaded
    back, serves the same greedy tokens as ``freeze_tree``'s tree."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint.manager import (CheckpointManager,
                                                _paths, export_quantized,
                                                frozen_tree, load_quantized)
    from repro_torch.configs import get_config
    from repro_torch.core import ecl, formats, qat
    from repro_torch.data import pipeline
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import train as T
    from repro_torch.nn import moe
    from repro_torch.nn import transformer as TT
    from repro_torch.optim import ec4t
    from repro_torch.runtime.fault import FaultTolerantLoop

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _moe_train_cfg()
    published = get_config(MOE_TRAIN["arch"])
    first, count = cfg.experts_held
    reduced = [f"depth {published.n_layers} -> {cfg.n_layers}",
               f"experts held {count} of {cfg.n_experts} ({first}-"
               f"{first + count - 1})",
               f"vocabulary {cfg.vocab:,} of {published.vocab:,} (ids 0-"
               f"{cfg.vocab - 1:,})"]
    deployment = (f"one shard of a {MOE_TRAIN_AXIS}-wide 'model' axis, "
                  f"expert-parallel as moe_ffn picks it ({cfg.n_experts} "
                  f"experts % {MOE_TRAIN_AXIS} == 0, the vocabulary "
                  f"sharded over it); attention whole on this card, more "
                  f"than its share")
    print(f"phase 8: {cfg.name} share: reduced {reduced}; deployment: "
          f"{deployment}")
    smoke = _moe_train_smoke_checks(dev)

    steps, at = MOE_TRAIN["steps"], MOE_TRAIN["ckpt_at"]
    step_fn = T.lm_step_fn(cfg, steps=steps, lr=MOE_TRAIN["lr"],
                           lam=MOE_TRAIN["lam"],
                           lam_ramp=MOE_TRAIN["lam_ramp"])
    batch_fn = T.lm_batch_fn(cfg, batch=MOE_TRAIN["batch"],
                             seq=MOE_TRAIN["seq"])
    state = ec4t.init_train_state(TT.lm_init(cfg, seed=MOE_TRAIN["seed"],
                                             device=dev))
    params_n = sum(t.numel() for t in tree.leaves(state["params"])
                   if t.is_floating_point())
    stack_p = state["params"]["stacks"]["moe"]
    stack_q = state["qstate"]["stacks"]["moe"]
    nodes = list(qat._quant_leaves(stack_p, stack_q))
    segments = sum(n["omega"][..., 0].numel() for n, _ in nodes)
    elements = sum(n["w"].numel() for n, _ in nodes)
    per_pass = -(-segments // eq.MAX_SEGMENTS)
    if segments != cfg.n_layers * (4 + len(MOE_BANKS) * count):
        raise AssertionError(f"{segments} ECL segments, expected q/k/v/o "
                             f"+ 3 banks x {count} held experts a layer")
    # each quantized leaf's place in a grouped pass (the tree's order)
    order = qat._map_quant_many(lambda ns, qs: list(range(len(ns))),
                                stack_p, stack_q, keep_params=True)
    picks = [(order["attn"]["q"]["kernel"], (0,)),
             (order["moe"]["experts"]["down"], (0, 1))]
    del order, nodes, stack_p, stack_q
    bias0 = state["params"]["stacks"]["moe"]["moe"]["router"][
        "bias_correction"].clone()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree.leaves(state))
    first_batch = pipeline.place(batch_fn(0), device=dev)
    grads_checked = _moe_backward_twice(dev, cfg, state, first_batch)
    del first_batch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"phase 8: checkpoint directory {tmp}: {free / 1e9:.1f} GB "
              f"free, the state is {state_bytes / 1e9:.1f} GB ({gpu})")
        if free < CKPT_ROOM * state_bytes:
            raise AssertionError(
                f"no room for the checkpoint: {free / 1e9:.1f} GB free in "
                f"{tmp}, {CKPT_ROOM * state_bytes / 1e9:.1f} GB wanted")
        ckpt_dir = os.path.join(tmp, "ckpt")
        export_dir = os.path.join(tmp, "export")
        history = []
        loop = FaultTolerantLoop(
            step_fn, CheckpointManager(ckpt_dir, keep=1), ckpt_every=at,
            metrics_every=1, on_metrics=lambda s, m: history.append(
                {"step": s, **{k: float(v) for k, v in m.items()}}))

        # the main path: counters zeroed just before, read just after
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eq.LAUNCHES = 0
        t0 = time.perf_counter()
        with _EclRecorder(ecl, eq, MOE_TRAIN_CHECKED_CALLS, None,
                          picks=picks, check=_plain_pair) as rec, \
                _DropCounter(cfg) as drops:
            feed = pipeline.ShardedFeed(batch_fn, start_step=0, device=dev)
            # the loop holds the only reference, so each step frees the
            # state before it (one state is 20.4 GB)
            held = [state]
            del state
            try:
                state, last, reason = loop.run(held.pop(), feed,
                                               start_step=0, total_steps=at)
            finally:
                feed.close()
            tail = []
            for i in range(at, steps):
                state, m = step_fn(state, pipeline.place(batch_fn(i),
                                                         device=dev))
                tail.append(m)
            torch.cuda.synchronize(dev)
            train_s = time.perf_counter() - t0
            step_launches = eq.LAUNCHES
            t0 = time.perf_counter()
            report = export_quantized(export_dir, state["params"],
                                      state["qstate"], cfg.lam)
            export_ms = (time.perf_counter() - t0) * 1e3
        export_launches = eq.LAUNCHES - step_launches
        peak_train = torch.cuda.max_memory_allocated(dev)
        if (reason, last) != ("done", at) or [s for s, _ in loop.saves] \
                != [at]:
            raise AssertionError(f"the loop ended {reason} at {last}, "
                                 f"saves {loop.saves}")
        history += [{"step": at + 1 + i, **{k: float(v) for k, v in
                                            m.items()}}
                    for i, m in enumerate(tail)]
        losses = [h["loss"] for h in history]
        auxes = [h["aux"] for h in history]
        if len(losses) != steps or not np.isfinite(losses + auxes).all():
            raise AssertionError(f"losses {losses}, aux {auxes}")
        if abs(losses[0] - np.log(cfg.vocab)) > MOE_LOSS0_TOL:
            raise AssertionError(f"first loss {losses[0]}, ln(vocab) "
                                 f"{np.log(cfg.vocab)}")
        per_call = [c["launches"] for c in rec.calls]
        if per_call != [per_pass] * (ECL_PASSES_PER_STEP * steps + 1) or \
                step_launches != per_pass * ECL_PASSES_PER_STEP * steps or \
                export_launches != per_pass:
            raise AssertionError(
                f"ecl_quant launches per grouped pass {per_call}: "
                f"{step_launches} in {steps} steps, {export_launches} in "
                f"the export; expected {per_pass} a pass")
        if any(c["segments"] != segments for c in rec.calls):
            raise AssertionError(f"an ECL pass did not take all {segments}"
                                 " segments")
        checked = []
        for i in MOE_TRAIN_CHECKED_CALLS:
            for (t_i, idx), equal in rec.calls[i]["equal"]:
                if not equal:
                    raise AssertionError(f"ECL pass {i}, tensor {t_i}"
                                         f"{list(idx)}: codes or ŵ != the "
                                         "plain version")
                checked.append([i, t_i, list(idx)])
        del rec
        dropped = torch.stack(drops.counts).cpu().tolist()
        bias = state["params"]["stacks"]["moe"]["moe"]["router"][
            "bias_correction"]
        if not torch.equal(bias, bias0):
            raise AssertionError("bias_correction moved in training")
        digest = _digest(state)
        ckpt_bytes = os.path.getsize(os.path.join(
            ckpt_dir, f"step_{at:08d}", "state.npz"))

        # the export loaded back == freeze_tree, and served alike
        t0 = time.perf_counter()
        loaded = load_quantized(export_dir, device=dev)
        load_ms = (time.perf_counter() - t0) * 1e3
        served = frozen_tree(loaded, device=dev)
        del loaded
        codec = _host_vs_card_decode(formats, export_dir,
                                     "stacks//moe//attn//q//kernel", dev)
        eq.LAUNCHES = 0
        frozen = qat.freeze_tree(state["params"], state["qstate"], cfg.lam)
        freeze_launches = eq.LAUNCHES
        want, got = dict(_paths(frozen)), dict(_paths(served))
        if sorted(want) != sorted(got) or not all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                for k in want):
            raise AssertionError("the loaded export != freeze_tree's tree")
        bank = got["stacks//moe//moe//experts//down//packed"]
        if tuple(bank.shape) != (cfg.n_layers, count, cfg.d_ff // 2,
                                 cfg.d_model):
            raise AssertionError(f"packed down bank {tuple(bank.shape)}")
        prompts = np.random.default_rng(MOE_TRAIN["seed"]).integers(
            0, cfg.vocab, (MOE_TRAIN["prompts"], MOE_TRAIN["prompt_len"]))
        serve_export = _lm_direct(dev, cfg, served, prompts,
                                  MOE_TRAIN["max_new"])
        serve_freeze = _lm_direct(dev, cfg, frozen, prompts,
                                  MOE_TRAIN["max_new"])
        if not (np.array_equal(serve_export["tokens"],
                               serve_freeze["tokens"])
                and bool(torch.isfinite(serve_export["logits"]).all())):
            raise AssertionError("the export's tokens != freeze_tree's")
        export_bytes = os.path.getsize(os.path.join(export_dir,
                                                    "export.npz"))
        del served, frozen, want, got, bank, serve_freeze
        serve_export.pop("cache")

        # resume: a fresh state restored from the step-3 checkpoint takes
        # steps 4-6 as the uninterrupted run took them, bit for bit
        del state, bias
        gc.collect()
        torch.cuda.empty_cache()
        fresh = ec4t.init_train_state(TT.lm_init(
            cfg, seed=MOE_TRAIN["seed"] + 1, device=dev))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        restored, start = FaultTolerantLoop(
            step_fn, CheckpointManager(ckpt_dir, keep=1)).resume_or(fresh)
        torch.cuda.synchronize(dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
        del fresh
        resumed = []
        for i in range(at, steps):
            restored, m = step_fn(restored, pipeline.place(batch_fn(i),
                                                           device=dev))
            resumed.append(m["loss"])
        resumed = [float(v) for v in resumed]
        if start != at or resumed != losses[at:] or \
                not torch.equal(_digest(restored), digest):
            raise AssertionError(f"resumed at {start}: losses {resumed}, "
                                 f"uninterrupted {losses[at:]}; digests "
                                 "equal "
                                 f"{torch.equal(_digest(restored), digest)}")

    # one grouped ECL pass of a train step, its plain version, its bounds
    sp, sq = restored["params"]["stacks"]["moe"], \
        restored["qstate"]["stacks"]["moe"]
    nodes = list(qat._quant_leaves(sp, sq))
    ws = [n["w"] for n, _ in nodes]
    oms = [n["omega"] for n, _ in nodes]
    pens = [ecl.penalty(n["w"], q["probs"], cfg.lam) for n, q in nodes]

    def ecl_pass():
        return ecl.quantize_many(ws, oms, pens)

    def ecl_plain():
        for w, om, pn in zip(ws, oms, pens):
            w3, om3, pn3 = (w.reshape(-1, *w.shape[-2:]), om.reshape(-1, 4),
                            pn.reshape(-1, 16))
            for i in range(w3.shape[0]):
                _plain_pair(w3[i], om3[i], pn3[i])
    pass_bound = ECL_BYTES_PER_ELEM * elements / PEAK_BYTES * 1e3
    ecl_row = {"ms": _time_ms(ecl_pass, dev, 1),
               **_device_time(ecl_pass, dev, 1, ECL_SYMBOL,
                              launches=lambda: eq.LAUNCHES),
               "queued_ms": _queued_ms(ecl_pass, dev, 2),
               "plain_ms": _once_ms(ecl_plain, dev),
               "bound_ms": pass_bound, "bound_by": "bytes",
               "codes_only_bound_ms":
                   ECL_CODES_BYTES_PER_ELEM * elements / PEAK_BYTES * 1e3,
               "library_ms": None, "segments": segments,
               "elements": elements, "launches_per_call": per_pass}
    del ws, oms, pens, nodes, sp, sq
    holder = [restored]
    del restored
    trace = _lm_train_trace(
        dev, step_fn, holder,
        pipeline.place(batch_fn(steps), device=dev), timed=3)
    del holder
    gc.collect()
    torch.cuda.empty_cache()
    if trace["host_syncs_per_step"]:
        raise AssertionError(f"host synchronisations inside a step: "
                             f"{trace['host_syncs_per_step']}")
    adam_bound = ADAM_BYTES_PER_PARAM * params_n / PEAK_BYTES * 1e3
    per_step = [{"dropped": d, "kept_held": k, "assigned_held": a}
                for d, k, a in dropped]
    out = {
        **MOE_TRAIN, "arch": cfg.name, "published_layers":
            published.n_layers, "published_vocab": published.vocab,
        "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "n_experts": cfg.n_experts, "top_k": cfg.top_k,
        "capacity": moe._capacity(
            MOE_TRAIN["batch"] * MOE_TRAIN["seq"] * cfg.top_k,
            cfg.n_experts, cfg.capacity_factor),
        "reduced": reduced, "deployment": deployment,
        "compute_dtype": "bfloat16", "params": params_n,
        "quant_weights": elements, "state_bytes": state_bytes,
        "losses": losses, "aux": auxes, "resumed_losses": resumed,
        "train_wall_s": train_s, "ecl_quant_launches": step_launches,
        "ecl_quant_launches_export": export_launches,
        "ecl_quant_launches_freeze": freeze_launches,
        "ecl_quant_launches_per_pass": per_pass,
        "ecl_quant_passes": len(per_call), "ecl_segments_checked": checked,
        "backward_twice_gradients_equal": grads_checked,
        "dropped_by_step": per_step, **trace,
        "ecl_quant_bound_ms_per_pass": pass_bound,
        "ecl_quant_bound_ms_per_step": ECL_PASSES_PER_STEP * pass_bound,
        "ecl_quant_pass": ecl_row, "adam_bound_ms": adam_bound,
        "peak_device_memory_bytes": peak_train,
        "checkpoint_bytes": ckpt_bytes,
        "checkpoint_save_ms": [s * 1e3 for _, s in loop.saves],
        "checkpoint_restore_ms": restore_ms,
        "export_bytes": export_bytes,
        "export_compressed_bytes": report["compressed_bytes"],
        "export_compression_ratio": report["compression_ratio"],
        "export_formats": sorted({t["format"] for t in
                                  report["tensors"].values()}),
        "export_ms": export_ms, "export_load_ms": load_ms,
        "export_host_vs_card_decode": codec,
        "served_tokens_0": serve_export["tokens"][0].tolist(),
        "smoke": smoke, "gpu": gpu,
        "wall_s": time.perf_counter() - t_phase}
    gb = 1e-9
    peaks = trace["peak_device_memory_bytes_by_stage"]
    print(f"phase 8: {cfg.name} share EC4T-trained {steps} steps at batch "
          f"{MOE_TRAIN['batch']} x seq {MOE_TRAIN['seq']} (bf16): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, aux {auxes[0]:.4f} -> "
          f"{auxes[-1]:.4f}; {step_launches} ecl_quant launches ({per_pass} "
          f"a pass, {segments} segments) + {export_launches} in the export; "
          f"resume bitwise; export == freeze_tree, tokens equal ({gpu})")
    print(f"phase 8: {trace['ms_per_step']:.1f} ms/step, device "
          f"{trace['device_ms_per_step']:.1f} ms/step, idle "
          f"{trace['device_idle_share']:.3f}, "
          f"{trace['device_ops_per_step']:.0f} device ops; ECL "
          f"{trace['ecl_quant_device_ms_per_step']:.2f} ms/step against "
          f"{2 * pass_bound:.2f} (bytes; codes only "
          f"{2 * ecl_row['codes_only_bound_ms']:.2f}); adam.apply "
          f"{_ms(trace['adam_apply_device_ms_per_step'])} ms against "
          f"{adam_bound:.2f}; FakeQuantGroup.backward "
          f"{_ms(trace['fake_quant_backward_device_ms_per_step'])} ms; "
          f"update_qstate {_ms(trace['update_qstate_device_ms_per_step'])} "
          f"ms ({gpu})")
    print(f"phase 8: peak memory after forward "
          f"{peaks.get('forward', 0) * gb:.1f} GB, backward "
          f"{peaks.get('backward', 0) * gb:.1f}, adam "
          f"{peaks.get('adam', 0) * gb:.1f}, update "
          f"{peaks.get('update_qstate', 0) * gb:.1f}; main path peak "
          f"{peak_train * gb:.1f} GB; checkpoint "
          f"{ckpt_bytes * gb:.2f} GB saved in "
          f"{out['checkpoint_save_ms'][0]:.0f} ms, restored in "
          f"{restore_ms:.0f} ms; export {export_bytes * gb:.3f} GB "
          f"({report['compression_ratio']:.2f}x) in {export_ms:.0f} ms, "
          f"loaded in {load_ms:.0f} ms (the attention q's "
          f"{codec['codes']:,} codes, {codec['format']}: decoded on the "
          f"host in {codec['host_ms']:.0f} ms, on the card in "
          f"{codec['card_ms']:.0f} ms, the same codes); dropped a step "
          f"{[d for d, _, _ in dropped]}, held kept "
          f"{[k for _, k, _ in dropped]} of {[a for _, _, a in dropped]} "
          f"({gpu})")
    print(f"phase 8: smoke shares vs uncut {smoke['shares_vs_uncut_max_rel']:.2e}"
          f", card vs CPU loss/aux "
          f"{smoke['card_vs_cpu_loss_aux_max_rel']:.2e}, gradients "
          f"{max(smoke['card_vs_cpu_grad_max_rel'].values()):.2e}; done in "
          f"{out['wall_s']:.1f} s ({gpu})")
    return out


# ------------------------------------------------------------- phase 9

MLA_SERVE = dict(arch="deepseek-v3-671b", layers=4, experts_held=(0, 8),
                 ep=32, seed=0, prompts=2, prompt_len=8192, max_new=16)
MLA_DECODE_UNIT = dict(ep=320, experts_held=1)
MLA_REL = 1e-4            # MLA, the two forms, re-prefill, MoE: relative
MLA_REF_HEADS = 16        # heads of the plain reference's attention a pass
EMPTY_CARD_BYTES = 1 << 30   # what phase 9 may find allocated at its start


def _mla_serve_cfg():
    """deepseek-v3-671b at its published widths: depth 4 (the 3 leading
    dense layers and the first MoE layer) and experts 0-7 of 256 held,
    one GPU's share of an EP32 deployment."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MLA_SERVE["arch"]),
                               n_layers=MLA_SERVE["layers"],
                               experts_held=MLA_SERVE["experts_held"])


def _mla_freeze(dev, cfg):
    """Phase 9's freeze (:func:`_gated_freeze`): 5 MLA leaves a layer, the
    dense FFN's 3, the held experts' 3 banks and the shared expert's 3;
    codes of layer 0's q_down and kv_up and of the first and last held
    expert of every bank checked."""
    first, count = cfg.experts_held
    n_moe = cfg.n_layers - cfg.n_dense_layers
    want = (cfg.n_dense_layers * (5 + 3)
            + n_moe * (5 + len(MOE_BANKS) * count + 3))
    checks = [("dense", ("attn", name, "kernel"), (0,))
              for name in ("q_down", "kv_up")] + [
        ("moe", ("moe", "experts", b), (0, e)) for b in MOE_BANKS
        for e in (0, count - 1)]
    return _gated_freeze(dev, cfg, MLA_SERVE["seed"], want,
                         "5 MLA + 3 FFN a dense layer; 5 MLA + 3 banks x "
                         f"{count} held experts + 3 shared a MoE layer",
                         checks)


class _MlaRecorder:
    """Records the calls of ``mla_apply`` whose index is in ``picks``
    (its input, keyword arguments, input cache and output) while in use;
    the transformer looks ``mla_apply`` up on its module at every call."""

    def __init__(self, picks):
        self.picks, self.calls, self.n = set(picks), {}, 0

    def __enter__(self):
        from repro_torch.nn import attention
        self._orig = attention.mla_apply

        def record(p, q, x, ctx, cfg, **kw):
            y, cache = self._orig(p, q, x, ctx, cfg, **kw)
            if self.n in self.picks:
                self.calls[self.n] = (x.detach().clone(), kw,
                                      y.detach().clone())
            self.n += 1
            return y, cache
        attention.mla_apply = record
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import attention
        attention.mla_apply = self._orig


def _mla_plain_ref(p, x, cfg, positions):
    """The MLA block in plain fp32 PyTorch: every weight decoded from its
    codes, K and V decompressed from the latent whole, rotary applied, and
    ``dense_attention_ref`` over all keys, MLA_REF_HEADS heads a pass."""
    import torch
    from repro_torch.core import qat
    from repro_torch.nn import attention as attn
    from repro_torch.nn.layers import apply_rotary, rope_cos_sin

    m = cfg.mla
    nope, rope, dv, r = (m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
                         m.kv_lora_rank)
    h = cfg.n_heads
    b, s, _ = x.shape
    w = {k: qat.decode_frozen(p[k]["kernel"])
         for k in ("q_down", "q_up", "kv_down", "kv_up", "o")}
    q = ((x @ w["q_down"]) @ w["q_up"]).view(b, s, h, nope + rope)
    kv = x @ w["kv_down"]
    cos, sin = rope_cos_sin(positions, rope, cfg.rope_theta)
    q = torch.cat([q[..., :nope], apply_rotary(q[..., nope:], cos, sin)], -1)
    kr = apply_rotary(kv[..., None, r:], cos, sin)          # (b, s, 1, rope)
    kvu = (kv[..., :r] @ w["kv_up"]).view(b, s, h, nope + dv)
    k = torch.cat([kvu[..., :nope], kr.expand(b, s, h, rope)], -1)
    out = torch.empty((b, s, h, dv), dtype=torch.float32, device=x.device)
    for h0 in range(0, h, MLA_REF_HEADS):
        sl = slice(h0, h0 + MLA_REF_HEADS)
        out[:, :, sl] = attn.dense_attention_ref(
            q[:, :, sl], k[:, :, sl], kvu[:, :, sl, nope:], positions,
            positions, causal=True, scale=(nope + rope) ** -0.5)
    return out.reshape(b, s, h * dv) @ w["o"]


def _moe_decode_checks(cfg, p, calls):
    """Every recorded decode call of the MoE layer ``p`` against the
    per-token share reference: (max relative error, held assignments a
    step); a decode step must drop nothing."""
    first, count = cfg.experts_held
    rel, held = 0.0, []
    for x, y in calls:
        if x.shape[1] != 1:
            raise AssertionError(f"a decode MoE call of shape {x.shape}")
        if not bool(_dispatch_of(p, x, cfg)[1].all()):
            raise AssertionError("a decode step dropped an assignment")
        want, ids = _moe_dense_ref(p, x, cfg)
        rel = max(rel, _rel(y, want))
        held.append(int(((ids >= first) & (ids < first + count)).sum()))
    return rel, held


def _decode_unit(dev, cfg, frozen, cache, tokens, s):
    """The decode at one GPU's share of the DeepSeek-V3 report's decode
    unit (arXiv:2412.19437 §3.4.2: EP320, one routed expert a GPU): the
    held banks cut to the first held expert (``convert.take_experts``),
    then the ``new - 1`` decode steps of the served run fed its tokens,
    from its cache rewound to the prompt (``len`` back to ``s``: each step
    rewrites its own slot, and the causal mask hides the later ones).  At
    depth 4 the MoE layer comes last, so every attention input, and with
    it the cache, is the served run's.  Returns ms a step (CUDA events),
    a traced step's device ms, operations and idle share, the held
    assignments a step, and the MoE output of every step against the
    per-token share reference (gated at MLA_REL)."""
    import dataclasses
    import torch
    from repro_torch.convert import take_experts
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX

    first, _ = cfg.experts_held
    held = (first, MLA_DECODE_UNIT["experts_held"])
    ucfg = dataclasses.replace(cfg, experts_held=held)
    ufrozen = take_experts(frozen, 0, held[1])
    b, new = tokens.shape
    fed = torch.from_numpy(tokens).to(dev)
    state = {kind: {"attn": {**c["attn"], "len": c["attn"]["len"] - (new - 1)}}
             for kind, c in cache.items()}
    clock = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def step(t, c):
        p_t = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
        return T.lm_apply(ufrozen, 0, fed[:, t:t + 1], FP32_CTX, ucfg,
                          positions=p_t, cache=c)

    with torch.no_grad(), _MoeRecorder() as rec:
        torch.cuda.synchronize(dev)
        clock[0].record()
        for t in range(new - 1):
            _, state, _ = step(t, state)
        clock[1].record()
        torch.cuda.synchronize(dev)
    ms = clock[0].elapsed_time(clock[1]) / max(new - 1, 1)
    rel, held_by_step = _moe_decode_checks(
        ucfg, _layer0(ufrozen["stacks"]["moe"]["moe"]), rec.calls)
    if rel > MLA_REL:
        raise AssertionError(f"decode unit: MoE output off the per-token "
                             f"share reference by {rel} relative")

    def last_step():
        with torch.no_grad():
            return step(new - 2, state)

    trace, _ = _step_trace(last_step, dev, 3)
    return {"deployment": f"one GPU of EP{MLA_DECODE_UNIT['ep']}, "
                          "arXiv:2412.19437 §3.4.2, the decode unit",
            "experts_held": list(held), "decode_ms_per_step": ms,
            "trace": trace, "held_by_step": held_by_step,
            "moe_max_rel_err": rel}


def _on_card(tree):
    from repro_torch.tree import leaves
    return all(t.device.type == "cuda" for t in leaves(tree)
               if hasattr(t, "device"))


def mla_serve_path(dev, gpu):
    """Phase 9: one GPU's share of deepseek-v3-671b at its published widths
    (depth 4, experts 0-7 of 256), frozen to 4 bits on the card and served
    with multi-head latent attention through the direct ``lm_apply`` path,
    first by the launcher's serving function on the share."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import serve
    from repro_torch.nn import attention as attn
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    start_bytes = torch.cuda.memory_allocated(dev)
    if start_bytes > EMPTY_CARD_BYTES:
        raise AssertionError(f"phase 9 starts with {start_bytes / 1e9:.2f} "
                             "GB allocated on the card")
    cfg = _mla_serve_cfg()
    m, first, count = cfg.mla, *cfg.experts_held
    b, s, new = (MLA_SERVE["prompts"], MLA_SERVE["prompt_len"],
                 MLA_SERVE["max_new"])
    published = get_config(cfg.name).n_layers
    print(f"phase 9: {cfg.name}, reduced: depth {published} -> "
          f"{cfg.n_layers} (the {cfg.n_dense_layers} dense layers and "
          f"one MoE layer), experts {cfg.n_experts} -> {count} held "
          f"({first}-{first + count - 1}: one GPU of EP{MLA_SERVE['ep']}); "
          f"router {cfg.n_experts} wide, top-{cfg.top_k}, shared expert, "
          f"attention and vocabulary {cfg.vocab} whole ({gpu})")

    # the main path, as the launcher serves a share a caller hands it
    argv = ["--arch", MLA_SERVE["arch"], "--batch", str(b), "--prompt-len",
            str(s), "--max-new", str(new), "--seed", str(MLA_SERVE["seed"])]
    args = serve.parse_args(argv)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eq.LAUNCHES = 0
    t0 = time.perf_counter()
    gen = serve.serve_lm_config(cfg, args)
    torch.cuda.synchronize(dev)
    launcher = {"argv": argv, "experts_held": list(cfg.experts_held),
                "wall_s": time.perf_counter() - t0,
                "ecl_quant_launches": eq.LAUNCHES,
                "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    if gen.shape != (b, new) or not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"launcher returned ids of shape {gen.shape}")
    gc.collect()
    torch.cuda.empty_cache()

    frozen, freeze, ecl_row = _mla_freeze(dev, cfg)
    if launcher["ecl_quant_launches"] != freeze["ecl_quant_launches"]:
        raise AssertionError(f"the launcher made "
                             f"{launcher['ecl_quant_launches']} ecl_quant "
                             f"launches, the freeze "
                             f"{freeze['ecl_quant_launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(dev)

    prompts = np.random.default_rng(MLA_SERVE["seed"]).integers(
        0, cfg.vocab, (b, s))
    n_layers = cfg.n_layers
    with _MoeRecorder() as rec, _MlaRecorder((0, n_layers)) as mrec:
        run = _lm_direct(dev, cfg, frozen, prompts, new)
    if not bool(torch.isfinite(run["logits"]).all()):
        raise AssertionError("non-finite logits")
    if not np.array_equal(run["tokens"], gen):
        raise AssertionError("the gated run's tokens != the launcher's")
    if not (_on_card(frozen) and _on_card(run["cache"])):
        raise AssertionError("a frozen leaf or the cache left the card")

    # MLA at full width: the naive prefill against the plain reference
    pa = _layer0(frozen["stacks"]["dense"]["attn"])
    x0, kw0, y0 = mrec.calls[0]
    want = _mla_plain_ref(pa, x0, cfg, kw0["positions"])
    naive_rel = _rel(y0, want)
    del want, x0, y0
    if naive_rel > MLA_REL:
        raise AssertionError(f"MLA prefill (naive) off the plain reference "
                             f"by {naive_rel} relative")
    # the two forms at the first decode step, from the same cache
    x1, kw1, y1 = mrec.calls[n_layers]
    mcfg = T._mla_cfg(cfg)
    forms = {}
    with torch.no_grad():
        for name, force in (("absorbed", True), ("naive", False)):
            forms[name], _ = attn.mla_apply(pa, 0, x1, FP32_CTX, mcfg,
                                            force_absorbed=force, **kw1)
    forms_rel = _rel(forms["absorbed"], forms["naive"])
    served_rel = _rel(y1, forms["absorbed"])
    if max(forms_rel, served_rel) > MLA_REL:
        raise AssertionError(f"decode step: the absorbed form off the naive "
                             f"by {forms_rel}, the served step off the "
                             f"absorbed form by {served_rel} relative")
    del mrec, forms, kw1, x1, y1

    # the MoE layer: routing card vs CPU, the decode step and the prefill
    # against the per-token share reference
    p = _layer0(frozen["stacks"]["moe"]["moe"])
    x_pre, y_pre = rec.calls[0]
    if len(rec.calls) != new or x_pre.shape != (b, s, cfg.d_model):
        raise AssertionError(f"{len(rec.calls)} MoE calls recorded")
    route_err = _moe_route_checks(dev, cfg, p, x_pre)
    decode_rel, held_dec = _moe_decode_checks(cfg, p, rec.calls[1:])
    ids_pre, keep_pre, cap_pre = _dispatch_of(p, x_pre, cfg)
    prefill_moe_rel = _rel(y_pre,
                           _moe_dense_ref(p, x_pre, cfg, keep_pre)[0])
    if max(decode_rel, prefill_moe_rel) > MLA_REL:
        raise AssertionError(f"MoE output off the per-token share reference "
                             f"by {decode_rel} (decode), {prefill_moe_rel} "
                             "(prefill) relative")
    if not sum(held_dec):
        raise AssertionError(f"none of the {new - 1} decode steps routed an "
                             "assignment to a held expert: the decode gate "
                             "held no bank against the reference")
    held = lambda ids: (ids >= first) & (ids < first + count)   # noqa: E731
    routed = {"prefill_assignments": int(ids_pre.numel()),
              "prefill_held": int(held(ids_pre).sum()),
              "prefill_dropped": int((~keep_pre).sum()),
              "prefill_held_dropped": int((held(ids_pre) & ~keep_pre).sum()),
              "prefill_capacity": cap_pre,
              "decode_held_by_step": held_dec}
    del rec, x_pre, y_pre

    # the cache against a re-prefill of each sequence's 8,207 tokens
    seqs = np.concatenate([prompts, run["tokens"][:, :-1]], axis=1)
    re_prefill, re_prefill_drops = _moe_re_prefill(
        dev, cfg, frozen, seqs, run["logits"][:, -1])

    cache = run["cache"]
    latent = sum(c["attn"][k].numel() * c["attn"][k].element_size()
                 for c in cache.values() for k in ("ckv", "krope"))
    slots = b * (s + new) * n_layers
    kv_bytes = slots * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim
                                      + m.v_head_dim) * 4
    step_tok = torch.from_numpy(run["tokens"][:, -1:]).to(dev)
    step_pos = torch.full((b, 1), s + new - 1, dtype=torch.int32, device=dev)

    def decode_step():
        with torch.no_grad():
            return T.lm_apply(frozen, 0, step_tok, FP32_CTX, cfg,
                              positions=step_pos, cache=cache)

    trace, _ = _step_trace(decode_step, dev, 3)
    timing = {k: run[k] for k in ("prefill_ms", "decode_ms",
                                  "prefill_peak_bytes", "decode_peak_bytes")}
    unit = _decode_unit(dev, cfg, frozen, cache, run["tokens"], s)
    del frozen, run, cache
    gc.collect()
    torch.cuda.empty_cache()
    smoke = _moe_smoke_card_vs_cpu(dev, MLA_SERVE["arch"])

    out = {
        "arch": cfg.name, "layers": cfg.n_layers,
        "published_layers": published,
        "reduced": {"n_layers": [published, n_layers],
                    "experts_held": [cfg.n_experts, count]},
        "deployment": f"one GPU of EP{MLA_SERVE['ep']} (DeepSeek-V3 report, "
                      "arXiv:2412.19437 §3.4.1, the prefill unit); the "
                      "decode metrics at this share too, and `decode_unit` "
                      "at the decode unit's",
        "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "mla": {"q_lora": m.q_lora_rank, "kv_lora": m.kv_lora_rank,
                "nope": m.qk_nope_dim, "rope": m.qk_rope_dim,
                "v": m.v_head_dim},
        "dense_ff": cfg.dense_ff, "d_ff": cfg.d_ff,
        "n_experts": cfg.n_experts, "experts_held": list(cfg.experts_held),
        "top_k": cfg.top_k, "vocab": cfg.vocab,
        "sequences": b, "prompt_len": s, "max_new": new,
        "start_device_bytes": start_bytes,
        "launcher": launcher, "freeze": freeze, "ecl_quant": ecl_row,
        "resident_device_bytes": resident,
        "prefill_ms": timing["prefill_ms"],
        "decode_ms_per_step": timing["decode_ms"],
        "prefill_peak_device_bytes": timing["prefill_peak_bytes"],
        "decode_peak_device_bytes": timing["decode_peak_bytes"],
        "decode_step_trace": trace, "decode_unit": unit,
        "latent_cache_bytes": latent, "uncompressed_kv_bytes": kv_bytes,
        "latent_bytes_per_token_layer": latent // slots,
        "kv_bytes_per_token_layer": kv_bytes // slots,
        "mla_naive_vs_plain_max_rel": naive_rel,
        "absorbed_vs_naive_max_rel": forms_rel,
        "served_step_vs_absorbed_max_rel": served_rel,
        "route_max_err_card_vs_cpu": route_err,
        "decode_moe_max_rel_err": decode_rel,
        "prefill_moe_max_rel_err": prefill_moe_rel, "routing": routed,
        "re_prefill_max_rel_err": re_prefill,
        "re_prefill_dropped_at_served_capacity": re_prefill_drops,
        "smoke_card_vs_cpu": smoke, "tokens_0": gen[0].tolist(), "gpu": gpu,
        "wall_s": time.perf_counter() - t_phase}
    gb = 1e-9
    print(f"phase 9: frozen in {freeze['ms']:.1f} ms "
          f"({freeze['ecl_quant_launches']} ecl_quant launches, "
          f"{freeze['segments']} segments, {freeze['quant_weights']:,} "
          f"elements; ECL device {ecl_row['device_ms']:.2f} ms "
          f"[{ecl_row['device_ms_from']}] against a "
          f"{ecl_row['bound_ms']:.2f} ms byte bound, "
          f"{ecl_row['codes_only_bound_ms']:.2f} codes-only), peak "
          f"{freeze['peak_device_bytes'] * gb:.1f} GB ({gpu})")
    print(f"phase 9: prefill of {b} x {s} {timing['prefill_ms']:.1f} ms "
          f"(peak {timing['prefill_peak_bytes'] * gb:.1f} GB), decode "
          f"{timing['decode_ms']:.2f} ms/step (peak "
          f"{timing['decode_peak_bytes'] * gb:.1f} GB), device "
          f"{trace['device_ms_per_step']:.2f} ms/step, "
          f"{trace['device_ops_per_step']:.0f} device ops, idle "
          f"{trace['device_idle_share']:.3f}; the launcher's peak "
          f"{launcher['peak_device_bytes'] * gb:.1f} GB ({gpu})")
    print(f"phase 9: decode at the decode unit's share ({unit['deployment']}"
          f"): {unit['decode_ms_per_step']:.2f} ms/step, device "
          f"{unit['trace']['device_ms_per_step']:.2f} ms/step, idle "
          f"{unit['trace']['device_idle_share']:.3f}, "
          f"{sum(unit['held_by_step'])} held assignments in "
          f"{len(unit['held_by_step'])} steps, MoE "
          f"{unit['moe_max_rel_err']:.2e} ({gpu})")
    print(f"phase 9: latent cache {latent / 1e6:.1f} MB "
          f"({out['latent_bytes_per_token_layer']} B a token a layer) "
          f"against {kv_bytes / 1e6:.1f} MB of K and V "
          f"({out['kv_bytes_per_token_layer']} B), "
          f"{kv_bytes / latent:.1f}x less; prefill dropped "
          f"{routed['prefill_dropped']} of {routed['prefill_assignments']} "
          f"assignments (held: {routed['prefill_held_dropped']} of "
          f"{routed['prefill_held']}, capacity {cap_pre}), the re-prefills "
          f"{re_prefill_drops} at the served factor ({gpu})")
    print(f"phase 9: MLA naive vs plain {naive_rel:.2e}, absorbed vs naive "
          f"{forms_rel:.2e}, MoE decode {decode_rel:.2e} / prefill "
          f"{prefill_moe_rel:.2e} ({sum(held_dec)} held decode assignments in "
          f"{new - 1} steps), re-prefill {re_prefill:.2e}, route "
          f"{route_err:.2e}, smoke card vs CPU "
          f"{smoke['max_abs_logit_err']:.2e}; done in {out['wall_s']:.1f} s "
          f"({gpu})")
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
    ecl_err = check_ecl_quant(dev)
    launches, path = main_path(dev)
    trained, train = train_path(dev)
    times, grid = timings(dev)
    floor = contract_floor(dev)
    ecl_times = ecl_timings(dev)
    train["step_timing"] = train_step_timing(dev)
    # the threaded phase runs after the single-stream timings
    frontend = frontend_path(dev, trained)
    lm = lm_path(dev)
    lm_train = lm_train_path(dev)
    moe = moe_path(dev, gpu)
    moe_train = moe_train_path(dev, gpu)
    mla = mla_serve_path(dev, gpu)

    report = []
    for name, (sched, replaces) in KERNELS.items():
        per = times[name]
        head = per[64]
        report.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "schedule": sched,
            "launches": launches[name],
            "launches_by_path": {
                "serving": launches[name],
                "training_serve": train["serve_launches"][
                    "fantastic4_matmul" if sched == "chain" else sched],
                "frontend": frontend["session"]["launches"][name],
                "lm": lm["kernel_launches"][name]},
            "max_abs_err": max_err[name],
            "int8_max_rel_err": max_rel8[name],
            "ms": head["ms"], "kernel_ms": head["ms"],
            "device_ms": head["device_ms"],
            "device_ms_from": head["device_ms_from"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"],
            "library_device_ms_from": head["library_device_ms_from"],
            "at": "mlp-gsc batch 64 fp32",
            "by_batch": {str(b): v for b, v in per.items()},
            "smollm_shapes": {k: v for k, v in lm["ffn_timed"].items()
                              if v["schedule"] == sched}})
    head = ecl_times["mlp-gsc 7 tensors grouped"]
    report.append({
        "name": "ecl_quant", "route": "cuda", "source": ECL_SOURCE,
        "replaces": TPU_KERNELS + "ecl_quant.py:56",
        "launches": train["ecl_quant_launches"],
        "launches_by_path": {"training": train["ecl_quant_launches"],
                             "lm": lm["freeze"]["ecl_quant_launches"],
                             "lm_training": lm_train["ecl_quant_launches"],
                             "moe": moe["launcher"]["ecl_quant_launches"],
                             "moe_train": moe_train["ecl_quant_launches"]
                             + moe_train["ecl_quant_launches_export"],
                             "mla": mla["launcher"]["ecl_quant_launches"]},
        "max_abs_err": ecl_err,
        "ms": head["ms"], "kernel_ms": head["ms"],
        "device_ms": head["device_ms"],
        "device_ms_from": head["device_ms_from"],
        "queued_ms": head["queued_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "at": "mlp-gsc 7 tensors, one grouped launch",
        "by_shape": ecl_times,
        "smollm_freeze": lm["ecl_quant"],
        "grok_freeze": moe["ecl_quant"],
        "deepseek_freeze": mla["ecl_quant"],
        "grok_share_training": {
            "pass": moe_train["ecl_quant_pass"],
            **{k: moe_train[k] for k in (
                "ecl_quant_device_ms_per_step", "ecl_quant_bound_ms_per_step",
                "quant_weights")}},
        "smollm_training": {
            "pass": lm_train["ecl_quant_pass"],
            **{k: lm_train[k] for k in (
                "ecl_quant_device_ms_per_step", "ecl_quant_bound_ms_per_step",
                "quant_weights")}}})
    print(json.dumps({"grid": grid, "contract_floor": floor}))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"path": path}))
    print(json.dumps({"train": train}))
    print(json.dumps({"frontend": frontend}))
    print(json.dumps({"lm": lm}))
    print(json.dumps({"lm_train": lm_train}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"moe_train": moe_train}))
    print(json.dumps({"mla": mla}))
    print(f"profiler traces: {TRACES['taken']} taken, {TRACES['retried']} "
          "retaken for want of the kernel's device time; "
          f"{TRACES['events']} device times from CUDA events for want of "
          "a whole trace")
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
