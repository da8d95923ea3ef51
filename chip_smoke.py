#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 1,10

With no argument every phase runs, in the order below.  ``--phases``
names the phases to run (phase 1, the build, always runs; 3c brings 3b,
whose trained pack it serves); each runs with the gates it has in the
whole run, and the script ends with the same last line.  The ``grid``
and ``kernels`` lines need every phase and are printed only then.

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
   the copies the kernels read, and in the cold tier; 60 waves, more up
   to 240 until the cold flip has fired) returns no result
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
   7, phase 8, phase 9, phase 10, phases 11 to 14 by arch, phases 15 and
   16),
   one ``path``, one ``train``, one ``frontend``, one ``lm``, one
   ``lm_train``, one ``moe``, one ``moe_train``, one ``mla``, one
   ``mla_train``, one ``ssm``, one ``ssm_train``, one ``vlm_audio``, one
   ``vlm_audio_train``, one ``scale_out`` and one ``mesh_train`` JSON
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

10. MLA training at published widths, run after phase 9 (whose state is
   freed first: at most 1 GiB allocated at its start): one GPU's share of
   deepseek-v3-671b in the DeepSeek-V3 report's training layout
   (arXiv:2412.19437 §3.2: PP16, EP64, ZeRO-1 DP) -- layers 0 and 3 (one
   dense, one MoE: ``n_layers=2, n_dense_layers=1``), experts 0-3 of 256
   (``experts_held=(0, 4)``, the router 256 wide and top-8), vocabulary
   32,768 of 129,280; MLA, the shared expert and every width whole
   (1.462 B parameters) -- from ``lm_init(seed=0)``, EC4T-trained through
   the launcher's functions (``lm_step_fn``, ``lm_batch_fn``,
   ``ShardedFeed``, ``FaultTolerantLoop`` with no checkpoint at this
   width) for 4 steps at batch 1 x seq 4,096 in bf16 (4 KV chunks of
   1,024 a layer, each chunk's body checkpointed) with ``remat="none"``,
   then ``export_quantized``.  Counters are zeroed just before and read
   just after.  Gates: first, at the smoke width on the card with MLA at
   3 KV chunks, one fp32 loss and aux (1e-5) and the gradients of layer
   0's kv_up (w and ω), q_up and the router (1e-4 relative) equal the
   CPU's, and the launcher's ``main`` (``--remat full``, 6 steps,
   checkpoints at 3 and 6, an export) resumed from its step-3
   checkpoint gives the same losses, step-6 checkpoint and export bit
   for bit; exactly 1 ecl_quant launch a pass over the 28 segments (5 MLA
   + 3 FFN, 5 MLA + 3 banks x 4 + 3 shared), 8 in the 4 steps and 1 in the
   export; the first and the last step's fake-quant codes and ŵ of layer
   0's kv_up and of held expert 3 of down bitwise equal to
   ``ecl_quant_plain``; losses and aux finite, the first within 0.5 of
   ln 32768; ``bias_correction`` bitwise unchanged; from step 4's input
   state and batch the loss and backward under ``none`` (twice),
   ``full`` and ``dots``: the loss, a digest of every gradient and kv_up's
   w and ω gradients bitwise equal, 1 ecl_quant launch each and the MoE
   layer counted once (no recompute counted), and a whole step under
   ``full`` and ``dots`` giving step 4's new state bit for bit;
   ``load_quantized`` of the export on the card equals ``freeze_tree``
   leaf for leaf, and both serve the same 2 x (16 + 8) greedy tokens
   (absorbed decode) through ``lm_apply``; no host synchronisation inside
   a step (``set_sync_debug_mode``).  Prints the reduced list and the
   deployment, ms a step, device ms, idle share and device operations
   (profiler), the ECL pass's device ms against its 2.66 ms byte bound,
   ``adam.apply``'s, ``update_qstate``'s and
   ``FakeQuantGroup.backward``'s device ms, layer 0's MLA attention
   forward and backward device ms, peak memory after the forward and the
   backward of each remat and after the forward, the backward, Adam and
   the update of a step under each with that step's ms (host clock,
   synchronised; none's from the timed steps), the dropped assignments a
   step and export bytes and ms, each beside the card's name and power
   limit, and one ``mla_train`` JSON line.

11. The ssm and hybrid families served at published widths, depths cut
   for the time limit (``SSM_SERVE["layers"]``: mamba2 48 -> 4, hymba
   32 -> 4), run after phase 10 (at most 1 GiB allocated at the start of
   each arch): mamba2-1.3b (48 SSD blocks of d_model 2048, d_inner 4096, 64
   heads of 64, state 128, chunk 256, tied vocabulary 50,280) and
   hymba-1.5b (32 hybrid layers of d_model 1600: GQA 25 heads, 5 KV, SWA
   1,024 but layers 0, 15 and 31 global, beside an SSD block of 50 heads,
   state 16, then an MLP of 5,504; vocabulary 32,001), each from
   ``lm_init(seed=0)``, first through the launcher (``launch.serve
   --arch ... --batch 2 --prompt-len 8192 --max-new 16 --layers N``: init,
   ``freeze_tree``, prefill and greedy decode through ``lm_apply`` with
   an fp32 cache), the ecl_quant counter zeroed just before and read just
   after; then the same init, freeze and prompts again for the gates,
   whose tokens must equal the launcher's.  Gates: exactly ⌈segments / 32⌉
   ecl_quant launches in the freeze (at full depth 3 for mamba2's 96
   segments, 9 for hymba's 288); codes
   of layer 0's in_proj and the last layer's out_proj bitwise equal to
   ``ecl_quant_plain``; layer 0's ``ssd_chunked`` on the card, on its
   recorded prefill inputs, within 1e-4 relative of the sequential
   recurrence in fp64, from zeros and from the recurrence's state at
   token 4,096 (outputs and final state); layer 0's SSD block over the
   last 16 prompt tokens by ``ssm_step`` after ``ssm_apply`` over the
   rest, against ``ssm_apply`` over all, within 1e-4 (outputs, state,
   conv tail); the last decode step's logits within 1e-3 relative of a
   no-cache forward over the prompt and the generated tokens; the decode
   state a sequence the same bytes at init, after 8,208 and after 1,040
   tokens; the smoke config card vs CPU, tokens equal and logits within
   1e-5; every frozen leaf and the cache on the card.  Prints per arch the
   freeze's ms, device ms and bounds, prefill ms and peak memory, decode
   ms a step (CUDA events and host clock), one decode step's device ms,
   operations and idle share at 2 x 8,192 and again after 2 x 1,024
   prompts, the state and KV bytes a sequence, each beside the card's
   name and power limit, and one ``ssm`` JSON line.
12. The ssm and hybrid families EC4T-trained at published widths, depths
   cut for the time limit (``TRAIN_RUNS``' ``layers``: mamba2 48 -> 4,
   hymba 32 -> 4), run after phase 11: mamba2-1.3b at 2 x 2,048 tokens for 4
   steps and hymba-1.5b at 1 x 2,048 for 3, from ``lm_init(seed=0)``, in
   bf16 under ``remat="full"`` through the launcher's functions
   (``lm_step_fn``, ``lm_batch_fn``, ``ShardedFeed``,
   ``FaultTolerantLoop`` with no checkpoint at this width), λ 0.05 ramped
   over 50 steps, then ``export_quantized``.  Counters are zeroed just
   before and read just after.  Gates: first, at the smoke width on the
   card (seq 20: a ragged SSD chunk), one fp32 loss (1e-5) and the
   gradients of layer 0's in_proj (w and ω), conv_w, A_log and dt_bias
   (1e-4 relative) equal the CPU's, and the launcher's ``main``
   (``--remat full``, 6 steps, checkpoints at 3 and 6, an export) resumed
   from its step-3 checkpoint gives the same losses, checkpoint and
   export bit for bit; for mamba2, a whole step at full width cut to depth
   4 under ``full`` bitwise ``none``'s; exactly ⌈segments / 32⌉ ecl_quant
   launches a pass (3 and 9 at full depth), 2 passes a step and 1 in the export; the
   first and the last step's fake-quant codes and ŵ of layer 0's in_proj
   and the last layer's out_proj bitwise equal to ``ecl_quant_plain``;
   finite losses; from the last step's input, the loss and every
   gradient twice, all finite and bitwise equal, the loss the step's;
   ``load_quantized`` of the export on the card equals ``freeze_tree``
   leaf for leaf, and both serve the same 2 x (16 + 8) greedy tokens; no
   host synchronisation inside a step (``set_sync_debug_mode``).  Prints
   per arch ms a step, device ms, idle share and device operations
   (profiler), the ECL pass's device ms against its byte bound,
   ``adam.apply``'s against its bound, ``update_qstate``'s and
   ``FakeQuantGroup.backward``'s, one SSD block's forward and backward
   device ms at the step's shape, peak memory by stage, export bytes and
   ms, each beside the card's name and power limit, and one ``ssm_train``
   JSON line.
13. The vlm and audio families served at published widths and depths
   (qwen2-vl's cut for the time limit, ``VLM_SERVE["layers"]``: 28 -> 4),
   run after phase 12 (at most 1 GiB allocated at the start of each
   arch), fp32 compute and cache.  qwen2-vl-2b (28 layers of d_model
   1536, 12 heads with 2 KV heads of 128, QKV bias, d_ff 8,960, M-RoPE
   sections (16, 24, 24), tied vocabulary 151,936): first the launcher
   (``launch.serve --arch qwen2-vl-2b --batch 2 --prompt-len 1024
   --max-new 16``, token prompts), the ecl_quant counter zeroed just
   before and read just after; then the gated freeze, and a prefill of 2
   x 8,192 patch embeddings drawn from seed 0 through ``lm_apply(embeds=)``
   and 16 greedy tokens by id.  Gates: exactly ⌈segments / 32⌉ ecl_quant
   launches (7 for 196 at full depth) in the launcher's and in the gated
   freeze, codes of layer 0's q and the last layer's down bitwise equal to ``ecl_quant_plain``;
   ``mrope_cos_sin`` at head dim 128 on three identical streams bitwise
   ``rope_cos_sin``, and on three distinct streams to position 8,207
   each stream's section bitwise ``rope_cos_sin`` of that stream; layer
   0's attention over the prefill's recorded input, a cached prefill and
   16 decode steps against the whole sequence without a cache, within
   1e-4 relative; at 2 x 1,024 patch embeddings, the cached decode's
   logits within 1e-3 relative of a no-cache forward over the
   embeddings and the generated tokens' rows; the KV cache 57,344 B a
   token a sequence; the smoke config card vs CPU, tokens equal and
   logits within 1e-5.  whisper-base (6 + 6 layers of d_model 512, 8
   heads of 64, d_ff 2,048, vocabulary 51,865, 1,500 frames, MAX_TGT
   448): the gated freeze (``whisper_init``), then 8 utterances of 1,500
   stubbed frames drawn from seed 0 served in the order of the
   reference's prefill and decode bodies: ``whisper_encode``,
   ``precompute_cross``, ``init_dec_cache(..., MAX_TGT)``,
   ``whisper_decode`` of the 4-token start-of-transcript prompt, then 123
   cached greedy steps.  Gates: exactly 3 ecl_quant launches (96
   segments), codes of encoder layer 0's q and decoder layer 5's cross v
   bitwise; every cached step's logits within 1e-3 relative of a no-cache
   decode of the same prefix; the cross K/V 36,864,000 B a sequence; the
   smoke config card vs CPU, tokens equal and logits within 1e-5; every
   frozen leaf, the cache and the cross K/V on the card.  Prints per arch
   the freeze's ms, device ms and bounds, prefill (or encode, cross and
   prompt) ms and peak memory, decode ms a step (CUDA events and host
   clock), one decode step's device ms, operations and idle share, each
   beside the card's name and power limit, and one ``vlm_audio`` JSON
   line.
14. The vlm and audio families EC4T-trained at published widths and
   depths (qwen2-vl's cut for the time limit: 28 -> 4) in bf16, run
   after phase 13: qwen2-vl-2b at 1 x 2,048 (patch
   embeddings and labels, no tokens) for 3 steps under ``remat="full"``,
   whisper-base at 8 x (1,500 frames, 448 tokens) for 10 steps, from
   ``lm_init`` / ``whisper_init(seed=0)`` through the launcher's
   functions (``lm_step_fn``, ``lm_batch_fn``, ``ShardedFeed``,
   ``FaultTolerantLoop`` with no checkpoint at this width), λ 0.05
   ramped over 50 steps, then ``export_quantized``.  Counters are zeroed
   just before and read just after.  Gates: first, at the smoke width on
   the card, one fp32 loss (1e-5) and picked gradients (1e-4 relative)
   equal the CPU's, and the launcher's ``main`` (``--remat full``, 6
   steps, checkpoints at 3 and 6, an export) resumed from its step-3
   checkpoint gives the same losses, checkpoint and export bit for bit;
   for qwen2-vl a whole step at full width cut to depth 2 under
   ``full`` bitwise ``none``'s; exactly 7 (qwen2-vl) and 3 (whisper)
   ecl_quant launches a pass, 2 passes a step and 1 in the export, every
   pass over all segments; the first and the last step's fake-quant codes
   and ŵ of the first layer's q and the last layer's down (qwen2-vl) or
   cross v (whisper) bitwise equal to ``ecl_quant_plain``; finite losses;
   from the last step's input the loss and every gradient twice, finite
   and bitwise equal, the loss the step's; ``load_quantized`` of the
   export on the card equals ``freeze_tree`` leaf for leaf, and both
   serve the same greedy tokens; no host synchronisation inside a step
   (``set_sync_debug_mode``).  Prints per arch ms a step, device ms, idle
   share and device operations (profiler), the ECL pass's device ms
   against its byte bound, ``adam.apply``'s against its bound,
   ``update_qstate``'s and ``FakeQuantGroup.backward``'s, peak memory by
   stage, export bytes and ms, each beside the card's name and power
   limit, and one ``vlm_audio_train`` JSON line.

15. Scale-out serving over ``torch.distributed``, run after phase 14: 4 ranks
   spawned by ``launch.mesh.RankPool`` (after the kernels are built
   here) share the card over gloo, every collective staged through host
   buffers; a rank that fails fails the phase.  Phases 16 and 18-20 run on
   the same ranks (one spawn: ``_rank_pool``), stopped at the script's
   end.  (a) MLP-GSC, MLP-HR and
   LeNet-300-100 frozen from seeds 150-152 at the paper's widths, served
   column-sharded (``ShardedStack``, kernel 1 at (K, N/tp) on each rank,
   one all-gather after each split layer) on meshes (1, 4) and (2, 2),
   fp32 and int8, at 1, 3, 8, 64 and 256 rows.  In each rank the
   matmul_kernel counter is zeroed just before a call and read just
   after.  Gates: every rank's logits bitwise equal to the unsharded
   per-layer chain kernel on the card, within the fp32 gate (int8
   relative ``< 5e-3``) of the plain oracle, one launch a layer a call,
   the ranks alike.  Recorded per rank: launches a call, the bytes each
   layer's gather brings, the ms a served batch (CUDA events; labelled
   "4 ranks sharing one H100 over gloo", not a claim).  (b)
   grok-1-314b at published widths (d 6,144, d_ff 32,768, 8 experts,
   top-2), depth 1, vocabulary cut to 32,768 (time), capacity factor E /
   k: first the single process serves the whole layer (every expert drawn
   from a generator of its own, as each rank draws its own), then each
   rank inits and freezes its blocks under the reference's layout (its 2
   experts, 12 heads and a quarter of the vocabulary; ecl_quant counted)
   and runs ``generate(mesh=)`` over 4 prompts of 16 ids and 4 tokens
   through ``moe_apply_ep`` (two all-to-alls a layer) on mesh (1, 4).  Gates:
   tokens equal to the single process's, a no-cache forward's logits
   within 1e-4 relative, at least one ecl_quant launch a rank.  Peak
   memory per rank recorded.  (c) ``moe_apply_tp`` at the smoke widths,
   2 experts over 4 ranks (``moe_ffn`` chooses it), within 1e-5 of
   ``moe_apply`` on the card; expert TP at grok's widths needs a 16-wide
   axis, more ranks than one card holds.  Prints one ``scale_out`` JSON
   line.

16. EC4T training over a mesh on ``torch.distributed``: 4
   gloo ranks share the card as in phase 15; the single-process
   references run first and are freed.  (a) SmolLM-360M at its published
   widths, depth 32 -> 8 (time), from ``lm_init(seed=0)``, a global
   batch of 8 x 64
   through ``build_train_step`` and ``ShardedFeed(mesh=)`` on meshes (4,
   1) and (2, 2) (on (2, 2) the dense family's tensor-parallel layout:
   each rank holds its blocks of the MLP and the tied vocabulary, its 15
   heads whole, attention sequence-parallel at seq 64): one fp32 step
   replicated, one with ZeRO-1, one with the int8 all-reduce on the same
   rows on every data rank, the int8 round trip of the first gradients on
   distinct rows, then 3 timed bf16 steps with ZeRO-1 off and on.
   ecl_quant's counter is zeroed just before each step and read just
   after, in each rank.  Gates: the mesh's
   gradients within 1e-4 of each leaf's largest of the single process's,
   the params after one step within ``atol=rtol=5e-3`` and the loss
   within ``rtol=1e-4`` (``tests/test_distributed_equivalence.py:70-74``);
   the reduced gradients and every replicated leaf (params, m, v,
   probabilities) equal on every rank, ZeRO-1's state the replicated
   step's and the int8 step on replicated rows the single process's
   ``compress_grads(mesh=None)`` step's (on (2, 2): that round trip of the
   mesh's own exact gradient, each leaf whole), each by digest (two int64
   sums of the bits, of the whole tree: a rank's blocks' shares summed
   over 'model'); the int8 gradients on distinct rows within half the shared
   scale of the exact mean; exactly 2 passes of ⌈56 / 32⌉ = 2 ecl_quant
   launches a step a rank.  Recorded: ms a bf16 step a rank (host clock,
   synchronised), bytes all-reduced a step (fp32 and int8), peak memory a
   rank with ZeRO-1 off and on.  (b) grok-1-314b's smoke layer (each
   expert from a generator of its own) through ``moe_ffn`` under grad at
   capacity
   factor E / k: EP on (1, 4) and (2, 2), whole banks and each rank's
   share, and expert TP on (1, 4) with 2 experts, where the reference's
   dispatcher picks it.  Gates: the objective ``Σ y·r + 0.01·aux`` and
   every gradient (router, banks, tokens) within 1e-5 of the same on one
   process; the layer under a checkpoint (its exchanges run again in the
   backward) bitwise the plain one.  (c) ``pipeline_apply`` of the
   reference test's ``tanh(x @ w)`` stack at d 960, L 32, batch 64 over a
   4-stage 'pipe' mesh, 4 and 8 micro-batches: the output and the
   gradients of the stage blocks and the input within 1e-5 of the
   sequential stack on the card; the ticks and ``bubble_fraction``
   printed with ms a forward and backward a rank.  Prints one
   ``mesh_train`` JSON line.

17. The autotuner's sweep and the dry run.  (a) A fresh
   autotune cache file in a temporary directory; MLP-GSC from
   ``mlp_init(seed=0)`` frozen and served through ``ExecutionPlan(mode=
   "auto")``, fp32 and int8, with the timed sweep on (the package's own
   choice on the card; every earlier phase binds from the prior, the
   script setting ``autotune.tuning`` as the tests do when it starts).
   Counters are zeroed just before the plans are built
   and read just after their buckets have served; each fused schedule
   must have launched.  Gates: the plan's block_m and every fused
   bucket with ``source == "sweep"``; measure calls equal to the candidate
   count (the block sweep's and each bucket's); the ws crossover recorded
   in the cache file; a second build over a cleared memory cache and the
   same file makes no measure call and binds the same; each bucket's
   served output within the fp32 gate of the plain oracle (int8: relative
   ``< 5e-3``); every int8 candidate the sweep timed bitwise equal to the
   chain kernel.  Prints each bucket's candidates' queued ms, the prior's
   binding and the winner.  (c) SmolLM-360M's FFN plans as ``LMProgram``
   builds them (gate, up, down of one block at 960 x 2560, random codes,
   mode auto, fp32, buckets to 64) with the sweep on, over the same file:
   every bucket fused with ``source == "sweep"``, measure calls equal to
   the candidates of gate and down (up, gate's shape, a hit), a warm build
   with none and the same bindings, each bucket's output within the fp32
   gate of the plain oracle; queued ms printed as in (a).  (b) SmolLM-360M
   at published widths: the
   8 x 64 bf16 train step (``launch.steps.build_train_step`` on a one-rank
   ``ShapeMesh``) counted by ``launch.op_analysis`` on meta tensors and on
   the card's real ones, FLOPs and bytes exactly equal (peak live bytes
   printed beside ``torch.cuda.max_memory_allocated``); ecl_quant's
   ``LAUNCHES``, zeroed just before the card's step and read just after,
   is 14 (2 passes x ceil(224 segments / 32)), as the count reports on
   the card and on meta; on a (4, 1)
   shape-only mesh the fp32 step's gradient all-reduce is 1,447,288,064 B
   (phase 16's bytes a step); then ``dryrun.run_cell`` of smollm-360m at
   the four shapes on pod16x16 (long_500k SKIP), records printed.  Prints
   one ``autotune`` JSON line.

18. Tensor parallelism over 'model' for the dense family, 4 gloo ranks
   sharing the card as in phase 16, each single-process reference run
   first and freed.  (a) h2o-danube-1.8b at its published widths (d
   2,560, 32 heads / 8 KV, d_ff 6,912, vocabulary 32,000), depth 24 -> 12
   (time), over (1, 4), the head-sharded path: each rank draws its blocks
   (``lm_init(mesh=)``, one layer whole at a time), freezes them (the
   probabilities' and mean(w²)'s sums over 'model'), then serves 2 x 512
   prompt tokens and 16 greedy tokens in fp32.  Gates: each rank's frozen
   tree bitwise its blocks of one process's freeze (by digest) and 3
   ecl_quant launches in each freeze, as one process's; tokens equal to
   one process's; the prefill's last 8 positions' logits within 1e-3 of
   their largest; a rank's KV cache a quarter of one process's.  (b)
   h2o-danube-1.8b at published widths, depth 24 -> 2, 8 x 64 over (1, 4)
   and (2, 2) (ZeRO-1): 2 fp32 steps held to one process (phase 16's
   gates: loss ``rtol=1e-4``, gradients 1e-4 of each leaf's largest,
   params ``atol=rtol=5e-3``), the probabilities after them bitwise one
   process's update of the same params, 2 ecl_quant launches a step a
   rank, then 2 timed bf16 steps.  Prints prefill, decode-step, freeze ms
   and peak memory a rank beside one process's, ms a step a rank, bytes
   all-reduced over 'model' a step, and one ``tensor_parallel`` JSON line.

19. Tensor parallelism over 'model' for the MoE family (the reference's
   ``Rules`` layout), 4 gloo ranks sharing the card as in phase 18, each
   single-process reference run first, kept on the host and freed.  (a)
   grok-1-314b at published widths (d 6,144, 48 heads / 8 KV, expert
   d_ff 32,768, 8 experts top-2, vocabulary 131,072), depth 1, capacity
   factor E / k, over (1, 4): head-sharded GQA, expert parallelism with 2
   experts a rank (each expert drawn from a generator of its own, so a
   rank draws its experts alone), the vocabulary cut; (b)
   deepseek-v3-671b at published widths (d 7,168, 128 heads, MLA q_lora
   1,536 / kv_lora 512, dense d_ff 18,432, expert d_ff 2,048, vocabulary
   129,280), depth 2 (one dense layer, one MoE layer), routed experts 256
   -> 32 (top-8, routed scaling 2.5, the shared expert), over (1, 4):
   MLA by heads with q_down / kv_down column-cut and gathered, the dense
   FFN and the shared expert cut, 8 experts a rank.  Each serves 2 x 512
   prompt tokens and 16 greedy tokens in fp32 (``ranks.tp_serve_card``).
   Gates: each rank's frozen tree bitwise its blocks of one process's
   freeze (by digest) in exactly ⌈a rank's segments / 32⌉ ecl_quant
   launches (grok 10 segments: 1; deepseek 40: 2); tokens equal to one
   process's; the prefill's last 8 positions' logits within 1e-3 of their
   largest; grok's KV cache a rank a quarter of one process's, deepseek's
   latent cache a rank equal to one process's; deepseek's absorbed decode
   within 1e-4 of the naive form on each rank.  (c) deepseek-v3 as in
   (b) with routed experts 256 -> 8 and the vocabulary cut to 32,768 (as
   phase 10), its MoE layer alone (depth 2 on (2, 2) ran out of the
   card), 8 x 64 over (1, 4) and (2, 2) (ZeRO-1): phase 18's gates
   against one process, whose load-balance aux is the mean of the 4
   token blocks' the expert-parallel ranks route (the reference's
   ``local_moe`` pmean), the probabilities of the expert banks included,
   and exactly ⌈a rank's segments / 32⌉ ecl_quant launches a pass; a
   bf16 step timed.  (d) The dry run of grok-1-314b's ``train_4k`` cell on
   pod16x16 (meta tensors): 8 experts do not divide 16, so each rank
   holds d_ff 2,048 of every expert (expert TP); gated OK, tensor
   parallel, expert TP, with all-reduces over 'model'; its FLOPs, bytes
   and ``model_axis_collectives`` recorded.  Prints one
   ``moe_tensor_parallel`` JSON line.

20. Tensor parallelism over 'model' for the ssm, hybrid and vlm families
   (the reference's ``Rules``: in_proj cut on its contracted d_model
   rows, out_proj on its d_inner rows, the SSM dynamics whole, the state
   cut on its heads where they divide), 4 gloo ranks sharing the card
   through phase 18's ``_tp_serve`` / ``_tp_train``.  (a) mamba2-1.3b at
   published widths (d 2,048, d_inner 4,096, 64 heads of 64, state 128,
   vocabulary 50,280), depth 48 -> 8, over (1, 4): 16 heads a rank
   ("heads": its slice of x, z, dt and the dynamics, the gated norm's
   sum all-reduced).  (b) hymba-1.5b at published widths (d 1,600, 25
   heads / 5 KV, d_ff 5,504, 50 SSM heads of 64, state 16), depth 32 ->
   3 with layer 0 global, over (1, 4) ("rows": 50 heads do not divide 4,
   so the scan runs whole and a rank takes its 800 of out_proj's rows;
   the attention weights whole, sequence-parallel on the prefill) and
   over (2, 2) ("heads": 25 a rank).  (c) qwen2-vl-2b at published widths
   (12 heads / 2 KV: q / k / v whole, o cut), depth 28 -> 2, over (1, 4),
   prefilled with the stubbed frontend's patch embeddings
   (``launch.train.lm_batch_fn``).  Each serves 2 x 512 prompt positions
   and 8 greedy tokens in fp32.  Gates as phase 18's: frozen blocks
   bitwise one process's in ⌈a rank's segments / 32⌉ ecl_quant launches
   (2 / 9 / 7 a layer), tokens equal, the last 8 positions' logits within
   1e-3 of their largest, the KV cache and the SSM state a rank its
   heads' share of one process's (mamba2's state a quarter), the conv
   tail whole.  (d) hymba-1.5b at published widths, depth 2, 8 x 64 over
   (1, 4): phase 18's step gates against one process, exactly 2 ecl_quant
   launches a step a rank.  (e) The dry run of hymba-1.5b's ``long_500k``
   decode on pod16x16 on meta tensors at depth 2 (512 KV chunks a layer,
   ~5 s a layer on the host): gated OK, tensor parallel, "rows",
   all-reduces over 'model'.
   Prints each part's seconds and one ``ssm_tp`` JSON line.

21. whisper-base over 'model' and the elastic restore of a mesh's train
   state, 4 gloo ranks sharing the card.  (a) whisper-base uncut at
   published widths (6 + 6 layers, d 512, 8 heads, d_ff 2,048,
   vocabulary 51,865 padded to 51,968) over (1, 4): each rank's heads
   (self and cross), fc1 columns, fc2 rows and vocabulary rows
   (``whisper_init(mesh=)``), frozen in 3 ecl_quant launches a rank (96
   segments), then the reference's serving bodies
   (``ranks.whisper_serve_timed``) on 8 utterances of 1,500 stubbed
   frames with the 4-token prompt and 16 greedy tokens in fp32: frozen
   blocks bitwise one process's, tokens equal, each step's logits within
   1e-3 of their largest, a rank's cross K/V and KV cache a quarter of
   one process's.  (b) Its EC4T step, 8 x (1,500 + 64), over (1, 4) and
   (2, 2) with ZeRO-1: phase 18's step gates against one process, 6
   ecl_quant launches a step a rank.  (c) The (2, 2) state after one fp32
   step saved (``CheckpointManager.save(specs=, mesh=)``) and restored
   (``resume_or(sharding_fn=)``) onto (2, 2), (1, 4) and one process: the
   restored tree bitwise the saved one, the next step on (2, 2) bitwise
   the uninterrupted run's, on (1, 4) and in one process the loss within
   ``rtol=1e-4`` and the params within ``atol=rtol=5e-3`` of one
   process's uninterrupted run, probabilities bitwise.  (d) The dry run
   of whisper-base's ``train_4k`` on pod16x16 on meta tensors: OK, tensor
   parallel, attention whole (8 heads over 16), all-reduces over 'model'.
   Prints each part's seconds and one ``audio_tp`` JSON line.

The script ends with a line that counts the profiler traces taken and
retaken, the device times taken from queued CUDA events and the queued
timings taken again behind a longer spin after a host stall, the ``nvidia-smi`` line and the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
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
# queued timings (``_queued_ms``, ``coop_probe``) taken again behind a
# longer spin after a host stall
SPIN_RETAKEN = {"spins": 0}
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
    # a host stall longer than the spin is taken again behind a spin four
    # times as long, then raises
    for spin in (SPIN_CYCLES, 4 * SPIN_CYCLES):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin_done = torch.cuda.Event()
        torch.cuda._sleep(spin)
        spin_done.record()
        start.record()
        for _ in range(iters):
            fn()
        # the spin must still hold the stream once every call is queued,
        # or host gaps would fall between the events
        if not spin_done.query():
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / iters
        SPIN_RETAKEN["spins"] += 1
    raise AssertionError("the host fell behind the queued launches")


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
# waves: the session's length; past it, up to max_waves while the
# injector's schedule has not reached its cold flip (launch 28): how many
# of the faulty model's requests admission sheds, and so how many
# launches 60 waves make (29-44 seen), moves with the host
FAULT = dict(model="mlp-hr", seed=939, rate=0.05, flip_rate=0.1,
             waves=60, max_waves=240, per_wave=4, max_rows=16, scrub_s=0.02)
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
                # a host stall longer than the spin is taken again behind
                # a spin four times as long, then raises
                for spin in (SPIN_CYCLES, 4 * SPIN_CYCLES):
                    torch.cuda.synchronize(dev)
                    gate = torch.cuda.Event(enable_timing=True)
                    spin_done = torch.cuda.Event()
                    with torch.cuda.stream(s0):
                        torch.cuda._sleep(spin)
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
                    if not spin_done.query():
                        break
                    SPIN_RETAKEN["spins"] += 1
                else:
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
    done, rejected, waves = [], [], 0
    with fe:
        for wave in range(FAULT["max_waves"]):
            if wave >= FAULT["waves"] and any(f[1] == "cold"
                                              for f in inj.flips):
                break
            waves += 1
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
    print(f"phase 3c: {waves} waves; faults {len(hot)} hot and "
          f"{len(cold)} cold flips, "
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
            "flip_rate": FAULT["flip_rate"], "waves": waves,
            "launches": inj.launches,
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


def _lm_direct(dev, cfg, frozen, prompts, new, tokens=None, embeds=None):
    """The direct path on a frozen tree (``lm_apply``: dense decode +
    ``torch.matmul``, no FantastIC4 kernel): a prefill of the ``prompts``
    ids, or of ``embeds`` (B, S, d) on the device in their place (a vlm's
    patch embeddings), then ``new - 1`` decode steps fed ``tokens``
    (teacher forcing) or, without them, each step's greedy pick.  Returns
    the greedy picks (B, new), each step's last-position logits (B, new,
    vocab) and the cache; on the card also prefill ms and decode ms a step
    (CUDA events) and the prefill's and the decode steps' peak device
    memory."""
    import torch
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX

    b, s = prompts.shape if embeds is None else embeds.shape[:2]
    on_card = dev.type == "cuda"
    cache = T.init_cache(cfg, b, s + new, dtype=torch.float32, device=dev)
    tok = None if embeds is not None else torch.from_numpy(prompts).to(dev)
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
                                      embeds=embeds, positions=pos,
                                      cache=cache)
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


def _step_trace(fn, dev, steps, traced=None):
    """``fn`` (one serving step) run ``steps`` times: its wall ms a step,
    and from one torch.profiler trace over ``traced`` runs (default as
    many) its device ms and device operations a step; the idle share is
    the part of the wall time the device is not busy.  Returns (that
    dict, device ms a step by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    traced = steps if traced is None else traced
    for attempt in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(traced):
                fn()
            torch.cuda.synchronize(dev)
            traced_ms = (time.perf_counter() - t0) * 1e3 / traced
        TRACES["taken"] += 1
        kernels, ops_n = {}, 0
        for evt in prof.key_averages():
            if _is_kernel(evt):
                kernels[evt.key] = kernels.get(evt.key, 0.0) + \
                    _kernel_us(evt) / 1e3 / traced
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
            "device_ops_per_step": ops_n / traced,
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


class _StagePeaks:
    """While in use, the peak device memory at the end of each stage of a
    train step (its forward, its backward, Adam and the probability
    update), from a peak reset on entry: the functions are patched where
    the step looks them up, and the peaks read on the host (no
    synchronisation)."""

    def __init__(self, dev):
        from repro_torch.core import qat
        from repro_torch.models import lm as lm_model
        from repro_torch.models import whisper
        from repro_torch.optim import adam
        self.dev, self.peaks = dev, {}
        self.stages = ((lm_model, "lm_forward_loss", None, "forward"),
                       (whisper, "whisper_forward_loss", None, "forward"),
                       (adam, "apply", "backward", "adam"),
                       (qat, "update_qstate", None, "update_qstate"))

    def _marked(self, fn, before, after):
        import torch

        def call(*a, **k):
            if before:
                self.peaks[before] = torch.cuda.max_memory_allocated(self.dev)
            out = fn(*a, **k)
            self.peaks[after] = torch.cuda.max_memory_allocated(self.dev)
            return out
        return call

    def __enter__(self):
        import torch
        self.originals = [getattr(mod, attr) for mod, attr, _, _ in
                          self.stages]
        torch.cuda.reset_peak_memory_stats(self.dev)
        for (mod, attr, before, after), fn in zip(self.stages,
                                                  self.originals):
            setattr(mod, attr, self._marked(fn, before, after))
        return self

    def __exit__(self, *exc):
        for (mod, attr, _, _), fn in zip(self.stages, self.originals):
            setattr(mod, attr, fn)


def _lm_train_trace(dev, step_fn, holder, batch,
                    timed=LM_TRAIN_TIMED_STEPS, traced=LM_TRAIN_TRACED_STEPS):
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

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with _StagePeaks(dev) as staged, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            steps(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    step_peak = torch.cuda.max_memory_allocated(dev)
    peaks = staged.peaks
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

    n = traced
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


def _gated_freeze(dev, cfg, seed, want_segments, layout, checks,
                  init=None):
    """Init on the card (``init``, default ``lm_init``) and ``freeze_tree``
    with the ecl_quant counter zeroed just before and read just after: the
    segment count ``layout`` names, the exact launch count the segments
    give, the codes of each ``(stack, path, index)`` of ``checks`` (stack
    None: ``path`` from the tree's root) bitwise equal to the plain
    version on the same card tensors, the grouped pass timed against its
    bounds, peak device memory."""
    import torch
    from repro_torch.core import bitplanes, ecl, qat
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.nn import transformer as T
    from repro_torch.tree import leaves

    params = (init or T.lm_init)(cfg, seed=seed, device=dev)
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
        node, qs, fnode = (t if stack is None else t["stacks"][stack]
                           for t in (params, qstate, frozen))
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
              "codes_checked": [".".join((st,) * bool(st) + p) + str(list(i))
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
    from repro_torch.launch import train as T
    return dataclasses.replace(
        T.lm_config(MOE_TRAIN["arch"], lam=MOE_TRAIN["lam"]),
        n_layers=MOE_TRAIN["layers"],
        experts_held=MOE_TRAIN["experts_held"], vocab=MOE_TRAIN["vocab"])


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


def _share_ecl_gates(rec, per_pass, segments, steps, step_launches,
                     export_launches, checked_calls):
    """A share's main path through ``_EclRecorder``: exactly ``per_pass``
    ecl_quant launches in each grouped pass (2 a step, then the
    export's), every pass over all ``segments``, and the picked segments
    of the passes ``checked_calls`` bitwise equal to the plain version.
    Returns the launches of each pass and the segments checked."""
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
    for i in checked_calls:
        for (t_i, idx), equal in rec.calls[i]["equal"]:
            if not equal:
                raise AssertionError(f"ECL pass {i}, tensor {t_i}"
                                     f"{list(idx)}: codes or ŵ != the "
                                     "plain version")
            checked.append([i, t_i, list(idx)])
    return per_call, checked


def _share_ecl_pass(dev, params, qstate, lam, segments, per_pass):
    """One grouped ECL pass of a train step over every quantized leaf of
    ``params`` (as the step's forward makes it), its plain version and
    its byte bounds: the ``ecl_quant_pass`` row."""
    from repro_torch.core import ecl, qat
    from repro_torch.kernels import ecl_quant as eq
    nodes = list(qat._quant_leaves(params, qstate))
    ws = [n["w"] for n, _ in nodes]
    oms = [n["omega"] for n, _ in nodes]
    pens = [ecl.penalty(n["w"], q["probs"], lam) for n, q in nodes]
    elements = sum(w.numel() for w in ws)

    def ecl_pass():
        return ecl.quantize_many(ws, oms, pens)

    def ecl_plain():
        for w, om, pn in zip(ws, oms, pens):
            w3, om3, pn3 = (w.reshape(-1, *w.shape[-2:]), om.reshape(-1, 4),
                            pn.reshape(-1, 16))
            for i in range(w3.shape[0]):
                _plain_pair(w3[i], om3[i], pn3[i])
    return {"ms": _time_ms(ecl_pass, dev, 1),
            **_device_time(ecl_pass, dev, 1, ECL_SYMBOL,
                           launches=lambda: eq.LAUNCHES),
            "queued_ms": _queued_ms(ecl_pass, dev, 2),
            "plain_ms": _once_ms(ecl_plain, dev),
            "bound_ms": ECL_BYTES_PER_ELEM * elements / PEAK_BYTES * 1e3,
            "bound_by": "bytes",
            "codes_only_bound_ms":
                ECL_CODES_BYTES_PER_ELEM * elements / PEAK_BYTES * 1e3,
            "library_ms": None, "segments": segments,
            "elements": elements, "launches_per_call": per_pass}


class _DropCounter:
    """Wraps ``moe_ffn`` while in use: for each call, on the device and
    without a host synchronisation, the assignments the capacity dropped
    over all experts, and those kept for the held experts.  A call made
    by the backward (a rematerialised forward) is not counted again; it
    runs the same operations, so a selective checkpoint's cache of saved
    products stays in step."""

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
                counts = torch.stack([(~keep).sum(), (held & keep).sum(),
                                      held.sum()])
            if torch._C._current_graph_task_id() == -1:   # not a recompute
                self.counts.append(counts)
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
        per_call, checked = _share_ecl_gates(
            rec, per_pass, segments, steps, step_launches, export_launches,
            MOE_TRAIN_CHECKED_CALLS)
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

    ecl_row = _share_ecl_pass(dev, restored["params"]["stacks"],
                              restored["qstate"]["stacks"], cfg.lam,
                              segments, per_pass)
    pass_bound = ecl_row["bound_ms"]
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


def _cut_depth(cfg, layers):
    """``cfg`` cut to ``layers`` layers at its widths (None: as it is)."""
    import dataclasses
    if layers is None or layers >= cfg.n_layers:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers)


_POOL = {}      # the ranks phases 15, 16 and 18-21 share (``_rank_pool``)


@contextlib.contextmanager
def _rank_pool(world, timeout):
    """``world`` gloo ranks sharing the card (every collective staged
    through host buffers) for phases 15, 16 and 18-21: spawned by the
    first of them that runs and kept for the others (a spawn is 10-17 s
    of the script's time limit); a phase that fails closes them, and
    ``main`` closes them at its end (:func:`_close_pool`)."""
    from repro_torch.launch import mesh as M
    pool = _POOL.get("pool")
    if pool is None:
        pool = _POOL["pool"] = M.RankPool(world, backend="gloo",
                                          device="cuda", timeout=timeout)
    if pool.world != world:
        raise ValueError(f"a pool of {pool.world} ranks, {world} asked")
    pool.timeout = timeout
    try:
        yield pool
    except BaseException:
        _close_pool()
        raise


def _close_pool():
    """Stop the shared ranks, if any run."""
    pool = _POOL.pop("pool", None)
    if pool is not None:
        pool.close()


def _empty_card(dev, what):
    """Free what the last phase left and gate that at most
    EMPTY_CARD_BYTES stay allocated; returns the bytes allocated."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    start_bytes = torch.cuda.memory_allocated(dev)
    if start_bytes > EMPTY_CARD_BYTES:
        raise AssertionError(f"{what} starts with {start_bytes / 1e9:.2f} "
                             "GB allocated")
    return start_bytes


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
    start_bytes = _empty_card(dev, "phase 9")
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


# ------------------------------------------------------------ phase 10

MLA_TRAIN = dict(arch="deepseek-v3-671b", layers=2, dense_layers=1,
                 experts_held=(0, 4), ep=64, pp=16, vocab=32768, seed=0,
                 steps=4, batch=1, seq=4096, lr=1e-3, lam=0.05, lam_ramp=50,
                 prompts=2, prompt_len=16, max_new=8)
# ECL passes whose layer-0 kv_up and held expert 3 of down are held
# against the plain version: the first step's forward and the last step's
MLA_TRAIN_CHECKED_CALLS = (0, 2 * MLA_TRAIN["steps"] - 2)
# the smoke config with MLA: seq 40 at its attn_chunk 16 is 3 KV chunks,
# the last one padded
MLA_SMOKE = dict(batch=2, seq=40, steps=6, ckpt_every=3)
MLA_CARD_CPU_FWD = 1e-5   # smoke: loss and aux, card vs CPU
MLA_CARD_CPU_GRAD = 1e-4  # smoke: kv_up w and ω, q_up w, the router w
REMATS = ("none", "full", "dots")


def _mla_train_cfg():
    """deepseek-v3-671b at published widths, one GPU's training share:
    layers 0 and 3 (one dense, one MoE), experts 0-3 of 256, vocabulary
    cut as phase 8 cuts grok's."""
    import dataclasses
    from repro_torch.launch import train as T
    return dataclasses.replace(
        T.lm_config(MLA_TRAIN["arch"], lam=MLA_TRAIN["lam"]),
        n_layers=MLA_TRAIN["layers"], n_dense_layers=MLA_TRAIN["dense_layers"],
        experts_held=MLA_TRAIN["experts_held"], vocab=MLA_TRAIN["vocab"])


class _Discard:
    """A checkpoint manager that keeps nothing: the loop's end-of-run
    save of a 17.5 GB state is skipped (phase 8 gates checkpointing)."""

    def save(self, step, state):
        pass

    def latest_step(self):
        return None


def _mla_launcher_resume(dev):
    """The launcher's ``main`` on the card at deepseek-v3's smoke width
    with MLA and ``--remat full``: 6 steps with checkpoints at 3 and 6,
    then again from a copy of the step-3 checkpoint alone
    (:func:`_launcher_resume`)."""
    return _launcher_resume(MLA_TRAIN["arch"], MLA_SMOKE["seq"], "full")


def _mla_train_smoke_checks(dev):
    """At deepseek-v3's smoke width with MLA on the card: one fp32 loss
    and its gradients of layer 0's kv_up (w and ω) and q_up and of the
    router equal the CPU's from the same init, at 3 KV chunks; and the
    launcher resumes bitwise under ``--remat full``."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import qat
    from repro_torch.data import pipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as T
    from repro_torch.nn import transformer as TT

    cfg = dataclasses.replace(get_config(MLA_TRAIN["arch"]).smoke(),
                              lam=MLA_TRAIN["lam"])
    if -(-MLA_SMOKE["seq"] // cfg.attn_chunk) < 3:
        raise AssertionError("the smoke check needs 3 KV chunks or more")
    params = TT.lm_init(cfg, seed=MLA_TRAIN["seed"], device="cpu")
    batch = T.lm_batch_fn(cfg, batch=MLA_SMOKE["batch"],
                          seq=MLA_SMOKE["seq"])(0)
    loss_fn = steps_mod._loss_fn(cfg, dtype=torch.float32)
    runs = []
    for where in (dev, torch.device("cpu")):
        p = tree.map_(lambda t: t.to(where).detach().requires_grad_()
                      if t.is_floating_point() else t.to(where), params)
        loss, m = loss_fn(p, qat.build_qstate(p),
                          pipeline.place(batch, device=where), cfg.lam)
        attn = p["stacks"]["dense"]["attn"]
        picked = (attn["kv_up"]["kernel"]["w"],
                  attn["kv_up"]["kernel"]["omega"],
                  attn["q_up"]["kernel"]["w"],
                  p["stacks"]["moe"]["moe"]["router"]["w"])
        grads = torch.autograd.grad(loss, picked)
        runs.append((float(loss.detach()), float(m["aux"].detach()),
                     [g.cpu() for g in grads]))
    (lc, ac, gc), (lh, ah, gh) = runs
    fwd_rel = max(abs(lc - lh) / abs(lh), abs(ac - ah) / abs(ah))
    grad_rel = [_rel(a, b) for a, b in zip(gc, gh)]
    if fwd_rel > MLA_CARD_CPU_FWD or max(grad_rel) > MLA_CARD_CPU_GRAD:
        raise AssertionError(f"deepseek smoke card vs CPU: loss/aux "
                             f"{fwd_rel}, gradients {grad_rel}")
    return {"card_vs_cpu_loss_aux_max_rel": fwd_rel,
            "card_vs_cpu_grad_max_rel": dict(zip(
                ("kv_up_w", "kv_up_omega", "q_up_w", "router_w"), grad_rel)),
            "loss_card": lc, "loss_cpu": lh,
            "launcher_resume": _mla_launcher_resume(dev)}


def _mla_grads(dev, cfg, state, batch, lam, remat):
    """The share's loss at λ ``lam`` and its gradients from ``state``
    under ``remat``, once: the loss, a digest of every gradient, layer 0's
    kv_up w and ω gradients, the ecl_quant launches and the MoE calls
    counted, and the peak device memory after the forward and after the
    backward."""
    import torch
    from repro_torch import tree
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import steps as steps_mod

    loss_fn = steps_mod._loss_fn(cfg, remat=remat)
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in tree.leaves(state["params"])]
    params = tree.unflatten(state["params"], leaves)
    kv_up = params["stacks"]["dense"]["attn"]["kv_up"]["kernel"]
    wants = [t for t in leaves if t.requires_grad]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = eq.LAUNCHES
    with _DropCounter(cfg) as drops:
        loss, _ = loss_fn(params, state["qstate"], batch, lam)
        peak_fwd = torch.cuda.max_memory_allocated(dev)
        grads = torch.autograd.grad(loss, wants, allow_unused=True)
    peak_bwd = torch.cuda.max_memory_allocated(dev)
    by_leaf = {id(t): g for t, g in zip(wants, grads)}
    out = {"loss": loss.detach(), "launches": eq.LAUNCHES - before,
           "digest": _digest([g for g in grads if g is not None]),
           "gradients": sum(g is not None for g in grads),
           "kv_up": (by_leaf[id(kv_up["w"])], by_leaf[id(kv_up["omega"])]),
           "drops": torch.stack(drops.counts).cpu().tolist(),
           "peak_forward_bytes": peak_fwd, "peak_backward_bytes": peak_bwd}
    del grads, by_leaf, leaves, params, wants
    return out


def _mla_attention_times(dev, cfg, batch, seq):
    """Device ms of layer 0's MLA block (``mla_apply``, the naive form
    over cfg.attn_chunk-key chunks) at the step's shape in bf16: the
    forward, and the forward and backward together (weights from seeded
    draws; the time does not depend on their values)."""
    import torch
    from repro_torch.nn import attention as attn
    from repro_torch.nn import transformer as TT
    from repro_torch.nn.layers import rope_cos_sin
    from repro_torch.nn.module import QuantCtx

    g = torch.Generator(device=dev).manual_seed(MLA_TRAIN["seed"] + 7)
    mcfg = TT._mla_cfg(cfg)
    p = {k: {"kernel": v["kernel"].to(torch.bfloat16).requires_grad_()}
         for k, v in attn.mla_init(g, mcfg, quantize=False).items()}
    ctx = QuantCtx(quant=False, compute_dtype=torch.bfloat16)
    x = (torch.randn((batch, seq, cfg.d_model), generator=g, device=dev)
         .to(torch.bfloat16).requires_grad_())
    pos = torch.arange(seq, dtype=torch.int32, device=dev).expand(batch, seq)
    cos_sin = rope_cos_sin(pos, mcfg.qk_rope_dim, cfg.rope_theta,
                           dtype=torch.float32)
    wants = [x] + [v["kernel"] for v in p.values()]
    gy = torch.randn((batch, seq, cfg.d_model), generator=g,
                     device=dev).to(torch.bfloat16)

    def forward():
        return attn.mla_apply(p, 0, x, ctx, mcfg, cos_sin=cos_sin,
                              positions=pos, chunk=cfg.attn_chunk)[0]

    def forward_backward():
        torch.autograd.grad(forward(), wants, gy)
    fwd = _device_time(forward, dev, 1)
    both = _device_time(forward_backward, dev, 1)
    return {"shape": [batch, seq, cfg.n_heads],
            "chunks": -(-seq // cfg.attn_chunk),
            "forward_device_ms": fwd["device_ms"],
            "forward_device_ms_from": fwd["device_ms_from"],
            "forward_backward_device_ms": both["device_ms"],
            "forward_backward_device_ms_from": both["device_ms_from"],
            "backward_device_ms": both["device_ms"] - fwd["device_ms"]}


def mla_train_path(dev, gpu):
    """Phase 10: EC4T-train one GPU's share of deepseek-v3-671b with MLA
    at published widths (depth 2, experts 0-3 of 256, vocabulary 32,768)
    through the launcher's functions, 4 steps at 1 x 4,096 tokens in
    bf16; from step 4's input the loss and backward again under each
    remat (bitwise); the 4-bit export, loaded back, serves the same
    greedy tokens as ``freeze_tree``'s tree."""
    import gc
    import tempfile
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint.manager import (_paths, export_quantized,
                                                frozen_tree, load_quantized)
    from repro_torch.configs import get_config
    from repro_torch.core import ecl, qat
    from repro_torch.data import pipeline
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import train as T
    from repro_torch.nn import moe
    from repro_torch.nn import transformer as TT
    from repro_torch.optim import ec4t, schedule
    from repro_torch.runtime.fault import FaultTolerantLoop

    t_phase = time.perf_counter()
    start_bytes = _empty_card(dev, "phase 10")
    cfg = _mla_train_cfg()
    published = get_config(MLA_TRAIN["arch"])
    first, count = cfg.experts_held
    reduced = [f"depth {published.n_layers} -> {cfg.n_layers} (layers 0 "
               f"and {published.n_dense_layers}: one dense, one MoE)",
               f"experts held {count} of {cfg.n_experts} ({first}-"
               f"{first + count - 1})",
               f"vocabulary {cfg.vocab:,} of {published.vocab:,} (ids 0-"
               f"{cfg.vocab - 1:,})"]
    deployment = (f"one GPU of the DeepSeek-V3 report's training layout "
                  f"(arXiv:2412.19437 §3.2: PP{MLA_TRAIN['pp']}, "
                  f"EP{MLA_TRAIN['ep']}, ZeRO-1 DP): {cfg.n_experts} / "
                  f"{MLA_TRAIN['ep']} = {count} experts, the router "
                  f"{cfg.n_experts} wide and top-{cfg.top_k}; half a PP "
                  "stage's depth with its whole fp32 master and Adam state "
                  "(no ZeRO-1 in the port); attention, the shared expert "
                  "and every width whole")
    print(f"phase 10: {cfg.name} share: reduced {reduced}; deployment: "
          f"{deployment} ({gpu})")
    smoke = _mla_train_smoke_checks(dev)

    steps = MLA_TRAIN["steps"]
    step_fn = T.lm_step_fn(cfg, steps=steps, lr=MLA_TRAIN["lr"],
                           lam=MLA_TRAIN["lam"],
                           lam_ramp=MLA_TRAIN["lam_ramp"])
    batch_fn = T.lm_batch_fn(cfg, batch=MLA_TRAIN["batch"],
                             seq=MLA_TRAIN["seq"])
    state = ec4t.init_train_state(TT.lm_init(cfg, seed=MLA_TRAIN["seed"],
                                             device=dev))
    params_n = sum(t.numel() for t in tree.leaves(state["params"])
                   if t.is_floating_point())
    stacks_p = state["params"]["stacks"]
    stacks_q = state["qstate"]["stacks"]
    nodes = list(qat._quant_leaves(stacks_p, stacks_q))
    segments = sum(n["omega"][..., 0].numel() for n, _ in nodes)
    elements = sum(n["w"].numel() for n, _ in nodes)
    per_pass = -(-segments // eq.MAX_SEGMENTS)
    n_moe = cfg.n_layers - cfg.n_dense_layers
    if segments != cfg.n_dense_layers * (5 + 3) + n_moe * (
            5 + len(MOE_BANKS) * count + 3):
        raise AssertionError(f"{segments} ECL segments, expected 5 MLA + 3 "
                             f"FFN a dense layer, 5 MLA + 3 banks x {count} "
                             "held experts + 3 shared a MoE layer")
    # each quantized leaf's place in a grouped pass (the stacks' order)
    order = qat._map_quant_many(lambda ns, qs: list(range(len(ns))),
                                stacks_p, stacks_q, keep_params=True)
    picks = [(order["dense"]["attn"]["kv_up"]["kernel"], (0,)),
             (order["moe"]["moe"]["experts"]["down"], (0, count - 1))]
    del order, nodes, stacks_p, stacks_q
    bias0 = state["params"]["stacks"]["moe"]["moe"]["router"][
        "bias_correction"].clone()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree.leaves(state))

    history, kept = [], {"calls": 0}

    def step_keeping_the_last_input(st, batch):
        # the last step's input state and batch are kept for the remat
        # runs (the loop retries nothing here: every call is a step)
        kept["calls"] += 1
        if kept["calls"] == steps:
            kept.update(state=st, batch=batch)
        return step_fn(st, batch)
    loop = FaultTolerantLoop(
        step_keeping_the_last_input, _Discard(), ckpt_every=steps + 1,
        metrics_every=1, on_metrics=lambda s, m: history.append(
            {"step": s, **{k: float(v) for k, v in m.items()}}))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mla_") as tmp:
        export_dir = os.path.join(tmp, "export")
        # the main path: counters zeroed just before, read just after
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eq.LAUNCHES = 0
        t0 = time.perf_counter()
        with _EclRecorder(ecl, eq, MLA_TRAIN_CHECKED_CALLS, None,
                          picks=picks, check=_plain_pair) as rec, \
                _DropCounter(cfg) as drops:
            feed = pipeline.ShardedFeed(batch_fn, start_step=0, device=dev)
            held = [state]
            del state
            try:
                state, last, reason = loop.run(held.pop(), feed,
                                               start_step=0,
                                               total_steps=steps)
            finally:
                feed.close()
            torch.cuda.synchronize(dev)
            train_s = time.perf_counter() - t0
            step_launches = eq.LAUNCHES
            t0 = time.perf_counter()
            report = export_quantized(export_dir, state["params"],
                                      state["qstate"], cfg.lam)
            export_ms = (time.perf_counter() - t0) * 1e3
        export_launches = eq.LAUNCHES - step_launches
        peak_train = torch.cuda.max_memory_allocated(dev)
        if (reason, last) != ("done", steps) or "state" not in kept:
            raise AssertionError(f"the loop ended {reason} at {last}")
        losses = [h["loss"] for h in history]
        auxes = [h["aux"] for h in history]
        if len(losses) != steps or not np.isfinite(losses + auxes).all():
            raise AssertionError(f"losses {losses}, aux {auxes}")
        if abs(losses[0] - np.log(cfg.vocab)) > MOE_LOSS0_TOL:
            raise AssertionError(f"first loss {losses[0]}, ln(vocab) "
                                 f"{np.log(cfg.vocab)}")
        per_call, checked = _share_ecl_gates(
            rec, per_pass, segments, steps, step_launches, export_launches,
            MLA_TRAIN_CHECKED_CALLS)
        del rec
        dropped = torch.stack(drops.counts).cpu().tolist()
        if not torch.equal(state["params"]["stacks"]["moe"]["moe"][
                "router"]["bias_correction"], bias0):
            raise AssertionError("bias_correction moved in training")
        digest = _digest(state)

        # the export loaded back == freeze_tree, and served alike
        t0 = time.perf_counter()
        loaded = load_quantized(export_dir, device=dev)
        load_ms = (time.perf_counter() - t0) * 1e3
        served = frozen_tree(loaded, device=dev)
        del loaded
        eq.LAUNCHES = 0
        frozen = qat.freeze_tree(state["params"], state["qstate"], cfg.lam)
        freeze_launches = eq.LAUNCHES
        del state
        gc.collect()
        torch.cuda.empty_cache()
        want, got = dict(_paths(frozen)), dict(_paths(served))
        if sorted(want) != sorted(got) or not all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                for k in want):
            raise AssertionError("the loaded export != freeze_tree's tree")
        prompts = np.random.default_rng(MLA_TRAIN["seed"]).integers(
            0, cfg.vocab, (MLA_TRAIN["prompts"], MLA_TRAIN["prompt_len"]))
        serve_export = _lm_direct(dev, cfg, served, prompts,
                                  MLA_TRAIN["max_new"])
        serve_freeze = _lm_direct(dev, cfg, frozen, prompts,
                                  MLA_TRAIN["max_new"])
        if not (np.array_equal(serve_export["tokens"],
                               serve_freeze["tokens"])
                and bool(torch.isfinite(serve_export["logits"]).all())):
            raise AssertionError("the export's tokens != freeze_tree's")
        export_bytes = os.path.getsize(os.path.join(export_dir,
                                                    "export.npz"))
        del served, frozen, want, got, serve_freeze
        serve_export.pop("cache")

    # from step 4's input: the loss and the backward under each remat, the
    # none run twice; every gradient bitwise none's
    s3, b3 = kept.pop("state"), kept.pop("batch")
    gc.collect()
    torch.cuda.empty_cache()
    lam3 = schedule.lambda_ramp(s3["opt"]["step"], lam=MLA_TRAIN["lam"],
                                ramp_steps=MLA_TRAIN["lam_ramp"])
    runs = {}
    for remat in ("none",) + REMATS:
        run = _mla_grads(dev, cfg, s3, b3, lam3, remat)
        if remat not in runs:
            runs[remat] = run
        elif not (torch.equal(run["digest"], runs[remat]["digest"])
                  and all(torch.equal(a, b) for a, b in
                          zip(run["kv_up"], runs[remat]["kv_up"]))):
            raise AssertionError("the full-width backward twice differs")
        del run
    base = runs["none"]
    for remat, run in runs.items():
        if not (torch.equal(run["loss"], base["loss"])
                and torch.equal(run["digest"], base["digest"])
                and all(torch.equal(a, b) for a, b in
                        zip(run["kv_up"], base["kv_up"]))
                and run["gradients"] == base["gradients"]):
            raise AssertionError(f"remat={remat}: the loss or a gradient "
                                 "differs from remat=none's")
        if run["launches"] != per_pass or run["drops"] != base["drops"] \
                or len(run["drops"]) != n_moe:
            raise AssertionError(
                f"remat={remat}: {run['launches']} ecl_quant launches "
                f"(want {per_pass}), MoE calls counted {run['drops']} "
                f"(none: {base['drops']})")
    if float(base["loss"]) != losses[-1]:
        raise AssertionError(f"the none run's loss {float(base['loss'])} "
                             f"!= step {steps}'s {losses[-1]}")
    remat_runs = {r: {"loss": float(run["loss"]),
                      "gradients": run["gradients"],
                      "ecl_quant_launches": run["launches"],
                      "peak_forward_bytes": run["peak_forward_bytes"],
                      "peak_backward_bytes": run["peak_backward_bytes"]}
                  for r, run in runs.items()}
    del runs, base

    # a whole step under full and dots: its new state bitwise step 4's
    for remat in REMATS[1:]:
        fn = T.lm_step_fn(cfg, steps=steps, lr=MLA_TRAIN["lr"],
                          lam=MLA_TRAIN["lam"],
                          lam_ramp=MLA_TRAIN["lam_ramp"], remat=remat)
        before = eq.LAUNCHES
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with _StagePeaks(dev) as staged:
            new, m = fn(s3, b3)
        torch.cuda.synchronize(dev)
        remat_runs[remat]["step_ms"] = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(_digest(new), digest)
                and float(m["loss"]) == losses[-1]
                and eq.LAUNCHES - before == ECL_PASSES_PER_STEP * per_pass):
            raise AssertionError(f"remat={remat}: step {steps} differs "
                                 "from remat=none's")
        remat_runs[remat]["peak_step_bytes_by_stage"] = staged.peaks
        del new, m
    gc.collect()
    torch.cuda.empty_cache()

    ecl_row = _share_ecl_pass(dev, s3["params"]["stacks"],
                              s3["qstate"]["stacks"], cfg.lam, segments,
                              per_pass)
    pass_bound = ecl_row["bound_ms"]
    holder = [s3]
    del s3
    trace = _lm_train_trace(dev, step_fn, holder, b3, timed=2)
    del holder, b3
    gc.collect()
    torch.cuda.empty_cache()
    if trace["host_syncs_per_step"]:
        raise AssertionError(f"host synchronisations inside a step: "
                             f"{trace['host_syncs_per_step']}")
    remat_runs["none"]["peak_step_bytes_by_stage"] = \
        trace["peak_device_memory_bytes_by_stage"]
    remat_runs["none"]["step_ms"] = trace["ms_per_step"]
    attention = _mla_attention_times(dev, cfg, MLA_TRAIN["batch"],
                                     MLA_TRAIN["seq"])
    adam_bound = ADAM_BYTES_PER_PARAM * params_n / PEAK_BYTES * 1e3
    out = {
        **MLA_TRAIN, "arch": cfg.name, "published_layers":
            published.n_layers, "published_vocab": published.vocab,
        "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "dense_ff": cfg.dense_ff, "d_ff": cfg.d_ff,
        "n_experts": cfg.n_experts, "top_k": cfg.top_k,
        "attn_chunk": cfg.attn_chunk,
        "capacity": moe._capacity(
            MLA_TRAIN["batch"] * MLA_TRAIN["seq"] * cfg.top_k,
            cfg.n_experts, cfg.capacity_factor),
        "reduced": reduced, "deployment": deployment,
        "compute_dtype": "bfloat16", "params": params_n,
        "quant_weights": elements, "ecl_segments": segments,
        "state_bytes": state_bytes, "losses": losses, "aux": auxes,
        "train_wall_s": train_s, "ecl_quant_launches": step_launches,
        "ecl_quant_launches_export": export_launches,
        "ecl_quant_launches_freeze": freeze_launches,
        "ecl_quant_launches_per_pass": per_pass,
        "ecl_quant_passes": len(per_call), "ecl_segments_checked": checked,
        "remat": remat_runs,
        "dropped_by_step": [{"dropped": d, "kept_held": k,
                             "assigned_held": a} for d, k, a in dropped],
        **trace,
        "ecl_quant_bound_ms_per_pass": pass_bound,
        "ecl_quant_bound_ms_per_step": ECL_PASSES_PER_STEP * pass_bound,
        "ecl_quant_pass": ecl_row, "adam_bound_ms": adam_bound,
        "mla_attention": attention,
        "peak_device_memory_bytes": peak_train,
        "export_bytes": export_bytes,
        "export_compressed_bytes": report["compressed_bytes"],
        "export_compression_ratio": report["compression_ratio"],
        "export_ms": export_ms, "export_load_ms": load_ms,
        "served_tokens_0": serve_export["tokens"][0].tolist(),
        "smoke": smoke, "gpu": gpu,
        "wall_s": time.perf_counter() - t_phase}
    gb = 1e-9

    def peaks(r):
        st = remat_runs[r]["peak_step_bytes_by_stage"]
        return (f"{r} ({remat_runs[r]['step_ms']:.1f} ms a step): "
                f"forward {remat_runs[r]['peak_forward_bytes'] * gb:.1f}"
                f" / backward {remat_runs[r]['peak_backward_bytes'] * gb:.1f}"
                f" GB; in a step forward {st.get('forward', 0) * gb:.1f}, "
                f"backward {st.get('backward', 0) * gb:.1f}, adam "
                f"{st.get('adam', 0) * gb:.1f}, update "
                f"{st.get('update_qstate', 0) * gb:.1f}")
    print(f"phase 10: {cfg.name} share EC4T-trained {steps} steps at batch "
          f"{MLA_TRAIN['batch']} x seq {MLA_TRAIN['seq']} (bf16, "
          f"{params_n / 1e9:.3f} B parameters): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, aux {auxes[0]:.4f} -> {auxes[-1]:.4f}; "
          f"{step_launches} ecl_quant launches ({per_pass} a pass, "
          f"{segments} segments, {elements:,} elements) + "
          f"{export_launches} in the export; remat full and dots bitwise "
          f"none's (loss, {remat_runs['none']['gradients']} gradients, a "
          "whole step); the backward twice bitwise; export == freeze_tree, "
          f"tokens equal ({gpu})")
    print(f"phase 10: {trace['ms_per_step']:.1f} ms/step, device "
          f"{trace['device_ms_per_step']:.1f} ms/step, idle "
          f"{trace['device_idle_share']:.3f}, "
          f"{trace['device_ops_per_step']:.0f} device ops; ECL pass "
          f"{ecl_row['device_ms']:.3f} ms ({ecl_row['device_ms_from']}) "
          f"against {pass_bound:.3f} (bytes), "
          f"{trace['ecl_quant_device_ms_per_step']:.2f} ms/step in the "
          f"trace; adam.apply "
          f"{_ms(trace['adam_apply_device_ms_per_step'])} ms against "
          f"{adam_bound:.2f}; FakeQuantGroup.backward "
          f"{_ms(trace['fake_quant_backward_device_ms_per_step'])} ms; "
          f"update_qstate {_ms(trace['update_qstate_device_ms_per_step'])} "
          f"ms; MLA attention (layer 0, {attention['chunks']} chunks) "
          f"forward {attention['forward_device_ms']:.2f} ms, backward "
          f"{attention['backward_device_ms']:.2f} ms ({gpu})")
    print(f"phase 10: peak memory {'; '.join(peaks(r) for r in REMATS)}; "
          f"main path peak {peak_train * gb:.1f} GB ({gpu})")
    print(f"phase 10: export {export_bytes * gb:.3f} GB "
          f"({report['compression_ratio']:.2f}x) in {export_ms:.0f} ms, "
          f"loaded in {load_ms:.0f} ms; dropped a step "
          f"{[d for d, _, _ in dropped]} of "
          f"{MLA_TRAIN['batch'] * MLA_TRAIN['seq'] * cfg.top_k}, held kept "
          f"{[k for _, k, _ in dropped]} of {[a for _, _, a in dropped]}; "
          f"smoke card vs CPU loss/aux "
          f"{smoke['card_vs_cpu_loss_aux_max_rel']:.2e}, gradients "
          f"{max(smoke['card_vs_cpu_grad_max_rel'].values()):.2e}, launcher "
          f"resume bitwise; done in {out['wall_s']:.1f} s ({gpu})")
    return out


# ------------------------------------------------------------ phase 11

SSM_ARCHS = ("mamba2-1.3b", "hymba-1.5b")
SSM_LEAVES = {"ssm": 2, "hybrid": 9}      # quantized leaves a layer
SSM_SERVE = dict(seed=0, prompts=2, prompt_len=8192, max_new=16,
                 short_prompt_len=1024,
                 # depth cut for the script's time limit (widths kept)
                 layers={"mamba2-1.3b": 4, "hymba-1.5b": 4})
SSM_REL = 1e-4            # the SSD vs fp64 recurrence; steps vs sequence
SSM_STACK_REL = 1e-3      # cached decode logits vs a no-cache forward
SSM_SPLIT = 4096          # where the carried-state SSD check starts
SSM_SHORT_NEW = 2         # tokens of the short-context run before its trace
SSM_TIMED_STEPS = 2       # decode steps timed on the host clock (then 1 traced)


class _Stages:
    """Seconds of each stage of a phase, on the host clock (each stage
    ends in a synchronisation or a host read)."""

    def __init__(self):
        self.seconds, self._t = {}, time.perf_counter()

    def mark(self, name):
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def _ssm_freeze(dev, cfg):
    """Phase 11's freeze (:func:`_gated_freeze`): every quantized leaf of
    the stack; codes of layer 0's in_proj and of the last layer's out_proj
    checked."""
    kind = cfg.family
    checks = [(kind, ("ssm", "in_proj", "kernel"), (0,)),
              (kind, ("ssm", "out_proj", "kernel"), (cfg.n_layers - 1,))]
    layout = ("in_proj and out_proj a layer" if kind == "ssm" else
              "q, k, v, o, gate, up, down, in_proj and out_proj a layer")
    return _gated_freeze(dev, cfg, SSM_SERVE["seed"],
                         cfg.n_layers * SSM_LEAVES[kind], layout, checks)


class _SsmRecorder:
    """While in use, keeps the inputs of the first ``ssm.ssd_chunked``
    call and of the first ``ssm.ssm_apply`` call (layer 0's, in a
    prefill): the transformer and ``ssm_apply`` look both up on the module
    at every call."""

    def __enter__(self):
        from repro_torch.nn import ssm
        self._orig = (ssm.ssd_chunked, ssm.ssm_apply)
        self.ssd = self.u = None

        def ssd(x, a, B, C, chunk, init_state=None):
            if self.ssd is None:
                self.ssd = tuple(t.detach().clone() for t in (x, a, B, C))
            return self._orig[0](x, a, B, C, chunk, init_state=init_state)

        def apply(p, q, u, ctx, cfg, **kw):
            if self.u is None:
                self.u = u.detach().clone()
            return self._orig[1](p, q, u, ctx, cfg, **kw)
        ssm.ssd_chunked, ssm.ssm_apply = ssd, apply
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import ssm
        ssm.ssd_chunked, ssm.ssm_apply = self._orig


def _ssd_vs_recurrence(x, a, B, C, chunk):
    """``ssd_chunked`` on the card, on one layer's recorded inputs, against
    the sequential recurrence in fp64 (s_t = exp(a_t)·s_{t-1} + x_t ⊗ B_t,
    y_t = s_t · C_t, group g of B and C serving heads g·h/G onward): the
    whole sequence from zeros, and its part from SSM_SPLIT on from the
    recurrence's state there (a carried-in state).  Max relative errors of
    y and of the final state."""
    import torch
    from repro_torch.nn import ssm

    b, s, h, p = x.shape
    rep = h // B.shape[2]
    f64 = torch.float64
    Bh = B.to(f64).repeat_interleave(rep, dim=2)
    Ch = C.to(f64).repeat_interleave(rep, dim=2)
    xd, decay = x.to(f64), torch.exp(a.to(f64))
    st = torch.zeros((b, h, p, B.shape[3]), dtype=f64, device=x.device)
    want = torch.empty((b, s, h, p), dtype=f64, device=x.device)
    mid = None
    for t in range(s):
        if t == SSM_SPLIT:
            mid = st.clone()
        st = st * decay[:, t, :, None, None] \
            + xd[:, t, :, :, None] * Bh[:, t, :, None, :]
        want[:, t] = torch.einsum("bhpn,bhn->bhp", st, Ch[:, t])
    del Bh, Ch, xd, decay
    with torch.no_grad():
        y, fin = ssm.ssd_chunked(x, a, B, C, chunk)
        out = {"from_zeros": {"y": _rel(y.to(f64), want),
                              "state": _rel(fin.to(f64), st)}}
        cut = slice(SSM_SPLIT, None)
        y, fin = ssm.ssd_chunked(x[:, cut], a[:, cut], B[:, cut], C[:, cut],
                                 chunk, init_state=mid.to(torch.float32))
        out["carried"] = {"y": _rel(y.to(f64), want[:, cut]),
                          "state": _rel(fin.to(f64), st)}
    return out


def _ssm_steps_vs_sequence(cfg, p, u, steps):
    """One layer's SSD block (frozen ``p``): ``ssm_apply`` over all of
    ``u``, against ``ssm_apply`` over all but the last ``steps`` tokens
    and then ``ssm_step`` over those: max relative errors of the outputs,
    the SSM state and the conv tail."""
    import torch
    from repro_torch.nn import ssm
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX

    scfg, s = T._ssm_cfg(cfg), u.shape[1]
    with torch.no_grad():
        y_all, st_all = ssm.ssm_apply(p, 0, u, FP32_CTX, scfg)
        _, st = ssm.ssm_apply(p, 0, u[:, :s - steps], FP32_CTX, scfg)
        ys = []
        for t in range(s - steps, s):
            y, st = ssm.ssm_step(p, 0, u[:, t:t + 1], FP32_CTX, scfg, st)
            ys.append(y)
    return {"y": _rel(torch.cat(ys, 1), y_all[:, s - steps:]),
            "state": _rel(st["ssm"], st_all["ssm"]),
            "conv": _rel(st["conv"], st_all["conv"])}


def _ssm_serve_one(dev, gpu, arch):
    """Phase 11 for one arch: the launcher, the gated freeze, the direct
    run with its gates, the decode timed at two context lengths."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import serve
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX

    t_arch = time.perf_counter()
    stages = _Stages()
    start_bytes = _empty_card(dev, f"phase 11 ({arch})")
    cfg = _cut_depth(get_config(arch), SSM_SERVE["layers"][arch])
    kind = cfg.family
    b, s, new = (SSM_SERVE["prompts"], SSM_SERVE["prompt_len"],
                 SSM_SERVE["max_new"])

    # the main path, as a user serves it
    argv = ["--arch", arch, "--batch", str(b), "--prompt-len", str(s),
            "--max-new", str(new), "--seed", str(SSM_SERVE["seed"]),
            "--layers", str(cfg.n_layers)]
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
    stages.mark("launcher")

    frozen, freeze, ecl_row = _ssm_freeze(dev, cfg)
    stages.mark("gated freeze and its timings")
    want_launches = -(-cfg.n_layers * SSM_LEAVES[kind] // eq.MAX_SEGMENTS)
    if not (launcher["ecl_quant_launches"] == freeze["ecl_quant_launches"]
            == want_launches):
        raise AssertionError(f"ecl_quant launches: the launcher "
                             f"{launcher['ecl_quant_launches']}, the freeze "
                             f"{freeze['ecl_quant_launches']}, want "
                             f"{want_launches}")
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(dev)

    prompts = np.random.default_rng(SSM_SERVE["seed"]).integers(
        0, cfg.vocab, (b, s))
    def per_seq(cache, entry):
        """Bytes a sequence of the cache's ``entry`` ("ssm" or "attn")."""
        return serve._cache_bytes(cache, entry) // b

    state0 = per_seq(T.init_cache(cfg, b, s + new, dtype=torch.float32,
                                  device=dev), "ssm")
    with _SsmRecorder() as rec:
        run = _lm_direct(dev, cfg, frozen, prompts, new)
    if not bool(torch.isfinite(run["logits"]).all()):
        raise AssertionError("non-finite logits")
    if not np.array_equal(run["tokens"], gen):
        raise AssertionError("the gated run's tokens != the launcher's")
    if not (_on_card(frozen) and _on_card(run["cache"])):
        raise AssertionError("a frozen leaf or the cache left the card")
    stages.mark("gated run")

    # the SSD scan at full width against the fp64 recurrence
    ssd = _ssd_vs_recurrence(*rec.ssd, cfg.ssm_chunk)
    stages.mark("SSD vs fp64 recurrence")
    # one layer's decode steps against its sequence mode
    p0 = _layer0(frozen["stacks"][kind]["ssm"])
    steps_rel = _ssm_steps_vs_sequence(cfg, p0, rec.u, new)
    del rec, p0
    stages.mark("steps vs sequence")
    worst = max([v for d in ssd.values() for v in d.values()]
                + list(steps_rel.values()))
    if worst > SSM_REL:
        raise AssertionError(f"{arch}: SSD off the fp64 recurrence {ssd}, "
                             f"decode steps off the sequence {steps_rel}")

    # the cached decode against a no-cache forward over the same tokens
    seqs = torch.from_numpy(np.concatenate(
        [prompts, run["tokens"][:, :-1]], axis=1)).to(dev)
    with torch.no_grad():
        full, _, _ = T.lm_apply(frozen, 0, seqs, FP32_CTX, cfg)
        no_cache = full[:, -1, :cfg.vocab].clone()
    del full, seqs
    stack_rel = _rel(run["logits"][:, -1], no_cache)
    if stack_rel > SSM_STACK_REL:
        raise AssertionError(f"{arch}: cached decode logits off a no-cache "
                             f"forward by {stack_rel} relative")
    stages.mark("no-cache forward")

    cache = run["cache"]
    state_bytes, kv_bytes = per_seq(cache, "ssm"), per_seq(cache, "attn")
    step_tok = torch.from_numpy(run["tokens"][:, -1:]).to(dev)
    step_pos = torch.full((b, 1), s + new - 1, dtype=torch.int32, device=dev)

    def decode_step():
        with torch.no_grad():
            return T.lm_apply(frozen, 0, step_tok, FP32_CTX, cfg,
                              positions=step_pos, cache=cache)

    trace, _ = _step_trace(decode_step, dev, SSM_TIMED_STEPS, traced=1)
    timing = {k: run[k] for k in ("prefill_ms", "decode_ms",
                                  "prefill_peak_bytes", "decode_peak_bytes")}
    del run, cache
    gc.collect()
    torch.cuda.empty_cache()
    stages.mark("traced decode step")

    # the decode after 2 x 1,024-token prompts: a prefill and one step
    # into a cache of short + SSM_SHORT_NEW slots, then traced steps
    short, short_new = SSM_SERVE["short_prompt_len"], SSM_SHORT_NEW
    run = _lm_direct(dev, cfg, frozen, prompts[:, :short], short_new)
    short_state = per_seq(run["cache"], "ssm")
    cache = run["cache"]
    step_tok = torch.from_numpy(run["tokens"][:, -1:]).to(dev)
    step_pos = torch.full((b, 1), short + short_new - 1, dtype=torch.int32,
                          device=dev)
    short_trace, _ = _step_trace(decode_step, dev, SSM_TIMED_STEPS,
                                 traced=1)
    short_run = {"prompt_len": short,
                 "decode_ms_per_step": short_trace["wall_ms_per_step"],
                 "kv_bytes_per_sequence": per_seq(cache, "attn"),
                 "decode_step_trace": short_trace}
    del run, cache, frozen
    if not state0 == state_bytes == short_state:
        raise AssertionError(f"{arch}: the decode state a sequence "
                             f"{state0} B at init, {state_bytes} after "
                             f"{s + new}, {short_state} after "
                             f"{short + short_new}")
    gc.collect()
    torch.cuda.empty_cache()
    stages.mark("short-context decode")
    smoke = _moe_smoke_card_vs_cpu(dev, arch)
    stages.mark("smoke card vs CPU")

    out = {"arch": arch, "family": kind, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_inner": cfg.d_inner,
           "ssm_heads": cfg.ssm_heads, "ssm_headdim": cfg.ssm_headdim,
           "ssm_state": cfg.ssm_state, "ssm_chunk": cfg.ssm_chunk,
           "vocab": cfg.vocab, "sequences": b, "prompt_len": s,
           "max_new": new, "start_device_bytes": start_bytes,
           "launcher": launcher, "freeze": freeze, "ecl_quant": ecl_row,
           "resident_device_bytes": resident,
           "prefill_ms": timing["prefill_ms"],
           "decode_ms_per_step": timing["decode_ms"],
           "prefill_peak_device_bytes": timing["prefill_peak_bytes"],
           "decode_peak_device_bytes": timing["decode_peak_bytes"],
           "decode_step_trace": trace, "short": short_run,
           "state_bytes_per_sequence": state_bytes,
           "kv_bytes_per_sequence": kv_bytes,
           "ssd_vs_fp64_recurrence_max_rel": ssd,
           "steps_vs_sequence_max_rel": steps_rel,
           "cached_vs_no_cache_logits_max_rel": stack_rel,
           "smoke_card_vs_cpu": smoke, "tokens_0": gen[0].tolist(),
           "stage_s": stages.seconds, "wall_s": time.perf_counter() - t_arch}
    if kind == "hybrid":
        out.update(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_ff=cfg.d_ff,
                   window=cfg.window,
                   global_layers=list(cfg.global_attn_layers))
    gb = 1e-9
    print(f"phase 11: {arch} frozen in {freeze['ms']:.1f} ms "
          f"({freeze['ecl_quant_launches']} ecl_quant launches, "
          f"{freeze['segments']} segments, {freeze['quant_weights']:,} "
          f"elements; ECL device {ecl_row['device_ms']:.2f} ms "
          f"[{ecl_row['device_ms_from']}] against a "
          f"{ecl_row['bound_ms']:.3f} ms byte bound, "
          f"{ecl_row['codes_only_bound_ms']:.3f} codes-only), peak "
          f"{freeze['peak_device_bytes'] * gb:.1f} GB; stages (s) "
          f"{ {k: round(v, 1) for k, v in stages.seconds.items()} } ({gpu})")
    print(f"phase 11: {arch} prefill of {b} x {s} "
          f"{timing['prefill_ms']:.1f} ms (peak "
          f"{timing['prefill_peak_bytes'] * gb:.1f} GB), decode "
          f"{timing['decode_ms']:.2f} ms/step (CUDA events; host clock "
          f"{trace['wall_ms_per_step']:.2f}), device "
          f"{trace['device_ms_per_step']:.2f} ms/step, "
          f"{trace['device_ops_per_step']:.0f} device ops, idle "
          f"{trace['device_idle_share']:.3f}; after {b} x {short}: "
          f"{short_run['decode_ms_per_step']:.2f} ms/step (host clock), "
          "device "
          f"{short_trace['device_ms_per_step']:.2f}, idle "
          f"{short_trace['device_idle_share']:.3f} ({gpu})")
    print(f"phase 11: {arch} decode state {state_bytes:,} B a sequence at "
          f"{s + new} and at {short + new} tokens; KV cache {kv_bytes:,} B "
          f"a sequence ({kv_bytes // (s + new):,} B a token); SSD vs "
          f"fp64 recurrence {ssd}, steps vs sequence {steps_rel}, cached vs "
          f"no-cache logits {stack_rel:.2e}, smoke card vs CPU "
          f"{smoke['max_abs_logit_err']:.2e}; {out['wall_s']:.1f} s ({gpu})")
    return out


def ssm_serve_path(dev, gpu):
    """Phase 11: mamba2-1.3b and hymba-1.5b at their published widths,
    depths cut (``SSM_SERVE["layers"]``), frozen to 4 bits on the card
    and served through the
    launcher's direct path, with the SSD scan and the recurrent decode
    state gated at full width."""
    t_phase = time.perf_counter()
    out = {arch: _ssm_serve_one(dev, gpu, arch) for arch in SSM_ARCHS}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 11: done in {out['wall_s']:.1f} s ({gpu})")
    return out


# ------------------------------------------------------------ phase 12

def _launcher_resume(arch, seq, remat):
    """The launcher's ``main`` on the card at ``arch``'s smoke width under
    ``--remat remat``: MLA_SMOKE's steps with checkpoints, then again from
    a copy of the first checkpoint alone.  The resumed run's losses, its
    last checkpoint (every leaf) and its export equal the uninterrupted
    run's bit for bit."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.launch import train as T

    argv = ["--arch", arch, "--smoke", "--remat", remat,
            "--steps", str(MLA_SMOKE["steps"]), "--ckpt-every",
            str(MLA_SMOKE["ckpt_every"]), "--batch", str(MLA_SMOKE["batch"]),
            "--seq", str(seq), "--log-every", "1"]
    at, last = MLA_SMOKE["ckpt_every"], MLA_SMOKE["steps"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        runs = {}
        for name in ("whole", "resumed"):
            ckpt = os.path.join(tmp, name, "ckpt")
            if name == "resumed":
                shutil.copytree(
                    os.path.join(tmp, "whole", "ckpt", f"step_{at:08d}"),
                    os.path.join(ckpt, f"step_{at:08d}"))
            hist = T.main(argv + ["--ckpt-dir", ckpt, "--export",
                                  os.path.join(tmp, name, "export")])
            with np.load(os.path.join(ckpt, f"step_{last:08d}",
                                      "state.npz")) as z:
                leaves = {k: z[k] for k in z.files}
            with np.load(os.path.join(tmp, name, "export",
                                      "export.npz")) as z:
                export = {k: z[k] for k in z.files}
            runs[name] = ({h["step"]: h["loss"] for h in hist}, leaves,
                          export)
    (whole, wl, we), (rest, rl, re_) = runs["whole"], runs["resumed"]
    if sorted(rest) != list(range(at + 1, last + 1)) or \
            [whole[s] for s in sorted(rest)] != [rest[s] for s in
                                                 sorted(rest)]:
        raise AssertionError(f"{arch} launcher resume: losses {rest}, "
                             f"uninterrupted {whole}")
    for mine, theirs, what in ((rl, wl, "checkpoint"), (re_, we, "export")):
        if sorted(mine) != sorted(theirs) or not all(
                mine[k].dtype == theirs[k].dtype
                and np.array_equal(mine[k], theirs[k]) for k in mine):
            raise AssertionError(f"{arch} launcher resume: the step-{last} "
                                 f"{what} differs from the uninterrupted "
                                 "run's")
    return {"losses": [whole[s] for s in sorted(whole)],
            "resumed_losses": [rest[s] for s in sorted(rest)],
            "checkpoint_leaves": len(wl), "export_arrays": len(we)}


def _ssd_block_times(dev, cfg, batch, seq):
    """Device ms of one SSD block (``ssm_apply``: the in projection, the
    conv, the chunked scan, the gated norm, the out projection) at the
    step's shape in bf16: the forward, and the forward and backward
    together (weights from seeded draws; the time does not depend on
    their values)."""
    import torch
    from repro_torch.nn import ssm
    from repro_torch.nn import transformer as TT
    from repro_torch.nn.module import QuantCtx

    g = torch.Generator(device=dev).manual_seed(TRAIN_ALL["seed"] + 7)
    scfg = TT._ssm_cfg(cfg)
    p = ssm.ssm_init(g, scfg, quantize=False)
    p = {k: ({"kernel": v["kernel"].to(torch.bfloat16).requires_grad_()}
             if isinstance(v, dict) else v.requires_grad_())
         for k, v in p.items()}
    ctx = QuantCtx(quant=False, compute_dtype=torch.bfloat16)
    x = (torch.randn((batch, seq, cfg.d_model), generator=g, device=dev)
         .to(torch.bfloat16).requires_grad_())
    wants = [x] + [v["kernel"] if isinstance(v, dict) else v
                   for v in p.values()]
    gy = torch.randn((batch, seq, cfg.d_model), generator=g,
                     device=dev).to(torch.bfloat16)

    def forward():
        return ssm.ssm_apply(p, 0, x, ctx, scfg)[0]

    def forward_backward():
        torch.autograd.grad(forward(), wants, gy)
    fwd = _device_time(forward, dev, 1)
    both = _device_time(forward_backward, dev, 1)
    return {"shape": [batch, seq, cfg.ssm_heads, cfg.ssm_headdim,
                      cfg.ssm_state],
            "chunks": -(-seq // cfg.ssm_chunk),
            "forward_device_ms": fwd["device_ms"],
            "forward_device_ms_from": fwd["device_ms_from"],
            "forward_backward_device_ms": both["device_ms"],
            "forward_backward_device_ms_from": both["device_ms_from"],
            "backward_device_ms": both["device_ms"] - fwd["device_ms"]}


# ------------------------------------------------------------ phase 13

VLM_ARCH, AUDIO_ARCH = "qwen2-vl-2b", "whisper-base"
VLM_LEAVES = 7            # q, k, v, o, gate, up, down a layer
AUDIO_LEAVES = (6, 10)    # an encoder layer's, a decoder layer's (+ cross)
VLM_SERVE = dict(seed=0, prompts=2, prompt_len=8192, max_new=16,
                 short_prompt_len=1024, launcher_prompt_len=1024,
                 layers=4)     # depth cut for the time limit (widths kept)
VLM_STEPS_REL = 1e-4      # layer 0's decode steps vs its sequence
VLM_STACK_REL = 1e-3      # cached decode logits vs a no-cache forward
# whisper's start of transcript: <|startoftranscript|> <|en|> <|transcribe|>
# <|notimestamps|>, then greedy text tokens
AUDIO_PROMPT = (50258, 50259, 50359, 50363)
AUDIO_SERVE = dict(seed=0, utterances=8, max_new=124)
AUDIO_STACK_REL = 1e-3    # cached decoder logits vs a no-cache decode
SMOKE_TOL = 1e-5          # a smoke config's logits, card vs CPU


def _mrope_gates(dev, cfg, s):
    """M-RoPE on the card at the config's head dim, positions 0 .. s - 1:
    three identical streams give ``rope_cos_sin`` bit for bit; three
    distinct streams (t ascending, h descending, w a seeded permutation)
    give, in each stream's section of the rotary pairs, ``rope_cos_sin``
    of that stream bit for bit."""
    import torch
    from repro_torch.nn.layers import mrope_cos_sin, rope_cos_sin

    hd, theta, sec = cfg.resolved_head_dim, cfg.rope_theta, \
        cfg.mrope_sections
    t = torch.arange(s, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    streams = torch.stack([t, t.flip(0), t[torch.randperm(
        s, generator=g, device=dev)]])[:, None]              # (3, 1, s)
    same = all(torch.equal(a, b) for a, b in zip(
        mrope_cos_sin(torch.stack([t[None]] * 3), hd, theta, sec),
        rope_cos_sin(t[None], hd, theta)))
    got, start, per_stream = mrope_cos_sin(streams, hd, theta, sec), 0, []
    for i, width in enumerate(sec):
        want = rope_cos_sin(streams[i], hd, theta)
        per_stream.append(all(torch.equal(a[..., start:start + width],
                                          b[..., start:start + width])
                              for a, b in zip(got, want)))
        start += width
    if not (same and all(per_stream)):
        raise AssertionError(f"M-RoPE != rope_cos_sin: identical streams "
                             f"{same}, each stream's section {per_stream}")
    return {"positions": s, "head_dim": hd, "sections": list(sec),
            "identical_streams_bitwise": True,
            "distinct_streams_bitwise_per_section": True}


class _AttnRecorder:
    """While in use, keeps the input of the first ``attention.gqa_apply``
    call (layer 0's normed input in a prefill): the transformer looks it
    up on the module at every call."""

    def __enter__(self):
        from repro_torch.nn import attention
        self._orig, self.x = attention.gqa_apply, None

        def record(p, q, x, ctx, **kw):
            if self.x is None:
                self.x = x.detach().clone()
            return self._orig(p, q, x, ctx, **kw)
        attention.gqa_apply = record
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import attention
        attention.gqa_apply = self._orig


def _gqa_steps_vs_sequence(cfg, p, h, steps):
    """One layer's attention (frozen ``p``, M-RoPE) over all of ``h``
    without a cache, against a cached prefill of all but the last
    ``steps`` positions and then one decode step a position: the max
    relative error of the last ``steps`` outputs."""
    import torch
    from repro_torch.nn import attention
    from repro_torch.nn.layers import mrope_cos_sin
    from repro_torch.nn.module import FP32_CTX

    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    pos = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=hd,
              chunk=cfg.attn_chunk)

    def run(x, at, cache=None):
        cs = mrope_cos_sin(torch.stack([at] * 3), hd, cfg.rope_theta,
                           cfg.mrope_sections)
        return attention.gqa_apply(p, 0, x, FP32_CTX, cos_sin=cs,
                                   positions=at, cache=cache, **kw)
    with torch.no_grad():
        y_all, _ = run(h, pos)
        cache = attention.init_kv_cache(b, s, cfg.n_kv, hd, torch.float32,
                                        device=h.device)
        _, cache = run(h[:, :s - steps], pos[:, :s - steps], cache)
        ys = []
        for t in range(s - steps, s):
            y, cache = run(h[:, t:t + 1], pos[:, t:t + 1], cache)
            ys.append(y)
    return _rel(torch.cat(ys, 1), y_all[:, s - steps:])


def _vlm_serve(dev, gpu):
    """Phase 13, qwen2-vl-2b: the launcher on token prompts, the gated
    freeze, a prefill of 2 x 8,192 patch embeddings and 16 greedy tokens,
    with M-RoPE, layer 0's decode and the stack gated at full width."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import serve
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX

    t_arch = time.perf_counter()
    stages = _Stages()
    start_bytes = _empty_card(dev, f"phase 13 ({VLM_ARCH})")
    run_cfg = VLM_SERVE
    cfg = _cut_depth(get_config(VLM_ARCH), run_cfg["layers"])
    b, s, new = run_cfg["prompts"], run_cfg["prompt_len"], run_cfg["max_new"]

    # the main path as a user serves it: token prompts through the launcher
    argv = ["--arch", VLM_ARCH, "--batch", str(b), "--prompt-len",
            str(run_cfg["launcher_prompt_len"]), "--max-new", str(new),
            "--seed", str(run_cfg["seed"]), "--device", dev.type,
            "--layers", str(cfg.n_layers)]
    torch.cuda.synchronize(dev)
    eq.LAUNCHES = 0
    t0 = time.perf_counter()
    gen = serve.main(argv)
    torch.cuda.synchronize(dev)
    launcher = {"argv": argv, "wall_s": time.perf_counter() - t0,
                "ecl_quant_launches": eq.LAUNCHES}
    if gen.shape != (b, new) or not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"launcher returned ids of shape {gen.shape}")
    gc.collect()
    torch.cuda.empty_cache()
    stages.mark("launcher")

    checks = [("dense", ("attn", "q", "kernel"), (0,)),
              ("dense", ("mlp", "down", "kernel"), (cfg.n_layers - 1,))]
    frozen, freeze, ecl_row = _gated_freeze(
        dev, cfg, run_cfg["seed"], cfg.n_layers * VLM_LEAVES,
        "q, k, v, o, gate, up, down a layer", checks)
    want_launches = -(-cfg.n_layers * VLM_LEAVES // eq.MAX_SEGMENTS)
    if not (launcher["ecl_quant_launches"] == freeze["ecl_quant_launches"]
            == want_launches):
        raise AssertionError(f"ecl_quant launches: the launcher "
                             f"{launcher['ecl_quant_launches']}, the freeze "
                             f"{freeze['ecl_quant_launches']}, want "
                             f"{want_launches}")
    gc.collect()
    torch.cuda.empty_cache()
    stages.mark("gated freeze and its timings")
    mrope = _mrope_gates(dev, cfg, s + new)
    stages.mark("M-RoPE gates")

    # patch embeddings from the seed, prefilled, then greedy decode by id
    g = torch.Generator(device=dev).manual_seed(run_cfg["seed"])
    embeds = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
    with _AttnRecorder() as rec:
        run = _lm_direct(dev, cfg, frozen, None, new, embeds=embeds)
    if not bool(torch.isfinite(run["logits"]).all()):
        raise AssertionError("non-finite logits")
    if not (_on_card(frozen) and _on_card(run["cache"])):
        raise AssertionError("a frozen leaf or the cache left the card")
    slots = run["cache"]["dense"]["attn"]["k"].shape[2]
    kv_token = serve._cache_bytes(run["cache"], "attn") // b // slots
    want_kv = cfg.n_layers * 2 * cfg.n_kv * cfg.resolved_head_dim * 4
    if kv_token != want_kv:
        raise AssertionError(f"KV cache {kv_token} B a token a sequence, "
                             f"expected {want_kv}")
    stages.mark("prefill and decode")
    steps_rel = _gqa_steps_vs_sequence(
        cfg, _layer0(frozen["stacks"]["dense"]["attn"]), rec.x, new)
    del rec
    if steps_rel > VLM_STEPS_REL:
        raise AssertionError(f"layer 0's decode steps off its sequence by "
                             f"{steps_rel} relative")
    stages.mark("layer 0 steps vs sequence")

    cache = run["cache"]
    step_tok = torch.from_numpy(run["tokens"][:, -1:]).to(dev)
    step_pos = torch.full((b, 1), s + new - 1, dtype=torch.int32, device=dev)

    def decode_step():
        with torch.no_grad():
            return T.lm_apply(frozen, 0, step_tok, FP32_CTX, cfg,
                              positions=step_pos, cache=cache)

    trace, _ = _step_trace(decode_step, dev, SSM_TIMED_STEPS, traced=1)
    timing = {k: run[k] for k in ("prefill_ms", "decode_ms",
                                  "prefill_peak_bytes", "decode_peak_bytes")}
    tokens_0 = run["tokens"][0].tolist()
    del run, cache
    gc.collect()
    torch.cuda.empty_cache()
    stages.mark("traced decode step")

    # at 2 x 1,024: the cached decode against a no-cache forward over the
    # prompt's embeddings and the generated tokens' (the table's rows)
    short = run_cfg["short_prompt_len"]
    head = embeds[:, :short].contiguous()
    del embeds
    run = _lm_direct(dev, cfg, frozen, None, new, embeds=head)
    fed = torch.from_numpy(run["tokens"][:, :-1]).to(dev)
    with torch.no_grad():
        seq = torch.cat([head, frozen["embed"]["table"][fed]], dim=1)
        full, _, _ = T.lm_apply(frozen, 0, None, FP32_CTX, cfg, embeds=seq)
        no_cache = full[:, short - 1:, :cfg.vocab].clone()
    del full, seq
    stack_rel = _rel(run["logits"], no_cache)
    del run, no_cache, head, frozen
    gc.collect()
    torch.cuda.empty_cache()
    if stack_rel > VLM_STACK_REL:
        raise AssertionError(f"cached decode logits off a no-cache forward "
                             f"by {stack_rel} relative")
    stages.mark("cached vs no-cache at 1,024")
    smoke = _moe_smoke_card_vs_cpu(dev, VLM_ARCH)
    stages.mark("smoke card vs CPU")

    out = {"arch": VLM_ARCH, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv": cfg.n_kv,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab, "padded_vocab": cfg.padded_vocab,
           "mrope_sections": list(cfg.mrope_sections), "reduced": "none",
           "sequences": b, "prompt_len": s, "prompt": "patch embeddings",
           "max_new": new, "start_device_bytes": start_bytes,
           "launcher": launcher, "freeze": freeze, "ecl_quant": ecl_row,
           "mrope": mrope, "prefill_ms": timing["prefill_ms"],
           "decode_ms_per_step": timing["decode_ms"],
           "prefill_peak_device_bytes": timing["prefill_peak_bytes"],
           "decode_peak_device_bytes": timing["decode_peak_bytes"],
           "decode_step_trace": trace, "kv_bytes_per_token_sequence": kv_token,
           "layer0_steps_vs_sequence_max_rel": steps_rel,
           "cached_vs_no_cache_logits_max_rel": stack_rel,
           "cached_vs_no_cache_prompt_len": short,
           "smoke_card_vs_cpu": smoke, "tokens_0": tokens_0,
           "stage_s": stages.seconds, "wall_s": time.perf_counter() - t_arch}
    gb = 1e-9
    print(f"phase 13: {VLM_ARCH} frozen in {freeze['ms']:.1f} ms "
          f"({freeze['ecl_quant_launches']} ecl_quant launches, "
          f"{freeze['segments']} segments, {freeze['quant_weights']:,} "
          f"elements; ECL device {ecl_row['device_ms']:.2f} ms "
          f"[{ecl_row['device_ms_from']}] against a "
          f"{ecl_row['bound_ms']:.3f} ms byte bound, "
          f"{ecl_row['codes_only_bound_ms']:.3f} codes-only), peak "
          f"{freeze['peak_device_bytes'] * gb:.1f} GB; M-RoPE == RoPE bitwise "
          f"to position {s + new - 1} ({gpu})")
    print(f"phase 13: {VLM_ARCH} prefill of {b} x {s} patch embeddings "
          f"{timing['prefill_ms']:.1f} ms (peak "
          f"{timing['prefill_peak_bytes'] * gb:.1f} GB), decode "
          f"{timing['decode_ms']:.2f} ms/step (CUDA events; host clock "
          f"{trace['wall_ms_per_step']:.2f}), device "
          f"{trace['device_ms_per_step']:.2f} ms/step, "
          f"{trace['device_ops_per_step']:.0f} device ops, idle "
          f"{trace['device_idle_share']:.3f}; KV {kv_token:,} B a token a "
          f"sequence; layer 0 steps vs sequence {steps_rel:.2e}, cached vs "
          f"no-cache at {short} {stack_rel:.2e}, smoke card vs CPU "
          f"{smoke['max_abs_logit_err']:.2e}; stages (s) "
          f"{ {k: round(v, 1) for k, v in stages.seconds.items()} } ({gpu})")
    return out


def _whisper_serve_run(dev, cfg, frozen, frames, prompt, new):
    """The reference's serving bodies on a frozen whisper tree: its
    prefill (``whisper_encode``, ``precompute_cross``, ``init_dec_cache``
    of ``MAX_TGT`` slots, ``whisper_decode`` of the ``prompt`` ids), then
    ``new - 1`` cached greedy decode steps; fp32 compute and cache.
    Returns the greedy picks (B, new), each step's last logits (B, new,
    vocab), the cache and the cross K/V; on the card also encode, cross,
    prompt and decode-step ms (CUDA events) and the peak device memory."""
    import torch
    from repro_torch.models import whisper as W
    from repro_torch.nn.module import FP32_CTX

    b, s = prompt.shape
    on_card = dev.type == "cuda"
    clock = [torch.cuda.Event(enable_timing=True) for _ in range(5)] \
        if on_card else None

    def mark(i):
        if on_card:
            clock[i].record()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        mark(0)
        enc = W.whisper_encode(frozen, 0, frames, FP32_CTX, cfg)
        mark(1)
        cross = W.precompute_cross(frozen, 0, enc, FP32_CTX, cfg)
        mark(2)
        del enc
        cache = W.init_dec_cache(cfg, b, W.MAX_TGT, dtype=torch.float32,
                                 device=dev)
        logits, cache = W.whisper_decode(frozen, 0, prompt, cross, FP32_CTX,
                                         cfg, cache=cache)
        mark(3)
        steps = [logits[:, -1, :cfg.vocab]]
        toks = [torch.argmax(steps[-1], dim=-1)]
        for t in range(new - 1):
            p_t = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
            logits, cache = W.whisper_decode(frozen, 0, toks[-1][:, None],
                                             cross, FP32_CTX, cfg,
                                             positions=p_t, cache=cache)
            steps.append(logits[:, -1, :cfg.vocab])
            toks.append(torch.argmax(steps[-1], dim=-1))
        mark(4)
    out = {"tokens": torch.stack(toks, dim=1).cpu().numpy(),
           "logits": torch.stack(steps, dim=1), "cache": cache,
           "cross": cross}
    if on_card:
        torch.cuda.synchronize(dev)
        ms = [clock[i].elapsed_time(clock[i + 1]) for i in range(4)]
        out.update(encode_ms=ms[0], cross_ms=ms[1], prompt_ms=ms[2],
                   decode_ms=ms[3] / max(new - 1, 1),
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
    return out


def _whisper_smoke_card_vs_cpu(dev):
    """whisper-base's smoke config from one CPU init, frozen on each
    device, then the same utterances served (:func:`_whisper_serve_run`):
    tokens equal, logits within SMOKE_TOL."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import qat
    from repro_torch.models import whisper as W

    cfg = get_config(AUDIO_ARCH).smoke()
    rng = np.random.default_rng(AUDIO_SERVE["seed"])
    frames = rng.standard_normal((2, cfg.enc_len, cfg.d_model),
                                 dtype=np.float32)
    prompt = rng.integers(0, cfg.vocab, (2, len(AUDIO_PROMPT)))
    params = W.whisper_init(cfg, seed=AUDIO_SERVE["seed"], device="cpu")
    runs = []
    for where in (dev, torch.device("cpu")):
        p = tree.map_(lambda t: t.to(where), params)
        frozen = qat.freeze_tree(p, qat.build_qstate(p), cfg.lam)
        runs.append(_whisper_serve_run(
            where, cfg, frozen, torch.from_numpy(frames).to(where),
            torch.from_numpy(prompt).to(where), 8))
    card, cpu = runs
    got, want = card["logits"].cpu(), cpu["logits"]
    err = float((got - want).abs().max())
    if not np.array_equal(card["tokens"], cpu["tokens"]) or \
            not torch.allclose(got, want, atol=SMOKE_TOL, rtol=SMOKE_TOL):
        raise AssertionError(f"{cfg.name}: card tokens {card['tokens']} vs "
                             f"CPU {cpu['tokens']}, logits off by {err}")
    return {"tokens_equal": True, "max_abs_logit_err": err}


def _audio_freeze(dev, cfg, seed):
    """Phase 13's whisper freeze (:func:`_gated_freeze`): both stacks'
    leaves; codes of encoder layer 0's q and of the last decoder layer's
    cross v checked."""
    from repro_torch.models import whisper as W
    checks = [(None, ("enc_layers", "attn", "q", "kernel"), (0,)),
              (None, ("dec_layers", "cross", "v", "kernel"),
               (cfg.n_layers - 1,))]
    want = cfg.n_enc_layers * AUDIO_LEAVES[0] + cfg.n_layers * AUDIO_LEAVES[1]
    return _gated_freeze(dev, cfg, seed, want,
                         "q, k, v, o, fc1, fc2 an encoder layer; and cross "
                         "q, k, v, o a decoder layer", checks,
                         init=W.whisper_init)


def _audio_serve(dev, gpu):
    """Phase 13, whisper-base: the gated freeze, then 8 utterances of
    1,500 stubbed frames served in the reference's prefill and decode
    bodies (the start-of-transcript prompt, 124 greedy tokens)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.models import whisper as W
    from repro_torch.nn.module import FP32_CTX

    t_arch = time.perf_counter()
    stages = _Stages()
    start_bytes = _empty_card(dev, f"phase 13 ({AUDIO_ARCH})")
    cfg = get_config(AUDIO_ARCH)
    b, new = AUDIO_SERVE["utterances"], AUDIO_SERVE["max_new"]
    frozen, freeze, ecl_row = _audio_freeze(dev, cfg, AUDIO_SERVE["seed"])
    segments = cfg.n_enc_layers * AUDIO_LEAVES[0] \
        + cfg.n_layers * AUDIO_LEAVES[1]
    if freeze["ecl_quant_launches"] != -(-segments // eq.MAX_SEGMENTS):
        raise AssertionError(f"{freeze['ecl_quant_launches']} ecl_quant "
                             f"launches for {segments} segments")
    stages.mark("gated freeze and its timings")

    g = torch.Generator(device=dev).manual_seed(AUDIO_SERVE["seed"])
    frames = torch.randn((b, cfg.enc_len, cfg.d_model), generator=g,
                         device=dev)
    prompt = torch.tensor([AUDIO_PROMPT] * b, dtype=torch.int64).to(dev)
    s = prompt.shape[1]
    run = _whisper_serve_run(dev, cfg, frozen, frames, prompt, new)
    if not bool(torch.isfinite(run["logits"]).all()):
        raise AssertionError("non-finite logits")
    if not (_on_card(frozen) and _on_card(run["cache"])
            and _on_card(run["cross"])):
        raise AssertionError("a frozen leaf, the cache or the cross K/V "
                             "left the card")
    cross_bytes = sum(t.numel() * t.element_size() for t in run["cross"]) // b
    want_cross = cfg.n_layers * 2 * cfg.enc_len * cfg.n_kv \
        * cfg.resolved_head_dim * 4
    if cross_bytes != want_cross:
        raise AssertionError(f"cross K/V {cross_bytes} B a sequence, "
                             f"expected {want_cross}")
    stages.mark("encode, cross, prompt and decode")

    # the cached decode against a no-cache decode of the same prefix
    fed = torch.cat([prompt, torch.from_numpy(run["tokens"][:, :-1]).to(dev)],
                    dim=1)
    with torch.no_grad():
        full, none = W.whisper_decode(frozen, 0, fed, run["cross"], FP32_CTX,
                                      cfg)
    stack_rel = _rel(run["logits"], full[:, s - 1:, :cfg.vocab])
    del full
    if none is not None or stack_rel > AUDIO_STACK_REL:
        raise AssertionError(f"cached decoder logits off a no-cache decode "
                             f"by {stack_rel} relative")
    stages.mark("cached vs no-cache")

    cache, cross = run["cache"], run["cross"]
    step_tok = torch.from_numpy(run["tokens"][:, -1:]).to(dev)
    step_pos = torch.full((b, 1), s + new - 1, dtype=torch.int32, device=dev)

    def decode_step():
        with torch.no_grad():
            return W.whisper_decode(frozen, 0, step_tok, cross, FP32_CTX,
                                    cfg, positions=step_pos, cache=cache)

    trace, _ = _step_trace(decode_step, dev, SSM_TIMED_STEPS, traced=1)
    timing = {k: run[k] for k in ("encode_ms", "cross_ms", "prompt_ms",
                                  "decode_ms", "peak_bytes")}
    tokens_0 = run["tokens"][0].tolist()
    del run, cache, cross, frozen, frames
    gc.collect()
    torch.cuda.empty_cache()
    stages.mark("traced decode step")
    smoke = _whisper_smoke_card_vs_cpu(dev)
    stages.mark("smoke card vs CPU")

    out = {"arch": AUDIO_ARCH, "family": cfg.family,
           "enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab, "padded_vocab": cfg.padded_vocab,
           "enc_len": cfg.enc_len, "max_tgt": W.MAX_TGT, "reduced": "none",
           "utterances": b, "prompt": list(AUDIO_PROMPT), "max_new": new,
           "start_device_bytes": start_bytes, "freeze": freeze,
           "ecl_quant": ecl_row, "encode_ms": timing["encode_ms"],
           "cross_ms": timing["cross_ms"], "prompt_ms": timing["prompt_ms"],
           "decode_ms_per_step": timing["decode_ms"],
           "peak_device_bytes": timing["peak_bytes"],
           "decode_step_trace": trace, "cross_bytes_per_sequence": cross_bytes,
           "cached_vs_no_cache_logits_max_rel": stack_rel,
           "smoke_card_vs_cpu": smoke, "tokens_0": tokens_0,
           "stage_s": stages.seconds, "wall_s": time.perf_counter() - t_arch}
    gb = 1e-9
    print(f"phase 13: {AUDIO_ARCH} frozen in {freeze['ms']:.1f} ms "
          f"({freeze['ecl_quant_launches']} ecl_quant launches, "
          f"{freeze['segments']} segments, {freeze['quant_weights']:,} "
          f"elements; ECL device {ecl_row['device_ms']:.3f} ms "
          f"[{ecl_row['device_ms_from']}] against a "
          f"{ecl_row['bound_ms']:.4f} ms byte bound); {b} utterances x "
          f"{cfg.enc_len} frames: encode {timing['encode_ms']:.1f} ms, cross "
          f"K/V {timing['cross_ms']:.2f} ms ({cross_bytes:,} B a sequence), "
          f"prompt {timing['prompt_ms']:.2f} ms, decode "
          f"{timing['decode_ms']:.2f} ms/step (CUDA events; host clock "
          f"{trace['wall_ms_per_step']:.2f}), device "
          f"{trace['device_ms_per_step']:.2f} ms/step, "
          f"{trace['device_ops_per_step']:.0f} device ops, idle "
          f"{trace['device_idle_share']:.3f}; peak "
          f"{timing['peak_bytes'] * gb:.2f} GB; cached vs no-cache "
          f"{stack_rel:.2e}, smoke card vs CPU "
          f"{smoke['max_abs_logit_err']:.2e}; stages (s) "
          f"{ {k: round(v, 1) for k, v in stages.seconds.items()} } ({gpu})")
    return out


def vlm_audio_serve_path(dev, gpu):
    """Phase 13: qwen2-vl-2b and whisper-base at their published widths
    and depths, frozen to 4 bits on the card and served: the vlm from
    patch embeddings through ``lm_apply(embeds=)``, whisper through the
    reference's prefill and decode bodies."""
    t_phase = time.perf_counter()
    out = {VLM_ARCH: _vlm_serve(dev, gpu), AUDIO_ARCH: _audio_serve(dev, gpu)}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 13: done in {out['wall_s']:.1f} s ({gpu})")
    return out


# ------------------------------------------------------ phases 12 and 14

TRAIN_RUNS = {   # each arch's run at published widths, and its smoke run
    "mamba2-1.3b": dict(phase="12", batch=2, seq=2048, steps=4,
                        smoke_seq=20, remat_depth=4, layers=4),
    "hymba-1.5b": dict(phase="12", batch=1, seq=2048, steps=3, smoke_seq=20,
                       layers=4),
    VLM_ARCH: dict(phase="14", batch=1, seq=2048, steps=3, smoke_seq=12,
                   remat_depth=2, layers=4),
    AUDIO_ARCH: dict(phase="14", batch=8, seq=448, steps=10, smoke_seq=8)}
# remat_depth: the arch cut to it (widths kept) for a whole step under
# full held to none's; an SSD smoke seq of 20 leaves a ragged chunk;
# layers: the run's depth, cut for the script's time limit (widths kept)
TRAIN_ALL = dict(seed=0, lr=1e-3, lam=0.05, lam_ramp=50, remat="full",
                 prompts=2, prompt_len=16, max_new=8, smoke_batch=2)
TRAIN_CARD_CPU_FWD = 1e-5    # smoke: the loss, card vs CPU
TRAIN_CARD_CPU_GRAD = 1e-4   # smoke: the picked gradients, card vs CPU


def _train_leaves(cfg):
    """What phases 12 and 14 hold of ``cfg``'s tree: the quantized
    segments it must have, the smoke gradients [(name, path from the
    root)] and the ECL picks [(path, index)], the first layer's and the
    last layer's."""
    last = (cfg.n_layers - 1,)
    if cfg.family in ("ssm", "hybrid"):
        ssm = ("stacks", cfg.family, "ssm")
        inp = ssm + ("in_proj", "kernel")
        grads = [("in_proj_w", inp + ("w",)),
                 ("in_proj_omega", inp + ("omega",)),
                 ("conv_w", ssm + ("conv_w",)), ("A_log", ssm + ("A_log",)),
                 ("dt_bias", ssm + ("dt_bias",))]
        picks = [(inp, (0,)), (ssm + ("out_proj", "kernel"), last)]
        segments = cfg.n_layers * SSM_LEAVES[cfg.family]
    elif cfg.family == "vlm":
        q = ("stacks", "dense", "attn", "q")
        down = ("stacks", "dense", "mlp", "down", "kernel")
        grads = [("q_w", q + ("kernel", "w")),
                 ("q_omega", q + ("kernel", "omega")),
                 ("q_bias", q + ("bias",)), ("down_w", down + ("w",)),
                 ("embed", ("embed", "table"))]
        picks = [(q + ("kernel",), (0,)), (down, last)]
        segments = cfg.n_layers * VLM_LEAVES
    else:
        q = ("enc_layers", "attn", "q", "kernel")
        cv = ("dec_layers", "cross", "v", "kernel")
        grads = [("enc_q_w", q + ("w",)), ("enc_q_omega", q + ("omega",)),
                 ("cross_v_w", cv + ("w",)),
                 ("dec_fc1_bias", ("dec_layers", "mlp", "fc1", "bias")),
                 ("dec_pos", ("dec_pos",))]
        picks = [(q, (0,)), (cv, last)]
        segments = cfg.n_enc_layers * AUDIO_LEAVES[0] \
            + cfg.n_layers * AUDIO_LEAVES[1]
    return segments, grads, picks


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _train_smoke_checks(dev, arch):
    """At ``arch``'s smoke width on the card: one fp32 loss and the picked
    gradients equal the CPU's from the same init; and the launcher
    resumes bitwise under ``--remat full``."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import qat
    from repro_torch.data import pipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as T

    seq = TRAIN_RUNS[arch]["smoke_seq"]
    cfg = dataclasses.replace(get_config(arch).smoke(), lam=TRAIN_ALL["lam"])
    if cfg.family in ("ssm", "hybrid") and seq % cfg.ssm_chunk == 0:
        raise AssertionError("the smoke check wants a ragged last chunk")
    params = T.lm_init(cfg, seed=TRAIN_ALL["seed"], device="cpu")
    batch = T.lm_batch_fn(cfg, batch=TRAIN_ALL["smoke_batch"], seq=seq)(0)
    loss_fn = steps_mod._loss_fn(cfg, dtype=torch.float32)
    _, picked, _ = _train_leaves(cfg)
    runs = []
    for where in (dev, torch.device("cpu")):
        p = tree.map_(lambda t: t.to(where).detach().requires_grad_()
                      if t.is_floating_point() else t.to(where), params)
        loss, _ = loss_fn(p, qat.build_qstate(p),
                          pipeline.place(batch, device=where), cfg.lam)
        grads = torch.autograd.grad(loss, [_at(p, path)
                                           for _, path in picked])
        runs.append((float(loss.detach()), [g.cpu() for g in grads]))
    (lc, gc), (lh, gh) = runs
    fwd_rel = abs(lc - lh) / abs(lh)
    grad_rel = {name: _rel(a, b) for (name, _), a, b in zip(picked, gc, gh)}
    if fwd_rel > TRAIN_CARD_CPU_FWD or \
            max(grad_rel.values()) > TRAIN_CARD_CPU_GRAD:
        raise AssertionError(f"{arch} smoke card vs CPU: loss {fwd_rel}, "
                             f"gradients {grad_rel}")
    return {"card_vs_cpu_loss_rel": fwd_rel,
            "card_vs_cpu_grad_max_rel": grad_rel, "loss_card": lc,
            "loss_cpu": lh,
            "launcher_resume": _launcher_resume(arch, seq, "full")}


def _train_grads(dev, cfg, state, batch, lam, remat):
    """The loss at λ ``lam`` and every gradient from ``state`` under
    ``remat``, once: the loss, a digest of the gradients, whether all are
    finite, the ecl_quant launches, and the peak device memory after the
    forward and after the backward."""
    import torch
    from repro_torch import tree
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import steps as steps_mod

    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in tree.leaves(state["params"])]
    params = tree.unflatten(state["params"], leaves)
    wants = [t for t in leaves if t.requires_grad]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = eq.LAUNCHES
    loss, _ = steps_mod._loss_fn(cfg, remat=remat)(params, state["qstate"],
                                                   batch, lam)
    peak_fwd = torch.cuda.max_memory_allocated(dev)
    grads = torch.autograd.grad(loss, wants)
    peak_bwd = torch.cuda.max_memory_allocated(dev)
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    out = {"loss": loss.detach(), "launches": eq.LAUNCHES - before,
           "digest": _digest(list(grads)), "gradients": len(grads),
           "finite": bool(finite), "peak_forward_bytes": peak_fwd,
           "peak_backward_bytes": peak_bwd}
    del grads, leaves, params, wants
    return out


def _train_serve_check(dev, cfg, frozen, served):
    """The same greedy tokens from the exported tree ``served`` and from
    ``frozen`` (``freeze_tree``'s): token prompts through ``lm_apply``, or
    for whisper frames and prompts through its serving bodies; returns the
    export's tokens of sequence 0."""
    import numpy as np
    import torch
    rng = np.random.default_rng(TRAIN_ALL["seed"])
    b, new = TRAIN_ALL["prompts"], TRAIN_ALL["max_new"]
    prompts = rng.integers(0, cfg.vocab, (b, TRAIN_ALL["prompt_len"]))
    if cfg.family == "audio":
        frames = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_len, cfg.d_model), dtype=np.float32)).to(dev)
        prompt = torch.from_numpy(prompts[:, :len(AUDIO_PROMPT)]).to(dev)
        runs = [_whisper_serve_run(dev, cfg, t, frames, prompt, new)
                for t in (served, frozen)]
    else:
        runs = [_lm_direct(dev, cfg, t, prompts, new)
                for t in (served, frozen)]
    if not (np.array_equal(runs[0]["tokens"], runs[1]["tokens"])
            and bool(torch.isfinite(runs[0]["logits"]).all())):
        raise AssertionError(f"{cfg.name}: the export's tokens != "
                             "freeze_tree's")
    return runs[0]["tokens"][0].tolist()


def _train_one(dev, gpu, arch):
    """Phase 12 or 14 for one arch: EC4T-train at published widths (the
    depth ``TRAIN_RUNS``' ``layers`` where it names one) through the
    launcher's functions, export; then the gates from the last step's
    input state."""
    import dataclasses
    import gc
    import tempfile
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint.manager import (_paths, export_quantized,
                                                frozen_tree, load_quantized)
    from repro_torch.core import ecl, qat
    from repro_torch.data import pipeline
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import train as T
    from repro_torch.optim import ec4t, schedule
    from repro_torch.runtime.fault import FaultTolerantLoop

    t_arch = time.perf_counter()
    stages = _Stages()
    run_cfg = {**TRAIN_ALL, **TRAIN_RUNS[arch]}
    phase = run_cfg["phase"]
    start_bytes = _empty_card(dev, f"phase {phase} ({arch})")
    cfg = _cut_depth(T.lm_config(arch, lam=run_cfg["lam"]),
                     run_cfg.get("layers"))
    steps, remat = run_cfg["steps"], run_cfg["remat"]
    want_segments, _, pick_paths = _train_leaves(cfg)
    smoke = _train_smoke_checks(dev, arch)

    def step_fn_for(c, r):
        return T.lm_step_fn(c, steps=steps, lr=run_cfg["lr"],
                            lam=run_cfg["lam"],
                            lam_ramp=run_cfg["lam_ramp"], remat=r)
    step_fn = step_fn_for(cfg, remat)
    batch_fn = T.lm_batch_fn(cfg, batch=run_cfg["batch"], seq=run_cfg["seq"])
    remat_check, depth = None, run_cfg.get("remat_depth")
    if depth is not None:
        # a whole step under none and under full from one state at full
        # width, cut in depth (mamba2's full depth does not fit under none)
        cut = dataclasses.replace(cfg, n_layers=depth)
        st = ec4t.init_train_state(T.lm_init(cut, seed=run_cfg["seed"],
                                             device=dev))
        b0 = pipeline.place(batch_fn(0), device=dev)
        news = {r: step_fn_for(cut, r)(st, b0) for r in ("none", "full")}
        if not (torch.equal(_digest(news["none"][0]),
                            _digest(news["full"][0]))
                and float(news["none"][1]["loss"])
                == float(news["full"][1]["loss"])):
            raise AssertionError(f"{arch} at depth {depth}: a step under "
                                 "remat full != under none")
        remat_check = {"depth": depth, "loss": float(news["none"][1]["loss"]),
                       "whole_step_bitwise": True}
        del st, b0, news
        gc.collect()
        torch.cuda.empty_cache()

    state = ec4t.init_train_state(T.lm_init(cfg, seed=run_cfg["seed"],
                                            device=dev))
    params_n = sum(t.numel() for t in tree.leaves(state["params"])
                   if t.is_floating_point())
    nodes = list(qat._quant_leaves(state["params"], state["qstate"]))
    segments = sum(n["omega"][..., 0].numel() for n, _ in nodes)
    elements = sum(n["w"].numel() for n, _ in nodes)
    per_pass = -(-segments // eq.MAX_SEGMENTS)
    if segments != want_segments:
        raise AssertionError(f"{segments} ECL segments, expected "
                             f"{want_segments}")
    order = qat._map_quant_many(lambda ns, qs: list(range(len(ns))),
                                state["params"], state["qstate"],
                                keep_params=True)
    picks = [(_at(order, path), idx) for path, idx in pick_paths]
    checked_calls = (0, ECL_PASSES_PER_STEP * steps - 2)
    del order, nodes
    # one grouped pass timed on the initial state (its work does not
    # depend on the values), before the main path's counters are zeroed
    ecl_row = _share_ecl_pass(dev, state["params"], state["qstate"], cfg.lam,
                              segments, per_pass)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree.leaves(state))

    history, kept = [], {"calls": 0}

    def step_keeping_the_last_input(st, batch):
        kept["calls"] += 1
        if kept["calls"] == steps:
            kept.update(state=st, batch=batch)
        return step_fn(st, batch)
    loop = FaultTolerantLoop(
        step_keeping_the_last_input, _Discard(), ckpt_every=steps + 1,
        metrics_every=1, on_metrics=lambda s, m: history.append(
            {"step": s, **{k: float(v) for k, v in m.items()}}))
    stages.mark("smoke checks, the remat check, the ECL pass timed")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        export_dir = os.path.join(tmp, "export")
        # the main path: counters zeroed just before, read just after
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eq.LAUNCHES = 0
        t0 = time.perf_counter()
        with _EclRecorder(ecl, eq, checked_calls, None, picks=picks,
                          check=_plain_pair) as rec:
            feed = pipeline.ShardedFeed(batch_fn, start_step=0, device=dev)
            held = [state]
            del state
            try:
                state, last, reason = loop.run(held.pop(), feed,
                                               start_step=0,
                                               total_steps=steps)
            finally:
                feed.close()
            torch.cuda.synchronize(dev)
            train_s = time.perf_counter() - t0
            step_launches = eq.LAUNCHES
            t0 = time.perf_counter()
            report = export_quantized(export_dir, state["params"],
                                      state["qstate"], cfg.lam)
            export_ms = (time.perf_counter() - t0) * 1e3
        export_launches = eq.LAUNCHES - step_launches
        peak_train = torch.cuda.max_memory_allocated(dev)
        if (reason, last) != ("done", steps) or "state" not in kept:
            raise AssertionError(f"the loop ended {reason} at {last}")
        losses = [h["loss"] for h in history]
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"{arch} losses {losses}")
        per_call, checked = _share_ecl_gates(
            rec, per_pass, segments, steps, step_launches, export_launches,
            checked_calls)
        del rec
        frozen = qat.freeze_tree(state["params"], state["qstate"], cfg.lam)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        stages.mark("main path: steps and export")

        # from the last step's input: the loss and the backward twice
        s_last, b_last = kept.pop("state"), kept.pop("batch")
        lam_last = schedule.lambda_ramp(s_last["opt"]["step"],
                                        lam=run_cfg["lam"],
                                        ramp_steps=run_cfg["lam_ramp"])
        runs = [_train_grads(dev, cfg, s_last, b_last, lam_last, remat)
                for _ in range(2)]
        if not (all(r["finite"] for r in runs)
                and torch.equal(runs[0]["digest"], runs[1]["digest"])
                and torch.equal(runs[0]["loss"], runs[1]["loss"])
                and all(r["launches"] == per_pass for r in runs)
                and float(runs[0]["loss"]) == losses[-1]):
            raise AssertionError(
                f"{arch}: the backward twice: finite "
                f"{[r['finite'] for r in runs]}, launches "
                f"{[r['launches'] for r in runs]}, losses "
                f"{[float(r['loss']) for r in runs]} (step {steps}: "
                f"{losses[-1]})")
        grads = {k: runs[0][k] for k in ("gradients", "peak_forward_bytes",
                                         "peak_backward_bytes")}
        del runs
        gc.collect()
        torch.cuda.empty_cache()
        stages.mark("backward twice")

        holder = [s_last]
        del s_last
        trace = _lm_train_trace(dev, step_fn, holder, b_last, timed=2,
                                traced=1)
        del holder, b_last
        gc.collect()
        torch.cuda.empty_cache()
        if trace["host_syncs_per_step"]:
            raise AssertionError(f"host synchronisations inside a step: "
                                 f"{trace['host_syncs_per_step']}")
        ssd_times = None
        if cfg.family in ("ssm", "hybrid"):
            ssd_times = _ssd_block_times(dev, cfg, run_cfg["batch"],
                                         run_cfg["seq"])
        stages.mark("traced steps")

        # the export loaded back == freeze_tree, and served alike; last,
        # on a card holding only the frozen tree: decoding a leaf's
        # Huffman stream on the card takes tens of bytes a code
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loaded = load_quantized(export_dir, device=dev)
        load_ms = (time.perf_counter() - t0) * 1e3
        load_peak = torch.cuda.max_memory_allocated(dev)
        served = frozen_tree(loaded, device=dev)
        del loaded
        want, got = dict(_paths(frozen)), dict(_paths(served))
        if sorted(want) != sorted(got) or not all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                for k in want):
            raise AssertionError(f"{arch}: the loaded export != "
                                 "freeze_tree's tree")
        del want, got
        served_tokens = _train_serve_check(dev, cfg, frozen, served)
        export_bytes = os.path.getsize(os.path.join(export_dir,
                                                    "export.npz"))
        del served, frozen
        stages.mark("export loaded and served")

    adam_bound = ADAM_BYTES_PER_PARAM * params_n / PEAK_BYTES * 1e3
    pass_bound = ecl_row["bound_ms"]
    out = {**run_cfg, "arch": arch, "family": cfg.family,
           "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "compute_dtype": "bfloat16", "reduced": "none",
           "params": params_n, "quant_weights": elements,
           "ecl_segments": segments, "state_bytes": state_bytes,
           "start_device_bytes": start_bytes, "losses": losses,
           "train_wall_s": train_s, "ecl_quant_launches": step_launches,
           "ecl_quant_launches_export": export_launches,
           "ecl_quant_launches_per_pass": per_pass,
           "ecl_quant_passes": len(per_call), "ecl_segments_checked": checked,
           "backward_twice_bitwise": True, "gradients_finite": True,
           "grads": grads, "remat_none_vs_full": remat_check,
           **trace, "ecl_quant_bound_ms_per_pass": pass_bound,
           "ecl_quant_bound_ms_per_step": ECL_PASSES_PER_STEP * pass_bound,
           "ecl_quant_pass": ecl_row, "adam_bound_ms": adam_bound,
           "ssd_block": ssd_times, "peak_device_memory_bytes": peak_train,
           "export_bytes": export_bytes,
           "export_compressed_bytes": report["compressed_bytes"],
           "export_compression_ratio": report["compression_ratio"],
           "export_ms": export_ms, "export_load_ms": load_ms,
           "export_load_peak_device_bytes": load_peak,
           "served_tokens_0": served_tokens, "smoke": smoke,
           "stage_s": stages.seconds, "wall_s": time.perf_counter() - t_arch}
    gb = 1e-9
    st = trace["peak_device_memory_bytes_by_stage"]
    print(f"phase {phase}: {arch} EC4T-trained {steps} steps at batch "
          f"{run_cfg['batch']} x seq {run_cfg['seq']} (bf16, remat {remat},"
          f" {cfg.n_layers} layers, {params_n / 1e9:.4f} B parameters): "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {step_launches} "
          f"ecl_quant launches ({per_pass} a pass, {segments} segments, "
          f"{elements:,} elements) + {export_launches} in the export; the "
          f"backward twice bitwise, {grads['gradients']} gradients finite"
          + (f"; a whole step under full == none at depth {depth}"
             if remat_check else "")
          + f"; export == freeze_tree, tokens equal ({gpu})")
    print(f"phase {phase}: {arch} {trace['ms_per_step']:.1f} ms/step, device "
          f"{trace['device_ms_per_step']:.1f} ms/step, idle "
          f"{trace['device_idle_share']:.3f}, "
          f"{trace['device_ops_per_step']:.0f} device ops; ECL pass "
          f"{ecl_row['device_ms']:.3f} ms ({ecl_row['device_ms_from']}) "
          f"against {pass_bound:.4f} (bytes); adam.apply "
          f"{_ms(trace['adam_apply_device_ms_per_step'])} ms against "
          f"{adam_bound:.2f}; FakeQuantGroup.backward "
          f"{_ms(trace['fake_quant_backward_device_ms_per_step'])} ms; "
          f"update_qstate {_ms(trace['update_qstate_device_ms_per_step'])} "
          "ms"
          + (f"; SSD block forward {ssd_times['forward_device_ms']:.2f} ms, "
             f"backward {ssd_times['backward_device_ms']:.2f} ms a layer"
             if ssd_times else "") + f" ({gpu})")
    print(f"phase {phase}: {arch} peak memory: main path "
          f"{peak_train * gb:.1f} GB; in a step forward "
          f"{st.get('forward', 0) * gb:.1f}, backward "
          f"{st.get('backward', 0) * gb:.1f}, adam {st.get('adam', 0) * gb:.1f}"
          f", update {st.get('update_qstate', 0) * gb:.1f}; export "
          f"{export_bytes * gb:.4f} GB ({report['compression_ratio']:.2f}x) "
          f"in {export_ms:.0f} ms, loaded in {load_ms:.0f} ms (peak "
          f"{load_peak * gb:.1f} GB); stages (s) "
          f"{ {k: round(v, 1) for k, v in stages.seconds.items()} }; smoke card "
          f"vs CPU loss {smoke['card_vs_cpu_loss_rel']:.2e}, gradients "
          f"{max(smoke['card_vs_cpu_grad_max_rel'].values()):.2e}, launcher "
          f"resume bitwise; {out['wall_s']:.1f} s ({gpu})")
    return out


def ssm_train_path(dev, gpu):
    """Phase 12: EC4T-train mamba2-1.3b (2 x 2,048) and hymba-1.5b (1 x
    2,048) at published widths, depths cut, in bf16 under remat full,
    through the launcher's functions."""
    t_phase = time.perf_counter()
    out = {arch: _train_one(dev, gpu, arch) for arch in SSM_ARCHS}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 12: done in {out['wall_s']:.1f} s ({gpu})")
    return out


def vlm_audio_train_path(dev, gpu):
    """Phase 14: EC4T-train qwen2-vl-2b (1 x 2,048 patch embeddings) and
    whisper-base (8 x (1,500 frames, 448 tokens)) at published widths
    (qwen2-vl's depth cut) in bf16, through the launcher's functions."""
    t_phase = time.perf_counter()
    out = {arch: _train_one(dev, gpu, arch) for arch in (VLM_ARCH,
                                                         AUDIO_ARCH)}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 14: done in {out['wall_s']:.1f} s ({gpu})")
    return out


# ------------------------------------------------------------ phase 15

SCALE_OUT = dict(world=4, meshes=((1, 4), (2, 2)), rows=(1, 3, 8, 64, 256),
                 iters=5, seed=150, timeout=900)
SCALE_OUT_LABEL = "4 ranks sharing one H100 over gloo"
SCALE_OUT_MLPS = ("mlp-gsc", "mlp-hr", "lenet-300-100")
# grok-1-314b at published widths, depth 1; the vocabulary cut as phase 8
# cuts it (time: phase 19 serves the whole vocabulary)
SCALE_OUT_MOE = dict(arch="grok-1-314b", layers=1, vocab=32768, prompts=4,
                     prompt_len=16, max_new=4, seed=0, mesh=(1, 4))
SCALE_OUT_MOE_REL = 1e-4   # logits, EP ranks vs the single process
SCALE_OUT_TP = dict(experts=2, tokens=24, seed=151, mesh=(1, 4))
SCALE_OUT_TP_TOL = 1e-5    # moe_apply_tp vs moe_apply, fp32


def _scale_out_mlps(dev, pool):
    """(a): the paper MLPs column-sharded over the ranks, each call gated
    in its rank against the unsharded chain kernel (bitwise) and the
    plain oracle (fp32 gate / int8 relative)."""
    import numpy as np
    from repro_torch.configs.paper_mlps import MLPS
    from repro_torch.convert import tree_to_numpy
    from repro_torch.core import qat
    from repro_torch.launch import ranks
    from repro_torch.models import mlp as M
    from repro_torch.serving import plans

    out, launches = {}, 0
    for i, arch in enumerate(SCALE_OUT_MLPS):
        cfg = MLPS[arch]
        params, bn = M.mlp_init(cfg, seed=SCALE_OUT["seed"] + i, device=dev)
        pack = M.freeze_mlp(params, qat.build_qstate(params), bn,
                            lam=cfg.lam)
        layers = tree_to_numpy(pack["layers"])   # what a rank is handed
        n_layers = len(layers)
        xs = [_x(r, cfg.d_in, SCALE_OUT["seed"] + r)
              for r in SCALE_OUT["rows"]]
        for act in ("float32", "int8"):
            scales = None
            if act == "int8":
                scales = plans.calibrate_act_scales(
                    pack, xs[-1])["act_scales"]
            res = pool.run(ranks.sharded_mlp, layers, xs,
                           SCALE_OUT["meshes"], act_dtype=act,
                           act_scales=scales, iters=SCALE_OUT["iters"])
            for mi, mesh in enumerate(SCALE_OUT["meshes"]):
                key = f"{arch} {act} mesh {mesh[0]}x{mesh[1]}"
                desc = res[0][mi]["describe"]
                rows = {}
                for ci, r in enumerate(SCALE_OUT["rows"]):
                    calls = [per[mi]["calls"][ci] for per in res]
                    tag = f"{key} rows {r}"
                    for rank, c in enumerate(calls):
                        if not c["bitwise"]:
                            raise AssertionError(
                                f"{tag} rank {rank}: the sharded logits "
                                "differ from the unsharded chain kernel")
                        if c["launches"] != n_layers:
                            raise AssertionError(
                                f"{tag} rank {rank}: {c['launches']} "
                                f"matmul_kernel launches, want {n_layers}")
                        if not np.array_equal(c["y"], calls[0]["y"]):
                            raise AssertionError(f"{tag}: ranks disagree")
                    y, plain = calls[0]["y"], calls[0]["plain"]
                    if act == "int8":
                        err = float(np.abs(y - plain).max()
                                    / np.abs(plain).max())
                        if not err < INT8_REL:
                            raise AssertionError(f"{tag}: int8 relative "
                                                 f"error {err}")
                    else:
                        err = float(np.abs(y - plain).max())
                        np.testing.assert_allclose(
                            y, plain, atol=FP32_ATOL, rtol=FP32_RTOL,
                            err_msg=tag)
                    launches += sum(c["launches"] for c in calls)
                    local = r // mesh[0] if r % mesh[0] == 0 else r
                    rows[str(r)] = {
                        "launches_per_rank": [c["launches"] for c in calls],
                        "bitwise": True, "max_err_vs_plain": err,
                        "ms_per_rank": [c["ms"] for c in calls],
                        "gathered_bytes_per_layer": [
                            b * local for b in desc["gathered_bytes_per_row"]]}
                out[key] = {"col_sharded_layers": desc["col_sharded_layers"],
                            "replicated_layers": desc["replicated_layers"],
                            "collectives": desc["collectives"], "rows": rows}
    return out, launches


def _scale_out_moe_cfg():
    """grok-1-314b at published widths, cut to depth 1 and the vocabulary
    SCALE_OUT_MOE gives, at capacity factor E / k (nothing drops)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(SCALE_OUT_MOE["arch"])
    return dataclasses.replace(cfg, n_layers=SCALE_OUT_MOE["layers"],
                               vocab=SCALE_OUT_MOE["vocab"],
                               capacity_factor=cfg.n_experts / cfg.top_k)


def _scale_out_single(dev, cfg, prompt):
    """(b)'s single-process path, run before any rank: the whole layer
    (every expert, each drawn from a generator of its own as the ranks
    draw theirs) frozen on the card, its greedy tokens and a no-cache
    forward's logits over prompt + tokens."""
    import torch
    from repro_torch.core import qat
    from repro_torch.models import lm as LM
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX

    torch.zeros((), device=dev)     # the allocator is live before its reset
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.lm_init(cfg, seed=SCALE_OUT_MOE["seed"], device=dev)
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    del params
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(prompt).to(dev)
    gen = LM.generate(frozen, 0, tokens, FP32_CTX, cfg,
                      max_new=SCALE_OUT_MOE["max_new"])
    full = torch.cat([tokens.to(torch.int32), gen], dim=1)
    logits = T.lm_apply(frozen, 0, full, FP32_CTX, cfg)[0][..., :cfg.vocab]
    out = (gen.cpu().numpy(), logits.cpu().numpy(),
           torch.cuda.max_memory_allocated(dev))
    del frozen, logits
    return out


def _scale_out_moe(dev, pool, single, cfg, prompt):
    """(b): the EP ranks' tokens and logits against the single path's."""
    import numpy as np
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import ranks
    gen, logits, single_peak = single
    res = pool.run(ranks.ep_serve, cfg, prompt, SCALE_OUT_MOE["max_new"],
                   SCALE_OUT_MOE["mesh"], seed=SCALE_OUT_MOE["seed"])
    per_rank = []
    for rank, r in enumerate(res):
        if not np.array_equal(r["tokens"], gen):
            raise AssertionError(f"EP rank {rank}: tokens {r['tokens']} "
                                 f"differ from the single process's {gen}")
        rel = float(np.abs(r["logits"] - logits).max()
                    / np.abs(logits).max())
        if not rel < SCALE_OUT_MOE_REL:
            raise AssertionError(f"EP rank {rank}: logits {rel} relative "
                                 "from the single process's")
        # q, k, v, o (its heads) and 3 banks of the rank's experts a
        # layer, in one grouped pass: MAX_SEGMENTS segments a launch
        segments = cfg.n_layers * (4 + 3 * r["experts_held"][1])
        if not (r["ecl_segments"] == segments and r["ecl_quant_launches"]
                == -(-segments // eq.MAX_SEGMENTS)):
            raise AssertionError(
                f"EP rank {rank}: {r['ecl_quant_launches']} ecl_quant "
                f"launches for {r['ecl_segments']} segments, want "
                f"{-(-segments // eq.MAX_SEGMENTS)} for {segments}")
        per_rank.append({"experts_held": r["experts_held"],
                         "ecl_quant_launches": r["ecl_quant_launches"],
                         "ecl_segments": r["ecl_segments"],
                         "logits_rel_err": rel, "aux": r["aux"],
                         "freeze_ms": r["ms"]["freeze"],
                         "generate_ms": r["ms"]["generate"],
                         "peak_gb": None if r["peak_bytes"] is None
                         else r["peak_bytes"] / 1e9})
    return {"tokens_equal": True, "tokens": gen.tolist(),
            "single_peak_gb": single_peak / 1e9, "ranks": per_rank}


def _scale_out_tp(dev, pool):
    """(c): moe_apply_tp at the smoke widths, 2 experts over 4 ranks,
    against moe_apply on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_tree_from_numpy, tree_to_numpy
    from repro_torch.launch import ranks
    from repro_torch.nn import moe
    from repro_torch.nn.module import FP32_CTX

    cfg = get_config(SCALE_OUT_MOE["arch"]).smoke()
    e = SCALE_OUT_TP["experts"]
    p = tree_to_numpy(moe.moe_init(
        torch.Generator().manual_seed(SCALE_OUT_TP["seed"]), cfg.d_model,
        cfg.d_ff, e, False))
    x = _x(SCALE_OUT_TP["tokens"], cfg.d_model, SCALE_OUT_TP["seed"])
    kw = dict(top_k=cfg.top_k, capacity_factor=e / cfg.top_k)
    want, want_aux = moe.moe_apply(lm_tree_from_numpy(p, device=dev), 0,
                                   torch.from_numpy(x).to(dev), FP32_CTX,
                                   **kw)
    res = pool.run(ranks.moe_layer, p, x, SCALE_OUT_TP["mesh"], path="ffn",
                   **kw)
    for rank, r in enumerate(res):
        if r["path"] != "tp":
            raise AssertionError(f"TP rank {rank}: moe_ffn chose {r['path']}")
        np.testing.assert_allclose(r["y"], want.cpu().numpy(),
                                   atol=SCALE_OUT_TP_TOL,
                                   rtol=SCALE_OUT_TP_TOL,
                                   err_msg=f"TP rank {rank}")
        np.testing.assert_allclose(r["aux"], float(want_aux),
                                   atol=SCALE_OUT_TP_TOL,
                                   rtol=SCALE_OUT_TP_TOL)
    return {"experts": e, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "mesh": list(SCALE_OUT_TP["mesh"]), "path": "tp",
            "max_abs_err": max(float(np.abs(r["y"] - want.cpu().numpy())
                                     .max()) for r in res),
            "published_widths": "not run: expert TP needs E % tp != 0 and "
            "ff % tp == 0, grok's 8 experts on a 16-wide model axis, 16 "
            "ranks' non-expert weights, more than one card holds"}


def scale_out_path(dev, gpu):
    """Phase 15: the serving half of scale-out over torch.distributed, 4
    gloo ranks sharing the card (staged through host buffers)."""
    import numpy as np
    import torch
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    _empty_card(dev, "phase 15")
    cfg = _scale_out_moe_cfg()
    prompt = np.random.default_rng(SCALE_OUT_MOE["seed"]).integers(
        0, cfg.vocab, (SCALE_OUT_MOE["prompts"], SCALE_OUT_MOE["prompt_len"]))
    t0 = time.perf_counter()
    single = _scale_out_single(dev, cfg, prompt)
    single_s = time.perf_counter() - t0
    _empty_card(dev, "phase 15's ranks")
    print(f"phase 15: grok-1-314b EP reference (one process, 8 experts) in "
          f"{single_s:.1f} s, peak {single[2] / 1e9:.2f} GB ({gpu})")
    t0 = time.perf_counter()
    with _rank_pool(SCALE_OUT["world"], SCALE_OUT["timeout"]) as pool:
        world = pool.run(M.describe_world)
        spawn_s = time.perf_counter() - t0
        mlps, launches = _scale_out_mlps(dev, pool)
        if launches < 1:
            raise AssertionError("phase 15: matmul_kernel never launched")
        t1 = time.perf_counter()
        moe_ep = _scale_out_moe(dev, pool, single, cfg, prompt)
        moe_ep["ranks_s"] = time.perf_counter() - t1
        tp = _scale_out_tp(dev, pool)
    out = {
        "label": SCALE_OUT_LABEL, "gpu": gpu, "world": world,
        "spawn_s": spawn_s, "matmul_kernel_launches": launches,
        "ecl_quant_launches": sum(r["ecl_quant_launches"]
                                  for r in moe_ep["ranks"]),
        "mlp": mlps,
        "moe_ep": {"arch": SCALE_OUT_MOE["arch"], "layers": cfg.n_layers,
                   "d_model": cfg.d_model, "d_ff": cfg.d_ff,
                   "n_experts": cfg.n_experts, "top_k": cfg.top_k,
                   "mesh": list(SCALE_OUT_MOE["mesh"]),
                   "reduced": {"n_layers": "64 -> 1",
                               "vocab": "131072 -> 32768 (time; phase 19 "
                               "serves the whole vocabulary)"},
                   "capacity_factor": cfg.capacity_factor,
                   "single_s": single_s, **moe_ep},
        "moe_tp": tp}
    out["wall_s"] = time.perf_counter() - t_phase
    for key, m in mlps.items():
        for rows in (SCALE_OUT["rows"][0], SCALE_OUT["rows"][-1]):
            r = m["rows"][str(rows)]
            print(f"phase 15: {key}: rows {rows}, "
                  f"{r['launches_per_rank'][0]} matmul_kernel launches a "
                  f"rank, ms a batch {[round(v, 3) for v in r['ms_per_rank']]}"
                  f" ({SCALE_OUT_LABEL}; {gpu})")
    print(f"phase 15: grok EP over {SCALE_OUT_MOE['mesh']}: tokens equal, "
          f"logits rel {max(r['logits_rel_err'] for r in moe_ep['ranks']):.2e}"
          f", ecl_quant {[r['ecl_quant_launches'] for r in moe_ep['ranks']]},"
          f" peak GB {[r['peak_gb'] for r in moe_ep['ranks']]}")
    print(f"phase 15: done in {out['wall_s']:.1f} s ({gpu})")
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 16

MESH_TRAIN = dict(arch="smollm-360m", layers=8, world=4,
                  meshes=((4, 1), (2, 2)), batch=8, seq=64, seed=0, lr=1e-3,
                  timed_steps=1, timed_mesh=(4, 1), timeout=900)
MESH_TRAIN_GRAD_REL = 1e-4   # mesh grads vs one process: of each leaf's max
MESH_TRAIN_PARAM_TOL = 5e-3  # tests/test_distributed_equivalence.py:70-74
MESH_TRAIN_LOSS_RTOL = 1e-4  # the same test's loss gate
MESH_TRAIN_MOE = dict(arch="grok-1-314b", tokens=24, seed=161, coef=0.01,
                      ep_meshes=((1, 4), (2, 2)),
                      tp_mesh=(1, 4), tp_experts=2)
MESH_TRAIN_MOE_TOL = 1e-5    # EP / TP objective and gradients vs one process
MESH_TRAIN_PP = dict(d=960, layers=32, batch=64, n_micro=(4, 8), seed=162,
                     iters=3)
MESH_TRAIN_PP_TOL = 1e-5     # forward: tests/test_pipeline_parallel.py:32;
#                              gradients: of the gradient's largest |value|


def _mesh_train_single(dev, cfg, batches, dps):
    """(a)'s single-process references on the card, run before any rank
    and freed after: the fp32 gradients at the initial state on batch 0,
    the loss and new params of one fp32 step (host numpy), and per data
    width ``dp`` the digests of one int8 step on the rows one data rank
    holds (``compress_grads(mesh=None)``)."""
    import torch
    from repro_torch.convert import tree_to_numpy
    from repro_torch.core import qat
    from repro_torch.launch import ranks
    from repro_torch.launch import steps as S
    from repro_torch.nn import transformer as T
    from repro_torch.optim import adam, ec4t
    from repro_torch.optim.grad_compress import GradCompressCfg

    params = T.lm_init(cfg, seed=MESH_TRAIN["seed"], device=dev)
    qstate = qat.build_qstate(params)
    loss_fn = S._loss_fn(cfg, dtype=torch.float32)

    def on_card(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    b0 = on_card(batches[0])
    _, grads = ec4t.local_grads(loss_fn, params, qstate, b0, cfg.lam)
    out = {"grads": tree_to_numpy(grads)}
    del grads
    step = ec4t.make_train_step(loss_fn, adam.AdamConfig(
        lr=MESH_TRAIN["lr"]), lam=cfg.lam)
    new, metrics = step(ec4t.init_train_state(params), b0)
    out.update(params=tree_to_numpy(new["params"]),
               loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]))
    del new
    out["int8"] = {}
    gcfg = GradCompressCfg()
    for dp in dps:
        local = on_card({k: v[:MESH_TRAIN["batch"] // dp]
                         for k, v in batches[0].items()})
        step = ec4t.make_train_step(loss_fn, adam.AdamConfig(
            lr=MESH_TRAIN["lr"]), lam=cfg.lam, compress=gcfg)
        new, _ = step(ec4t.init_train_state(params, gcfg), local)
        final = {"params": new["params"], "qstate": new["qstate"],
                 "opt": {"m": new["opt"]["m"], "v": new["opt"]["v"]},
                 "err": new["err"]}
        out["int8"][dp] = {n: ranks.digest(t)
                           for n, t in ranks.named_leaves(final)}
        del new, final
    del params, qstate
    torch.cuda.empty_cache()
    return out


def _leaf_errors(got, want, tol=None):
    """Over the leaves of ``got`` (numpy by leaf name) and ``want`` (a
    numpy tree): the largest |got - want|, and the largest of it over the
    leaf's max |want|; with ``tol`` raise where |got - want| > tol + tol ·
    |want| (``assert_allclose``'s test, in torch's threads)."""
    import torch
    from repro_torch.launch import ranks
    w = dict(ranks.named_leaves(want))
    if sorted(got) != sorted(w):
        raise AssertionError("the mesh's and the single process's leaves "
                             "differ")
    worst_abs = worst_rel = 0.0
    for name, g in got.items():
        a, b = torch.from_numpy(g), torch.from_numpy(w[name])
        diff = (a - b).abs()
        if tol is not None and bool((diff > tol + tol * b.abs()).any()):
            raise AssertionError(f"{name}: {float(diff.max())} past "
                                 f"atol=rtol={tol}")
        err = float(diff.max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(float(b.abs().max()), 1e-30))
    return worst_abs, worst_rel


def _mesh_train_dp(dev, pool, cfg, batches, single, gpu):
    """(a): SmolLM-360M data-parallel over each mesh, gated against the
    single process; the timed bf16 steps with ZeRO-1 off and on."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import ranks
    from repro_torch.optim.grad_compress import GradCompressCfg

    segments = 7 * cfg.n_layers
    per_step = ECL_PASSES_PER_STEP * -(-segments // eq.MAX_SEGMENTS)
    gcfg = GradCompressCfg()
    out, launches = {}, 0
    for mesh in MESH_TRAIN["meshes"]:
        key = f"mesh {mesh[0]}x{mesh[1]}"
        dp = mesh[0]
        timed = mesh == MESH_TRAIN["timed_mesh"]
        tiled = {k: np.concatenate([v[:MESH_TRAIN["batch"] // dp]] * dp)
                 for k, v in batches[0].items()}
        runs = [{"state": True, "steps": 1},
                {"compress": gcfg, "batches": [tiled]}]
        if timed:       # ZeRO-1 held bitwise over the timed bf16 steps
            runs += [{"dtype": torch.bfloat16, "zero1": zero1}
                     for zero1 in (False, True)]
        else:
            runs.append({"zero1": True, "steps": 1})
        tp = mesh[1] > 1
        if tp:
            # tensor-parallel ranks sum the single device's gradient in
            # another order: int8 on replicated rows is held to the round
            # trip of the mesh's own exact gradient, each leaf whole
            runs.append({"compress": gcfg, "batches": [tiled],
                         "int8_local": True})
        t0 = time.perf_counter()
        dumps = tempfile.mkdtemp(prefix="mesh_train_")
        try:
            res = pool.run(ranks.dp_train, cfg, mesh, batches,
                           seed=MESH_TRAIN["seed"], lr=MESH_TRAIN["lr"],
                           grads=True, compress_check=gcfg, runs=runs,
                           out_dir=dumps)
            ranks_s = time.perf_counter() - t0
            _, grad_rel = _leaf_errors(
                ranks.load_dump(os.path.join(dumps, "grads")),
                single["grads"])
            param_err, _ = _leaf_errors(
                ranks.load_dump(os.path.join(dumps, "run0")),
                single["params"], MESH_TRAIN_PARAM_TOL)
        finally:
            shutil.rmtree(dumps)
        if not grad_rel <= MESH_TRAIN_GRAD_REL:
            raise AssertionError(f"{key}: gradients {grad_rel} of a leaf's "
                                 "max from the single process's")
        zero1_of = (3, 2) if timed else (2, 0)   # (ZeRO-1 run, its twin)
        for rank, r in enumerate(res):
            tag = f"{key} rank {rank}"
            loss = r["runs"][0]["metrics"][0]["loss"]
            np.testing.assert_allclose(loss, single["loss"],
                                       rtol=MESH_TRAIN_LOSS_RTOL,
                                       err_msg=tag)
            if r["grad_digests"] != res[0]["grad_digests"]:
                raise AssertionError(f"{tag}: reduced gradients differ")
            for i, run in enumerate(r["runs"]):
                if run["digests"] != res[0]["runs"][i]["digests"]:
                    raise AssertionError(f"{tag}: run {i}'s replica differs "
                                         "from rank 0's (params, m, v or "
                                         "probs)")
            z, twin = (r["runs"][i] for i in zero1_of)
            if z["block_digests"] != twin["block_digests"] or \
                    z["digests"] != {k: v for k, v in twin["digests"].items()
                                     if k.split("/")[1] != "opt"}:
                raise AssertionError(f"{tag}: ZeRO-1 differs from the "
                                     "replicated step")
            if r["layout"] != ("tensor parallel" if tp else "replicated"):
                raise AssertionError(f"{tag}: layout {r['layout']}")
            int8_want = r["runs"][-1]["digests"] if tp else single["int8"][dp]
            if r["runs"][1]["digests"] != int8_want:
                raise AssertionError(f"{tag}: int8 on replicated rows "
                                     "differs from compress_grads(mesh=None)")
            if not r["int8_err_over_half_scale"] <= 1.0 + 1e-5:
                raise AssertionError(
                    f"{tag}: int8 {r['int8_err_over_half_scale']} half "
                    "scales from the exact mean")
            if r["int8_digests"] != res[0]["int8_digests"]:
                raise AssertionError(f"{tag}: int8 gradients differ")
            for run in r["runs"]:
                if run["ecl_launches"] != [per_step] * len(run["ms"]):
                    raise AssertionError(
                        f"{tag}: ecl_quant {run['ecl_launches']}, want "
                        f"{per_step} a step (2 passes of "
                        f"{-(-segments // eq.MAX_SEGMENTS)})")
                if not all(np.isfinite(m["loss"]) for m in run["metrics"]):
                    raise AssertionError(f"{tag}: a loss is not finite")
                launches += sum(run["ecl_launches"])
        out[key] = {
            "loss": res[0]["runs"][0]["metrics"][0]["loss"],
            "single_loss": single["loss"],
            "grad_norm": res[0]["runs"][0]["metrics"][0]["grad_norm"],
            "single_grad_norm": single["grad_norm"],
            "grad_rel_err": grad_rel, "param_max_abs_err": param_err,
            "replicas_bitwise": True, "zero1_bitwise": True,
            "int8_replicated_rows_bitwise": True,
            "int8_err_over_half_scale": max(
                r["int8_err_over_half_scale"] for r in res),
            "ecl_quant_launches_per_step_per_rank": per_step,
            "layout": res[0]["layout"],
            "reduced_bytes_per_step": {
                "fp32": res[0]["runs"][0]["reduced_bytes"],
                "int8": res[0]["runs"][1]["reduced_bytes"]},
            "model_allreduce_bytes_per_step": res[0]["runs"][0][
                "model_bytes"],
            "fp32_peak_gb_per_rank": [r["runs"][0]["peak_bytes"] / 1e9
                                      for r in res],
            "fp32_ms_per_step_per_rank": {
                "replicated": [r["runs"][0]["ms"][0] for r in res],
                "int8": [r["runs"][1]["ms"][0] for r in res]},
            "ranks_s": ranks_s, "rank0_s": {
                **res[0]["s"], "runs": [r["s"] for r in res[0]["runs"]]},
            "wall_s": time.perf_counter() - t0}
        line = (f"phase 16: smollm-360m {key} ({res[0]['layout']}): loss "
                f"{out[key]['loss']:.6f} (one process {single['loss']:.6f}),"
                f" grads {grad_rel:.2e} of max, params {param_err:.2e}; "
                f"replicas, ZeRO-1 and int8 on replicated rows bitwise; fp32"
                f" ms a step (rank 0) {res[0]['runs'][0]['ms'][0]:.1f}, int8"
                f" {res[0]['runs'][1]['ms'][0]:.1f}; fp32 peak "
                f"{out[key]['fp32_peak_gb_per_rank'][0]:.2f} GB a rank, "
                f"{out[key]['model_allreduce_bytes_per_step'][0]} B "
                f"all-reduced over 'model' a step")
        if timed:
            out[key].update({
                "bf16_ms_per_step_per_rank": {
                    name: [r["runs"][i]["ms"] for r in res]
                    for i, name in ((2, "replicated"), (3, "zero1"))},
                "bf16_loss": [m["loss"] for m in res[0]["runs"][2][
                    "metrics"]],
                "peak_gb_per_rank": {
                    name: [r["runs"][i]["peak_bytes"] / 1e9 for r in res]
                    for i, name in ((2, "replicated"), (3, "zero1"))}})
            ms, peak = (out[key][k] for k in ("bf16_ms_per_step_per_rank",
                                               "peak_gb_per_rank"))
            line += (f"; bf16 ms a step (rank 0) "
                     f"{[round(v, 1) for v in ms['replicated'][0]]}, ZeRO-1"
                     f" {[round(v, 1) for v in ms['zero1'][0]]}; peak GB "
                     f"{peak['replicated'][0]:.2f} / {peak['zero1'][0]:.2f}")
        print(f"{line}; {out[key]['wall_s']:.1f} s (the ranks "
              f"{ranks_s:.1f}: {json.dumps(out[key]['rank0_s'])}) "
              f"({MESH_TRAIN_LABEL}; {gpu})")
    return out, launches


MESH_TRAIN_LABEL = "4 ranks sharing one H100 over gloo"


def _mesh_train_moe_layer(dev, cfg, experts):
    """grok's smoke layer (``experts`` of them) from ``lm_init`` (each
    expert from a generator of its own), as numpy."""
    import dataclasses
    from repro_torch.convert import tree_to_numpy
    from repro_torch.nn import transformer as T
    cfg = dataclasses.replace(cfg, n_experts=experts, n_layers=1,
                              capacity_factor=experts / cfg.top_k)
    params = T.lm_init(cfg, seed=MESH_TRAIN_MOE["seed"], device=dev)
    layer = tree_to_numpy(params["stacks"]["moe"]["moe"])
    return cfg, {k: {kk: (vv[0] if not isinstance(vv, dict) else
                          {kkk: vvv[0] for kkk, vvv in vv.items()})
                     for kk, vv in v.items()} for k, v in layer.items()}


def _mesh_train_moe(dev, pool, gpu):
    """(b): grok's smoke layer through ``moe_ffn``'s exchanges under grad,
    against the same objective on one device."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import ranks
    base = get_config(MESH_TRAIN_MOE["arch"]).smoke()
    rng = np.random.default_rng(MESH_TRAIN_MOE["seed"])
    n = MESH_TRAIN_MOE["tokens"]
    x = rng.normal(size=(n, base.d_model)).astype(np.float32)
    r = rng.normal(size=(n, base.d_model)).astype(np.float32)
    cases = [("ep", m, share, base.n_experts)
             for m in MESH_TRAIN_MOE["ep_meshes"] for share in (False, True)]
    cases.append(("ffn", MESH_TRAIN_MOE["tp_mesh"], False,
                  MESH_TRAIN_MOE["tp_experts"]))
    out = {}
    for path, mesh, share, e in cases:
        cfg, p = _mesh_train_moe_layer(dev, base, e)
        kw = dict(top_k=cfg.top_k, gate=cfg.moe_gate,
                  capacity_factor=e / cfg.top_k,
                  routed_scaling=cfg.routed_scaling,
                  coef=MESH_TRAIN_MOE["coef"])
        res = pool.run(ranks.ep_train, p, x, r, mesh, path=path,
                       share=share, **kw)
        blocks = 4 if res[0]["path"] == "ep" else mesh[0]
        val, gx, gp = ranks.moe_single_grads(p, x, r, blocks=blocks,
                                             device=dev, **kw)
        flat = dict(ranks.named_leaves(gp))
        worst = 0.0
        key = f"{res[0]['path']} {mesh[0]}x{mesh[1]} " \
              f"{'shares' if share else 'whole banks'} ({e} experts)"
        for rank, rr in enumerate(res):
            if not rr["remat_bitwise"]:
                raise AssertionError(f"{key} rank {rank}: remat full "
                                     "differs from none")
            worst = max(worst, abs(rr["obj"] - val) / max(abs(val), 1.0),
                        float(np.abs(rr["grads"]["x"] - gx).max()))
            for name, g in ranks.named_leaves(rr["grads"]["p"]):
                want = flat[name]
                if rr["experts_held"] is not None \
                        and name.startswith("/experts/"):
                    first, count = rr["experts_held"]
                    want = want[first:first + count]
                worst = max(worst, float(np.abs(g - want).max()))
        if not worst <= MESH_TRAIN_MOE_TOL:
            raise AssertionError(f"{key}: {worst} from one process")
        out[key] = {"path": res[0]["path"], "mesh": list(mesh),
                    "experts": e, "shares": share, "max_err": worst,
                    "remat_full_bitwise": True}
        print(f"phase 16: grok smoke {key}: objective and every gradient "
              f"within {worst:.2e} of one process; remat full bitwise none")
    return out


def _mesh_train_pp(dev, pool, gpu):
    """(c): the tanh stack through ``pipeline_apply`` on a 4-stage 'pipe'
    mesh against the sequential stack on the card."""
    import numpy as np
    import torch
    from repro_torch.launch import ranks
    c = MESH_TRAIN_PP
    rng = np.random.default_rng(c["seed"])
    ws = (rng.normal(size=(c["layers"], c["d"], c["d"]))
          * c["d"] ** -0.5).astype(np.float32)
    x = rng.normal(size=(c["batch"], c["d"])).astype(np.float32)
    r = rng.normal(size=(c["batch"], c["d"])).astype(np.float32)
    wt = torch.from_numpy(ws).to(dev).requires_grad_()
    xt = torch.from_numpy(x).to(dev).requires_grad_()
    y = ranks._tanh_stack(wt, xt)
    gw, gx = torch.autograd.grad(torch.sum(y * torch.from_numpy(r).to(dev)),
                                 (wt, xt))
    y, gw, gx = (t.detach().cpu().numpy() for t in (y, gw, gx))
    seq_ms = _time_ms(lambda: ranks._tanh_stack(wt, xt), dev, c["iters"])
    res = pool.run(ranks.pp_apply, ws, x, r, n_micro=c["n_micro"],
                   iters=c["iters"])
    world = len(res)
    per = c["layers"] // world
    out = {"d": c["d"], "layers": c["layers"], "batch": c["batch"],
           "stages": world, "sequential_fwd_ms": seq_ms,
           "grad_scale": {"stage": float(np.abs(gw).max()),
                          "x": float(np.abs(gx).max())}, "runs": {}}
    scale = {"y": 1.0, "stage_grad": float(np.abs(gw).max()),
             "x_grad": float(np.abs(gx).max())}
    for i, m in enumerate(c["n_micro"]):
        err = {"y": 0.0, "stage_grad": 0.0, "x_grad": 0.0}
        for rank, rr in enumerate(res):
            got = rr[i]
            err["y"] = max(err["y"], float(np.abs(got["y"] - y).max()))
            err["stage_grad"] = max(err["stage_grad"], float(np.abs(
                got["stage_grad"] - gw[rank * per:(rank + 1) * per]).max()))
            err["x_grad"] = max(err["x_grad"],
                                float(np.abs(got["x_grad"] - gx).max()))
        rel = {k: v / scale[k] for k, v in err.items()}
        if not max(rel.values()) <= MESH_TRAIN_PP_TOL:
            raise AssertionError(f"pipeline n_micro {m}: {err} (of "
                                 f"{scale})")
        out["runs"][str(m)] = {
            "ticks": res[0][i]["ticks"], "bubble_fraction": res[0][i][
                "bubble"], "max_abs_err": err, "max_err_of_scale": rel,
            "ms_fwd_bwd_per_rank": [rr[i]["ms"] for rr in res]}
        print(f"phase 16: pipeline d {c['d']} L {c['layers']} over {world} "
              f"stages, n_micro {m}: {res[0][i]['ticks']} ticks, bubble "
              f"fraction {res[0][i]['bubble']:.4f}; forward and gradients "
              f"within {max(rel.values()):.2e} of the sequential stack's "
              f"(|y| <= 1, gradients of their largest); ms "
              f"a forward + backward {[round(rr[i]['ms'], 2) for rr in res]}"
              f" ({MESH_TRAIN_LABEL}; {gpu})")
    return out


def mesh_train_path(dev, gpu):
    """Phase 16: training over a mesh on torch.distributed, 4 gloo ranks
    sharing the card (staged through host buffers)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.train import lm_batch_fn

    t_phase = time.perf_counter()
    _empty_card(dev, "phase 16")
    cfg = _cut_depth(get_config(MESH_TRAIN["arch"]), MESH_TRAIN["layers"])
    batch_fn = lm_batch_fn(cfg, batch=MESH_TRAIN["batch"],
                           seq=MESH_TRAIN["seq"])
    batches = [batch_fn(i) for i in range(MESH_TRAIN["timed_steps"])]
    t0 = time.perf_counter()
    single = _mesh_train_single(dev, cfg, batches, sorted(
        {m[0] for m in MESH_TRAIN["meshes"] if m[1] == 1}))
    single_s = time.perf_counter() - t0
    _empty_card(dev, "phase 16's ranks")
    print(f"phase 16: smollm-360m single-process references in "
          f"{single_s:.1f} s ({gpu})")
    t0 = time.perf_counter()
    with _rank_pool(MESH_TRAIN["world"], MESH_TRAIN["timeout"]) as pool:
        world = pool.run(M.describe_world)
        spawn_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        dp, launches = _mesh_train_dp(dev, pool, cfg, batches, single, gpu)
        dp_s = time.perf_counter() - t1
        del single
        t1 = time.perf_counter()
        moe = _mesh_train_moe(dev, pool, gpu)
        moe_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        pp = _mesh_train_pp(dev, pool, gpu)
        pp_s = time.perf_counter() - t1
    print(f"phase 16: spawn {spawn_s:.1f} s, (a) {dp_s:.1f} s, (b) "
          f"{moe_s:.1f} s, (c) {pp_s:.1f} s")
    if launches < 1:
        raise AssertionError("phase 16: ecl_quant never launched")
    out = {"label": MESH_TRAIN_LABEL, "gpu": gpu, "world": world,
           "spawn_s": spawn_s, "single_s": single_s,
           "ecl_quant_launches": launches,
           "dp": {"arch": MESH_TRAIN["arch"], "layers": cfg.n_layers,
                  "d_model": cfg.d_model, "batch": MESH_TRAIN["batch"],
                  "seq": MESH_TRAIN["seq"],
                  "reduced": {"n_layers": f"32 -> {cfg.n_layers} (the "
                              "script's time limit, phase 19 added)"},
                  "meshes": dp, "s": dp_s},
           "moe": {"arch": MESH_TRAIN_MOE["arch"], "widths": "smoke",
                   "reduced": {"widths": "smoke (d 64, d_ff 128): four "
                               "ranks of grok's 2-expert training share "
                               "(58.8 GB each, phase 8) cannot share one "
                               "card"}, "cases": moe, "s": moe_s},
           "pipeline": {**pp, "s": pp_s}}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 16: done in {out['wall_s']:.1f} s ({gpu})")
    torch.cuda.empty_cache()
    return out


AUTOTUNE_ARCH = "mlp-gsc"
AUTOTUNE_SEED = 170
DRYRUN = dict(arch="smollm-360m", batch=8, seq=64, dp_mesh=(4, 1),
              grad_bytes=1_447_288_064)      # phase 16's bytes a step
# the package's own tuning (the sweep on the card), kept while phases
# 2-16 bind from the prior
_TUNING = {}


def set_tuning(mode):
    """Plans built after this call bind by the package's sweep
    (``"sweep"``, its own choice on the card) or from the prior
    (``"prior"``: phases 2-16, whose gates need the prior's bindings), by
    setting ``autotune.tuning`` as the tests do."""
    from repro_torch.kernels import autotune
    own = _TUNING.setdefault("sweep", autotune.tuning)
    autotune.tuning = own if mode == "sweep" else (lambda device: "prior")


@contextlib.contextmanager
def recorded_measures(calls):
    """Every measure the plans built inside make, appended to ``calls`` as
    (act dtype, rows, schedule or "block", block_m, seconds)."""
    from repro_torch.serving import plans as P
    sched_measure = P.ExecutionPlan._schedule_measure
    block_measure = P.ExecutionPlan._block_measure

    def rec_sched(plan, rows):
        m = sched_measure(plan, rows)

        def measure(s, bm):
            t = m(s, bm)
            calls.append((plan.act_dtype, rows, s, bm, t))
            return t
        return measure

    def rec_block(plan, rows):
        m = block_measure(plan, rows)

        def measure(c):
            t = m(c)
            calls.append((plan.act_dtype, rows, "block", c.block_m, t))
            return t
        return measure

    P.ExecutionPlan._schedule_measure = rec_sched
    P.ExecutionPlan._block_measure = rec_block
    try:
        yield calls
    finally:
        P.ExecutionPlan._schedule_measure = sched_measure
        P.ExecutionPlan._block_measure = block_measure


def _want_measures(plan, max_bucket):
    """The measure calls a cold build of ``plan`` makes: the block sweep's
    (when the batch-tiled stack fits) and every bucket's candidates."""
    from repro_torch.kernels import autotune as at
    want = sum(len(at.candidate_schedule_blocks(
        b, plan._eligible_schedules(b))) for b in plan.bucket_sizes)
    if plan.block_source == "sweep":
        want += len(at.candidate_blocks(max_bucket, plan.d_in, plan.d_out,
                                        fused=True))
    return want


def _sweep_plans(dev, gpu):
    """Phase 17 (a): ExecutionPlan's timed sweep on a fresh cache file."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.paper_mlps import MLPS
    from repro_torch.core import qat
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
    from repro_torch.kernels import fantastic4_matmul as fm
    from repro_torch.models import mlp as M
    from repro_torch.serving import plans as P

    cfg = MLPS[AUTOTUNE_ARCH]
    params, bn = M.mlp_init(cfg, seed=0, device=dev)
    pack = M.freeze_mlp(params, qat.build_qstate(params), bn, lam=cfg.lam)
    rng = np.random.default_rng(AUTOTUNE_SEED)
    calib_x = rng.normal(size=(64, cfg.d_in)).astype(np.float32)
    cache_dir = tempfile.mkdtemp(prefix="fantastic4_autotune_")
    cache_file = os.path.join(cache_dir, "autotune_torch.json")
    os.environ[at.ENV_CACHE] = cache_file
    at.clear_memory_cache()
    # every measure the plans make, and its seconds
    calls = []

    def build(act, mode):
        set_tuning(mode)
        return P.ExecutionPlan(pack, act_dtype=act, device=dev,
                               calib_x=calib_x if act == "int8" else None)

    def bindings(plan):
        return {b: (p.path, p.block_m, p.source)
                for b, p in plan.buckets.items()}

    out = {"arch": AUTOTUNE_ARCH, "cache_file": cache_file, "plans": {}}
    try:
        torch.cuda.synchronize(dev)
        fm.LAUNCHES = 0
        ffm.reset_launches()
        t0 = time.perf_counter()
        plans, warm = {}, {}
        for act in ("float32", "int8"):
            n0 = len(calls)
            with recorded_measures(calls):
                plans[act] = build(act, "sweep")
            plan = plans[act]
            want = _want_measures(plan, P.DEFAULT_MAX_BUCKET)
            made = len(calls) - n0
            if made != want:
                raise AssertionError(f"phase 17: {act} plan made {made} "
                                     f"measure calls for {want} candidates")
            if plan.block_source != "sweep":
                raise AssertionError(f"phase 17: {act} block_m from "
                                     f"{plan.block_source}")
            bad = {b: p.source for b, p in plan.buckets.items()
                   if p.path.startswith("fused") and p.source != "sweep"}
            if bad or not plan.buckets:
                raise AssertionError(f"phase 17: {act} buckets not swept: "
                                     f"{bad}")
            cross = at.get_ws_crossover(
                plan.d_in, plan.d_out, backend=plan._backend_key,
                act_dtype=act, stack=plan._stack_extra)
            if cross != plan.ws_crossover_rows:
                raise AssertionError(f"phase 17: {act} crossover "
                                     f"{cross} recorded, plan "
                                     f"{plan.ws_crossover_rows}")
        build_s = time.perf_counter() - t0
        # a warm build: a new process's view of the same file
        at.clear_memory_cache()
        n0 = len(calls)
        for act in ("float32", "int8"):
            with recorded_measures(calls):
                warm[act] = build(act, "sweep")
            if bindings(warm[act]) != bindings(plans[act]) or \
                    warm[act].block_m != plans[act].block_m:
                raise AssertionError(f"phase 17: warm {act} bindings "
                                     f"{bindings(warm[act])} != "
                                     f"{bindings(plans[act])}")
            if warm[act].ws_prior_source != "measured":
                raise AssertionError(f"phase 17: warm {act} prior from "
                                     f"{warm[act].ws_prior_source}")
        if len(calls) != n0:
            raise AssertionError(f"phase 17: the warm builds measured "
                                 f"{len(calls) - n0} times")
        # every bucket serves through its binding
        served = {}
        for act, plan in plans.items():
            for b in plan.bucket_sizes:
                x = torch.from_numpy(rng.normal(size=(b, cfg.d_in)).astype(
                    np.float32)).to(dev)
                served[(act, b)] = (x, plan.entry(b)(x))
        torch.cuda.synchronize(dev)
        launches = {"fantastic4_matmul": fm.LAUNCHES}
        for name, (sched, _) in KERNELS.items():
            if sched != "chain":
                launches[name] = ffm.LAUNCHES[sched]
        never = [n for n, c in launches.items()
                 if c == 0 and n != "fantastic4_matmul"]
        if never:
            raise AssertionError(f"phase 17: never launched {never}: "
                                 f"{launches}")
    finally:
        set_tuning("prior")

    # the checks: each bucket's output against the plain oracle, every
    # int8 candidate the sweep timed against the chain kernel
    fm.LAUNCHES = 0
    ffm.reset_launches()
    worst = {"float32": 0.0, "int8": 0.0}
    for act, plan in plans.items():
        oracle = P.ExecutionPlan(pack, act_dtype=act, mode="oracle",
                                 device=dev, calib={"act_scales":
                                                    plan.act_scales})
        chain = P.ExecutionPlan(pack, act_dtype=act, mode="per_layer",
                                device=dev, calib={"act_scales":
                                                   plan.act_scales})
        for b in plan.bucket_sizes:
            x, y = served[(act, b)]
            want = oracle.run(x)
            err = float((y - want).abs().max())
            if act == "float32":
                ok = bool(((y - want).abs() <= FP32_ATOL
                           + FP32_RTOL * want.abs()).all())
                worst[act] = max(worst[act], err)
            else:
                rel = err / max(float(want.abs().max()), 1e-6)
                ok = rel < INT8_REL
                worst[act] = max(worst[act], rel)
            if not ok or not torch.isfinite(y).all():
                raise AssertionError(f"phase 17: {act} bucket {b} "
                                     f"({plan.buckets[b].path}) err {err}")
            if act == "int8":
                ref = chain.run(x)
                for a, rows, s, bm, t in calls:
                    if a == act and rows == b and s != "block" \
                            and t != float("inf"):
                        got = plan._execute(x, P.PATH_BY_SCHEDULE[s],
                                            block_m=bm)
                        if not torch.equal(got, ref):
                            raise AssertionError(
                                f"phase 17: int8 {s} block_m {bm} at "
                                f"{b} rows != the chain bitwise")
    torch.cuda.synchronize(dev)
    check_launches = {"fantastic4_matmul": fm.LAUNCHES}
    for name, (sched, _) in KERNELS.items():
        if sched != "chain":
            check_launches[name] = ffm.LAUNCHES[sched]

    for act in ("float32", "int8"):
        plan = plans[act]
        prior = build(act, "prior")
        rows_out = {}
        for b in plan.bucket_sizes:
            cands = {f"{s}/{bm}": (None if t == float("inf") else t * 1e3)
                     for a, rows, s, bm, t in calls
                     if a == act and rows == b and s != "block"}
            bp, pp = plan.buckets[b], prior.buckets.get(b)
            rows_out[b] = {
                "sweep": f"{P.SCHEDULE_BY_PATH.get(bp.path, bp.path)}/"
                         f"{bp.block_m}",
                "prior": None if pp is None else
                f"{P.SCHEDULE_BY_PATH.get(pp.path, pp.path)}/{pp.block_m}",
                "queued_ms": cands}
            print(f"phase 17: {act} bucket {b}: prior {rows_out[b]['prior']}"
                  f", swept {rows_out[b]['sweep']}; queued ms "
                  + ", ".join(f"{k} {v:.5f}" if v is not None else
                              f"{k} no fit" for k, v in cands.items())
                  + f" ({gpu})")
        blocks = {str(bm): t * 1e3 for a, rows, s, bm, t in calls
                  if a == act and s == "block"}
        out["plans"][act] = {
            "block_m": plan.block_m, "prior_block_m": prior.block_m,
            "block_queued_ms": blocks, "buckets": rows_out,
            "ws_crossover_rows": plan.ws_crossover_rows,
            "describe": plan.describe()}
        print(f"phase 17: {act} block_m {plan.block_m} (prior "
              f"{prior.block_m}; queued ms at {P.DEFAULT_MAX_BUCKET} rows "
              f"{ {k: round(v, 5) for k, v in blocks.items()} }), ws "
              f"crossover {plan.ws_crossover_rows} rows")
    out.update(measure_calls=len(calls), build_s=build_s,
               launches=launches, check_launches=check_launches,
               max_abs_err=worst["float32"], int8_max_rel_err=worst["int8"],
               cache_entries=len(json.load(open(cache_file))))
    print(f"phase 17 (a): {len(calls)} measures in {build_s:.1f} s, warm "
          f"builds none; launches {launches}; fp32 max abs err "
          f"{worst['float32']:.3g}, int8 rel {worst['int8']:.3g}, int8 "
          f"candidates bitwise the chain ({gpu})")
    return out


def _sweep_lm_ffn(dev, gpu):
    """Phase 17 (c): SmolLM-360M's FFN plans as ``LMProgram`` builds them
    (``serving/lm.py`` ``_plan_kw``), with the package's sweep on."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import fantastic4_fused_mlp as ffm
    from repro_torch.kernels import fantastic4_matmul as fm
    from repro_torch.models.mlp import freeze_dense_layer
    from repro_torch.serving import plans as P

    cfg = get_config(LM["arch"])
    d, f = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(AUTOTUNE_SEED + 1)

    def layer(k, n):
        codes = torch.from_numpy(rng.integers(0, 16, (k, n)).astype(
            np.uint8)).to(dev)
        omega = torch.from_numpy((rng.normal(size=4) / np.sqrt(k)).astype(
            np.float32)).to(dev)
        return freeze_dense_layer(codes, omega, activation=None)

    # gate and up share a shape, so up's plan is a hit of gate's sweep
    packs = {name: {"layers": [layer(*shape)], "name": f"blk0.{name}"}
             for name, shape in (("gate", (d, f)), ("up", (d, f)),
                                 ("down", (f, d)))}
    kw = dict(mode="auto", act_dtype="float32", max_bucket=LM["max_bucket"],
              block_m=None, device=dev)

    def bindings(plan):
        return {b: (p.path, p.block_m, p.source)
                for b, p in plan.buckets.items()}

    calls, plans, made = [], {}, {}
    set_tuning("sweep")
    try:
        torch.cuda.synchronize(dev)
        fm.LAUNCHES = 0
        ffm.reset_launches()
        t0 = time.perf_counter()
        for name, pack in packs.items():
            n0 = len(calls)
            with recorded_measures(calls):
                plans[name] = P.build_plan(pack, **kw)
            made[name] = len(calls) - n0
        build_s = time.perf_counter() - t0
        want = {"gate": _want_measures(plans["gate"], LM["max_bucket"]),
                "up": 0,
                "down": _want_measures(plans["down"], LM["max_bucket"])}
        if made != want:
            raise AssertionError(f"phase 17: SmolLM FFN plans made {made} "
                                 f"measure calls for {want}")
        for name, plan in plans.items():
            bad = {b: p.source for b, p in plan.buckets.items()
                   if not p.path.startswith("fused") or p.source != "sweep"}
            if bad or plan.tuning != "sweep":
                raise AssertionError(f"phase 17: SmolLM {name} buckets not "
                                     f"swept: {bad} ({plan.tuning})")
        at.clear_memory_cache()
        n0 = len(calls)
        for name, pack in packs.items():
            with recorded_measures(calls):
                warm = P.build_plan(pack, **kw)
            if bindings(warm) != bindings(plans[name]):
                raise AssertionError(f"phase 17: warm SmolLM {name} "
                                     f"bindings {bindings(warm)} != "
                                     f"{bindings(plans[name])}")
        if len(calls) != n0:
            raise AssertionError(f"phase 17: the warm SmolLM builds "
                                 f"measured {len(calls) - n0} times")
        served = {}
        for name, plan in plans.items():
            for b in plan.bucket_sizes:
                x = torch.from_numpy(rng.normal(size=(b, plan.d_in)).astype(
                    np.float32)).to(dev)
                served[(name, b)] = (x, plan.run(x))
        torch.cuda.synchronize(dev)
        launches = {"fantastic4_matmul": fm.LAUNCHES}
        for kname, (sched, _) in KERNELS.items():
            if sched != "chain":
                launches[kname] = ffm.LAUNCHES[sched]
    finally:
        set_tuning("prior")
    worst, out = 0.0, {"arch": LM["arch"], "max_bucket": LM["max_bucket"],
                       "plans": {}}
    for name, plan in plans.items():
        oracle = P.build_plan(packs[name], mode="oracle", device=dev)
        prior = P.build_plan(packs[name], **kw)
        rows_out = {}
        for b in plan.bucket_sizes:
            x, y = served[(name, b)]
            want_y = oracle.run(x)
            if not torch.isfinite(y).all() or not bool(
                    ((y - want_y).abs() <= FP32_ATOL
                     + FP32_RTOL * want_y.abs()).all()):
                raise AssertionError(
                    f"phase 17: SmolLM {name} bucket {b} "
                    f"({plan.buckets[b].path}) err "
                    f"{float((y - want_y).abs().max())}")
            worst = max(worst, float((y - want_y).abs().max()))
            bp, pp = plan.buckets[b], prior.buckets[b]
            rows_out[b] = {
                "sweep": f"{P.SCHEDULE_BY_PATH.get(bp.path, bp.path)}/"
                         f"{bp.block_m}",
                "prior": f"{P.SCHEDULE_BY_PATH.get(pp.path, pp.path)}/"
                         f"{pp.block_m}"}
        out["plans"][name] = {"shape": [plan.d_in, plan.d_out],
                              "block_m": plan.block_m,
                              "block_source": plan.block_source,
                              "measure_calls": made[name],
                              "buckets": rows_out}
    # the candidates' queued ms of the two swept shapes, in sweep order
    i = 0
    for name in ("gate", "down"):
        mine = calls[i:i + made[name]]
        i += made[name]
        for b in plans[name].bucket_sizes:
            cands = {f"{s}/{bm}": (None if t == float("inf") else t * 1e3)
                     for _, rows, s, bm, t in mine
                     if rows == b and s != "block"}
            out["plans"][name]["buckets"][b]["queued_ms"] = cands
            r = out["plans"][name]["buckets"][b]
            print(f"phase 17: SmolLM {name} {plans[name].d_in}x"
                  f"{plans[name].d_out} bucket {b}: prior {r['prior']}, "
                  f"swept {r['sweep']}; queued ms "
                  + ", ".join(f"{k} {v:.5f}" if v is not None else
                              f"{k} no fit" for k, v in cands.items())
                  + f" ({gpu})")
    out.update(measure_calls=len(calls), build_s=build_s,
               launches=launches, max_abs_err=worst)
    print(f"phase 17 (c): SmolLM-360M FFN plans: {len(calls)} measures in "
          f"{build_s:.1f} s, warm builds none; launches {launches}; fp32 "
          f"max abs err {worst:.3g} ({gpu})")
    return out


def _dryrun_counts(dev, gpu):
    """Phase 17 (b): the dry run's counts on meta against the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.nn import transformer as T

    cfg = get_config(DRYRUN["arch"])
    b, s = DRYRUN["batch"], DRYRUN["seq"]
    out = {"arch": DRYRUN["arch"], "batch": b, "seq": s}
    t0 = time.perf_counter()
    bundle = S.build_train_step(cfg, ShapeMesh((1, 1)), remat="none",
                                zero1=False, dtype=torch.bfloat16)

    def meta_batch(rows):
        return {k: torch.empty((rows, s), dtype=torch.int32, device="meta")
                for k in ("tokens", "labels")}
    meta = op_analysis.analyze(bundle.fn, bundle.args[0], meta_batch(b))
    del meta["out"]
    meta_s = time.perf_counter() - t0
    _empty_card(dev, "phase 17 (b)")
    rng = np.random.default_rng(DRYRUN.get("seed", 0))
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32)).to(dev) for k in ("tokens", "labels")}
    state = bundle.init_state(T.lm_init(cfg, seed=0, device=dev))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eq.LAUNCHES = 0
    real = op_analysis.analyze(bundle.fn, state, batch)
    loss = float(real["out"][1]["loss"])
    torch.cuda.synchronize(dev)
    launches = eq.LAUNCHES
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    del real["out"], state
    for key in ("flops", "bytes", "ops"):
        if meta[key] != real[key]:
            raise AssertionError(f"phase 17: {key} on meta {meta[key]} != "
                                 f"on the card {real[key]}")
    # each ECL pass groups the step's quantized matrices, MAX_SEGMENTS a
    # launch: 2 x ceil(32 blocks x 7 / 32) = 14 at published widths
    want = ECL_PASSES_PER_STEP * -(-cfg.n_layers * len(LM_LEAVES)
                                   // eq.MAX_SEGMENTS)
    if not np.isfinite(loss) or launches != want or not (
            real["kernels"] == meta["kernels"] == {"ecl_quant": want}):
        raise AssertionError(f"phase 17: loss {loss}, ecl_quant launched "
                             f"{launches} times for {want}, reported "
                             f"{real['kernels']} on the card, "
                             f"{meta['kernels']} on meta")
    out["step"] = {"flops": meta["flops"], "bytes": meta["bytes"],
                   "ops": meta["ops"], "ecl_quant_launches": launches,
                   "kernels_reported_meta": meta["kernels"],
                   "peak_live_bytes_meta": meta["peak_bytes"],
                   "peak_live_bytes_card": real["peak_bytes"],
                   "max_memory_allocated_minus_state": peak,
                   "argument_bytes": meta["argument_bytes"], "loss": loss,
                   "meta_s": meta_s, "card_s": real_s}
    print(f"phase 17: {DRYRUN['arch']} {b} x {s} bf16 step: {meta['flops']:.6g}"
          f" FLOPs, {meta['bytes']:.6g} B, {meta['ops']} operations on meta "
          f"and on the card alike; ecl_quant launched {launches} times "
          f"(LAUNCHES); peak live {meta['peak_bytes']} B (meta), "
          f"{real['peak_bytes']} B (card) beside max_memory_allocated "
          f"{peak} B above the state ({gpu})")
    _empty_card(dev, "phase 17 (b) dp")
    mesh = ShapeMesh(DRYRUN["dp_mesh"])
    dp = S.build_train_step(cfg, mesh, remat="none", zero1=False,
                            dtype=torch.float32)
    rows = b // mesh.axis_size(mesh.data_axes)
    counted = op_analysis.analyze(dp.fn, dp.args[0], meta_batch(rows))
    grad = max(n for k, _, n in mesh.calls if k == "all-reduce")
    if grad != DRYRUN["grad_bytes"]:
        raise AssertionError(f"phase 17: the gradient all-reduce moves "
                             f"{grad} B, phase 16 {DRYRUN['grad_bytes']}")
    out["dp"] = {"mesh": list(DRYRUN["dp_mesh"]), "gradient_bytes": grad,
                 "collectives": counted["collectives"]}
    print(f"phase 17: (4, 1) shape-only mesh: gradient all-reduce {grad} B "
          f"(phase 16: {DRYRUN['grad_bytes']}); all-reduce in all "
          f"{counted['collectives']['all-reduce']} B")
    cells = {}
    t0 = time.perf_counter()
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        rec = dryrun.run_cell(DRYRUN["arch"], shape, False)
        rec.pop("traceback", None)
        if rec["status"] not in ("OK", "SKIP") or (
                shape == "long_500k") != (rec["status"] == "SKIP"):
            raise AssertionError(f"phase 17: run_cell {shape}: {rec}")
        cells[shape] = rec
        print(f"phase 17: dryrun {json.dumps(rec)}")
    out["cells"] = cells
    out["cells_s"] = time.perf_counter() - t0
    return out


def autotune_path(dev, gpu):
    """Phase 17: the autotuner's sweep and the dry run."""
    import torch
    t0 = time.perf_counter()
    _empty_card(dev, "phase 17")
    out = {"sweep": _sweep_plans(dev, gpu)}
    try:
        out["lm_sweep"] = _sweep_lm_ffn(dev, gpu)
    finally:
        shutil.rmtree(os.path.dirname(out["sweep"]["cache_file"]),
                      ignore_errors=True)
    torch.cuda.empty_cache()
    out["dryrun"] = _dryrun_counts(dev, gpu)
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 17: done in {out['wall_s']:.1f} s ({gpu})")
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 18

TP = dict(arch="h2o-danube-1.8b", world=4, seed=0, serve_mesh=(1, 4),
          prompts=2, prompt_len=512, max_new=16, tail=8, serve_layers=12,
          train_layers=2,
          batch=8, seq=64, steps=2, lr=1e-3,
          train_meshes=((1, 4), (2, 2)), timeout=900)
TP_LOGIT_REL = LM_LOGIT_REL     # phase 5's gate, of the max |logit|
TP_LABEL = "4 ranks sharing one H100 over gloo"


def _tp_block(t, spec, r, tp):
    """Rank ``r``'s block of ``t`` over a (1, tp) mesh under ``spec``."""
    for d, axes in enumerate(spec):
        if axes is not None:
            n = t.shape[d] // tp
            t = t.narrow(d, r * n, n)
    return t


def _tp_single_frozen(dev, cfg, run):
    """The one-process reference's frozen tree: ``cfg``'s init with
    ``run["seed"]`` whole on the card (the peak counted from before it),
    frozen with its ecl_quant launches counted (zeroed just before, read
    just after), and the digests of each rank's blocks of it over
    ``run["serve_mesh"]``.  Returns (frozen, a record of those)."""
    import torch
    from repro_torch.core import qat
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.runtime.sharding import layout_specs
    from repro_torch.tree import map_

    torch.zeros((), device=dev)     # the allocator is live before its reset
    torch.cuda.reset_peak_memory_stats(dev)
    params = ranks.model_init(cfg)(cfg, seed=run["seed"], device=dev)
    qstate = qat.build_qstate(params)
    torch.cuda.synchronize(dev)
    eq.LAUNCHES = 0
    t0 = time.perf_counter()
    frozen = qat.freeze_tree(params, qstate, cfg.lam)
    torch.cuda.synchronize(dev)
    out = {"freeze_ms": (time.perf_counter() - t0) * 1e3,
           "freeze_launches": eq.LAUNCHES}
    del params, qstate
    tp = run["serve_mesh"][1]
    specs = layout_specs(frozen, cfg, MeshSpec(run["serve_mesh"],
                                               ("data", "model")))
    out["block_digests"] = [{n: ranks.digest(t) for n, t in ranks.named_leaves(
        map_(lambda t, sp: _tp_block(t, sp, r, tp), frozen, specs))}
        for r in range(tp)]
    return frozen, out


def _tp_rank_gates(phase, cfg, res, single, want_launches, logits_key):
    """The gates every tensor-parallel serve holds each rank to against one
    process: its frozen blocks bitwise the one process's blocks, its
    freeze's ecl_quant launches, its tokens equal, its ``logits_key``
    logits within TP_LOGIT_REL of the largest; returns (the largest
    logit error, that largest logit)."""
    import numpy as np
    scale = float(np.abs(single[logits_key]).max())
    worst = 0.0
    for rank, r in enumerate(res):
        tag = f"phase {phase}: {cfg.name} rank {rank}"
        i = r["coords"]["model"]
        if r["digests"] != single["block_digests"][i]:
            bad = [n for n in r["digests"]
                   if r["digests"][n] != single["block_digests"][i].get(n)]
            raise AssertionError(f"{tag}: frozen blocks differ from one "
                                 f"process's: {bad[:6]}")
        if r["freeze_launches"] != want_launches:
            raise AssertionError(f"{tag}: freeze launched ecl_quant "
                                 f"{r['freeze_launches']} times, want "
                                 f"{want_launches}")
        if not np.array_equal(r["tokens"], single["tokens"]):
            raise AssertionError(f"{tag}: tokens {r['tokens'].tolist()} != "
                                 f"{single['tokens'].tolist()}")
        err = float(np.abs(r[logits_key] - single[logits_key]).max())
        worst = max(worst, err)
        if not err <= TP_LOGIT_REL * scale:
            raise AssertionError(f"{tag}: logits {err} past "
                                 f"{TP_LOGIT_REL} of {scale}")
    return worst, scale


def _tp_serve_single(dev, cfg, prompt, run=TP, embeds=None):
    """(a)'s one-process reference, run before any rank and freed after:
    ``lm_init`` whole, frozen (its ecl_quant launches counted), the
    digests of each rank's blocks of the frozen tree, and the same
    greedy serve the ranks run (``ranks.serve_timed``, fp32, from the
    ``prompt`` tokens or a vlm's ``embeds``); ``run`` names the seed, the
    mesh and the serve's sizes."""
    import torch
    from repro_torch.launch import ranks
    from repro_torch.nn.module import FP32_CTX

    frozen, out = _tp_single_frozen(dev, cfg, run)
    on = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    served, cache = ranks.serve_timed(frozen, on(prompt), cfg, FP32_CTX,
                                      run["max_new"], run["tail"],
                                      embeds=on(embeds))
    out.update(served)
    del cache
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del frozen
    torch.cuda.empty_cache()
    return out


def _tp_serve(dev, pool, cfg, gpu, run=TP, phase="18", segments=None):
    """(a): ``cfg`` served over ``run["serve_mesh"]`` (phase 18:
    h2o-danube-1.8b at published widths and depth): each rank's freeze
    bitwise the one process's blocks in the launches its segments take
    (``segments``: a rank's and one process's, default 7 a layer both),
    tokens equal, logits within 1e-3, the KV cache a rank its share of
    one process's (a quarter with its KV heads cut, the whole of an MLA
    latent), the SSM state its heads' share (the conv tail whole), and
    for MLA the absorbed decode within 1e-4 of the naive form on each
    rank.  With ``run["embeds"]`` a vlm's prefill takes the stubbed
    frontend's patch embeddings (``launch.train.lm_batch_fn``)."""
    import numpy as np
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.runtime.sharding import model_tp

    prompt = embeds = None
    if run.get("embeds"):
        embeds = lm_batch_fn(cfg, batch=run["prompts"], seq=run[
            "prompt_len"])(run["seed"])["embeds"]
    else:
        prompt = np.random.default_rng(run["seed"] + 180).integers(
            0, cfg.vocab, (run["prompts"], run["prompt_len"])).astype(
            np.int32)
    t0 = time.perf_counter()
    single = _tp_serve_single(dev, cfg, prompt, run, embeds)
    single_s = time.perf_counter() - t0
    _empty_card(dev, f"phase {phase} {cfg.name}'s ranks")
    t0 = time.perf_counter()
    res = pool.run(ranks.tp_serve_card, cfg, run["serve_mesh"], run["seed"],
                   prompt, run["max_new"], run["tail"], embeds=embeds)
    ranks_s = time.perf_counter() - t0
    rank_seg, one_seg = segments or (7 * cfg.n_layers,) * 2
    want_launches = -(-rank_seg // eq.MAX_SEGMENTS)
    one_launches = -(-one_seg // eq.MAX_SEGMENTS)
    if single["freeze_launches"] != one_launches:
        raise AssertionError(f"phase {phase}: one process's freeze launched "
                             f"{single['freeze_launches']}, want "
                             f"{one_launches}")
    tp = run["serve_mesh"][1]
    heads = model_tp(cfg, MeshSpec(run["serve_mesh"], ("data", "model")))
    kv_split = tp if cfg.mla is None and heads.heads else 1
    ssm_split = tp if heads.ssm_heads else 1
    worst, scale = _tp_rank_gates(phase, cfg, res, single, want_launches,
                                  "tail_logits")
    forms = 0.0
    for rank, r in enumerate(res):
        tag = f"phase {phase}: {cfg.name} rank {rank}"
        if r["kv_cache_bytes"] * kv_split != single["kv_cache_bytes"]:
            raise AssertionError(f"{tag}: KV cache {r['kv_cache_bytes']} B, "
                                 f"one process {single['kv_cache_bytes']}")
        if (r["ssm_state_bytes"] * ssm_split != single["ssm_state_bytes"]
                or r["conv_tail_bytes"] != single["conv_tail_bytes"]):
            raise AssertionError(
                f"{tag}: SSM state {r['ssm_state_bytes']} B and conv tail "
                f"{r['conv_tail_bytes']} B, one process "
                f"{single['ssm_state_bytes']} and "
                f"{single['conv_tail_bytes']}")
        if cfg.mla is not None:
            forms = max(forms, r["mla_forms_rel"])
            if not r["mla_forms_rel"] <= MLA_REL:
                raise AssertionError(f"{tag}: absorbed decode "
                                     f"{r['mla_forms_rel']} from the naive "
                                     "form")
    rank_ms = lambda k: [r[k] for r in res]
    out = {"arch": run["arch"], "mesh": list(run["serve_mesh"]),
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "prompts": run["prompts"], "prompt_len": run["prompt_len"],
           "max_new": run["max_new"], "dtype": "fp32",
           "codes_bitwise": True, "tokens_equal": True,
           "logit_max_abs_err": worst, "logit_scale": scale,
           "freeze_launches_per_rank": want_launches,
           "freeze_segments_per_rank": rank_seg,
           "freeze_launches_one_process": one_launches,
           "ecl_quant_launches": sum(r["freeze_launches"] for r in res),
           "kv_cache_bytes": {"rank": res[0]["kv_cache_bytes"],
                              "one_process": single["kv_cache_bytes"]},
           **({"ssm_mode": ranks.ssm_mode(heads), **{
               k: {"rank": res[0][k], "one_process": single[k],
                   "rank_per_layer_seq": res[0][k] // (
                       cfg.n_layers * run["prompts"])}
               for k in ("ssm_state_bytes", "conv_tail_bytes")}}
              if single["ssm_state_bytes"] else {}),
           "input": "embeds" if embeds is not None else "tokens",
           "freeze_ms": {"ranks": rank_ms("freeze_ms"),
                         "one_process": single["freeze_ms"]},
           "prefill_ms": {"ranks": rank_ms("prefill_ms"),
                          "one_process": single["prefill_ms"]},
           "decode_ms_per_step": {
               "ranks": [float(np.median(r["decode_ms"])) for r in res],
               "one_process": float(np.median(single["decode_ms"]))},
           "peak_gb": {"ranks": [r["peak_bytes"] / 1e9 for r in res],
                       "one_process": single["peak_bytes"] / 1e9},
           "init_s": rank_ms("init_s"), "single_s": single_s,
           "ranks_s": ranks_s}
    if cfg.mla is not None:
        out["mla_absorbed_vs_naive_rel"] = forms
    print(f"phase {phase}: {run['arch']} over {run['serve_mesh']} "
          f"({cfg.n_layers} layers, d {cfg.d_model}): frozen blocks bitwise "
          f"one process's ({want_launches} ecl_quant launches a rank for "
          f"{rank_seg} segments), {run['prompts']} x {run['prompt_len']} + "
          f"{run['max_new']} tokens equal, logits {worst:.3e} of max "
          f"{scale:.2f}; KV cache {res[0]['kv_cache_bytes']} B a rank, "
          f"{single['kv_cache_bytes']} B one process; "
          + (f"SSM ({out['ssm_mode']}) state {res[0]['ssm_state_bytes']} B"
             f" a rank, {single['ssm_state_bytes']} B one process, conv tail"
             f" {res[0]['conv_tail_bytes']} B both; "
             if single["ssm_state_bytes"] else "")
          + f"rank 0 freeze "
          f"{res[0]['freeze_ms']:.1f} ms, prefill {res[0]['prefill_ms']:.1f}"
          f" ms, decode {out['decode_ms_per_step']['ranks'][0]:.1f} ms a "
          f"step, peak {out['peak_gb']['ranks'][0]:.2f} GB; one process "
          f"{single['freeze_ms']:.1f} / {single['prefill_ms']:.1f} / "
          f"{out['decode_ms_per_step']['one_process']:.1f} ms, peak "
          f"{out['peak_gb']['one_process']:.2f} GB"
          + (f"; absorbed vs naive {forms:.2e}" if cfg.mla is not None
             else "") + f" ({TP_LABEL}; {gpu})")
    return out


def _tp_train_single(dev, cfg, batches, ref, run=TP):
    """(b)'s one-process reference on the card, freed after: the fp32
    gradients at the initial state on batch 0 and the params after
    ``run["steps"]`` fp32 steps dumped under ``ref`` (``grads/``,
    ``params/``: ``ranks.dump``, for the ranks' ``block_errors``); returns
    the steps' losses and the peak memory."""
    import torch
    from repro_torch.core import qat
    from repro_torch.launch import ranks
    from repro_torch.launch import steps as S
    from repro_torch.optim import adam, ec4t

    torch.zeros((), device=dev)     # the allocator is live before its reset
    torch.cuda.reset_peak_memory_stats(dev)
    params = ranks.model_init(cfg)(cfg, seed=run["seed"], device=dev)
    qstate = qat.build_qstate(params)
    loss_fn = S._loss_fn(cfg, dtype=torch.float32)
    on_card = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in batches]
    _, grads = ec4t.local_grads(loss_fn, params, qstate, on_card[0],
                                cfg.lam)
    ranks.dump(grads, os.path.join(ref, "grads"))
    del grads
    step = ec4t.make_train_step(loss_fn, adam.AdamConfig(lr=run["lr"]),
                                lam=cfg.lam)
    state, losses = ec4t.init_train_state(params), []
    del params, qstate
    for b in on_card[:run["steps"]]:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    out = {"losses": losses,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    ranks.dump(state["params"], os.path.join(ref, "params"))
    del state
    torch.cuda.empty_cache()
    return out


def _tp_train(dev, pool, gpu, cfg=None, run=TP, phase="18",
              segments=None, single_ctx=contextlib.nullcontext):
    """(b): ``cfg``'s EC4T step (phase 18: h2o-danube-1.8b at published
    widths, depth 2) over ``run["train_meshes"]`` (ZeRO-1 where the data
    axis is wider than 1): phase 16's gates against one process on the
    fp32 steps (its step run under ``single_ctx()``), exactly
    ``segments(mesh)`` segments' ecl_quant launches a pass a rank
    (default 7 a layer); the bf16 steps timed."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import lm_batch_fn

    if cfg is None:
        cfg = dataclasses.replace(get_config(run["arch"]),
                                  n_layers=run["train_layers"])
    batch_fn = lm_batch_fn(cfg, batch=run["batch"], seq=run["seq"])
    batches = [batch_fn(i) for i in range(run["steps"])]
    ref = tempfile.mkdtemp(prefix="tp_train_ref_")
    try:
        t0 = time.perf_counter()
        with single_ctx():
            single = _tp_train_single(dev, cfg, batches, ref, run)
        single_s = time.perf_counter() - t0
        _empty_card(dev, f"phase {phase} (b)'s ranks")
        out, launches = _tp_train_meshes(pool, gpu, cfg, run, phase,
                                         segments, batches, single, ref)
    finally:
        shutil.rmtree(ref)
    return {"arch": run["arch"], "layers": cfg.n_layers,
            "reduced": {"depth": f"{get_config(run['arch']).n_layers} -> "
                        f"{cfg.n_layers} (time)"},
            "batch": run["batch"], "seq": run["seq"], "meshes": out,
            "single_s": single_s}, launches


def _rank_errors(res, key, runs=False):
    """Each leaf's ``ranks.block_errors`` ``key`` (``grad_errors``, or with
    ``runs`` run 0's ``param_errors``) over every rank: (the largest
    |got - want|, the largest of it over its leaf's max |want|, the
    largest |got - want| / (1 + |want|), and the leaf of the second with
    its |got - want| and max |want|)."""
    merged = {}
    for r in res:
        errs = r["runs"][0][key] if runs else r[key]
        for name, e in errs.items():
            merged[name] = tuple(max(a, b) for a, b in
                                 zip(merged.get(name, e), e))
    rel = {n: e[0] / max(e[1], 1e-30) for n, e in merged.items()}
    worst = max(rel, key=rel.get)
    return (max(e[0] for e in merged.values()), rel[worst],
            max(e[2] for e in merged.values()),
            {"leaf": worst, "max_abs_err": merged[worst][0],
             "max_abs_want": merged[worst][1]})


def _tp_train_meshes(pool, gpu, cfg, run, phase, segments, batches, single,
                     ref):
    """:func:`_tp_train`'s meshes, each rank holding its blocks to the one
    process's reference under ``ref``."""
    import numpy as np
    import torch
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import ranks

    segments = segments or (lambda mesh: 7 * cfg.n_layers)
    out, launches = {}, 0
    for mesh in run["train_meshes"]:
        per_step = ECL_PASSES_PER_STEP * -(-segments(mesh)
                                           // eq.MAX_SEGMENTS)
        key = f"mesh {mesh[0]}x{mesh[1]}"
        zero1 = mesh[0] > 1
        t0 = time.perf_counter()
        res = pool.run(
            ranks.dp_train, cfg, mesh, batches, seed=run["seed"],
            lr=run["lr"], grads=True, ref=ref,
            runs=[{"zero1": zero1, "state": True, "probs_check": True},
                  {"zero1": zero1, "dtype": torch.bfloat16,
                   "steps": run.get("bf16_steps", run["steps"])}])
        ranks_s = time.perf_counter() - t0
        _, grad_rel, _, grad_worst = _rank_errors(res, "grad_errors")
        param_err, _, param_tol, _ = _rank_errors(res, "param_errors",
                                                  True)
        if not param_tol <= MESH_TRAIN_PARAM_TOL:
            raise AssertionError(f"phase {phase}: {key}: params past "
                                 f"atol=rtol={MESH_TRAIN_PARAM_TOL} "
                                 f"({param_tol} of 1 + |want|)")
        if not grad_rel <= MESH_TRAIN_GRAD_REL:
            raise AssertionError(f"phase {phase}: {key}: gradients {grad_rel} of "
                                 "a leaf's max from one process's")
        for rank, r in enumerate(res):
            tag = f"phase {phase}: {key} rank {rank}"
            if r["layout"] != "tensor parallel":
                raise AssertionError(f"{tag}: layout {r['layout']}")
            np.testing.assert_allclose(
                [m["loss"] for m in r["runs"][0]["metrics"]],
                single["losses"], rtol=MESH_TRAIN_LOSS_RTOL, err_msg=tag)
            if not r["runs"][0]["probs_bitwise"]:
                raise AssertionError(f"{tag}: probabilities differ from one "
                                     "process's update of the same params")
            if r["runs"][0]["digests"] != res[0]["runs"][0]["digests"]:
                raise AssertionError(f"{tag}: the gathered tree differs from "
                                     "rank 0's")
            for rr in r["runs"]:
                if rr["ecl_launches"] != [per_step] * len(rr["ms"]):
                    raise AssertionError(f"{tag}: ecl_quant "
                                         f"{rr['ecl_launches']}, want "
                                         f"{per_step} a step")
                if not all(np.isfinite(m["loss"]) for m in rr["metrics"]):
                    raise AssertionError(f"{tag}: a loss is not finite")
                launches += sum(rr["ecl_launches"])
        bf16 = [r["runs"][1] for r in res]
        out[key] = {
            "zero1": zero1, "losses": [m["loss"] for m in res[0]["runs"][0][
                "metrics"]], "single_losses": single["losses"],
            "grad_rel_err": grad_rel, "grad_worst": grad_worst,
            "param_max_abs_err": param_err,
            "probs_bitwise": True,
            "ecl_quant_launches_per_step_per_rank": per_step,
            "fp32_ms_per_step_per_rank": [r["runs"][0]["ms"] for r in res],
            "bf16_ms_per_step_per_rank": [b["ms"] for b in bf16],
            "bf16_losses": [m["loss"] for m in bf16[0]["metrics"]],
            "model_allreduce_bytes_per_step": {
                "fp32": res[0]["runs"][0]["model_bytes"],
                "bf16": bf16[0]["model_bytes"]},
            "reduced_bytes_per_step": res[0]["runs"][0]["reduced_bytes"],
            "single_peak_gb": single["peak_bytes"] / 1e9,
            "peak_gb_per_rank": {"fp32": [r["runs"][0]["peak_bytes"] / 1e9
                                          for r in res],
                                 "bf16": [b["peak_bytes"] / 1e9
                                          for b in bf16]},
            "ranks_s": ranks_s, "rank0_s": {
                **res[0]["s"], "runs": [x["s"] for x in res[0]["runs"]]}}
        o = out[key]
        print(f"phase {phase}: {run['arch']} depth {cfg.n_layers} "
              f"{run['batch']} x {run['seq']} over {mesh}{' ZeRO-1' if zero1 else ''}: losses "
              f"{[round(v, 6) for v in o['losses']]} (one process "
              f"{[round(v, 6) for v in single['losses']]}), grads "
              f"{grad_rel:.2e} of max ({grad_worst['leaf']}: "
              f"{grad_worst['max_abs_err']:.3e} of "
              f"{grad_worst['max_abs_want']:.3e}), params {param_err:.2e}, "
              "probabilities"
              f" bitwise, {per_step} ecl_quant a step a rank; bf16 ms a step"
              f" (rank 0) {[round(v, 1) for v in bf16[0]['ms']]}, "
              f"all-reduced over 'model' {bf16[0]['model_bytes']} B a step,"
              f" peak {o['peak_gb_per_rank']['bf16'][0]:.2f} GB a rank; "
              f"{ranks_s:.1f} s ({TP_LABEL}; {gpu})")
    return out, launches


def tensor_parallel_path(dev, gpu):
    """Phase 18: tensor parallelism over 'model' for the dense family, 4
    gloo ranks sharing the card (staged through host buffers)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    _empty_card(dev, "phase 18")
    cfg = _cut_depth(get_config(TP["arch"]), TP["serve_layers"])
    t0 = time.perf_counter()
    with _rank_pool(TP["world"], TP["timeout"]) as pool:
        pool.run(M.describe_world)
        spawn_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        serve = _tp_serve(dev, pool, cfg, gpu)
        serve_s = time.perf_counter() - t1
        _empty_card(dev, "phase 18 (b)")
        t1 = time.perf_counter()
        train, launches = _tp_train(dev, pool, gpu)
        train_s = time.perf_counter() - t1
    launches += serve["ecl_quant_launches"]
    out = {"label": TP_LABEL, "gpu": gpu, "spawn_s": spawn_s,
           "serve": {**serve, "s": serve_s, "reduced": {
               "depth": f"{get_config(TP['arch']).n_layers} -> "
                        f"{cfg.n_layers} (time, phase 19 added)"}},
           "train": {**train, "s": train_s},
           "ecl_quant_launches": launches}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 18: spawn {spawn_s:.1f} s, (a) {serve_s:.1f} s, (b) "
          f"{train_s:.1f} s; done in {out['wall_s']:.1f} s ({gpu})")
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 19

MOE_TP = dict(world=4, timeout=900, ep_blocks=4)
MOE_TP_SERVE = (
    dict(arch="grok-1-314b", layers=1, seed=0, serve_mesh=(1, 4), prompts=2,
         prompt_len=512, max_new=16, tail=8,
         reduced={"n_layers": "64 -> 1 (one process's layer is 26 GB in "
                  "fp32, and its freeze twice that)"}),
    dict(arch="deepseek-v3-671b", layers=2, dense_layers=1, experts=32,
         seed=0, serve_mesh=(1, 4), prompts=2, prompt_len=512, max_new=16,
         tail=8,
         reduced={"n_layers": "61 -> 2 (one dense layer, one MoE layer, "
                  "as phase 10)", "n_experts": "256 -> 32 (one process "
                  "holds and freezes every expert)"}))
MOE_TP_TRAIN = (
    dict(arch="deepseek-v3-671b", layers=1, dense_layers=0, experts=8,
         vocab=32768, seed=0, batch=8, seq=64, steps=2, bf16_steps=1,
         lr=1e-3, train_meshes=((1, 4), (2, 2)),
         reduced={"n_layers": "61 -> 1 (the MoE layer: four (2, 2) ranks' "
                  "fp32 ZeRO-1 steps at depth 2 ran out of the card's 80 GB "
                  "at ~19.5 GB a rank, and depth 2 took 169 s; the dense "
                  "layer's cut is phase 18's)",
                  "n_experts": "256 -> 8 (one process's fp32 step with Adam "
                  "holds ~28 B a parameter; top-8 needs 8)",
                  "vocab": "129280 -> 32768 (as phase 10)"}),)
MOE_TP_DRYRUN = dict(arch="grok-1-314b", shape="train_4k")


def _moe_tp_cfg(run):
    """``run``'s arch at its published widths, cut as ``run`` says, at
    capacity factor E / k (nothing drops, so the expert-parallel ranks'
    per-rank capacity is moot)."""
    import dataclasses
    from repro_torch.configs import get_config
    kw = {"n_layers": run["layers"]}
    for key, field in (("dense_layers", "n_dense_layers"),
                       ("experts", "n_experts"), ("vocab", "vocab")):
        if key in run:
            kw[field] = run[key]
    cfg = dataclasses.replace(get_config(run["arch"]), **kw)
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)


def _moe_segments(cfg, mesh_shape=None):
    """The ECL segments of ``cfg``'s quantized leaves: one process's, or
    with ``mesh_shape`` a rank's under the layout (its E/tp experts of
    each bank when they are cut on the experts, else every expert's
    block)."""
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.runtime.sharding import model_tp
    experts = cfg.n_experts
    if mesh_shape is not None:
        tp = model_tp(cfg, MeshSpec(mesh_shape, ("data", "model")))
        if tp.experts == "ep":
            experts //= tp.tp
    attn = 5 if cfg.mla is not None else 4
    moe = attn + 3 * experts + (3 if cfg.n_shared_experts else 0)
    dense = cfg.n_dense_layers
    return dense * (attn + 3) + (cfg.n_layers - dense) * moe


@contextlib.contextmanager
def _ep_aux(blocks):
    """One process's MoE load-balance aux as the expert-parallel ranks
    take it: the mean of ``route``'s over ``blocks`` equal token blocks
    (the reference's ``local_moe`` pmean), the ids and weights the whole
    batch's."""
    from repro_torch.nn import moe
    real = moe.route

    def blocked(logits, bias_correction, **kw):
        ids, w, _ = real(logits, bias_correction, **kw)
        aux = sum(real(b, bias_correction, **kw)[2]
                  for b in logits.chunk(blocks)) / blocks
        return ids, w, aux
    moe.route = blocked
    try:
        yield
    finally:
        moe.route = real


def _moe_tp_dryrun(gpu):
    """(d): grok-1-314b's train_4k cell on pod16x16, on meta tensors."""
    import tempfile
    from repro_torch.launch import dryrun
    c = MOE_TP_DRYRUN
    with tempfile.TemporaryDirectory() as d:
        rec = dryrun.run_cell(c["arch"], c["shape"], False, out_dir=d)
    rec.pop("ops", None)
    if rec["status"] != "OK":
        raise AssertionError(f"phase 19: run_cell {c}: {rec}")
    over = rec["model_axis_collectives"]
    if (rec["layout"] != "tensor parallel" or rec["experts"] != "tp"
            or not over.get("all-reduce")):
        raise AssertionError(f"phase 19: {c['arch']} {c['shape']} took "
                             f"{rec['layout']} / {rec['experts']}, over "
                             f"'model' {over}")
    print(f"phase 19: dry run {rec['cell']}: {rec['layout']}, experts "
          f"{rec['experts']}: {rec['flops_per_device']:.6g} FLOPs, "
          f"{rec['bytes_per_device']:.6g} B a device, over 'model' {over}, "
          f"ecl_quant {rec['kernels']}, traced in {rec['trace_s']} s "
          f"(meta tensors; {gpu})")
    return rec


def moe_tensor_parallel_path(dev, gpu):
    """Phase 19: tensor parallelism over 'model' for the MoE family, 4
    gloo ranks sharing the card (staged through host buffers)."""
    import torch
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    _empty_card(dev, "phase 19")
    out = {"label": TP_LABEL, "gpu": gpu, "serve": {}}
    launches = 0
    t0 = time.perf_counter()
    with _rank_pool(MOE_TP["world"], MOE_TP["timeout"]) as pool:
        pool.run(M.describe_world)
        out["spawn_s"] = time.perf_counter() - t0
        for run in MOE_TP_SERVE:
            t1 = time.perf_counter()
            cfg = _moe_tp_cfg(run)
            rec = _tp_serve(dev, pool, cfg, gpu, run, "19", (
                _moe_segments(cfg, run["serve_mesh"]), _moe_segments(cfg)))
            rec.update(reduced=run["reduced"],
                       capacity_factor=cfg.capacity_factor,
                       n_experts=cfg.n_experts,
                       s=time.perf_counter() - t1)
            out["serve"][run["arch"]] = rec
            launches += rec["ecl_quant_launches"]
            _empty_card(dev, f"phase 19 after {run['arch']}")
        out["train"] = {}
        for run in MOE_TP_TRAIN:
            t1 = time.perf_counter()
            cfg = _moe_tp_cfg(run)
            train, n = _tp_train(
                dev, pool, gpu, cfg, run, "19",
                functools.partial(_moe_segments, cfg),
                lambda: _ep_aux(MOE_TP["ep_blocks"]))
            train.update(reduced=run["reduced"], n_experts=cfg.n_experts,
                         vocab=cfg.vocab, s=time.perf_counter() - t1)
            out["train"].update(train.pop("meshes"))
            out["train"][f"depth {cfg.n_layers}"] = train
            launches += n
            _empty_card(dev, "phase 19 after a step")
    _empty_card(dev, "phase 19 (d)")
    t1 = time.perf_counter()
    out["dryrun"] = _moe_tp_dryrun(gpu)
    out["dryrun"]["s"] = time.perf_counter() - t1
    out["ecl_quant_launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 19: spawn {out['spawn_s']:.1f} s, (a) "
          f"{out['serve']['grok-1-314b']['s']:.1f} s, (b) "
          f"{out['serve']['deepseek-v3-671b']['s']:.1f} s, (c) "
          f"{sum(v['s'] for k, v in out['train'].items() if k.startswith('depth')):.1f}"
          f" s, (d) {out['dryrun']['s']:.1f} s; done in "
          f"{out['wall_s']:.1f} s ({gpu})")
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 20

SSM_TP = dict(world=4, timeout=900)
SSM_TP_SERVE = (
    dict(part="a", arch="mamba2-1.3b", layers=8, seed=0, serve_mesh=(1, 4),
         prompts=2, prompt_len=512, max_new=8, tail=8, mode="heads",
         reduced={"n_layers": "48 -> 8 (time)"}),
    dict(part="b", arch="hymba-1.5b", layers=3, global_layers=(0,), seed=0,
         serve_mesh=(1, 4), prompts=2, prompt_len=512, max_new=8, tail=8,
         mode="rows", reduced={"n_layers": "32 -> 3, layer 0 global (time)"}),
    dict(part="b", arch="hymba-1.5b", layers=3, global_layers=(0,), seed=0,
         serve_mesh=(2, 2), prompts=2, prompt_len=512, max_new=8, tail=8,
         mode="heads", reduced={"n_layers": "32 -> 3, layer 0 global "
                                "(time)"}),
    dict(part="c", arch="qwen2-vl-2b", layers=2, seed=0, serve_mesh=(1, 4),
         prompts=2, prompt_len=512, max_new=8, tail=8, mode=None,
         embeds=True, reduced={"n_layers": "28 -> 2 (time)"}))
SSM_TP_TRAIN = dict(part="d", arch="hymba-1.5b", layers=2,
                    global_layers=(0,), seed=0, batch=8, seq=64, steps=2,
                    bf16_steps=1, lr=1e-3, train_meshes=((1, 4),),
                    reduced={"n_layers": "32 -> 2, layer 0 global (time)"})
SSM_TP_DRYRUN = dict(part="e", arch="hymba-1.5b", shape="long_500k",
                     layers=2, mode="rows")
# a layer's quantized leaves: in_proj and out_proj; hymba's q, k, v, o
# beside them and gate, up, down; qwen2-vl's q, k, v, o, gate, up, down
SSM_TP_LEAVES = {"ssm": 2, "hybrid": 9, "vlm": 7}


def _ssm_tp_cfg(run):
    """``run``'s arch at its published widths, cut as ``run`` says."""
    import dataclasses
    from repro_torch.configs import get_config
    kw = {"n_layers": run["layers"]}
    if "global_layers" in run:
        kw["global_attn_layers"] = run["global_layers"]
    return dataclasses.replace(get_config(run["arch"]), **kw)


def _ssm_tp_dryrun(gpu):
    """(e): hymba-1.5b's long_500k decode on pod16x16, on meta tensors
    (depth cut for time: 512 KV chunks a layer): tensor parallel, its 50
    SSM heads whole on each rank ("rows"), all-reduces over 'model'."""
    import tempfile
    from repro_torch.launch import dryrun, ranks
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import model_tp
    c = SSM_TP_DRYRUN
    cfg = _ssm_tp_cfg(dict(c, global_layers=(0,)))
    mode = ranks.ssm_mode(model_tp(cfg, make_production_mesh()))
    with tempfile.TemporaryDirectory() as d:
        rec = dryrun.run_cell(c["arch"], c["shape"], False, out_dir=d,
                              cfg=cfg)
    rec.pop("ops", None)
    if rec["status"] != "OK":
        raise AssertionError(f"phase 20: run_cell {c}: {rec}")
    over = rec["model_axis_collectives"]
    if (rec["layout"] != "tensor parallel" or mode != c["mode"]
            or not over.get("all-reduce")):
        raise AssertionError(f"phase 20: {c['arch']} {c['shape']} took "
                             f"{rec['layout']}, SSM {mode}, over 'model' "
                             f"{over}")
    rec.update(ssm_mode=mode, reduced={
        "n_layers": f"32 -> {cfg.n_layers}, layer 0 global (time: 512 KV "
                    "chunks a layer on meta)"})
    print(f"phase 20: (e) dry run {rec['cell']} at depth {cfg.n_layers}: "
          f"{rec['layout']}, SSM {mode}: {rec['flops_per_device']:.6g} "
          f"FLOPs, {rec['bytes_per_device']:.6g} B a device, over 'model' "
          f"{over}, traced in {rec['trace_s']} s (meta tensors; {gpu})")
    return rec


def ssm_tensor_parallel_path(dev, gpu):
    """Phase 20: tensor parallelism over 'model' for the ssm, hybrid and
    vlm families, 4 gloo ranks sharing the card (staged through host
    buffers), through phase 18's ``_tp_serve`` and ``_tp_train``."""
    import torch
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    _empty_card(dev, "phase 20")
    out = {"label": TP_LABEL, "gpu": gpu, "serve": {}, "s": {}}
    launches = 0
    t0 = time.perf_counter()
    with _rank_pool(SSM_TP["world"], SSM_TP["timeout"]) as pool:
        pool.run(M.describe_world)
        out["spawn_s"] = time.perf_counter() - t0
        for run in SSM_TP_SERVE:
            t1 = time.perf_counter()
            cfg = _ssm_tp_cfg(run)
            seg = SSM_TP_LEAVES[cfg.family] * cfg.n_layers
            rec = _tp_serve(dev, pool, cfg, gpu, run, "20", (seg, seg))
            if rec.get("ssm_mode") != run["mode"]:
                raise AssertionError(f"phase 20: {run['arch']} over "
                                     f"{run['serve_mesh']}: SSM "
                                     f"{rec.get('ssm_mode')}, want "
                                     f"{run['mode']}")
            rec.update(reduced=run["reduced"], s=time.perf_counter() - t1)
            key = f"{run['arch']} {run['serve_mesh'][0]}x" \
                f"{run['serve_mesh'][1]}"
            out["serve"][key] = rec
            out["s"][run["part"]] = out["s"].get(run["part"], 0) + rec["s"]
            launches += rec["ecl_quant_launches"]
            _empty_card(dev, f"phase 20 after {key}")
        t1 = time.perf_counter()
        run = SSM_TP_TRAIN
        cfg = _ssm_tp_cfg(run)
        train, n = _tp_train(dev, pool, gpu, cfg, run, "20",
                             lambda mesh: SSM_TP_LEAVES[cfg.family]
                             * cfg.n_layers)
        train.update(reduced=run["reduced"])
        out["train"] = train
        out["s"]["d"] = time.perf_counter() - t1
        launches += n
    _empty_card(dev, "phase 20 (e)")
    t1 = time.perf_counter()
    out["dryrun"] = _ssm_tp_dryrun(gpu)
    out["s"]["e"] = time.perf_counter() - t1
    out["ecl_quant_launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 20: spawn {out['spawn_s']:.1f} s, "
          + ", ".join(f"({k}) {v:.1f} s" for k, v in out["s"].items())
          + f"; done in {out['wall_s']:.1f} s ({gpu})")
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 21

AUDIO_TP = dict(world=4, timeout=900, arch="whisper-base", seed=0,
                serve_mesh=(1, 4), utterances=8, max_new=16,
                train_meshes=((1, 4), (2, 2)), batch=8, seq=64, steps=2,
                bf16_steps=1, lr=1e-3, restore_meshes=((2, 2), (1, 4)),
                reduced={"max_new": "124 -> 16 decode tokens (time)"})
AUDIO_TP_DRYRUN = dict(arch="whisper-base", shape="train_4k")
AUDIO_TP_SEGMENTS = 96    # 6 x 6 encoder and 6 x 10 decoder leaves
AUDIO_TP_LABEL = "4 ranks sharing one H100 over gloo"


def _audio_tp_single(dev, cfg, frames, prompt, run=AUDIO_TP):
    """(a)'s one-process reference, run before any rank and freed after:
    ``whisper_init`` whole, frozen (its ecl_quant launches counted), the
    digests of each rank's blocks of the frozen tree, and the same serve
    the ranks run (``ranks.whisper_serve_timed``, fp32)."""
    import torch
    from repro_torch.launch import ranks
    from repro_torch.nn.module import FP32_CTX

    frozen, out = _tp_single_frozen(dev, cfg, run)
    served, cache, cross = ranks.whisper_serve_timed(
        frozen, torch.from_numpy(frames).to(dev),
        torch.from_numpy(prompt).to(dev), cfg, FP32_CTX, run["max_new"])
    out.update(served, cross_shape=list(cross[0].shape),
               cache_shape=list(cache["attn"]["k"].shape))
    del cache, cross
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del frozen
    torch.cuda.empty_cache()
    return out


def _audio_tp_serve(dev, pool, cfg, gpu, run=AUDIO_TP):
    """(a): whisper-base at published widths over ``run["serve_mesh"]``:
    each rank's freeze bitwise the one process's blocks in 3 launches (96
    segments), tokens equal, logits within 1e-3 of the max, a rank's cross
    K/V and self-attention KV cache its heads' share of one process's."""
    import numpy as np
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import ranks

    rng = np.random.default_rng(run["seed"] + 210)
    frames = rng.standard_normal((run["utterances"], cfg.enc_len,
                                  cfg.d_model), dtype=np.float32)
    prompt = np.array([AUDIO_PROMPT] * run["utterances"], dtype=np.int64)
    t0 = time.perf_counter()
    single = _audio_tp_single(dev, cfg, frames, prompt, run)
    single_s = time.perf_counter() - t0
    _empty_card(dev, "phase 21 (a)'s ranks")
    t0 = time.perf_counter()
    res = pool.run(ranks.whisper_serve_card, cfg, run["serve_mesh"],
                   run["seed"], frames, prompt, run["max_new"])
    ranks_s = time.perf_counter() - t0
    want = -(-AUDIO_TP_SEGMENTS // eq.MAX_SEGMENTS)
    if single["freeze_launches"] != want:
        raise AssertionError(f"phase 21: one process's freeze launched "
                             f"{single['freeze_launches']}, want {want}")
    tp = run["serve_mesh"][1]
    worst, scale = _tp_rank_gates("21", cfg, res, single, want, "logits")
    heads = lambda shape: shape[:3] + [shape[3] // tp] + shape[4:]
    for rank, r in enumerate(res):
        tag = f"phase 21: {cfg.name} rank {rank}"
        if (r["cross_bytes"] * tp != single["cross_bytes"]
                or r["kv_cache_bytes"] * tp != single["kv_cache_bytes"]):
            raise AssertionError(
                f"{tag}: cross K/V {r['cross_bytes']} B and KV "
                f"{r['kv_cache_bytes']} B, one process "
                f"{single['cross_bytes']} and {single['kv_cache_bytes']}")
    b = run["utterances"]
    rank_ms = lambda k: [r[k] for r in res]
    med = lambda xs: float(np.median(xs))
    out = {"arch": run["arch"], "mesh": list(run["serve_mesh"]),
           "enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers,
           "d_model": cfg.d_model, "utterances": b, "frames": cfg.enc_len,
           "prompt": list(AUDIO_PROMPT), "max_new": run["max_new"],
           "dtype": "fp32", "codes_bitwise": True, "tokens_equal": True,
           "logit_max_abs_err": worst, "logit_scale": scale,
           "freeze_launches_per_rank": want,
           "freeze_segments_per_rank": AUDIO_TP_SEGMENTS,
           "ecl_quant_launches": sum(rank_ms("freeze_launches")),
           "cross_bytes_per_sequence": {
               "rank": res[0]["cross_bytes"] // b,
               "one_process": single["cross_bytes"] // b},
           "kv_cache_bytes_per_sequence": {
               "rank": res[0]["kv_cache_bytes"] // b,
               "one_process": single["kv_cache_bytes"] // b},
           "cross_shape": {"rank": heads(single["cross_shape"]),
                           "one_process": single["cross_shape"]},
           "freeze_ms": {"ranks": rank_ms("freeze_ms"),
                         "one_process": single["freeze_ms"]},
           "encode_cross_ms": {
               "ranks": [r["encode_ms"] + r["cross_ms"] for r in res],
               "one_process": single["encode_ms"] + single["cross_ms"]},
           "prefill_ms": {"ranks": rank_ms("prompt_ms"),
                          "one_process": single["prompt_ms"]},
           "decode_ms_per_step": {
               "ranks": [med(r["decode_ms"]) for r in res],
               "one_process": med(single["decode_ms"])},
           "peak_gb": {"ranks": [r["peak_bytes"] / 1e9 for r in res],
                       "one_process": single["peak_bytes"] / 1e9},
           "init_s": rank_ms("init_s"), "single_s": single_s,
           "ranks_s": ranks_s, "reduced": run["reduced"]}
    print(f"phase 21: (a) {run['arch']} over {run['serve_mesh']} (6 + 6 "
          f"layers, d {cfg.d_model}): frozen blocks bitwise one process's "
          f"({want} ecl_quant launches a rank, {AUDIO_TP_SEGMENTS} segments),"
          f" {b} x {cfg.enc_len} frames + {len(AUDIO_PROMPT)} + "
          f"{run['max_new']} tokens equal, logits {worst:.3e} of max "
          f"{scale:.2f}; cross K/V {out['cross_bytes_per_sequence']['rank']}"
          f" B a sequence a rank ({out['cross_bytes_per_sequence']['one_process']}"
          f" one process), KV {out['kv_cache_bytes_per_sequence']['rank']} B "
          f"({out['kv_cache_bytes_per_sequence']['one_process']}); rank 0 "
          f"freeze {res[0]['freeze_ms']:.1f} ms, encode + cross "
          f"{out['encode_cross_ms']['ranks'][0]:.1f} ms, prefill "
          f"{res[0]['prompt_ms']:.1f} ms, decode "
          f"{out['decode_ms_per_step']['ranks'][0]:.1f} ms a step, peak "
          f"{out['peak_gb']['ranks'][0]:.2f} GB; one process "
          f"{single['freeze_ms']:.1f} / "
          f"{out['encode_cross_ms']['one_process']:.1f} / "
          f"{single['prompt_ms']:.1f} / "
          f"{out['decode_ms_per_step']['one_process']:.1f} ms, peak "
          f"{out['peak_gb']['one_process']:.2f} GB ({AUDIO_TP_LABEL}; {gpu})")
    return out


def _audio_tp_restore(dev, pool, cfg, gpu, run=AUDIO_TP):
    """(c): (b)'s state (ZeRO-1) saved after one fp32 step on (2, 2)
    (``CheckpointManager.save(specs=, mesh=)``), restored onto (2, 2),
    (1, 4) and one process (``resume_or(sharding_fn=)``): the restored
    tree bitwise the saved one (whole digests), the next step on (2, 2)
    bitwise the uninterrupted run's, on (1, 4) and in one process the
    loss within ``rtol=1e-4`` and the params within ``atol=rtol=5e-3`` of
    one process's uninterrupted run, probabilities bitwise, 6 ecl_quant
    launches a step a rank."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.kernels import ecl_quant as eq
    from repro_torch.launch import ranks
    from repro_torch.launch.train import lm_batch_fn

    batch_fn = lm_batch_fn(cfg, batch=run["batch"], seq=run["seq"])
    batches = [batch_fn(100 + i) for i in range(2)]
    per_step = ECL_PASSES_PER_STEP * -(-AUDIO_TP_SEGMENTS // eq.MAX_SEGMENTS)
    root = tempfile.mkdtemp(prefix="audio_tp_ckpt_")
    ref, ckpt = os.path.join(root, "ref"), os.path.join(root, "ckpt")
    launches = 0
    try:
        t0 = time.perf_counter()
        one = ranks.elastic_train(cfg, None, batches, os.path.join(root, "one"),
                                  save=True, seed=run["seed"], lr=run["lr"],
                                  out_dir=ref, device=dev)
        _empty_card(dev, "phase 21 (c)'s ranks")
        saved = pool.run(ranks.elastic_train, cfg, (2, 2), batches, ckpt,
                         save=True, seed=run["seed"], lr=run["lr"])
        single_s = time.perf_counter() - t0
        s0 = saved[0]
        if any(r["saved"] != s0["saved"] for r in saved):
            raise AssertionError("phase 21: (c) the ranks' saved digests "
                                 "differ")
        targets = {}
        for mesh in run["restore_meshes"] + (None,):
            key = "one process" if mesh is None else f"mesh {mesh[0]}x{mesh[1]}"
            t0 = time.perf_counter()
            if mesh is None:
                _empty_card(dev, "phase 21 (c) one process")
                res = [ranks.elastic_train(cfg, None, batches, ckpt,
                                           lr=run["lr"], ref=ref, device=dev)]
            else:
                res = pool.run(ranks.elastic_train, cfg, mesh, batches, ckpt,
                               lr=run["lr"], ref=ref)
            wall = time.perf_counter() - t0
            worst = 0.0
            for r in res:
                tag = f"phase 21: (c) {key} rank {r['rank']}"
                if r["restored"] != s0["saved"]:
                    bad = [n for n in r["restored"]
                           if r["restored"][n] != s0["saved"].get(n)]
                    raise AssertionError(f"{tag}: the restored tree differs "
                                         f"from the saved one: {bad[:6]}")
                if mesh == (2, 2):
                    if r["final"] != saved[r["rank"]]["final"]:
                        raise AssertionError(f"{tag}: the next step differs "
                                             "from the uninterrupted run's")
                else:
                    np.testing.assert_allclose(
                        r["metrics"][0]["loss"], one["metrics"][0]["loss"],
                        rtol=MESH_TRAIN_LOSS_RTOL, err_msg=tag)
                    rel = max(e[2] for e in r["param_errors"].values())
                    worst = max(worst, rel)
                    if not rel <= MESH_TRAIN_PARAM_TOL:
                        raise AssertionError(f"{tag}: params {rel} past "
                                             f"{MESH_TRAIN_PARAM_TOL}")
                if mesh is not None and not r["probs_bitwise"]:
                    raise AssertionError(f"{tag}: probabilities differ from "
                                         "one process's update")
                if r["ecl_launches"] != [per_step]:
                    raise AssertionError(f"{tag}: ecl_quant "
                                         f"{r['ecl_launches']}, want "
                                         f"{per_step}")
                launches += sum(r["ecl_launches"])
            targets[key] = {
                "restored_bitwise": True,
                "next_step_bitwise": mesh == (2, 2),
                "loss": res[0]["metrics"][0]["loss"],
                "param_max_rel_err": worst,
                "restore_ms": [r["restore_ms"] for r in res],
                "wall_s": wall}
        for r in saved:
            launches += sum(r["ecl_launches"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"save_mesh": [2, 2], "zero1": True, "batch": run["batch"],
           "seq": run["seq"], "ckpt_bytes": s0["ckpt_bytes"],
           "save_ms": [r["save_ms"] for r in saved],
           "one_process_loss": one["metrics"][0]["loss"],
           "uninterrupted_loss": s0["metrics"][0]["loss"],
           "targets": targets, "ecl_quant_launches": launches,
           "single_s": single_s}
    print(f"phase 21: (c) whisper-base's state (ZeRO-1, {run['batch']} x "
          f"({cfg.enc_len} + {run['seq']})) saved on (2, 2) after one step: "
          f"{s0['ckpt_bytes']:,} B, save {s0['save_ms']:.1f} ms (rank 0); "
          + "; ".join(f"{k}: restored bitwise in "
                      f"{v['restore_ms'][0]:.1f} ms, "
                      + ("next step bitwise the uninterrupted run's"
                         if v["next_step_bitwise"] else
                         f"loss {v['loss']:.6f} (one process "
                         f"{out['one_process_loss']:.6f}), params "
                         f"{v['param_max_rel_err']:.2e}")
                      for k, v in targets.items())
          + f" ({AUDIO_TP_LABEL}; {gpu})")
    return out


def _audio_tp_dryrun(gpu):
    """(d): whisper-base's train_4k on pod16x16, on meta tensors: tensor
    parallel with all-reduces over 'model', attention whole (8 heads do not
    divide 16) and fc1, fc2 and the vocabulary cut."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import model_tp
    c = AUDIO_TP_DRYRUN
    cfg = get_config(c["arch"])
    tp = model_tp(cfg, make_production_mesh())
    with tempfile.TemporaryDirectory() as d:
        rec = dryrun.run_cell(c["arch"], c["shape"], False, out_dir=d)
    rec.pop("ops", None)
    if rec["status"] != "OK":
        raise AssertionError(f"phase 21: run_cell {c}: {rec}")
    over = rec["model_axis_collectives"]
    if (rec["layout"] != "tensor parallel" or tp.heads or tp.o_rows
            or not (tp.mlp and tp.vocab) or not over.get("all-reduce")):
        raise AssertionError(f"phase 21: {c['arch']} {c['shape']} took "
                             f"{rec['layout']}, {tp}, over 'model' {over}")
    rec.update(attention="whole", mlp_cut=True, vocab_cut=True)
    print(f"phase 21: (d) dry run {rec['cell']}: {rec['layout']}, attention "
          f"whole (8 heads over 16), fc1 / fc2 / vocabulary cut: "
          f"{rec['flops_per_device']:.6g} FLOPs, {rec['bytes_per_device']:.6g}"
          f" B a device, over 'model' {over}, traced in {rec['trace_s']} s "
          f"(meta tensors; {gpu})")
    return rec


def audio_tensor_parallel_path(dev, gpu):
    """Phase 21: whisper-base over 'model' and the elastic restore of a
    mesh's train state, 4 gloo ranks sharing the card (staged through host
    buffers)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    _empty_card(dev, "phase 21")
    run = AUDIO_TP
    cfg = get_config(run["arch"])
    out = {"label": AUDIO_TP_LABEL, "gpu": gpu, "s": {}}
    t0 = time.perf_counter()
    with _rank_pool(run["world"], run["timeout"]) as pool:
        pool.run(M.describe_world)
        out["spawn_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out["serve"] = _audio_tp_serve(dev, pool, cfg, gpu)
        out["s"]["a"] = time.perf_counter() - t1
        _empty_card(dev, "phase 21 (b)")
        t1 = time.perf_counter()
        train, n = _tp_train(dev, pool, gpu, cfg, run, "21",
                             lambda mesh: AUDIO_TP_SEGMENTS)
        train["reduced"] = {"depth": "none"}
        out["train"] = train
        out["s"]["b"] = time.perf_counter() - t1
        _empty_card(dev, "phase 21 (c)")
        t1 = time.perf_counter()
        out["restore"] = _audio_tp_restore(dev, pool, cfg, gpu)
        out["s"]["c"] = time.perf_counter() - t1
    _empty_card(dev, "phase 21 (d)")
    t1 = time.perf_counter()
    out["dryrun"] = _audio_tp_dryrun(gpu)
    out["s"]["d"] = time.perf_counter() - t1
    out["ecl_quant_launches"] = (out["serve"]["ecl_quant_launches"] + n
                                 + out["restore"]["ecl_quant_launches"])
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 21: spawn {out['spawn_s']:.1f} s, "
          + ", ".join(f"({k}) {v:.1f} s" for k, v in out["s"].items())
          + f"; done in {out['wall_s']:.1f} s ({gpu})")
    torch.cuda.empty_cache()
    return out


def kernels_report(r):
    """The ``kernels`` line: every kernel's launches by path, error, times
    and bound, from the results ``r`` of a run of every phase."""
    report = []
    for name, (sched, replaces) in KERNELS.items():
        per = r["times"][name]
        head = per[64]
        report.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "schedule": sched,
            "launches": r["launches"][name],
            "launches_by_path": {
                "serving": r["launches"][name],
                "training_serve": r["train"]["serve_launches"][
                    "fantastic4_matmul" if sched == "chain" else sched],
                "frontend": r["frontend"]["session"]["launches"][name],
                "lm": r["lm"]["kernel_launches"][name],
                **({"scale_out": r["scale_out"]["matmul_kernel_launches"]}
                   if sched == "chain" else {}),
                "autotune": r["autotune"]["sweep"]["launches"][name],
                "autotune_checks": r["autotune"]["sweep"][
                    "check_launches"][name],
                "autotune_lm": r["autotune"]["lm_sweep"]["launches"][
                    name]},
            "max_abs_err": r["max_err"][name],
            "int8_max_rel_err": r["max_rel8"][name],
            "ms": head["ms"], "kernel_ms": head["ms"],
            "device_ms": head["device_ms"],
            "device_ms_from": head["device_ms_from"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"],
            "library_device_ms_from": head["library_device_ms_from"],
            "at": "mlp-gsc batch 64 fp32",
            "by_batch": {str(b): v for b, v in per.items()},
            "smollm_shapes": {k: v for k, v in r["lm"]["ffn_timed"].items()
                              if v["schedule"] == sched}})
    head = r["ecl_times"]["mlp-gsc 7 tensors grouped"]
    report.append({
        "name": "ecl_quant", "route": "cuda", "source": ECL_SOURCE,
        "replaces": TPU_KERNELS + "ecl_quant.py:56",
        "launches": r["train"]["ecl_quant_launches"],
        "launches_by_path": {"training": r["train"]["ecl_quant_launches"],
                             "lm": r["lm"]["freeze"]["ecl_quant_launches"],
                             "lm_training": r["lm_train"]["ecl_quant_launches"],
                             "moe": r["moe"]["launcher"]["ecl_quant_launches"],
                             "moe_train": r["moe_train"]["ecl_quant_launches"]
                             + r["moe_train"]["ecl_quant_launches_export"],
                             "mla": r["mla"]["launcher"]["ecl_quant_launches"],
                             "mla_train": r["mla_train"]["ecl_quant_launches"]
                             + r["mla_train"]["ecl_quant_launches_export"],
                             **{f"ssm {a}": r["ssm"][a]["launcher"][
                                 "ecl_quant_launches"] for a in SSM_ARCHS},
                             **{f"ssm_train {a}": r["ssm_train"][a][
                                 "ecl_quant_launches"] + r["ssm_train"][a][
                                 "ecl_quant_launches_export"]
                                for a in SSM_ARCHS},
                             f"vlm {VLM_ARCH}": r["vlm_audio"][VLM_ARCH][
                                 "launcher"]["ecl_quant_launches"],
                             f"audio {AUDIO_ARCH}": r["vlm_audio"][
                                 AUDIO_ARCH]["freeze"]["ecl_quant_launches"],
                             **{f"vlm_audio_train {a}": r["vlm_audio_train"][
                                 a]["ecl_quant_launches"] + r[
                                 "vlm_audio_train"][a][
                                 "ecl_quant_launches_export"]
                                for a in (VLM_ARCH, AUDIO_ARCH)},
                             "scale_out": r["scale_out"][
                                 "ecl_quant_launches"],
                             "mesh_train": r["mesh_train"][
                                 "ecl_quant_launches"],
                             "tensor_parallel": r["tensor_parallel"][
                                 "ecl_quant_launches"],
                             "moe_tensor_parallel": r["moe_tp"][
                                 "ecl_quant_launches"],
                             "ssm_tensor_parallel": r["ssm_tp"][
                                 "ecl_quant_launches"],
                             "audio_tensor_parallel": r["audio_tp"][
                                 "ecl_quant_launches"],
                             "dryrun_step": r["autotune"]["dryrun"]["step"][
                                 "ecl_quant_launches"]},
        "max_abs_err": r["ecl_err"],
        "ms": head["ms"], "kernel_ms": head["ms"],
        "device_ms": head["device_ms"],
        "device_ms_from": head["device_ms_from"],
        "queued_ms": head["queued_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "at": "mlp-gsc 7 tensors, one grouped launch",
        "by_shape": r["ecl_times"],
        "smollm_freeze": r["lm"]["ecl_quant"],
        "grok_freeze": r["moe"]["ecl_quant"],
        "deepseek_freeze": r["mla"]["ecl_quant"],
        **{f"{a}_freeze": r["ssm"][a]["ecl_quant"] for a in SSM_ARCHS},
        **{name: {"pass": r[key]["ecl_quant_pass"],
                  **{k: r[key][k] for k in (
                      "ecl_quant_device_ms_per_step",
                      "ecl_quant_bound_ms_per_step", "quant_weights")}}
           for name, key in (("grok_share_training", "moe_train"),
                             ("smollm_training", "lm_train"),
                             ("deepseek_share_training", "mla_train"))},
        **{f"{a}_freeze": r["vlm_audio"][a]["ecl_quant"]
           for a in (VLM_ARCH, AUDIO_ARCH)},
        **{f"{a}_training": {"pass": r[key][a]["ecl_quant_pass"],
                             **{k: r[key][a][k] for k in (
                                 "ecl_quant_device_ms_per_step",
                                 "ecl_quant_bound_ms_per_step",
                                 "quant_weights")}}
           for key, archs in (("ssm_train", SSM_ARCHS),
                              ("vlm_audio_train", (VLM_ARCH, AUDIO_ARCH)))
           for a in archs}})
    return report


PHASES = ("2", "3", "3b", "4", "3c", "5", "6", "7", "8", "9", "10", "11",
          "12", "13", "14", "15", "16", "17", "18", "19", "20", "21")


def parse_phases(argv):
    """The phases ``--phases 1,10`` names (phase 1, the build, always
    runs; 3c needs 3b's trained pack, so naming it runs 3b too), or every
    phase without the argument."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after phase 1, "
                    f"of {','.join(PHASES)} (default: all)")
    args = ap.parse_args(argv)
    if args.phases is None:
        return set(PHASES)
    named = {p.strip() for p in args.phases.split(",") if p.strip()}
    unknown = named - set(PHASES) - {"1"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; have 1,"
                 f"{','.join(PHASES)}")
    if "3c" in named:
        named.add("3b")
    return named - {"1"}


def main(argv=None) -> int:
    phases = parse_phases(argv)
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

    # plans bind from the prior until phase 17 turns the sweep on
    set_tuning("prior")
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

    r = {}
    if "2" in phases:
        r["max_err"], r["max_rel8"] = check_kernels(dev)
        r["ecl_err"] = check_ecl_quant(dev)
    if "3" in phases:
        r["launches"], r["path"] = main_path(dev)
    if "3b" in phases:
        r["trained"], r["train"] = train_path(dev)
    if "4" in phases:
        r["times"], r["grid"] = timings(dev)
        r["floor"] = contract_floor(dev)
        r["ecl_times"] = ecl_timings(dev)
        r["step_timing"] = train_step_timing(dev)
        if "train" in r:
            r["train"]["step_timing"] = r["step_timing"]
    # the threaded phase runs after the single-stream timings
    steps = (("3c", "frontend", lambda: frontend_path(dev, r["trained"])),
             ("5", "lm", lambda: lm_path(dev)),
             ("6", "lm_train", lambda: lm_train_path(dev)),
             ("7", "moe", lambda: moe_path(dev, gpu)),
             ("8", "moe_train", lambda: moe_train_path(dev, gpu)),
             ("9", "mla", lambda: mla_serve_path(dev, gpu)),
             ("10", "mla_train", lambda: mla_train_path(dev, gpu)),
             ("11", "ssm", lambda: ssm_serve_path(dev, gpu)),
             ("12", "ssm_train", lambda: ssm_train_path(dev, gpu)),
             ("13", "vlm_audio", lambda: vlm_audio_serve_path(dev, gpu)),
             ("14", "vlm_audio_train",
              lambda: vlm_audio_train_path(dev, gpu)),
             ("15", "scale_out", lambda: scale_out_path(dev, gpu)),
             ("16", "mesh_train", lambda: mesh_train_path(dev, gpu)),
             ("17", "autotune", lambda: autotune_path(dev, gpu)),
             ("18", "tensor_parallel", lambda: tensor_parallel_path(dev, gpu)),
             ("19", "moe_tp", lambda: moe_tensor_parallel_path(dev, gpu)),
             ("20", "ssm_tp", lambda: ssm_tensor_parallel_path(dev, gpu)),
             ("21", "audio_tp",
              lambda: audio_tensor_parallel_path(dev, gpu)))
    try:
        for phase, key, run in steps:
            if phase in phases:
                r[key] = run()
    finally:
        _close_pool()

    if phases == set(PHASES):
        print(json.dumps({"grid": r["grid"], "contract_floor": r["floor"]}))
        print(json.dumps({"kernels": kernels_report(r)}))
    for key in ("path", "train", "frontend", "lm", "lm_train", "moe",
                "moe_train", "mla", "mla_train", "ssm", "ssm_train",
                "vlm_audio", "vlm_audio_train", "scale_out", "mesh_train",
                "autotune", "tensor_parallel", "moe_tp", "ssm_tp",
                "audio_tp"):
        if key in r:
            print(json.dumps({key: r[key]}))
    print(f"profiler traces: {TRACES['taken']} taken, {TRACES['retried']} "
          "retaken for want of the kernel's device time; "
          f"{TRACES['events']} device times from CUDA events for want of "
          f"a whole trace; {SPIN_RETAKEN['spins']} queued timings taken "
          "again behind a longer spin")
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
