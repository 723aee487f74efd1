#!/usr/bin/env python3
"""On-card smoke run of horovod_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py        # from the repo root, on a machine with one GPU

Drives the port's main path — one data-parallel gpt-small training step
at full width and depth (12 layers, 12 heads, emb 768, vocab 32000, bf16,
seq 1024, batch 8 per GPU, AdamW lr 1e-4) — its fp32 twin and gpt-nano's
bf16 step (head_dim 32), and holds every kernel of them against its plain
PyTorch version.  Nine kernels: the bf16 tensor-core forward, dK/dV and
dQ (``flash_fwd_tc``, ``flash_bwd_dkdv_tc``, ``flash_bwd_dq_tc``; bf16 at
head_dims 16/32/64), the fp32 3xTF32 tensor-core forward, dK/dV and dQ
(``flash_fwd_f32tc``, ``flash_bwd_dkdv_f32tc``, ``flash_bwd_dq_f32tc``;
fp32 at head_dims 16/32/64), and the scalar-FMA forward, dK/dV and dQ
(``flash_fwd``, ``flash_bwd_dkdv``, ``flash_bwd_dq``), which no route
reaches (``fa.OFF_ROUTE``): the tensor-core kernels' yardstick, forced
through their launch helpers.  Phases, one JSON line each:

1. ``build``: compile the CUDA kernels from ``horovod_tpu_torch/csrc``
   (one nvcc per source, all at once), print the seconds taken, each
   kernel's registers, spills and ptxas's wgmma serialization notes (none
   may appear), and the HGMMA (wgmma) and UTMALDG (TMA load) instructions
   in the six tensor-core libraries' SASS.
2. ``kernel_check``: each kernel against its plain version at ``SHAPES``:
   the bf16 main path (Z=96, S=1024, D=64, causal), a bf16 and an fp32
   GQA + window shape with a ragged S, the fp32 main shape (the same in
   fp32; the scalar twins there too, through their launch helpers),
   gpt-nano's head_dim 32 in fp32, bf16 at D=32 (the same as the main
   shape at gpt-nano's head_dim), gpt-nano's own bf16 attention (Z=128,
   S=256, D=32: ``train_nano``'s; the scalar twins forced at both)
   and a bf16 GQA + window and an MQA shape at D=32 and D=16.  Each kernel
   is timed at each of its routes' shapes (``RECORD_SHAPE``; the scalar
   twins at ``OFF_ROUTE_SHAPE``) beside the plain versions and the
   PyTorch library call (SDPA's flash kernels in bf16, its
   memory-efficient ones in fp32; a yardstick the port never calls);
   ``speedup``: every tensor-core kernel at least ``MIN_SPEEDUP`` x its
   scalar twin, that one forced through its launch helper on the same
   inputs, at gpt-small's size in each route's dtype and head_dim
   (``SPEEDUP_SHAPES``; reported at gpt-nano's).  ``tile_skip``: each kernel's time unmasked,
   causal and windowed; the masked runs must be faster by the tiles they
   skip.
3. ``model_check``: gpt-nano on the card, flash kernels against the plain
   reference attention: logits and gradients in fp32, and in bf16 (the
   tensor-core forward, dK/dV and dQ at head_dim 32) within
   ``NANO_BF16_SCALE_TOL`` of each tensor's scale, with its launches
   counted.
4. ``train``: ``init()``, ``build_gpt_step("small", "bf16", 8, 1024)``,
   2 warm-up and 5 timed steps; every loss finite, each main-path kernel
   launched 12 times per step, and the 7 losses within 1% of the same
   steps run with the plain reference attention.
5. ``profile``: one more step under ``torch.profiler``: device time by
   kernel, the device's busy share, host busy time by op (the phases
   below profile one step of each of their runs the same way).
   ``train_nano``: ``build_gpt_step("nano", "bf16", 32, 256)`` (3 layers,
   4 heads, emb 128: head_dim 32), the same 7 steps: exactly 3 launches a
   step of ``NANO_PATH`` and nothing else, losses within ``LOSS_RTOL`` of
   the same steps with reference attention, tokens/s/GPU, one profiled
   step (the device's busy share); phase ``launcher`` (12 below) runs
   the bench of gpt-nano that is this step's bench record.
   ``train_fp32``: ``build_gpt_step("small", "fp32", 8, 1024)``, TF32
   off, the same 7 steps: exactly 12 launches a step of the 3xTF32
   forward, dK/dV and dQ and nothing else, losses within
   ``FP32_LOSS_RTOL`` of the same steps with reference attention, step
   time, tokens/s/GPU, MFU at 67 TFLOP/s, peak memory, one profiled step
   (the flash kernels' share of device time).  ``bench``: ``python -m
   horovod_tpu_torch.bench --model gpt-small --dtype fp32`` once (beside
   ``obs``, see 17).
6. ``overlap``: the same 7 steps from the same weights and tokens through
   the backward-overlap plane, ``overlap_mode="bucket"`` and
   ``"bucket+zero1"`` (16 MB buckets): losses against ``train``'s within
   ``OVERLAP_LOSS_RTOL`` (and whether bit for bit), exact launch counts,
   step time, MFU, peak memory, the buckets, and the issue order: the
   bucket collectives issued on the host before the step's last
   ``flash_bwd_dkdv_tc`` launch, held at the buckets that hold no
   gradient produced after block 0's attention backward or more.
   ``spmd``: the same 7 steps written against the reference's SPMD
   surface (``spmd_step``): ``hvd.distribute(local_step)``, whose step
   takes the loss and gradients from ``hvd.sync_gradients`` and passes
   them through ``hvd.DistributedGradientTransform()`` into AdamW 1e-4:
   losses bit for bit ``train``'s (else within ``OVERLAP_LOSS_RTOL``; which
   held is printed), exact launches, and ``overlap``'s issue-order rule on
   the buckets ``sync_gradients`` reduces (at least one before the step's
   last dK/dV launch).  Its two examples of the reference's, each in its
   own process (``SPMD_EXAMPLES``: ``synthetic_benchmark --model resnet50
   --batch-size 64`` and ``bert_style --smoke``, each exiting 0), run
   later, beside ``lint`` and ``elastic``, and the phase's line is printed
   after them.  Printed: step ms, tokens/s/GPU, the examples' figures, the
   card.
7. ``rope_remat``: ``pos_embedding="rope"``, ``remat=True``,
   ``"bucket+zero1"``: ``flash_fwd_tc`` launched twice per layer and step
   (the recompute), the backward kernels once; losses within 1% of the
   same steps with the plain reference attention; peak memory no higher
   than the same run without remat.
   ``moe``: ``build_gpt_step("small", "bf16", 8, 1024, moe_experts=8)``
   (top 2, capacity factor 2, routing groups of 4096: the reference
   model's defaults), the same 7 steps: exactly 12 launches a step of
   ``MAIN_PATH`` (the MoE replaces the MLP, not the attention), the first
   loss within ``LOSS_RTOL`` and every loss within ``MOE_LOSS_RTOL`` of
   the same steps with reference attention, each block's aux loss at init
   in ``MOE_AUX_INIT``; step time, tokens/s/GPU, MFU by
   ``model_flops_per_step``'s MoE rule, memory, one profiled step, the
   routing einsums' and the experts' device ms (``moe_split``), the
   dropped share and the tokens whose experts the kernels' attention
   moves (``flipped``); then ``bench --model gpt-small --moe-experts 8``.
   ``parallel``: ``world_check.a11_checks`` at this world of one on
   gpt-small fp32 (TF32 off, batch 4, seq 1024): ring, zigzag and Ulysses
   attention, tensor parallelism, the GPipe, circular and tp-in-pp
   pipelines, expert parallelism and the sharded decode over axes of size
   one, each against the unsharded model (loss 1e-5, gradients 1e-4 of
   the largest), tp and the pipelines with exact fp32-route launches
   (``parallel_launches``).  The collectives between ranks are held by
   ``world_check --only a11`` on four cards.
8. ``conv``: the conv zoo, which runs no kernel of this repo (its
   convolutions are cuDNN's).  ``conv_check``: one SGD step of ResNet-18
   (batch 4, 64x64), ResNet-50 (batch 2, 64x64), VGG-16 (64x64) and
   Inception V3 (96x96, eval mode: see ``CONV_CHECKS``) in fp32 with TF32
   off, on the card and on the CPU from the same weights: logits, loss,
   every gradient, the updated parameters and running statistics within
   ``CONV_TOL``.  ``resnet``:
   ``build_step("resnet50", "bf16", 128, 224)``, 2 warm-up and 5 timed
   steps in ``off`` and ``bucket`` (16 MB buckets): every loss finite,
   ``bucket`` within ``OVERLAP_LOSS_RTOL`` of ``off``, the bf16 first
   loss within ``LOSS_RTOL`` of the same step in fp32 (TF32 off), no
   flash launch; images/s/GPU, MFU, memory, the buckets and their issue
   order, and one profiled step with the share of device time in cuDNN's
   layout conversions (0 if channels_last holds end to end).  ``zoo``:
   VGG-16 at 224 and Inception V3 at 299, bf16, batch 32, 1 warm-up and
   3 steps: finite losses, images/s/GPU.
9. ``reductions``: ``train``'s 7 steps from its weights and tokens through
   ``DistributedOptimizer(op=Adasum)`` and ``OverlapPlan`` with
   ``hierarchical_axes=(LOCAL_AXIS, CROSS_AXIS)`` in ``bucket``,
   ``bucket+zero1`` and ``bucket`` with a bf16 cross leg: exact launches,
   finite losses, the first three bit for bit ``train``'s (at world 1
   Adasum is the identity on fp32 gradients and both group legs reduce
   nothing), the bf16 one within ``LOSS_RTOL``; step time, busy share,
   peak memory.  Then an ``nn.Embedding(sparse=True)`` trained by SGD
   under ``sparse_as_dense`` True and False: the same weights.
10. ``eager``: ``train``'s 7 steps from its weights and tokens through the
   ``horovod.torch`` script's optimizer, ``interop.torch.
   DistributedOptimizer(named_parameters=...)``: each parameter's
   post-accumulate-grad hook enqueues ``allreduce_async`` on the eager
   engine under ``allreduce.<name>`` (149 a step), ``step()`` synchronizes
   and writes the results back; exact launches, losses bit for bit
   ``train``'s (the world-1 engine resolves every allreduce to its input,
   scale 1), gradients on the card; step time, busy share, peak memory.
   Then every eager op on CUDA tensors (result on the card, the input's
   dtype), and the engine's data plane on a 1-rank NCCL group: one fused,
   pre- and post-scaled allreduce of a block's gradients run as the engine
   runs it, against its plain version (bit for bit), with the payloads
   written late on the caller's stream (the engine's stream waits on their
   ready events) and ``synchronize`` returning while the caller's stream
   is still busy (the result is ordered on the stream, not the host).
   ``native``: the same optimizer on the native (C++) eager engine
   (``HVDTPU_EAGER_ENGINE=native``), its library built from
   ``horovod_tpu_torch/csrc/engine`` by ``runtime/native_build.py`` beside
   the kernels' build in phase ``build`` (its seconds printed here).  (i) World 1, in this process: ``eager``'s 7 steps
   from ``train``'s weights and tokens; exact launches, losses bit for bit
   ``train``'s, 149 handles a step (each gradient crosses to the host and
   back: the TCP wire carries host bytes; at one rank the C++ allreduce
   returns at once), gradients on the card; the step ms beside
   ``eager``'s, the engine's host payloads and bytes a step.  (ii) World
   2 on the one card: ``python -m horovod_tpu_torch.run -np 2 python
   chip_smoke.py --native-worker OUT``; each rank opens a gloo world (NCCL
   puts no two ranks on one card), builds the same model on ``cuda:0``
   and takes ``NATIVE_WARMUP`` + ``NATIVE_STEPS`` steps of the hook
   optimizer on ``train``'s tokens, so every gradient crosses the engine's
   TCP ring.  Gates: every loss of both ranks bit for bit ``train``'s (the
   mean of two equal fp32 gradients is exact), the SHA-256 of the
   parameters equal across the ranks, exactly 12 launches a step of each
   of ``MAIN_PATH`` on each rank, 149 handles a step, gradients on the
   card.  Printed: each step's ms, fused responses, cycles and wire bytes
   (``hvdtpu_perf_bytes``), per rank.  Then, in the same two-rank world,
   the collective microbench's CUDA payload leg on the native engine
   (``bench.collective.measure``: ``NATIVE_BENCH_ITERS`` allreduces of
   each of ``NATIVE_BENCH_KB`` on ``cuda:0``, each a host round trip
   around the TCP ring): every result on both ranks exactly 2 x the input;
   printed: each rank's goodput and engine counters by size, and the
   reference's goodput table (rank 0).
11. ``fp8``: gpt-small ``--dtype fp8`` (e4m3 storage of the attention
   context, the branch deltas and the GELU output; 12 launches of each
   flash kernel a step) from ``train``'s weights and tokens, and ResNet-50
   fp8 (every ReLU output) from the ``resnet`` phase's, each against its
   bf16 run with the reference's ``test_fp8.py`` gates (first loss within
   2%, later ones within 15% + 0.05, finite); step time, rate, MFU, peak
   memory beside bf16's.  Then ``act_store`` on the card against the CPU
   on ``act_store_grid``, values and gradients, NaN where NaN.

12. ``launcher`` (beside ``obs``, see 17; it runs ``train_nano``'s bench):
   the port's launcher, ``python -m horovod_tpu_torch.run``:
   ``--check-build`` (NCCL, gloo, the card and the built kernels must be
   reported), then ``-np 1 python -m horovod_tpu_torch.bench --model
   gpt-nano --seq-len 256 --batch-size 32``, whose record, read back
   through the launcher's ``[0]`` output tag, must show the launcher's
   rendezvous environment, ``cuda:0`` and exactly ``NANO_PATH``, 3 a step.
   Phase ``lint`` (17) runs beside ``elastic``.
   ``elastic``: gpt-small bf16 as ``train`` builds it, 6 steps under
   ``elastic.run`` from an ``elastic.State`` of the model, AdamW, the step
   and the losses (step k's tokens from ``RandomState(k)``; a commit every
   4 steps, the replica pushed at each; a sharded save at step 4), run
   three times, side by side, through ``python -m horovod_tpu_torch.run
   --elastic -np 1 --ckpt-dir D --ckpt-replica python chip_smoke.py
   --elastic-worker``:
   clean; with rank 0 killed in step 6 (``worker_exit:step=6:rank=0``),
   where the respawned worker restores from its peer replica; and with
   that kill and every replica push dropped, where it restores from the
   ``hvdtpu-sharded-ckpt-v1`` manifest on disk.  The faulted runs' 6
   losses, parameters and AdamW state must equal the clean run's bit for
   bit, every incarnation must launch exactly ``MAIN_PATH`` (12 a step),
   and the launcher must respawn once in each faulted run and never in
   the clean one.  Printed: the snapshot's bytes, commit, replica push,
   sharded save and restore times, time to recover, the median step
   beside ``train``'s, each run's wall time.  The workers load the
   kernels this run built and compile none.

13. ``serve_check`` (fp32, TF32 off): the serving path, which runs no
   kernel of this repo (decode and prefill attention are fp32 einsums, as
   the reference's).  gpt-small (reference attention, seed-0 weights) in
   a contiguous ``SlotEngine`` of 8 slots serving 12 greedy requests of
   16 tokens (prompts of ``RandomState(0).randint(16, 257)`` tokens): each
   emission's logit row (the first token's and the decoded ones') within
   ``SERVE_LOGIT_RTOL`` x max |logit| of a teacher-forced ``GPT.forward``
   over prompt + tokens, every token by the margin rule (``margin_rule``)
   at ``SERVE_FP32_MARGIN`` against it, and the same gate rejecting a
   planted fault (``planted_fault``); then the same engine and
   requests at 2 layers on the card and on the CPU from the same weights:
   logits of every emission within ``SERVE_LOGIT_RTOL``, tokens by the
   margin rule.
14. ``serve`` (bf16): gpt-small as ``train`` builds it (learned positions,
   seed 0) behind a 16-slot ``SlotEngine``, contiguous (``cache_len``
   1024) and then paged (512 pages of 16 rows, half the worst case, so
   admission waits for pages), serving 48 requests enqueued at step 0
   (prompts of ``randint(16, 769)`` tokens, budgets ``randint(16, 129)``,
   every 4th request sampled at temperature 0.8, top-k 50) through the
   scheduler loop: every request ends with exactly its budget of tokens
   in range, no NaN logit, no kernel launch, the paged streams equal the
   contiguous ones bit for bit, and each greedy stream, whole, passes the
   margin rule at ``SERVE_BF16_MARGIN`` against a teacher-forced bf16
   forward (flash kernels); the same gate must reject a planted fault
   (``planted_fault``).  Printed: wall seconds, requests/s, generated
   tokens/s, the median decode-step ms (CUDA events and host clock) at 16
   active slots, prefill ms by prompt bucket (these timed numbers include
   the NaN tap's three small launches per engine call), ``kv_stats`` at
   the step of most live rows (read after the loop), peak memory, and,
   untapped, one decode step and one 512-token admission profiled as
   ``profile_step`` does.
15. ``sampler_check``: ``ops/prng.py`` and ``serve/sampling.py`` on the
   card against the CPU: keys, folds, splits, 32000 random bits and the
   uniform draws equal on a grid of seeds, rids and emission indices;
   Gumbel noise within ``GUMBEL_ULPS`` ulp (at the scale max(|g|, 1)) of
   ``-log(-log(u))`` in float64 on those draws (the CPU's float32 noise
   measured against it, not gated: it has been 840 ulp off on the card's
   host); ``sample_token`` on 256 rows of 32000 fp32 logits, the tokens
   by the margin rule at 1e-5 against the float64 scores.
16. ``serve_fleet``: the serving plane end to end, which runs no kernel of
   this repo.  gpt-small bf16 (full width and depth, seed-0 weights; 16
   slots, 512 pages of 16) served by two ranks on the one card through
   ``python -m horovod_tpu_torch.run --elastic --serve -np 2 --frontends 2
   -- python -m horovod_tpu_torch.serve --size small ...``; a
   ``ServeClient`` on the launcher's store (its endpoint from the
   launcher's output, its secret the ``HVDTPU_SECRET`` this script gave
   the launcher) submits one warm-up request, then the ``serve`` phase's
   48 requests open loop (exponential gaps at ``FLEET_RATE`` a second).
   (a) Clean: every request done with exactly its budget of tokens in
   range, both ranks' summaries back, no kernel launched by a rank, each
   greedy stream whole by the margin rule at ``SERVE_BF16_MARGIN``
   against the teacher-forced bf16 forward, the sampled streams' forward
   finite.  (c) In the same fleet, a second version of the weights (seed
   ``FLEET_SWAP_SEED``) published with ``publish_weights`` into
   ``--serve-weights-dir``: both ranks report the same single flip, and
   ``FLEET_SWAP_REQUESTS`` greedy requests admitted after it pass the
   margin rule against the new weights' forward.  (b) A second fleet, the
   same traffic, the leader killed mid-stream (``FLEET_KILL``): one
   failure and one respawn, no request dropped, some finished in epoch >=
   1, every greedy stream by the margin rule between engines against (a)'s
   (and whole against the forward); the sampled streams equal to (a)'s bit
   for bit are counted, not gated.  (d) ``python -m
   horovod_tpu_torch.bench --serve --model gpt-small`` (the same pool) at
   half the ``serve`` phase's paged requests/s.  Printed: each run's
   generated tokens/s and requests/s, TTFT and TPOT medians and p99 (client
   clock), the schedule broadcast's host-clock ms on each rank, the time
   from the kill to the first token after it, the flip's step, the card
   beside each.

17. ``obs``: the observability planes (after ``elastic``).  (i) gpt-small
   bf16 (``GPT_STEP``, full width and depth) in ``bucket`` mode, 6 steps
   through ``python -m horovod_tpu_torch.run -np 1 python chip_smoke.py
   --obs-worker`` twice: with every observability flag off, and with
   ``--metrics-dump``, ``--flightrec-dump``, ``--trace`` (sample rate 1),
   ``--stats-summary``, ``--live-stats-secs 0.5``, ``--live-history-file``,
   ``--health on``, ``--health-check-steps 2`` and ``--divergence-action
   halt``.  Gates: both exit 0; the losses equal bit for bit; each run
   launches exactly ``MAIN_PATH``, 12 a step; each step's health bundle
   has the step's loss, a ``grad_norm`` within ``OBS_GRAD_RTOL`` of the
   norm of the reduced gradients taken independently (fp32, accumulated in
   fp64) and ``nonfinite`` 0; the on-card digest of the parameters equals
   the numpy host digest of the same parameters; the metrics dump parses,
   the summary prints its health section, the merged trace is JSON with
   one step span per step, the live history has a round, and no
   ``postmortem.json`` is written.  (ii) Two elastic gpt-nano bf16 ranks
   sharing the card, their gradients averaged over the launcher's KV store
   (``elastic.context().allreduce``), ``OBS_ELASTIC_STEPS`` steps under
   ``--health on``, run 3 times: clean (no alert); with
   ``grad_ready:rank=1:step=3:action=flip_bits`` and ``--divergence-action
   dump``, where both ranks name rank 1, the same bucket and leaf (the
   leaf the flipped element lies in), and each rank's ring dump holds the
   divergence; with ``worker_exit:rank=1:step=3:action=abort`` and no
   respawn, where the launcher exits non-zero and ``postmortem.json``
   blames rank 1 (the three launchers side by side, and beside (i)).
   Printed: step ms with and without the flags (host clock around a
   device synchronize, contended), the phase's wall time, the card.
   Beside ``obs``, each in a thread of its own: ``launcher``, the
   gpt-small fp32 ``bench`` (5), ``campaign`` and ``estimator`` (18): all
   gates around processes that start on the card, so their step times
   are taken contended; the serving phases after them time their traffic
   and run alone.
   ``lint`` (side by side with ``elastic``, whose times are contended
   already): the port's hvdtpu-lint and its schedule gate.  (i) ``python -m horovod_tpu_torch.analysis --jobs 0`` over the
   port's surface (``horovod_tpu_torch/`` and this script) in a
   subprocess on the card's host: exit 0 against
   ``horovod_tpu_torch/analysis/baseline.json``.  (ii) Beside it,
   ``GPT_STEP`` in ``bucket`` mode for ``LINT_STEPS`` steps through
   ``python -m horovod_tpu_torch.run -np 1 python chip_smoke.py
   --lint-worker`` with torch's flight recorder on (NCCL), the rank's
   collective schedule dumped after the build and after each step
   (``obs.collective_schedule``): every step's slice issues the same
   sequence (``analysis.schedule.diff_schedules``), one ``all_reduce`` per
   bucket of the plan (of the bucket's elements) and one of the loss, and
   nothing else; exactly ``MAIN_PATH``, 12 a step; ``python -m
   horovod_tpu_torch.analysis.schedule`` exits 1 on a copy of the last
   dump with one bucket's entry dropped and 0 on two copies of it.
   Printed: the rule count, the findings by status and rule, the lint's
   seconds, each step's collectives, the phase's wall time, the card.
   ``bench_supervisor`` (beside ``lint`` and ``elastic``): ``python -m
   horovod_tpu_torch.bench --model gpt-small --warmup 100000
   --total-budget-secs 0`` with ``HVDTPU_BENCH_RECORD_DIR`` and
   ``HVDTPU_BENCH_SIDECAR`` in a temporary directory: the watchdog's
   daemon thread, at its first tick, must give up while the main thread
   works on the card: exit 86, no re-exec, a sidecar naming the phase
   (``init``, ``build`` or ``warmup``: the budget does not cap
   ``measure``, which the long warm-up keeps the run from reaching) with
   ``outcome: gave_up``, one degraded ``BENCH_r01.json`` with that
   ``failure_phase``, rc 86 and provenance ``gpu`` (or none, never the
   CPU), and no file written into the checkout.

18. ``anatomy`` (after ``serve_fleet``; runs nothing new): the
   ``anatomy`` block of every bench record above (gpt-nano bf16,
   gpt-small fp32, MoE-8, ``bench --serve``): its components tile
   ``step_ms`` within ``ANATOMY_RTOL``, compute is MFU x step (method
   ``"mfu x step"``), the roofline is no estimate on the H100, and
   ``top_ops`` names the route's flash kernels at their launches a step
   (none for the serving record).  Printed: each record's host-gap share
   (ROADMAP C14).  ``campaign``: ``python -m horovod_tpu_torch.bench
   --campaign`` on gpt-small bf16 (``GPT_STEP``, full width and depth)
   over ``overlap`` in {off, bucket} at 16 MB buckets, two points, each a
   bench process on the card: both ``done``, each record with
   ``attention == "kernels"``, ``MAIN_PATH``'s launches for its steps, an
   ``anatomy`` block and the regression sentinel's ``regression`` and
   ``baseline_record`` (each point gets its budget as
   ``--total-budget-secs`` and the journal's directory as its record
   dir, which holds no degraded record after the clean campaign); then
   the same spec again, which runs no point
   and leaves the journal (``spec_sha`` included) as it was.  Printed:
   each point's tokens/s/GPU beside this call's ``train`` and ``overlap``
   numbers.  ``estimator``: (i) the reference estimator test's MLP on its
   blobs, ``backend="local"`` on the card (fp32, TF32 off): every epoch's
   loss within ``EST_LOSS_TOL`` of the same fit on the CPU (a launcher
   worker with the GPUs hidden), and ``Model.load`` from the
   ``LocalStore`` predicting bit for bit what the fitted Model does; (ii)
   gpt-small bf16 (seq 1024, batch 8, 32 sequences of ``RandomState(0)``
   tokens, 1 epoch of 4 steps, next-token loss) with
   ``backend="launcher"``, ``np_workers=1``: a finite loss, exactly
   ``train``'s launches a step of ``MAIN_PATH`` in the worker (read at
   each loss call), the final checkpoint in the store.  ``autoscale``:
   ``python -m horovod_tpu_torch.run --elastic --serve --serve-autoscale
   -np 1 --max-workers 2`` (``AUTOSCALE_FLAGS``) with ``serve_fleet``'s
   fleet; the ``serve`` phase's 48 requests arrive as a backlog at t = 0,
   the queue grows the world to two ranks on the card and the drain
   shrinks it back.  Gates: one scale-up and one scale-down, the live
   digest's world tokens 1 -> 2 -> 1, no request dropped, every budget
   met, greedy streams by the margin rule at ``SERVE_BF16_MARGIN``
   against the teacher-forced forward, rank 1 released, the summary's
   autoscale section.  Printed: the time from the grow decision to the
   grown world's first step, and tokens/s, TTFT p50/p99 and TPOT p50
   before and after the grow.

``processes``: the script is the subreaper of every process it starts
(an orphan is re-parented to it, not to init), and at its end, whether
the phases passed or not, it stops every process still below it (SIGTERM,
then SIGKILL after 5 s) and reaps it.  Printed: those still running, with
their command lines.

Then the ``kernels`` summary, one record per kernel and route shape (its
launches from that route's run: ``train`` at ``bf16_main`` (with the
``moe`` phase's, ``native`` (i)'s and ``spmd``'s beside them),
``train_fp32`` at ``fp32_main``, ``train_nano`` at ``bf16_nano``; the
scalar twins' from ``train_nano``, which must launch them 0 times), the
card's name and power limit, and ``{"ok": true, ...}`` as the
last line.  Any failure raises and exits
nonzero; without a GPU it exits 2 and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import subprocess
import sys
import threading
import time

H100_BF16_PEAK = 989e12     # FLOP/s, dense, H100 SXM data sheet
# fp32-accurate products on the tensor cores: 3xTF32 takes three TF32
# products (495 TFLOP/s) for each
H100_TF32X3_PEAK = 495e12 / 3
H100_FP32_PEAK = 67e12      # fp32 FMA, outside the tensor cores
H100_HBM_BYTES = 3.35e12    # B/s

# (atol, rtol) of |kernel - plain| <= atol + rtol * |plain|, elementwise.
# bf16: the outputs are rounded to bf16 (8 bits of mantissa) after fp32
# sums taken in another order than the plain version's, and the
# tensor-core kernels also round P and dS to bf16 before their second
# product; fp32: sums in another order only.
TOL = {"bf16": (1e-2, 1e-2), "fp32": (1e-4, 1e-4), "lse": (1e-3, 0.0)}

# what each kernel replaces (horovod_tpu/ops/flash_attention.py) and the
# launch helper's pass name
SOURCES = {
    "flash_fwd_tc": ("horovod_tpu_torch/csrc/flash_fwd_tc.cu",
                     "horovod_tpu/ops/flash_attention.py:158"),
    "flash_bwd_dkdv_tc": ("horovod_tpu_torch/csrc/flash_bwd_dkdv_tc.cu",
                          "horovod_tpu/ops/flash_attention.py:291"),
    "flash_bwd_dq_tc": ("horovod_tpu_torch/csrc/flash_bwd_dq_tc.cu",
                        "horovod_tpu/ops/flash_attention.py:324"),
    "flash_fwd": ("horovod_tpu_torch/csrc/flash_fwd.cu",
                  "horovod_tpu/ops/flash_attention.py:158"),
    "flash_bwd_dkdv": ("horovod_tpu_torch/csrc/flash_bwd_dkdv.cu",
                       "horovod_tpu/ops/flash_attention.py:291"),
    "flash_bwd_dq": ("horovod_tpu_torch/csrc/flash_bwd_dq.cu",
                     "horovod_tpu/ops/flash_attention.py:324"),
    "flash_fwd_f32tc": ("horovod_tpu_torch/csrc/flash_fwd_f32tc.cu",
                        "horovod_tpu/ops/flash_attention.py:158"),
    "flash_bwd_dkdv_f32tc": ("horovod_tpu_torch/csrc/flash_bwd_dkdv_f32tc.cu",
                             "horovod_tpu/ops/flash_attention.py:291"),
    "flash_bwd_dq_f32tc": ("horovod_tpu_torch/csrc/flash_bwd_dq_f32tc.cu",
                           "horovod_tpu/ops/flash_attention.py:324"),
}
PASS = {"flash_fwd_tc": "fwd", "flash_fwd": "fwd", "flash_fwd_f32tc": "fwd",
        "flash_bwd_dkdv_tc": "dkdv", "flash_bwd_dkdv": "dkdv",
        "flash_bwd_dkdv_f32tc": "dkdv",
        "flash_bwd_dq_tc": "dq", "flash_bwd_dq": "dq",
        "flash_bwd_dq_f32tc": "dq"}
# tensor-core kernel -> the scalar kernel of the same function, timed at the
# tensor-core kernel's own shapes, in its dtype (``RECORD_SHAPE``)
SCALAR_TWIN = {"flash_fwd_tc": "flash_fwd",
               "flash_bwd_dkdv_tc": "flash_bwd_dkdv",
               "flash_bwd_dq_tc": "flash_bwd_dq",
               "flash_fwd_f32tc": "flash_fwd",
               "flash_bwd_dkdv_f32tc": "flash_bwd_dkdv",
               "flash_bwd_dq_f32tc": "flash_bwd_dq"}
MIN_SPEEDUP = 3.0
# the peak of a bound, by the dtype of the shape a kernel's record is taken
# at: bf16 work at the bf16 tensor-core rate, fp32 work at the 3xTF32 one
# (the rate fp32-accurate work can reach on this card)
PEAK = {"bf16": H100_BF16_PEAK, "fp32": H100_TF32X3_PEAK}


def act_store_grid(dtype):
    """The inputs ``act_store`` is held on (a CPU tensor of ``dtype``):
    in bf16 every value of magnitude up to 1024, subnormals included; in
    another dtype every e4m3 value, every midpoint between two neighbours
    (the rounding boundaries), the neighbours of each in ``dtype``, and
    448..1024 around 464, where XLA's conversion turns to NaN; both signs
    of each, then +-inf and nan."""
    import torch

    if dtype == torch.bfloat16:
        # bf16 bit patterns 0 .. 0x4480 (= 1024.0) in order of magnitude
        pos = torch.arange(0, 0x4481, dtype=torch.int16).view(torch.bfloat16)
    else:
        e4m3 = torch.arange(0, 256, dtype=torch.int32).to(torch.uint8).view(
            torch.float8_e4m3fn).float()
        vals = torch.unique(e4m3[torch.isfinite(e4m3) & (e4m3 >= 0)])
        mids = (vals[1:] + vals[:-1]) / 2
        edge = torch.tensor([448.0, 456.0, 464.0, 472.0, 480.0, 1024.0])
        base = torch.cat([vals, mids, edge]).to(dtype)
        inf = torch.tensor(float("inf"), dtype=dtype)
        pos = torch.unique(torch.cat([base, torch.nextafter(base, inf),
                                      torch.nextafter(base, -inf)]))
        pos = pos[pos >= 0]
    special = torch.tensor([float("inf"), float("-inf"), float("nan")],
                           dtype=dtype)
    return torch.cat([pos, -pos, special])


T0 = time.perf_counter()


_EMIT = threading.Lock()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started
    (whole, when two phases run side by side)."""
    line = json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0,
                       **fields})
    with _EMIT:
        print(line, flush=True)


def adopt_descendants() -> None:
    """Make this process the subreaper of every process it starts: one
    orphaned by its parent's exit (a bench that gave up with ``os._exit``,
    a launcher killed at its timeout) is re-parented here rather than to
    init, so :func:`stop_descendants` finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:  # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _descendants() -> dict:
    """pid -> (state, command line) of every live or zombie process below
    this one, read from /proc."""
    import os

    parent, info = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        parent[int(d)] = int(fields[1])
        info[int(d)] = (fields[0], cmd.strip()[:200])
    below, frontier = {}, [os.getpid()]
    while frontier:
        kids = [p for p, pp in parent.items() if pp in frontier]
        below.update({p: info[p] for p in kids})
        frontier = kids
    return below


def stop_descendants(grace: float = 5.0, failed: bool = False) -> list:
    """Stop every process still running below this one: SIGTERM, then
    SIGKILL after ``grace`` seconds, reaping each; the ones that were
    running, as {pid, state, cmd}, on the ``processes`` line (on stderr
    when the script ``failed``: it prints no result then)."""
    import os
    import signal

    left = [{"pid": p, "state": s, "cmd": c}
            for p, (s, c) in sorted(_descendants().items()) if s != "Z"]
    deadline = time.monotonic() + grace
    sig = signal.SIGTERM
    while True:
        live = [p for p, (s, _) in _descendants().items() if s != "Z"]
        for p in live:
            try:
                os.kill(p, sig)
            except ProcessLookupError:
                pass
        while True:  # reap this process's children, adopted ones included
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break
        if not live and not _descendants():
            break
        if time.monotonic() > deadline + 10:
            raise RuntimeError(f"processes that outlive SIGKILL: "
                               f"{_descendants()}")
        if time.monotonic() > deadline:
            sig = signal.SIGKILL
        time.sleep(0.1)
    if failed:
        print(json.dumps({"phase": "processes", "left_running": left}),
              file=sys.stderr, flush=True)
    else:
        emit("processes", left_running=left)
    return left


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, CUDA
    events around the batch, after ``warmup`` calls.  The batch is queued
    behind a device-side sleep, so the host's launch overhead between calls
    does not show as device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms of cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, tol) -> float:
    """Max |got - want|; raises if any element is outside the tolerance."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol, rtol = tol
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {err.max().item()}")
    return err.max().item()


def launcher(fa, name, q, k, v, o, lse, do, cfg):
    """One launch of kernel ``name`` through its launch helper, into
    scratch outputs; ``cfg`` is (causal, scale, h, hkv, window).  A dQ
    kernel's launches follow one dK/dV launch, as in ``flash_bwd``: it
    fills the (lse, delta) pairs that the tensor-core dQ reads, outside
    the timed launches."""
    import torch

    if PASS[name] == "fwd":
        o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
        return lambda: fa.launch_fwd(q, k, v, o2, lse2, *cfg, kernel=name)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if PASS[name] == "dkdv":
        pairs = fa.pair_scratch(q)
        return lambda: fa.launch_dkdv(q, k, v, o, lse, do, dk, dv, *cfg,
                                      kernel=name, pairs=pairs)
    pairs = fa.launch_dkdv_for_dq(name, q, k, v, o, lse, do, dk, dv, *cfg)
    dq = torch.empty_like(q)
    return lambda: fa.launch_dq(q, k, v, o, lse, do, dq, *cfg, kernel=name,
                                pairs=pairs)


# The kernels skip the (Q, K) tiles their masks rule out, and that shows in
# their times.  A causal mask leaves about half the tiles and a 64-key
# window a small band of the causal ones; a kernel that visited every tile
# would take as long masked as not.  The check runs at S = 4096: at the
# main path's S = 1024 the tensor-core kernels come near their byte floor,
# which no mask lowers (every row of q, k, v, o and dO is still read
# once), so there the ratios are reported, not held.
SKIP_WINDOW = 64
SKIP_LIMITS = {"causal_over_full": 0.7, "window_over_causal": 0.5}
SKIP_SHAPE = {"b": 2, "s": 4096, "h": 12, "d": 64}
MAIN_SHAPE = {"b": 8, "s": 1024, "h": 12, "d": 64}
# dtype each kernel is timed in, at head_dim 64: a dtype of its route (the
# scalar twins, on no route, in bf16, the dtype of the bf16 tensor-core
# kernels they are the twins of)
SKIP_DTYPE = {"flash_fwd_tc": "bf16", "flash_bwd_dkdv_tc": "bf16",
              "flash_bwd_dq_tc": "bf16", "flash_fwd": "bf16",
              "flash_bwd_dkdv": "bf16", "flash_bwd_dq": "bf16",
              "flash_fwd_f32tc": "fp32", "flash_bwd_dkdv_f32tc": "fp32",
              "flash_bwd_dq_f32tc": "fp32"}


def mask_times(fa, names, b, s, h, d, dtype):
    """Device ms of each kernel in ``names`` unmasked, causal and with a
    ``SKIP_WINDOW``-key band, on one set of inputs."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b * h, s, d, device="cuda",
                               generator=g).to(dtype) for _ in range(4))
    ms = {}
    for mask, (causal, window) in {"full": (False, None),
                                   "causal": (True, None),
                                   "window": (True, SKIP_WINDOW)}.items():
        cfg = (causal, d ** -0.5, h, h, window)
        o, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5, s, s, h, h, window)
        ms[mask] = {n: cuda_ms(launcher(fa, n, q, k, v, o, lse, do, cfg), 10)
                    for n in names}
    return ms


def ratios_of(ms):
    return {n: {"causal_over_full": ms["causal"][n] / ms["full"][n],
                "window_over_causal": ms["window"][n] / ms["causal"][n]}
            for n in ms["full"]}


def tile_skip(fa):
    """Each kernel's device time unmasked, causal and windowed at
    ``SKIP_SHAPE``, in the dtype of ``SKIP_DTYPE``.  Raises unless each
    masked run is as much faster as ``SKIP_LIMITS`` says; returns the times
    and ratios per kernel, and the bf16 tensor-core kernels' ratios at the
    main shape (reported only)."""
    import torch

    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    ms = {"full": {}, "causal": {}, "window": {}}
    for tname, dt in dts.items():
        names = [n for n, t in SKIP_DTYPE.items() if t == tname]
        for mask, row in mask_times(fa, names, dtype=dt,
                                    **SKIP_SHAPE).items():
            ms[mask].update(row)
    ratios = ratios_of(ms)
    main = ratios_of(mask_times(fa, list(MAIN_PATH), dtype=torch.bfloat16,
                                **MAIN_SHAPE))
    bad = {n: r for n, r in ratios.items()
           if any(r[key] >= lim for key, lim in SKIP_LIMITS.items())}
    if bad:
        raise AssertionError(f"masked tiles are not skipped: {bad} "
                             f"(limits {SKIP_LIMITS})")
    return ms, ratios, main


def attention_work(b, s, h, hkv, d, causal, window, itemsize,
                   pairs_read=True):
    """FLOPs of each kernel's products and the bytes it must move (each
    of its inputs read once, each of its outputs written once) on these
    shapes; only the (q, k) pairs the masks leave alive count.  Keyed by
    kernel: the tensor-core backward kernels move other tensors than their
    scalar twins (dK/dV's pre-pass also writes the (lse, delta) pairs, dQ
    reads them in place of o and lse).  *pairs_read*: whether the route's
    dQ reads those pairs (the bf16 tensor-core dQ does; a dQ that
    recomputes delta does not, and then writing them is no part of
    dK/dV's work)."""
    import torch

    qp = torch.arange(s)[:, None]
    kp = torch.arange(s)[None, :]
    alive = torch.ones(s, s, dtype=torch.bool)
    if causal:
        alive &= kp <= qp
    if window:
        alive &= kp >= qp - (window - 1)
    pairs = int(alive.sum()) * b * h
    q_bytes = b * h * s * d * itemsize
    kv_bytes = b * hkv * s * d * itemsize
    lse_bytes = b * h * s * 4
    # [Z, S rounded up to 64] float2 (lse, delta): fa.pair_scratch
    pair_bytes = b * h * -(-s // 64) * 64 * 8
    # S = QK^T and O = PV: q, k, v in; o, lse out
    fwd = (4 * d * pairs, q_bytes + 2 * kv_bytes + q_bytes + lse_bytes)
    # S, dP = dO V^T, dV = P^T dO, dK = dS^T Q: q, o, dO, k, v, lse in;
    # dk, dv out
    dkdv = (8 * d * pairs, 3 * q_bytes + 2 * kv_bytes + lse_bytes
            + 2 * kv_bytes)
    # S, dP, dQ = dS K: q, o, dO, k, v, lse in; dq out
    dq = (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + lse_bytes + q_bytes)
    return {
        "flash_fwd_tc": fwd, "flash_fwd": fwd, "flash_fwd_f32tc": fwd,
        "flash_bwd_dkdv_tc": (dkdv[0],
                              dkdv[1] + (pair_bytes if pairs_read else 0)),
        "flash_bwd_dkdv": dkdv, "flash_bwd_dkdv_f32tc": dkdv,
        # q, dO, k, v and the pairs in; dq out
        "flash_bwd_dq_tc": (dq[0], dq[1] - q_bytes - lse_bytes + pair_bytes),
        "flash_bwd_dq": dq, "flash_bwd_dq_f32tc": dq,
    }


def bound(flops: int, nbytes: int, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# gpt-nano at full width and depth (3 layers, 4 heads, emb 128, so head_dim
# 32; vocab 1024), bf16, its max_len 256 as seq, batch 32 per GPU: the
# bf16 route at head_dim 32, the tensor-core forward, dK/dV and dQ
NANO_STEP = ("nano", "bf16", 32, 256)
NANO_PATH = ("flash_fwd_tc", "flash_bwd_dkdv_tc", "flash_bwd_dq_tc")


# The shapes kernel_check holds the kernels at: the kernels of each one's
# route (``fa.kernel_for``) and those it "forced", launched through their
# launch helpers off their route: the scalar twins of the tensor-core
# kernels (``SCALAR_TWIN``) at those kernels' shapes.  A "timed" shape
# times them all.
SHAPES = (
    dict(name="bf16_main", b=8, s=1024, h=12, hkv=12, d=64, dtype="bf16",
         causal=True, window=None, timed=True,
         forced=("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")),
    # GQA + sliding window, S not a multiple of any tile
    dict(name="bf16_gqa_window", b=2, s=300, h=8, hkv=2, d=64,
         dtype="bf16", causal=True, window=100, timed=False, forced=()),
    dict(name="fp32_gqa_window", b=2, s=300, h=8, hkv=2, d=64,
         dtype="fp32", causal=True, window=100, timed=False, forced=()),
    dict(name="fp32_main", b=8, s=1024, h=12, hkv=12, d=64, dtype="fp32",
         causal=True, window=None, timed=True,
         forced=("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")),
    # gpt-nano's head_dim in fp32
    dict(name="fp32_d32", b=4, s=256, h=4, hkv=4, d=32, dtype="fp32",
         causal=True, window=None, timed=False, forced=()),
    # gpt-small's size at gpt-nano's head_dim: the speedup gate's D 32 shape
    dict(name="bf16_d32", b=8, s=1024, h=12, hkv=12, d=32, dtype="bf16",
         causal=True, window=None, timed=True,
         forced=("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")),
    # gpt-nano's attention in ``train_nano`` (batch 32, seq 256, 4 heads)
    dict(name="bf16_nano", b=NANO_STEP[2], s=NANO_STEP[3], h=4, hkv=4, d=32,
         dtype="bf16", causal=True, window=None, timed=True,
         forced=("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")),
    # the GQA fold and ragged S at head_dims 32 and 16
    dict(name="bf16_d32_gqa_window", b=2, s=300, h=8, hkv=2, d=32,
         dtype="bf16", causal=True, window=100, timed=False, forced=()),
    dict(name="bf16_d16_mqa", b=2, s=97, h=4, hkv=1, d=16, dtype="bf16",
         causal=True, window=None, timed=False, forced=()),
)
# the shapes each kernel's records (the ``kernels`` line, PERF.md) and
# their launches come from, one for each of its routes, each the shape of
# the run that launches it: gpt-small's bf16 attention (head_dim 64,
# ``train``), the fp32 gpt-small step's (the 3xTF32 kernels;
# ``train_fp32``) and gpt-nano's bf16 head_dim 32 (the bf16 tensor-core
# kernels; ``train_nano``)
RECORD_SHAPE = {"flash_fwd_tc": ("bf16_main", "bf16_nano"),
                "flash_bwd_dkdv_tc": ("bf16_main", "bf16_nano"),
                "flash_bwd_dq_tc": ("bf16_main", "bf16_nano"),
                "flash_fwd_f32tc": ("fp32_main",),
                "flash_bwd_dkdv_f32tc": ("fp32_main",),
                "flash_bwd_dq_f32tc": ("fp32_main",)}
# the scalar twins on no route (fa.OFF_ROUTE), each recorded at the shape
# it is forced at beside the tensor-core kernel it was the route of
OFF_ROUTE_SHAPE = {"flash_fwd": "bf16_nano", "flash_bwd_dkdv": "bf16_nano",
                   "flash_bwd_dq": "bf16_nano"}
# the shapes the speedup gate holds each tensor-core kernel to
# ``MIN_SPEEDUP`` x its scalar twin at: gpt-small's size in each route's
# dtype and head_dim.  At ``bf16_nano`` (kernels of a few microseconds) the
# ratio is reported, not held.
SPEEDUP_SHAPES = ("bf16_main", "fp32_main", "bf16_d32")


def library_ms(q, k, v, do, b, h, s, d, scale):
    """Device ms of one PyTorch call computing the forward, and of one
    computing dq, dk and dv together, on these inputs: SDPA's flash
    kernels in bf16, its memory-efficient ones in fp32 (the flash backend
    takes no fp32).  A yardstick the port never calls."""
    import torch
    import torch.nn.functional as F

    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    if q.dtype == torch.bfloat16:
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale), 20)
        fw = torch.ops.aten._scaled_dot_product_flash_attention(
            q4, k4, v4, 0.0, True, False, scale=scale)
        bwd = cuda_ms(
            lambda: torch.ops.aten
            ._scaled_dot_product_flash_attention_backward(
                do4, q4, k4, v4, fw[0], fw[1], fw[2], fw[3], fw[4],
                fw[5], 0.0, True, fw[6], fw[7], scale=scale), 10)
        return fwd, bwd
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale), 20)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             scale=scale)
        bwd = cuda_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do4, retain_graph=True), 10)
    return fwd, bwd


def kernel_check(fa):
    """Every kernel against its plain version at ``SHAPES`` (its route's,
    and the forced launches); the timed shapes' device times of the
    kernels, the plain versions and the library calls.  Raises unless each
    tensor-core kernel is ``MIN_SPEEDUP`` x its scalar twin at each of its
    own shapes, or if a kernel's ``RECORD_SHAPE`` is off its route (an
    ``OFF_ROUTE_SHAPE`` must be off it, and forced).  Returns the records,
    keyed by (kernel, shape)."""
    import torch

    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    records, timed_ms = {}, {}
    for shp in SHAPES:
        b, s, h, hkv, d = (shp[x] for x in ("b", "s", "h", "hkv", "d"))
        tname, causal, window = shp["dtype"], shp["causal"], shp["window"]
        dt = dts[tname]
        g = torch.Generator(device="cuda").manual_seed(0)
        mk = lambda heads: torch.randn(b * heads, s, d, device="cuda",
                                       generator=g).to(dt)
        q, k, v, do = mk(h), mk(hkv), mk(hkv), mk(h)
        scale = d ** -0.5
        bq, bk = fa._pick_block(s, 512), fa._pick_block(s, 256)
        args = (causal, scale, bq, bk, h, hkv, window)
        cfg = (causal, scale, h, hkv, window)
        route = {p: fa.kernel_for(p, dt, d) for p in ("fwd", "dkdv", "dq")}

        o, lse = fa.flash_fwd(q, k, v, *args)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, *args)
        err = {
            route["fwd"]: check_close(route["fwd"] + " o", o, o_p,
                                      TOL[tname]),
            "lse": check_close(route["fwd"] + " lse", lse, lse_p,
                               TOL["lse"]),
        }
        # both backward passes from the plain forward's (o, lse)
        dq, dk, dv = fa.flash_bwd(q, k, v, o_p, lse_p, do, *args)
        dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do,
                                              causal, scale, bk, h, hkv,
                                              window)
        err[route["dq"]] = check_close(route["dq"], dq, dq_p, TOL[tname])
        err[route["dkdv"]] = max(
            check_close(route["dkdv"] + " dk", dk, dk_p, TOL[tname]),
            check_close(route["dkdv"] + " dv", dv, dv_p, TOL[tname]),
        )
        for name in shp["forced"]:
            if PASS[name] == "fwd":
                o_s, lse_s = torch.empty_like(q), torch.empty_like(lse)
                fa.launch_fwd(q, k, v, o_s, lse_s, *cfg, kernel=name)
                err[name] = check_close(name + " o", o_s, o_p, TOL[tname])
            elif PASS[name] == "dq":
                dq_s = torch.empty_like(q)
                fa.launch_dq(q, k, v, o_p, lse_p, do, dq_s, *cfg,
                             kernel=name)
                err[name] = check_close(name, dq_s, dq_p, TOL[tname])
            else:
                dk_s, dv_s = torch.empty_like(k), torch.empty_like(v)
                fa.launch_dkdv(q, k, v, o_p, lse_p, do, dk_s, dv_s, *cfg,
                               kernel=name)
                err[name] = max(
                    check_close(name + " dk", dk_s, dk_p, TOL[tname]),
                    check_close(name + " dv", dv_s, dv_p, TOL[tname]))
        line = {"shape": {"name": shp["name"], "b": b, "s": s, "h": h,
                          "hkv": hkv, "d": d, "dtype": tname,
                          "causal": causal, "window": window},
                "route": route, "forced": list(shp["forced"]),
                "tolerance": {"atol": TOL[tname][0],
                              "rtol": TOL[tname][1],
                              "lse_atol": TOL["lse"][0]},
                "max_abs_err": err}
        if shp["timed"]:
            ms = {n: cuda_ms(launcher(fa, n, q, k, v, o_p, lse_p, do, cfg),
                             20 if n in SCALAR_TWIN else 10)
                  for n in dict.fromkeys((*route.values(), *shp["forced"]))}
            timed_ms[shp["name"]] = ms
            plain_fwd = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, *args),
                                3, warmup=1)
            # the plain backward computes dq, dk and dv together
            plain_bwd = cuda_ms(lambda: fa.flash_bwd_plain(
                q, k, v, o_p, lse_p, do, causal, scale, bk, h, hkv, window),
                3, warmup=1)
            lib_fwd, lib_bwd = library_ms(q, k, v, do, b, h, s, d, scale)
            work = attention_work(
                b, s, h, hkv, d, causal, window, q.element_size(),
                pairs_read=route["dq"] in fa._PAIRS_FILLED_BY)
            recorded = [(n, True) for n, at in RECORD_SHAPE.items()
                        if shp["name"] in at]
            recorded += [(n, False) for n, at in OFF_ROUTE_SHAPE.items()
                         if at == shp["name"]]
            for name, on_route in recorded:
                routed = name in route.values()
                if routed != on_route or not (routed or
                                              name in shp["forced"]):
                    raise AssertionError(
                        f"{name}'s record shape {shp['name']} routes to "
                        f"{route} (forced: {shp['forced']})")
                flops, nbytes = work[name]
                peak = PEAK[tname]
                bms, by = bound(flops, nbytes, peak)
                fwd = PASS[name] == "fwd"
                records[name, shp["name"]] = {
                    "max_abs_err": err[name], "ms": ms[name],
                    "plain_ms": plain_fwd if fwd else plain_bwd,
                    "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_fwd if fwd else lib_bwd,
                    "flops": flops, "bytes": nbytes, "peak_flops": peak,
                    "shape": shp["name"],
                }
            line["kernel_ms"] = ms
            line["plain_ms"] = {"forward": plain_fwd,
                                "backward_dq_dk_dv": plain_bwd}
            line["library_ms"] = {"sdpa_forward": lib_fwd,
                                  "sdpa_backward_dq_dk_dv": lib_bwd}
            line["bound_ms"] = {n: r["bound_ms"]
                                for (n, at), r in records.items()
                                if at == shp["name"]}
        emit("kernel_check", **line)

    # every tensor-core kernel against the scalar kernel of its function,
    # both timed on the same inputs: each timed shape that runs both
    speedup = {f"{n}@{where}": ms[twin] / ms[n]
               for n, twin in SCALAR_TWIN.items()
               for where, ms in timed_ms.items() if n in ms and twin in ms}
    bf, f32 = timed_ms["bf16_main"], timed_ms["fp32_main"]
    d32, nano = timed_ms["bf16_d32"], timed_ms["bf16_nano"]
    emit("speedup", min_speedup=MIN_SPEEDUP, held_at=SPEEDUP_SHAPES,
         over_scalar_twin=speedup,
         backward_ms={
             "bf16_tensor_core_dkdv_plus_dq":
                 bf["flash_bwd_dkdv_tc"] + bf["flash_bwd_dq_tc"],
             "bf16_scalar_dkdv_plus_dq":
                 bf["flash_bwd_dkdv"] + bf["flash_bwd_dq"],
             "bf16_d32_tensor_core_dkdv_plus_dq":
                 d32["flash_bwd_dkdv_tc"] + d32["flash_bwd_dq_tc"],
             "bf16_d32_scalar_dkdv_plus_dq":
                 d32["flash_bwd_dkdv"] + d32["flash_bwd_dq"],
             "bf16_nano_tensor_core_dkdv_plus_dq":
                 nano["flash_bwd_dkdv_tc"] + nano["flash_bwd_dq_tc"],
             "bf16_nano_scalar_dkdv_plus_dq":
                 nano["flash_bwd_dkdv"] + nano["flash_bwd_dq"],
             "fp32_tensor_core_dkdv_plus_dq":
                 f32["flash_bwd_dkdv_f32tc"] + f32["flash_bwd_dq_f32tc"],
             "fp32_scalar_dkdv_plus_dq":
                 f32["flash_bwd_dkdv"] + f32["flash_bwd_dq"]})
    slow = {n: x for n, x in speedup.items()
            if x < MIN_SPEEDUP and n.split("@")[1] in SPEEDUP_SHAPES}
    if slow:
        raise AssertionError(
            f"tensor-core kernels under {MIN_SPEEDUP}x their scalar twins "
            f"at their own shapes: {slow}")
    return records


# gpt-nano (3 layers, head_dim 32) in bf16 runs the tensor-core forward,
# dK/dV and dQ: the gate against reference attention is 3%
# of each tensor's largest magnitude (measured on the CPU through the
# plain versions: logits 1.0%, gradients 0.93%; bf16 rounds q, k, v, P and
# the outputs at other places than the reference's einsums)
NANO_BF16_SCALE_TOL = 0.03


def model_check(hvd_models, fa):
    """gpt-nano on the card, flash kernels against the plain reference
    attention through the whole model, logits and grads: in fp32 (the
    3xTF32 forward, dK/dV and dQ) and in bf16 (the tensor-core forward,
    dK/dV and dQ), each route's kernels launched once a layer, counted
    from 0 around its flash model only."""
    import numpy as np
    import torch

    toks = torch.from_numpy(
        np.random.RandomState(1).randint(0, 1024, (2, 128))).cuda()
    out, launches = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        for impl in ("flash", "reference"):
            m = hvd_models.gpt("nano", device="cuda", dtype=dt,
                               attention_impl=impl)
            if impl == "flash":
                fa.reset_launch_counts()
            layers = m.cfg.num_layers
            logits = m(toks)
            logits.float().square().mean().backward()
            if impl == "flash":
                torch.cuda.synchronize()
                launches[dt] = dict(fa.LAUNCHES)
            out[dt, impl] = (logits.detach().float(),
                             {n: p.grad.float()
                              for n, p in m.named_parameters()})
    f32 = torch.float32
    err_logits = check_close("nano logits", out[f32, "flash"][0],
                             out[f32, "reference"][0], (2e-4, 2e-4))
    err_grads = max(
        check_close(f"nano grad {n}", g, out[f32, "reference"][1][n],
                    (5e-4, 5e-4))
        for n, g in out[f32, "flash"][1].items()
    )
    bf = torch.bfloat16

    def scaled(name, got, want):
        worst = ((got - want).abs().max() / want.abs().max()).item()
        if not torch.isfinite(got).all() or worst > NANO_BF16_SCALE_TOL:
            raise AssertionError(
                f"{name}: max |flash - reference| is {worst:.4f} of the "
                f"largest |reference| (> {NANO_BF16_SCALE_TOL})")
        return worst

    bf16_logits = scaled("nano bf16 logits", out[bf, "flash"][0],
                         out[bf, "reference"][0])
    bf16_grads = max(scaled(f"nano bf16 grad {n}", g,
                            out[bf, "reference"][1][n])
                     for n, g in out[bf, "flash"][1].items())
    route = {fa.kernel_for(p, bf, 32) for p in ("fwd", "dkdv", "dq")}
    want = {n: layers if n in route else 0 for n in fa.LAUNCHES}
    if launches[bf] != want:
        raise AssertionError(f"bf16 nano launches {launches[bf]} != {want}")
    emit("model_check", model="gpt-nano seq 128 batch 2",
         fp32={"max_abs_err_logits": err_logits,
               "max_abs_err_grads": err_grads,
               "tolerance": {"logits": [2e-4, 2e-4],
                             "grads": [5e-4, 5e-4]},
               "launches": launches[f32]},
         bf16={"max_err_over_scale_logits": bf16_logits,
               "max_err_over_scale_grads": bf16_grads,
               "tolerance_of_scale": NANO_BF16_SCALE_TOL,
               "launches": launches[bf]})


# the kernels of the main path (bf16, head_dim 64) and the ones it must not
# reach
MAIN_PATH = ("flash_fwd_tc", "flash_bwd_dkdv_tc", "flash_bwd_dq_tc")
LOSS_RTOL = 0.01
STEPS, WARMUP = 5, 2
# the gpt-small step every phase from ``train`` on drives
GPT_STEP = ("small", "bf16", 8, 1024)
# bucket and bucket+zero1 compute off's update: at world 1 the reduce of a
# bucket is its own gradient and AdamW the same elementwise arithmetic, so
# the losses may differ from off's only where a kernel of the step sums in
# a run-dependent order
OVERLAP_LOSS_RTOL = 1e-3
OVERLAP_MODES = ("bucket", "bucket+zero1")
# parameters whose gradients the backward produces only after block 0's
# attention backward, the step's last flash_bwd_dkdv_tc launch
LATE_PARAMS = ("block0.qkv.", "block0.ln1.", "wpe", "wte.")


def run_steps(step, state, n):
    losses = []
    for _ in range(n):
        model, opt, loss = step(*state)
        state = (model, opt) + state[2:]
        losses.append(loss)
    return state, losses


def drive(fa, step, state, remat: bool = False, path=MAIN_PATH,
          peak: float = H100_BF16_PEAK):
    """``WARMUP`` then ``STEPS`` timed steps from ``state``: the launch
    counts are set to 0 just before and read just after, and must be exact
    (each kernel of ``path`` once per layer and step; the forward twice
    under remat, which recomputes it; none of the others).  MFU against
    ``peak``.  Returns the state and the run's record."""
    import torch

    model = state[0]
    batch, seq = state[2].shape[0], state[2].shape[1] - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30

    fa.reset_launch_counts()                # the main path starts here
    state, losses = run_steps(step, state, WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, timed = run_steps(step, state, STEPS)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / STEPS
    launches = dict(fa.LAUNCHES)            # ... and ends here
    losses = [float(x) for x in losses + timed]

    total = STEPS + WARMUP
    layers = model.cfg.num_layers
    per_step = {n: (layers * (2 if remat and PASS[n] == "fwd" else 1)
                    if n in path else 0) for n in launches}
    want = {n: k * total for n, k in per_step.items()}
    if launches != want:
        raise AssertionError(
            f"kernel launches {launches} != {want} ({per_step} per step x "
            f"{total} steps)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    from horovod_tpu_torch.bench import model_flops_per_step

    flops = model_flops_per_step(model.cfg, batch, seq)
    return state, {
        "losses": losses, "step_ms": secs * 1e3,
        "tokens_per_s_per_gpu": batch * seq / secs,
        "model_flops_per_step": flops, "mfu": flops / secs / peak,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        # what the built model, optimizer and buffers hold before a step
        "resident_mem_gib": resident,
        "launches": launches, "launches_per_step": per_step}


def losses_of(build, cfg=GPT_STEP, **kwargs):
    """The losses of the same steps built with ``kwargs`` (no timing)."""
    step, state, _ = build(*cfg, **kwargs)
    return [float(x) for x in run_steps(step, state, STEPS + WARMUP)[1]]


def max_rel(losses, ref) -> float:
    return max(abs(a - r) / abs(r) for a, r in zip(losses, ref))


# what may stay allocated once a run is dropped (library workspaces); a
# gpt-small run that stayed alive would hold over 1 GiB
RELEASE_SLACK_GIB = 0.5


def release() -> None:
    """Free what the last run left on the card and check that it is gone,
    so the next run's resident and peak memory are its own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    if left > RELEASE_SLACK_GIB:
        raise AssertionError(f"{left:.3f} GiB still allocated after the last "
                             f"run was dropped (> {RELEASE_SLACK_GIB})")


def train(hvd, fa):
    from horovod_tpu_torch.train import build_gpt_step

    topo = hvd.init()
    assert topo.device.type == "cuda" and topo.backend == "nccl", topo
    step, state, static = build_gpt_step(*GPT_STEP)
    state, run = drive(fa, step, state)
    # the same steps from the same weights and tokens, with the plain
    # reference attention in place of the kernels
    ref_losses = losses_of(build_gpt_step, attention="reference")
    rel = max_rel(run["losses"], ref_losses)
    if rel > LOSS_RTOL:
        raise AssertionError(
            f"losses {run['losses']} differ from the reference attention's "
            f"{ref_losses} by {rel:.4f} > {LOSS_RTOL}")
    emit("train", model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3],
         world=static["n_chips"], steps_timed=STEPS, warmup=WARMUP,
         reference_losses=ref_losses, max_rel_loss_diff=rel,
         loss_rtol=LOSS_RTOL, mfu_peak_flops=H100_BF16_PEAK, **run)
    return state, step, run, static["n_chips"]


GPT_FP32_STEP = ("small", "fp32", 8, 1024)
# losses of the same steps with the reference's fp32 einsum attention:
# fp32 sums in other orders through 7 AdamW steps (measured 1.2e-6 on the
# H100; 1e-4 at first, tightened with an 8x margin)
FP32_LOSS_RTOL = 1e-5


def train_fp32(fa):
    """``build_gpt_step("small", "fp32", 8, 1024)`` from ``train``'s seed-0
    weights and tokens: exact launches (the fp32 route's forward, dK/dV
    and dQ 12 a step, nothing else), finite losses within ``FP32_LOSS_RTOL`` of reference attention,
    step time, tokens/s, MFU at the fp32 FMA peak, memory, one profiled
    step.  TF32 must be off for matmuls: the only tensor-core arithmetic
    of the step is the kernels' own 3xTF32.  Returns the run's record."""
    import torch
    from horovod_tpu_torch.train import build_gpt_step

    step, state, _ = build_gpt_step(*GPT_FP32_STEP)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 step with TF32 matmuls on")
    # the kernels fa.kernel_for sends fp32 at gpt-small's head_dim 64 to
    path = tuple(fa.kernel_for(p, torch.float32, state[0].cfg.head_dim)
                 for p in ("fwd", "dkdv", "dq"))
    state, run = drive(fa, step, state, path=path, peak=H100_FP32_PEAK)
    prof = profile_step(state, step, run["step_ms"])
    del state, step
    release()
    ref_losses = losses_of(build_gpt_step, cfg=GPT_FP32_STEP,
                           attention="reference")
    release()
    rel = max_rel(run["losses"], ref_losses)
    if rel > FP32_LOSS_RTOL:
        raise AssertionError(
            f"fp32 losses {run['losses']} differ from the reference "
            f"attention's {ref_losses} by {rel:.3g} > {FP32_LOSS_RTOL}")
    emit("train_fp32", model="gpt-small", dtype="fp32",
         batch_per_gpu=GPT_FP32_STEP[2], seq=GPT_FP32_STEP[3],
         steps_timed=STEPS, warmup=WARMUP, tf32_matmul=False,
         reference_losses=ref_losses, max_rel_loss_diff=rel,
         loss_rtol=FP32_LOSS_RTOL, mfu_peak_flops=H100_FP32_PEAK,
         attention_share=(prof["flash_kernels_ms"] / prof["device_busy_ms"]
                          if prof["device_busy_ms"] else None),
         profile=prof, **run)
    return run


def bench(*args, path) -> dict:
    """``python -m horovod_tpu_torch.bench *args`` once, in its own
    process: its record, whose flash kernels launched must be exactly
    ``path``'s."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.bench", *args]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"bench exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    record = json.loads(out.stdout.strip().splitlines()[-1])
    if (record.get("attention") != "kernels"
            or set(record["flash_launches"]) != set(path)):
        raise AssertionError(f"bench ran other flash kernels than {path}: "
                             f"{record}")
    emit("bench", command=" ".join(cmd[1:]), record=record)
    return record


def train_nano(fa):
    """``build_gpt_step("nano", "bf16", 32, 256)``: exact launches
    (``NANO_PATH`` 3 a step, nothing else), finite losses within
    ``LOSS_RTOL`` of the same steps with reference attention, step time,
    tokens/s/GPU, memory, one profiled step (the device's busy share).
    Returns the run's record."""
    import torch
    from horovod_tpu_torch.train import build_gpt_step

    step, state, _ = build_gpt_step(*NANO_STEP)
    path = tuple(fa.kernel_for(p, torch.bfloat16, state[0].cfg.head_dim)
                 for p in ("fwd", "dkdv", "dq"))
    if path != NANO_PATH:
        raise AssertionError(f"gpt-nano bf16 routes to {path}")
    state, run = drive(fa, step, state, path=path)
    prof = profile_step(state, step, run["step_ms"])
    del state, step
    release()
    ref_losses = losses_of(build_gpt_step, cfg=NANO_STEP,
                           attention="reference")
    release()
    rel = max_rel(run["losses"], ref_losses)
    if rel > LOSS_RTOL:
        raise AssertionError(
            f"gpt-nano losses {run['losses']} differ from the reference "
            f"attention's {ref_losses} by {rel:.4f} > {LOSS_RTOL}")
    emit("train_nano", model="gpt-nano", dtype="bf16",
         batch_per_gpu=NANO_STEP[2], seq=NANO_STEP[3], steps_timed=STEPS,
         warmup=WARMUP, reference_losses=ref_losses, max_rel_loss_diff=rel,
         loss_rtol=LOSS_RTOL, mfu_peak_flops=H100_BF16_PEAK,
         device_busy_share=prof["device_busy_share"], profile=prof, **run)
    return run


# the MoE step: gpt-small, 8 experts in every block (top 2, capacity 2,
# routing groups of 4096: the reference model's defaults), train's batch
MOE_STEP = ("small", "bf16", 8, 1024)
MOE_EXPERTS = 8
# each block's aux loss at init: the Switch loss is 1 at uniform routing,
# and a seed-0 router (std 0.02) routes near uniformly
MOE_AUX_INIT = (0.9, 1.5)
# the MoE step's losses against the same steps with reference attention:
# the first (the forward alone) within LOSS_RTOL; every one within
# MOE_LOSS_RTOL.  Routing is discrete and the seed-0 router's gates lie
# within ~1e-3 of each other, so the kernels' bf16 attention, an ulp from
# the reference's, sends a share of the tokens to other experts
# (``moe_split``'s ``flipped``), and the two runs' losses part further with
# each AdamW step: 0.05% at the first step, 1.18% at the seventh
# (NVIDIA H100 80GB HBM3, 700.00 W, the first run of this phase)
MOE_LOSS_RTOL = 0.03


def moe_split(model, tokens) -> dict:
    """Device ms of one MoE layer's routing (gates, top-k one-hots, and the
    fp32 dispatch and combine einsums, an identity in the experts' place)
    and of its experts' FFN, each forward and backward, at the step's
    shapes and dtype (CUDA events, 3 repeats after 1 warm-up).  At init,
    over the step's tokens: the share of (token, choice) pairs that
    overflowed their expert's capacity and were dropped, each block's aux
    loss, and each block's share of tokens whose top-k experts differ when
    the blocks attend through the plain reference attention instead of
    the kernels (``flipped``: what sets the loss gate, ``MOE_LOSS_RTOL``)."""
    import dataclasses

    import torch

    from horovod_tpu_torch.parallel import moe

    cfg = model.cfg
    dev = tokens.device
    b, s = tokens.shape[0], tokens.shape[1] - 1
    d, e = cfg.emb_dim, cfg.moe_experts
    kept, wanted, choices = [], [], []
    plain = moe._routing

    def counting(x2, router, num_experts, top_k, capacity, valid):
        out = plain(x2, router, num_experts, top_k, capacity, valid)
        kept.append(float(out[0].sum()))
        wanted.append(float(valid.float().sum()) * top_k)
        top = (x2.float() @ router.float()).topk(top_k, dim=-1).indices
        choices.append(top.sort(-1).values)
        return out

    moe._routing = counting
    try:
        with torch.no_grad():
            losses = []
            model(tokens[:, :-1], losses=losses)
            flash_choices, choices[:] = list(choices), []
            blocks = model.blocks()
            for blk in blocks:
                blk.cfg = dataclasses.replace(blk.cfg,
                                              attention_impl="reference")
            model(tokens[:, :-1])
            for blk in blocks:
                blk.cfg = cfg
    finally:
        moe._routing = plain
    flipped = [float((a != r).any(-1).float().mean())
               for a, r in zip(flash_choices, choices)]
    kept, wanted = kept[:len(flipped)], wanted[:len(flipped)]
    aux = [float(a) for a in losses]
    p = moe.moe_params_of(model.block0)
    x = torch.randn((b, s, d), device=dev, requires_grad=True)

    def routing():
        xg, disp, comb, cap, a, n = moe._grouped_routing(
            x.reshape(-1, d), p.router, e, cfg.moe_top_k,
            cfg.moe_capacity_factor, cfg.moe_group_size)
        buf = moe._dispatch(xg, disp, e, cap)
        y = moe._combine(buf, comb, n, (b, s, d), x.dtype)
        (y.float().square().mean() + a).backward()

    cap = math.ceil(cfg.moe_capacity_factor * min(cfg.moe_group_size, b * s)
                    * cfg.moe_top_k / e)
    groups = -(-b * s // cfg.moe_group_size)
    buf = torch.randn((e, groups * cap, d), device=dev, requires_grad=True)

    def experts():
        out = moe._expert_ffn(buf, p.w1, p.b1, p.w2, p.b2, cfg.dtype)
        out.float().square().mean().backward()

    ms = {name: cuda_ms(fn, 3, 1) for name, fn in
          (("routing_ms_per_layer", routing),
           ("experts_ms_per_layer", experts))}
    return dict(ms, dropped_share=1.0 - sum(kept) / sum(wanted),
                aux_at_init=aux, flipped=flipped, capacity=cap,
                groups=groups)


def moe_phase(fa):
    """``build_gpt_step("small", "bf16", 8, 1024, moe_experts=8)`` from
    seed-0 weights and ``RandomState(0)`` tokens: exact launches
    (``MAIN_PATH`` 12 a step: the blocks' attention is unchanged), finite
    losses against the same steps with reference attention (the first
    within ``LOSS_RTOL``, all within ``MOE_LOSS_RTOL``), each block's aux
    loss finite and in ``MOE_AUX_INIT`` at
    init; step ms, tokens/s/GPU, MFU by ``model_flops_per_step``'s MoE
    rule, memory, one profiled step (the device's busy share), the routing
    einsums' and the experts' device ms (``moe_split``), the dropped
    share.  Then ``bench --model gpt-small --moe-experts 8`` in its own
    process, which must launch exactly ``MAIN_PATH``.  Returns the run."""
    import torch
    from horovod_tpu_torch.train import build_gpt_step

    step, state, _ = build_gpt_step(*MOE_STEP, moe_experts=MOE_EXPERTS)
    path = tuple(fa.kernel_for(p, torch.bfloat16, state[0].cfg.head_dim)
                 for p in ("fwd", "dkdv", "dq"))
    if path != MAIN_PATH:
        raise AssertionError(f"gpt-small bf16 routes to {path}")
    layers = state[0].cfg.num_layers
    split = moe_split(state[0], state[2])
    lo, hi = MOE_AUX_INIT
    if not all(math.isfinite(a) and lo <= a <= hi
               for a in split["aux_at_init"]):
        raise AssertionError(f"aux losses at init {split['aux_at_init']} "
                             f"outside {MOE_AUX_INIT}")
    state, run = drive(fa, step, state, path=path)
    prof = profile_step(state, step, run["step_ms"])
    del state, step
    release()
    ref_losses = losses_of(build_gpt_step, cfg=MOE_STEP,
                           attention="reference", moe_experts=MOE_EXPERTS)
    release()
    rel = max_rel(run["losses"], ref_losses)
    first = max_rel(run["losses"][:1], ref_losses[:1])
    if first > LOSS_RTOL or rel > MOE_LOSS_RTOL:
        raise AssertionError(
            f"MoE losses {run['losses']} differ from the reference "
            f"attention's {ref_losses} by {first:.4f} at the first step "
            f"(> {LOSS_RTOL}?) and {rel:.4f} at most (> {MOE_LOSS_RTOL}?)")
    emit("moe", model="gpt-small", dtype="bf16", experts=MOE_EXPERTS,
         top_k=2, capacity_factor=2.0, group_size=4096,
         batch_per_gpu=MOE_STEP[2], seq=MOE_STEP[3], steps_timed=STEPS,
         warmup=WARMUP, reference_losses=ref_losses, max_rel_loss_diff=rel,
         first_rel_loss_diff=first, loss_rtol=(LOSS_RTOL, MOE_LOSS_RTOL),
         mfu_peak_flops=H100_BF16_PEAK, routing_ms_per_step=split["routing_ms_per_layer"] * layers,
         experts_ms_per_step=split["experts_ms_per_layer"] * layers,
         device_busy_share=prof["device_busy_share"], split=split,
         profile=prof, **run)
    record = bench("--model", "gpt-small", "--moe-experts",
                   str(MOE_EXPERTS), "--iters", str(STEPS), "--warmup",
                   str(WARMUP), path=MAIN_PATH)
    if record["device_index"] != 0 or record["n_gpus"] != 1:
        raise AssertionError(f"MoE bench ran on {record['device']} "
                             f"{record['device_index']}")
    run["bench"] = record
    return run


# the parallel phase's launches a step at a world of one: tp runs each
# layer once; pp and its circular and tp-in-pp twins run each layer once
# a microbatch (one a sequence row), their forward twice under the
# per-tick remat
def parallel_launches(path, layers: int, microbatches: int) -> dict:
    return {"tp": {n: layers for n in path},
            **{name: {n: layers * microbatches * (2 if PASS[n] == "fwd"
                                                  else 1) for n in path}
               for name in ("pp", "pp_circular", "pp_tp")}}


def parallel_phase(fa) -> dict:
    """``horovod_tpu_torch.world_check.a11_checks`` at a world of one on
    the card: gpt-small at full width, fp32 with TF32 off, batch 4, seq
    1024, every schedule over axes of size one (ring, zigzag, Ulysses,
    tp, pp, circular pp, pp x tp, expert parallelism, the sharded decode)
    held against the unsharded model within the fp32 gates; the tp and
    pipeline runs must launch exactly the fp32 route's kernels
    (``parallel_launches``).  This proves device placement, the tick loop
    and the kernels' launches; the collectives between ranks it does not
    (NCCL puts no two ranks on one card)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import world_check

    checks = world_check.a11_checks(hvd, torch, cpu=False)
    failures = world_check.a11_failures(checks)
    path = tuple(fa.kernel_for(p, torch.float32, 64)
                 for p in ("fwd", "dkdv", "dq"))
    want = parallel_launches(path, 12, 4)
    for name, launches in want.items():
        if checks[name]["launches"] != launches:
            failures.append(f"{name} launched {checks[name]['launches']}, "
                            f"not {launches}")
    emit("parallel", world=hvd.size(), model="gpt-small", dtype="fp32",
         batch=4, seq=1024, tf32_matmul=torch.backends.cuda.matmul
         .allow_tf32, loss_rtol=world_check.A11_LOSS_RTOL,
         grad_rtol=world_check.A11_GRAD_RTOL, checks=checks,
         failures=failures)
    if failures:
        raise AssertionError(f"parallel phase: {failures}")
    return checks


def issue_order(fa, plan, names):
    """Record, at each bucket collective the plan issues, how many
    ``flash_bwd_dkdv_tc`` launches came before it.  Returns the record and
    *expected*: the buckets holding no parameter of ``LATE_PARAMS``."""
    seen = []
    plan.on_issue = lambda index: seen.append(
        (index, fa.LAUNCHES["flash_bwd_dkdv_tc"]))
    late = {i for i, n in enumerate(names) if n.startswith(LATE_PARAMS)}
    expected = sum(1 for b in plan.layout.buckets
                   if not late & set(b.leaf_indices))
    return seen, expected


def early_issues(seen, n_buckets: int, layers: int) -> list:
    """Per step: the bucket collectives issued before the step's last
    ``flash_bwd_dkdv_tc`` launch (its ``layers``-th), from
    :func:`issue_order`'s record; every bucket must be issued once per
    step."""
    if len(seen) % n_buckets:
        raise AssertionError(f"{len(seen)} bucket issues for {n_buckets} "
                             "buckets a step")
    steps = [seen[i:i + n_buckets] for i in range(0, len(seen), n_buckets)]
    out = []
    for k, issues in enumerate(steps):
        if sorted(i for i, _ in issues) != list(range(n_buckets)):
            raise AssertionError(f"step {k} issued buckets {issues}")
        out.append(sum(1 for _, dkdv in issues if dkdv < layers * (k + 1)))
    return out


def overlap(fa, off_losses):
    """gpt-small in ``bucket`` and ``bucket+zero1``: the ``train`` phase's
    steps, through the overlap plane."""
    from horovod_tpu_torch.train import build_gpt_step

    out = {}
    for mode in OVERLAP_MODES:
        step, state, _ = build_gpt_step(*GPT_STEP, overlap_mode=mode)
        model, plan = state[0], state[1]
        seen, expected = issue_order(
            fa, plan, [n for n, _ in model.named_parameters()])
        state, run = drive(fa, step, state)
        layout = plan.layout
        early = early_issues(seen, len(layout.buckets), model.cfg.num_layers)
        run["profile"] = profile_step(state, step, run["step_ms"], top=6)
        rel = max_rel(run["losses"], off_losses)
        out[mode] = dict(
            run, buckets=len(layout.buckets), bucket_mb=layout.bucket_bytes
            / 2**20, bucket_bytes=[b.nbytes for b in layout.buckets],
            total_grad_bytes=layout.total_bytes,
            issued_before_last_dkdv=min(early),
            issued_before_last_dkdv_per_step=early,
            expected_before_last_dkdv=expected,
            max_rel_loss_diff_vs_off=rel,
            bitwise_equal_to_off=run["losses"] == off_losses)
        del step, state, model, plan
        release()
        if rel > OVERLAP_LOSS_RTOL:
            raise AssertionError(
                f"{mode} losses {run['losses']} differ from off's "
                f"{off_losses} by {rel:.2e} > {OVERLAP_LOSS_RTOL}")
        if min(early) < expected:
            raise AssertionError(
                f"{mode}: {early} bucket collectives issued before the last "
                f"dK/dV launch per step, fewer than the {expected} buckets "
                "complete by then")
    emit("overlap", model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3], world=1,
         off_losses=off_losses, loss_rtol=OVERLAP_LOSS_RTOL, modes=out)
    return out


# the reference's examples the spmd phase runs, each in its own process
SPMD_EXAMPLES = (
    ("synthetic_benchmark", "--model", "resnet50", "--batch-size", "64",
     "--num-warmup-batches", "2", "--num-batches-per-iter", "2",
     "--num-iters", "3"),
    ("bert_style", "--smoke"),
)
SPMD_EXAMPLE_TIMEOUT = 300


def spmd_step(model):
    """The ``train`` phase's step written against the reference's SPMD
    surface: ``hvd.distribute(local_step)``, where ``local_step`` takes
    the loss and the gradients from ``sync_gradients`` (one reduce per
    bucket inside the backward), passes them through
    ``DistributedGradientTransform()`` and steps AdamW 1e-4."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.train import lm_loss_fn, make_adamw

    params = dict(model.named_parameters())
    opt = make_adamw(params.values())
    tx = hvd.DistributedGradientTransform()
    tx_state = tx.init(params)
    loss_fn = lm_loss_fn(model)

    def local_step(model, opt, toks):
        loss, grads = hvd.sync_gradients(loss_fn, params, toks)
        grads, _ = tx.update(grads, tx_state)
        for name, p in params.items():
            p.grad = grads[name]
        opt.step()
        return model, opt, hvd.allreduce(loss)

    return hvd.distribute(local_step), opt


def run_example(name: str, *args) -> dict:
    """``python -m horovod_tpu_torch.examples.<name> *args`` in its own
    process: its closing JSON line; fails unless it exits 0."""
    cmd = [sys.executable, "-m", f"horovod_tpu_torch.examples.{name}",
           *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=SPMD_EXAMPLE_TIMEOUT)
    if out.returncode != 0:
        raise AssertionError(f"example {name} exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    record = json.loads(out.stdout.strip().splitlines()[-1])
    record["seconds"] = time.perf_counter() - t0
    return record


def spmd(fa, off_losses) -> dict:
    """gpt-small bf16 at full width through ``hvd.distribute`` +
    ``sync_gradients`` + ``DistributedGradientTransform`` in front of
    AdamW, from ``train``'s weights and tokens: the losses against
    ``train``'s (bit for bit, else within the ``bucket`` mode's
    ``OVERLAP_LOSS_RTOL``), the launches exact, and bucket reduces issued
    before the step's last dK/dV launch (``overlap``'s rule).  Returns
    the phase's record; ``main`` prints it with :func:`spmd_examples`'
    results."""
    import torch

    from horovod_tpu_torch.optim import overlap as ov
    from horovod_tpu_torch.runtime.autotune import resolve_grad_bucket_bytes
    from horovod_tpu_torch.train import build_gpt_step

    # train's model and tokens (the same seeds); its optimizer is dropped
    _, built, _ = build_gpt_step(*GPT_STEP)
    model, toks = built[0], built[2]
    del built
    step, opt = spmd_step(model)
    names = [n for n, _ in model.named_parameters()]
    layout = ov.build_layout(list(model.parameters()),
                             resolve_grad_bucket_bytes(None))
    late = {i for i, n in enumerate(names) if n.startswith(LATE_PARAMS)}
    expected = sum(1 for b in layout.buckets
                   if not late & set(b.leaf_indices))
    seen = []
    ov.on_sync_issue = lambda index: seen.append(
        (index, fa.LAUNCHES["flash_bwd_dkdv_tc"]))
    try:
        state, run = drive(fa, step, (model, opt, toks))
    finally:
        ov.on_sync_issue = None
    early = early_issues(seen, len(layout.buckets), model.cfg.num_layers)
    bitwise = run["losses"] == off_losses
    rel = max_rel(run["losses"], off_losses)
    del state, step, opt, model
    release()
    torch.cuda.synchronize()
    if not bitwise and rel > OVERLAP_LOSS_RTOL:
        raise AssertionError(
            f"spmd losses {run['losses']} differ from off's {off_losses} "
            f"by {rel:.2e} > {OVERLAP_LOSS_RTOL}")
    if min(early) < max(expected, 1):
        raise AssertionError(
            f"spmd: {early} bucket reduces issued before the last dK/dV "
            f"launch per step, fewer than the {max(expected, 1)} buckets "
            "complete by then")
    return dict(model="gpt-small", dtype="bf16", card=card_line(),
                batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3], world=1,
                off_losses=off_losses, bitwise_equal_to_off=bitwise,
                max_rel_loss_diff_vs_off=rel,
                held_to="bitwise" if bitwise
                else f"rtol {OVERLAP_LOSS_RTOL}",
                buckets=len(layout.buckets),
                issued_before_last_dkdv=min(early),
                issued_before_last_dkdv_per_step=early,
                expected_before_last_dkdv=expected, **run)


def spmd_examples() -> dict:
    """The ``spmd`` phase's examples (``SPMD_EXAMPLES``), side by side, each
    in its own process: ``run_example``'s record by name."""
    with concurrent.futures.ThreadPoolExecutor(len(SPMD_EXAMPLES)) as pool:
        return dict(zip((a[0] for a in SPMD_EXAMPLES),
                        pool.map(lambda a: run_example(*a), SPMD_EXAMPLES)))


def rope_remat(fa):
    """RoPE + remat + ZeRO-1 at full width: exact launches (the forward
    twice per layer), losses against the reference attention, and peak
    memory against the same run without remat."""
    from horovod_tpu_torch.train import build_gpt_step

    kw = dict(pos_embedding="rope", overlap_mode="bucket+zero1")
    runs = {}
    for remat in (True, False):
        step, state, _ = build_gpt_step(*GPT_STEP, remat=remat, **kw)
        state, runs[remat] = drive(fa, step, state, remat=remat)
        runs[remat]["profile"] = profile_step(state, step,
                                              runs[remat]["step_ms"], top=6)
        del step, state
        release()
    ref_losses = losses_of(build_gpt_step, attention="reference", remat=True,
                           **kw)
    release()
    rel = max_rel(runs[True]["losses"], ref_losses)
    if rel > LOSS_RTOL:
        raise AssertionError(
            f"rope+remat losses {runs[True]['losses']} differ from the "
            f"reference attention's {ref_losses} by {rel:.4f} > {LOSS_RTOL}")
    peak, plain_peak = runs[True]["peak_mem_gib"], runs[False]["peak_mem_gib"]
    if peak > plain_peak:
        raise AssertionError(f"remat raised the peak memory: {peak:.3f} GiB "
                             f"against {plain_peak:.3f} without it")
    emit("rope_remat", model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3], world=1, **kw,
         remat=runs[True], no_remat=runs[False],
         reference_losses=ref_losses, max_rel_loss_diff=rel,
         loss_rtol=LOSS_RTOL,
         max_rel_loss_diff_remat_vs_not=max_rel(runs[True]["losses"],
                                                runs[False]["losses"]),
         bitwise_equal_remat_vs_not=(runs[True]["losses"]
                                     == runs[False]["losses"]))


# (atol, rtol) of the card's fp32 conv step against the CPU's: both sum in
# fp32, in orders their libraries choose (cuDNN with TF32 off, oneDNN)
CONV_TOL = (1e-4, 1e-4)
# model, batch, image size, train mode of the card-vs-CPU step.  Inception
# V3 runs in eval mode (BatchNorm on its running statistics): its
# train-mode fp32 step is ill-conditioned at init, at any size (on the
# CPU the port's own fp32 and fp64 gradients differ by 3-5% normwise, and
# at 96x96 its last blocks normalise 1x1 maps over 2 values), so there a
# card-vs-CPU difference would measure rounding, not the path.
CONV_CHECKS = (("resnet18", 4, 64, True), ("resnet50", 2, 64, True),
               ("vgg16", 2, 64, True), ("inception3", 2, 96, False))
# the headline step: Horovod's ResNet-50 images/s benchmark
RESNET_STEP = ("resnet50", "bf16", 128, 224)
ZOO = (("vgg16", 224), ("inception3", 299))
ZOO_BATCH, ZOO_STEPS, ZOO_WARMUP = 32, 3, 1


def sgd_step_record(model, images, labels) -> dict:
    """One SGD-momentum step of ``model`` on one batch: its logits, loss,
    gradients, updated parameters and running statistics, copied to the
    CPU."""
    import torch.nn.functional as F

    from horovod_tpu_torch.train import make_sgd

    logits = model(images)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    out = {"logits": logits.detach(), "loss": loss.detach()}
    out.update({f"grad {n}": p.grad for n, p in model.named_parameters()})
    make_sgd(model.parameters()).step()
    out.update({f"param {n}": p.detach()
                for n, p in model.named_parameters()})
    out.update({f"stat {n}": b for n, b in model.named_buffers()})
    return {k: v.cpu() for k, v in out.items()}


def conv_inputs(batch: int, size: int):
    """The seeded batch of ``build_step``: NCHW (channels_last) images and
    labels, fp32, on the CPU."""
    import numpy as np
    import torch

    from horovod_tpu_torch.models.layers import from_nhwc

    images = from_nhwc(np.random.RandomState(0).randn(
        batch, size, size, 3).astype(np.float32))
    labels = torch.from_numpy(
        np.random.RandomState(1).randint(0, 1000, size=(batch,)))
    return images, labels


def card_vs_cpu(name: str, batch: int, size: int, train: bool = True):
    """One fp32 SGD step of conv model ``name`` on the card (TF32 off) and
    on the CPU from the same weights and batch.  Returns the max abs error
    by kind (logits, loss, grad, param, stat) and the failures outside
    ``CONV_TOL``."""
    import copy

    import torch

    from horovod_tpu_torch.train import conv_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = conv_model(name, "fp32", size).train(train)
    card = copy.deepcopy(model).cuda()
    images, labels = conv_inputs(batch, size)
    want = sgd_step_record(model, images, labels)
    got = sgd_step_record(card, images.cuda(), labels.cuda())
    errs: dict = {}
    failures = []
    for key, w in want.items():
        kind = key.split(" ")[0]
        e = (got[key].double() - w.double()).abs().max().item()
        errs[kind] = max(errs.get(kind, 0.0), e)
        try:
            check_close(f"{name} {key}", got[key], w, CONV_TOL)
        except AssertionError as exc:
            failures.append(str(exc))
    return errs, failures


def conv_check() -> None:
    errs, failures = {}, []
    for name, batch, size, train in CONV_CHECKS:
        errs[name], bad = card_vs_cpu(name, batch, size, train)
        failures += bad
    release()
    emit("conv_check", dtype="fp32", tf32=False,
         models=[{"model": n, "batch": b, "image_size": s,
                  "mode": "train" if t else "eval"}
                 for n, b, s, t in CONV_CHECKS],
         tolerance={"atol": CONV_TOL[0], "rtol": CONV_TOL[1]},
         max_abs_err=errs, failures=failures[:20])
    if failures:
        raise AssertionError(f"{len(failures)} tensors of the card's conv "
                             f"step outside {CONV_TOL}: {failures[:3]}")


def run_carry(step, state, carry: int, n: int):
    """``n`` steps of a step whose first ``carry`` state entries come back
    updated; the new state and the losses (device tensors)."""
    losses = []
    for _ in range(n):
        *out, loss = step(*state)
        state = tuple(out) + state[carry:]
        losses.append(loss)
    return state, losses


def drive_conv(fa, model_name, step, state, static, warmup: int,
               steps: int):
    """``warmup`` then ``steps`` timed steps of a conv-zoo step: every
    loss finite and no flash kernel launched (the counts are set to 0
    just before and read just after).  Returns the state and the run's
    record."""
    import torch

    from horovod_tpu_torch.bench import conv_flops_per_image

    carry = static["carry_len"]
    images = state[carry]
    batch, size = images.shape[0], images.shape[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    fa.reset_launch_counts()
    state, losses = run_carry(step, state, carry, warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, timed = run_carry(step, state, carry, steps)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / steps
    launches = {n: k for n, k in fa.LAUNCHES.items() if k}
    losses = [float(x) for x in losses + timed]
    if launches:
        raise AssertionError(f"flash kernels launched on a conv step: "
                             f"{launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    flops = conv_flops_per_image(model_name, size)
    return state, {
        "model": model_name, "batch_per_gpu": batch, "image_size": size,
        "world": static["n_chips"], "steps_timed": steps, "warmup": warmup,
        "losses": losses, "step_ms": secs * 1e3,
        "images_per_s_per_gpu": batch / secs, "flops_per_image": flops,
        "mfu": flops * batch / secs / H100_BF16_PEAK,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "resident_mem_gib": resident, "flash_launches": launches}


def bn_costs(model) -> dict:
    """What BatchNorm's flax bookkeeping costs on the step, apart from the
    normalisation itself: the biased-variance read-back and the running
    update of every BatchNorm of ``model`` (device ms, and host ms per
    step), and which implementation ``F.batch_norm`` picks for the bf16
    channels_last input (0 native, 1 cuDNN)."""
    import torch

    from horovod_tpu_torch.models.layers import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    stats = [(torch.zeros_like(m.running_mean), torch.ones_like(
        m.running_var)) for m in bns]

    def update():
        with torch.no_grad():
            for m, (mean, invstd) in zip(bns, stats):
                m.update_running(mean, invstd.pow(-2).sub_(m.eps))

    # two updates a batch: ~640 launches, which the host issues within
    # cuda_ms's device sleep, so the time is the device's
    device_ms = cuda_ms(update, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        update()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    dev = bns[0].running_mean.device
    x = torch.randn(8, 64, 56, 56, device=dev, dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.ones(64, device=dev)
    impl = torch.ops.aten._batch_norm_impl_index(
        x, w, w, None, None, True, 0.0, 1e-5, True)[4]
    return {"batch_norms": len(bns), "update_device_ms": device_ms,
            "update_host_ms": host_ms, "bf16_channels_last_impl": impl}


def resnet(fa) -> dict:
    """ResNet-50, bf16, 224, batch 128: ``off`` and ``bucket`` against
    each other and the first loss against fp32 (TF32 off).  Returns the
    ``off`` run's record."""
    from horovod_tpu_torch.train import build_step

    name, _, batch, size = RESNET_STEP
    step, state, static = build_step(name, "fp32", batch, size)
    fp32_first = float(step(*state)[-1])
    costs = bn_costs(state[0])
    del step, state
    release()
    runs, issues = {}, []
    for mode in ("off", "bucket"):
        step, state, static = build_step(*RESNET_STEP, overlap_mode=mode,
                                         grad_bucket_mb=16)
        plan = state[2]
        if mode != "off":
            plan.on_issue = issues.append
        state, run = drive_conv(fa, name, step, state, static, WARMUP, STEPS)
        if mode != "off":
            plan.on_issue = None
            n = len(plan.layout.buckets)
            run.update(buckets=n, bucket_bytes=[b.nbytes for b in
                                                plan.layout.buckets],
                       issue_order_step_1=issues[:n])
            per_step = [sorted(issues[i:i + n])
                        for i in range(0, len(issues), n)]
            if len(issues) != n * (WARMUP + STEPS) or \
                    any(p != list(range(n)) for p in per_step):
                raise AssertionError(f"bucket issues {issues} are not each "
                                     f"of {n} buckets once per step")
        run["profile"] = profile_step(state, step, run["step_ms"], top=8)
        runs[mode] = run
        del step, state, plan
        release()
    off, bucket = runs["off"]["losses"], runs["bucket"]["losses"]
    rel_bucket = max_rel(bucket, off)
    rel_bf16 = abs(off[0] - fp32_first) / abs(fp32_first)
    emit("resnet", model=name, dtype="bf16", mfu_peak_flops=H100_BF16_PEAK,
         modes=runs, batch_norm_bookkeeping=costs,
         max_rel_loss_diff_bucket_vs_off=rel_bucket,
         bitwise_equal_bucket_vs_off=bucket == off,
         bucket_loss_rtol=OVERLAP_LOSS_RTOL, fp32_first_loss=fp32_first,
         rel_diff_bf16_vs_fp32_first_loss=rel_bf16, bf16_loss_rtol=LOSS_RTOL)
    if rel_bucket > OVERLAP_LOSS_RTOL:
        raise AssertionError(f"bucket losses {bucket} differ from off's "
                             f"{off} by {rel_bucket:.2e}")
    if rel_bf16 > LOSS_RTOL:
        raise AssertionError(f"bf16 first loss {off[0]} differs from fp32's "
                             f"{fp32_first} by {rel_bf16:.4f}")
    return runs["off"]


def zoo(fa) -> None:
    """VGG-16 (224) and Inception V3 (299), bf16, batch ``ZOO_BATCH``."""
    from horovod_tpu_torch.train import build_step

    runs = {}
    for name, size in ZOO:
        step, state, static = build_step(name, "bf16", ZOO_BATCH, size)
        state, runs[name] = drive_conv(fa, name, step, state, static,
                                       ZOO_WARMUP, ZOO_STEPS)
        runs[name]["profile"] = profile_step(state, step,
                                             runs[name]["step_ms"], top=4)
        del step, state
        release()
    emit("zoo", dtype="bf16", mfu_peak_flops=H100_BF16_PEAK, models=runs)


def conv(fa) -> dict:
    """Phase ``conv``: ``conv_check``, ``resnet``, ``zoo``; returns the
    ResNet-50 ``off`` run's record."""
    conv_check()
    off = resnet(fa)
    zoo(fa)
    return off


# ---------------------------------------------------------------------------
# reductions: Adasum, the two-level schedules, the sparse path
# ---------------------------------------------------------------------------

def gpt_with(build_opt):
    """``train``'s gpt-small step, weights and tokens, its optimizer
    replaced by ``build_opt(model)`` (AdamW with optax's constants inside
    any plane)."""
    from horovod_tpu_torch.train import build_gpt_step

    step, state, _ = build_gpt_step(*GPT_STEP)
    model = state[0]
    return step, (model, build_opt(model), state[2])


def reduction_runs(hvd):
    """The four ways of phase ``reductions``: name -> (optimizer factory,
    whether its losses must equal ``train``'s bit for bit)."""
    from horovod_tpu_torch.optim.overlap import OverlapPlan
    from horovod_tpu_torch.train import make_adamw

    axes = (hvd.LOCAL_AXIS, hvd.CROSS_AXIS)
    return {
        "adasum": (lambda m: hvd.DistributedOptimizer(
            make_adamw(m.parameters()), op=hvd.Adasum), True),
        "hierarchical_bucket": (lambda m: OverlapPlan(
            m.parameters(), make_adamw, mode="bucket",
            hierarchical_axes=axes), True),
        "hierarchical_bucket+zero1": (lambda m: OverlapPlan(
            m.parameters(), make_adamw, mode="bucket+zero1",
            hierarchical_axes=axes), True),
        "hierarchical_bucket_bf16_cross": (lambda m: OverlapPlan(
            m.parameters(), make_adamw, mode="bucket",
            hierarchical_axes=axes, dcn_compression="bf16"), False),
    }


SPARSE_ROWS, SPARSE_DIM, SPARSE_LOOKUPS, SPARSE_STEPS = 64, 16, 32, 3


def sparse_sgd(sparse_as_dense: bool, device: str = "cuda"):
    """``SPARSE_STEPS`` SGD steps (lr 0.5) of an ``nn.Embedding(sparse=True)``
    through ``DistributedOptimizer(sparse_as_dense=...)`` on ``device`` (a
    world of one); the final weights on the CPU and the kind of gradient
    SGD got at each step.  Weights and loss weights are multiples
    of 2^-4 no larger than 4 and the lookups repeat rows, so every sum is
    exact in any order: the paths may differ only in where the duplicate
    rows are combined."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd

    rng = np.random.RandomState(3)
    weight = torch.from_numpy(
        (rng.randint(-32, 33, (SPARSE_ROWS, SPARSE_DIM)) / 16)
        .astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, SPARSE_ROWS // 4,
                                       (SPARSE_STEPS, SPARSE_LOOKUPS)))
    w = torch.from_numpy((rng.randint(-8, 9, (SPARSE_STEPS, SPARSE_LOOKUPS,
                                              SPARSE_DIM)) / 16)
                         .astype(np.float32))
    emb = torch.nn.Embedding(SPARSE_ROWS, SPARSE_DIM, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(weight)
    emb = emb.to(device)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.5),
                                   sparse_as_dense=sparse_as_dense)
    kinds = []
    for k in range(SPARSE_STEPS):
        opt.zero_grad()
        (emb(idx[k].to(device)) * w[k].to(device)).sum().backward()
        opt.synchronize()
        kinds.append("sparse" if emb.weight.grad.is_sparse else "dense")
        opt.optimizer.step()
    return emb.weight.detach().cpu(), kinds


def reductions(hvd, fa, train_run) -> dict:
    """Phase ``reductions``: gpt-small from ``train``'s weights and tokens
    through Adasum and the two-level planes (exact launches, losses
    against ``train``'s), then the sparse embedding path."""
    import torch

    out = {}
    for name, (build_opt, bitwise) in reduction_runs(hvd).items():
        step, state = gpt_with(build_opt)
        state, run = drive(fa, step, state)
        run["profile"] = profile_step(state, step, run["step_ms"], top=4)
        rel = max_rel(run["losses"], train_run["losses"])
        run.update(max_rel_loss_diff_vs_train=rel,
                   bitwise_equal_to_train=run["losses"]
                   == train_run["losses"])
        out[name] = run
        del step, state
        release()
        if bitwise and not run["bitwise_equal_to_train"]:
            raise AssertionError(
                f"{name}: losses {run['losses']} differ from train's "
                f"{train_run['losses']} (at world 1 the reduce is the "
                "identity)")
        if rel > LOSS_RTOL:
            raise AssertionError(f"{name}: losses {run['losses']} differ "
                                 f"from train's by {rel:.4f} > {LOSS_RTOL}")
    sparse = {d: sparse_sgd(d) for d in (True, False)}
    same = torch.equal(sparse[True][0], sparse[False][0])
    emit("reductions", model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3], world=1,
         train_losses=train_run["losses"], loss_rtol=LOSS_RTOL, runs=out,
         sparse={"rows": SPARSE_ROWS, "dim": SPARSE_DIM,
                 "lookups_per_step": SPARSE_LOOKUPS, "steps": SPARSE_STEPS,
                 "grad_kinds": {str(d): sparse[d][1] for d in sparse},
                 "dense_equals_sparse": same})
    if not same or sparse[False][1] != ["sparse"] * SPARSE_STEPS:
        raise AssertionError(f"sparse_as_dense=False left "
                             f"{sparse[False][1]} gradients, or its weights "
                             "differ from the densified path's")
    return out


# ---------------------------------------------------------------------------
# the eager named-tensor engine
# ---------------------------------------------------------------------------

# the data plane's check: one fused response of a transformer block's
# gradients at gpt-small's width (fp32 and bf16), pre- and post-scaled
PLANE_SHAPES = ((2304, 768), (2304,), (768, 768), (768,), (768,), (768,),
                (3072, 768), (3072,), (768, 3072), (768,), (768,), (768,))
PLANE_SCALES = (0.5, 3.0)
# device cycles the producer's stream sleeps before it writes the payloads
# (~0.5 s at the H100's clock): an engine that read them without waiting on
# their ready events would reduce stale memory
PLANE_SLEEP = 1_000_000_000


def eager_ops_check(device: str = "cuda") -> dict:
    """Every eager op on ``device`` tensors in a world of one: the result
    on the caller's device with the input's dtype, equal to the input (the
    scales applied), in place where asked.  Returns name -> (device,
    dtype); raises on a mismatch."""
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.interop.torch as ht
    from horovod_tpu_torch.ops import eager

    x = torch.arange(12, dtype=torch.float32, device=device).reshape(4, 3)
    cases = {
        "allreduce_average": (x, lambda t: eager.allreduce(t), x),
        "allreduce_sum_bf16": (x.bfloat16(), lambda t: eager.allreduce(
            t, hvd.Sum), x.bfloat16()),
        "allreduce_min_int32": (x.int(), lambda t: eager.allreduce(
            t, hvd.Min), x.int()),
        "allreduce_max": (x, lambda t: eager.allreduce(t, hvd.Max), x),
        "allreduce_scaled": (x, lambda t: eager.allreduce(
            t, hvd.Sum, prescale_factor=2.0, postscale_factor=3.0), x * 6),
        "allreduce_adasum": (x, lambda t: eager.allreduce(t, hvd.Adasum), x),
        "allreduce_inplace": (x.clone(), lambda t: eager.allreduce_(
            t, hvd.Sum), x),
        "allgather": (x, eager.allgather, x),
        "broadcast": (x, lambda t: eager.broadcast(t, 0), x),
        "broadcast_inplace": (x.clone(), lambda t: eager.broadcast_(t, 0), x),
        "alltoall": (x, eager.alltoall, x),
        "reducescatter": (x, eager.reducescatter, x),
        "interop_allreduce_fp16_wire": (x, lambda t: ht.allreduce(
            t, op=ht.Sum, compression=ht.Compression.fp16), x),
    }
    out = {}
    for name, (t, fn, want) in cases.items():
        got = fn(t)
        out[name] = (str(got.device), str(got.dtype))
        if got.device != t.device or got.dtype != t.dtype \
                or not torch.equal(got, want):
            raise AssertionError(f"eager {name}: {got.dtype} on {got.device}"
                                 f" {got.flatten()[:4].tolist()}, want "
                                 f"{want.dtype} on {t.device} "
                                 f"{want.flatten()[:4].tolist()}")
    return out


def eager_plane_check(shapes=PLANE_SHAPES, scales=PLANE_SCALES) -> dict:
    """The engine's device data plane on a 1-rank NCCL group of its own:
    one fused response (pack into the fusion buffer, one NCCL allreduce,
    unpack), pre- and post-scaled, in fp32 and bf16, run on a background
    thread with the engine's stream current, as the engine's loop runs it.
    The payloads are written on the caller's stream behind a device sleep,
    so only an engine stream that waits on their ready events reads them.
    ``synchronize`` must return while the caller's stream is still busy
    (it orders the result on the stream, it does not block the host), and
    the results are read on the caller's stream right after it, before
    anything drains the card: only a caller's stream that waits on the
    results' completion events reads them written.  Held against the
    plain version (scale, reduce over one rank, scale) on the same inputs:
    equal, bit for bit (the same elementwise operations in the same
    order).  Each dtype runs twice, the first time on the negated values
    to warm the communicator and the allocator up (so memory the second
    pass reuses holds other numbers).  Returns the record."""
    import threading

    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops import eager
    from horovod_tpu_torch.ops.collectives import ReduceOp
    from horovod_tpu_torch.runtime.device_plane import DataPlane
    from horovod_tpu_torch.runtime.engine import EagerEngine, \
        TensorTableEntry, dtype_name
    from horovod_tpu_torch.runtime.messages import Request, RequestType, \
        Response, ResponseType

    dev = torch.device("cuda", torch.cuda.current_device())
    eng = EagerEngine()  # a world of one: no thread, no planes of its own
    eng._device_plane = DataPlane(dist.new_group([0], backend="nccl"), dev,
                                  1)
    eng._stream = torch.cuda.Stream(dev)
    pre, post = scales
    gen = torch.Generator(device=dev).manual_seed(0)

    def fused_pass(dtype, values):
        """One engine cycle's worth of the response; the results, the host
        time to the last synchronize, and whether the caller's stream was
        still busy then."""
        names = [f"plane.{dtype_name(dtype)}.{i}" for i in range(len(shapes))]
        srcs = [torch.empty_like(v) for v in values]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(PLANE_SLEEP)
        futures = []
        for name, src, v, shape in zip(names, srcs, values, shapes):
            src.copy_(v)  # the late write, then enqueue's snapshot of it
            copy, ready = eng._snapshot(src)
            req = Request(0, RequestType.ALLREDUCE, name, dtype_name(dtype),
                          tuple(shape), int(ReduceOp.AVERAGE), -1, pre, post,
                          True)
            entry = TensorTableEntry(request=req, tensor=copy, ready=ready)
            eng._table[name] = entry
            futures.append(entry.future)
        resp = Response(ResponseType.ALLREDUCE, list(names))
        resp._shapes = [tuple(s) for s in shapes]
        resp._dtype = dtype_name(dtype)
        resp._fuse_meta = (dtype_name(dtype), int(ReduceOp.AVERAGE), pre,
                           post)
        resp._device = True

        def cycle():
            torch.cuda.set_device(dev)
            with torch.cuda.stream(eng._stream):
                eng._perform_operation(resp)

        thread = threading.Thread(target=cycle)
        thread.start()
        thread.join(timeout=120)
        outs = [eager.synchronize(f) for f in futures]
        host_ms = (time.perf_counter() - t0) * 1e3
        busy = not torch.cuda.current_stream().query()
        # read on the caller's stream, queued behind synchronize's wait
        reads = [o.clone() for o in outs]
        torch.cuda.synchronize()
        return outs, reads, host_ms, busy

    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        values = [torch.randn(s, generator=gen, device=dev).to(dtype)
                  for s in shapes]
        fused_pass(dtype, [-v for v in values])  # warm-up
        outs, reads, host_ms, busy = fused_pass(dtype, values)
        plain = [(((v.float() * pre).to(dtype).float()) / 1 * post).to(dtype)
                 for v in values]
        err = max(float((o.float() - w.float()).abs().max())
                  for o, w in zip(reads, plain))
        on_card = all(o.is_cuda and o.dtype == dtype for o in outs)
        record[dtype_name(dtype)] = dict(
            tensors=len(shapes),
            bytes=sum(v.numel() * v.element_size() for v in values),
            on_card=on_card, max_abs_err=err, tolerance=0.0,
            synchronize_left_stream_busy=busy,
            host_ms_to_synchronized=host_ms)
        if err != 0.0 or not on_card:
            raise AssertionError(f"data plane {dtype}: max |engine - plain| "
                                 f"{err}, results on the card {on_card}")
        if not busy:
            raise AssertionError(
                "synchronize returned after the caller's stream drained: it "
                "blocked the host instead of ordering the stream")
    record["device_data_ops"] = eng.stats["device_data_ops"]
    # the fused allreduce (pack, NCCL, scales) and its plain version at these
    # shapes, device time
    x = [torch.randn(s, device=dev) for s in shapes]
    entries = [TensorTableEntry(None, t) for t in x]

    def fused():
        buf = eng._pack(entries, shapes, torch.float32, dev, None)
        eng._device_plane.allreduce(buf, int(ReduceOp.AVERAGE), pre, post,
                                    torch.float32, False)

    record["fused_allreduce_ms"] = cuda_ms(fused, 20)
    record["plain_ms"] = cuda_ms(lambda: [t * pre * post for t in x], 20)
    return record


def eager(hvd, fa, train_run) -> dict:
    """Phase ``eager``: ``train``'s gpt-small steps from its weights and
    tokens through ``interop.torch.DistributedOptimizer`` (per-parameter
    hooks -> ``allreduce_async`` named ``allreduce.<param>`` ->
    ``synchronize`` in ``step()``): exact launches, losses bit for bit
    ``train``'s (at world 1 every allreduce is the identity, scale 1), one
    handle per parameter and step (149); then every eager op's result on the card and the data
    plane's fused allreduce on a 1-rank NCCL group against its plain
    version."""
    import horovod_tpu_torch.interop.torch as ht
    from horovod_tpu_torch.obs import get_registry
    from horovod_tpu_torch.train import make_adamw

    step, state = gpt_with(lambda m: ht.DistributedOptimizer(
        make_adamw(m.parameters()), named_parameters=m.named_parameters()))
    names = set(state[1]._names.values())
    # one named allreduce per parameter and step: 149 for gpt-small (12
    # blocks of 12, wpe, wte, the final LayerNorm's 2, the head)
    n_params = len(list(state[0].parameters()))
    completed = get_registry().counter("engine.collectives_completed")
    before = completed.value
    state, run = drive(fa, step, state)
    handles = (completed.value - before) / (STEPS + WARMUP)
    run["profile"] = profile_step(state, step, run["step_ms"], top=6)
    grads_on_card = all(p.grad is None or p.grad.is_cuda
                        for p in state[0].parameters())
    run.update(handles_per_step=handles, named_tensors=len(names),
               parameters=n_params,
               grads_on_card=grads_on_card,
               bitwise_equal_to_train=run["losses"] == train_run["losses"],
               max_rel_loss_diff_vs_train=max_rel(run["losses"],
                                                  train_run["losses"]))
    del step, state
    release()
    ops = eager_ops_check()
    plane = eager_plane_check()
    emit("eager", model="gpt-small", dtype="bf16", batch_per_gpu=GPT_STEP[2],
         seq=GPT_STEP[3], world=1, train_losses=train_run["losses"],
         run=run, ops=ops, plane=plane)
    if not run["bitwise_equal_to_train"]:
        raise AssertionError(
            f"eager: losses {run['losses']} differ from train's "
            f"{train_run['losses']} (at world 1 every allreduce is the "
            "identity)")
    if handles != n_params or len(names) != n_params:
        raise AssertionError(f"eager: {handles} handles a step over "
                             f"{len(names)} names, want {n_params}")
    if not grads_on_card:
        raise AssertionError("eager: a gradient left the card")
    return run


# the native engine's two-rank run (phase ``native`` ii): steps a rank
NATIVE_WARMUP, NATIVE_STEPS = 1, 2
# native (ii)'s microbench leg: payload sizes (KB) and timed allreduces
NATIVE_BENCH_KB = (4, 1024, 16384)
NATIVE_BENCH_ITERS = 10


def hook_optimizer(model):
    """``interop.torch.DistributedOptimizer`` around AdamW, every parameter
    named: the ``horovod.torch`` script's optimizer."""
    import horovod_tpu_torch.interop.torch as ht
    from horovod_tpu_torch.train import make_adamw

    return ht.DistributedOptimizer(make_adamw(model.parameters()),
                                   named_parameters=model.named_parameters())


def native_build_timed():
    """The native engine's library, built from the checkout's
    ``csrc/engine`` (``runtime/native_build.py``), and the seconds taken."""
    from horovod_tpu_torch.runtime import native_build

    t0 = time.perf_counter()
    lib = native_build.build()
    return lib, time.perf_counter() - t0


def native(fa, train_run, eager_run, built) -> dict:
    """Phase ``native`` (the module docstring's 10): the hook optimizer's
    step through the C++ engine, (i) in this process at world 1, (ii) two
    ranks on the one card through the engine's TCP ring.  ``built``: the
    future of ``native_build_timed``, started beside the kernels' build
    (its failure raises here)."""
    import os
    import shutil
    import tempfile

    from horovod_tpu_torch import _engine_registry
    from horovod_tpu_torch.ops import kernels
    from horovod_tpu_torch.runtime.native import NativeEngine
    from horovod_tpu_torch.world_check import _engine_env

    lib, build_s = built.result()
    total = WARMUP + STEPS
    with _engine_env(HVDTPU_EAGER_ENGINE="native"):
        step, state = gpt_with(hook_optimizer)
        eng = _engine_registry.get_engine()
        if not isinstance(eng, NativeEngine):
            raise AssertionError(f"native: the engine is {type(eng)}")
        before = eng.stats
        state, run = drive(fa, step, state)
        after = eng.stats
        grads_on_card = all(p.grad is None or p.grad.is_cuda
                            for p in state[0].parameters())
        n_params = len(list(state[0].parameters()))
        del step, state
    per_step = {k: (after[k] - before[k]) / total
                for k in ("enqueued", "device_payloads",
                          "device_payload_bytes", "cycles", "responses",
                          "fused_responses", "wire_bytes")}
    run.update(per_step=per_step, handles_per_step=per_step["enqueued"],
               parameters=n_params, grads_on_card=grads_on_card,
               bitwise_equal_to_train=run["losses"] == train_run["losses"],
               eager_python_step_ms=eager_run["step_ms"])
    release()
    if not run["bitwise_equal_to_train"]:
        raise AssertionError(f"native (i): losses {run['losses']} differ "
                             f"from train's {train_run['losses']}")
    if per_step["enqueued"] != n_params or \
            per_step["device_payloads"] != n_params:
        raise AssertionError(f"native (i): {per_step} a step, want "
                             f"{n_params} handles and CUDA payloads")
    if not grads_on_card:
        raise AssertionError("native (i): a gradient left the card")

    root = tempfile.mkdtemp(prefix="native_run_", dir=kernels.build_dir())
    try:
        out, wall = hvdrun("-np", "2", sys.executable,
                           os.path.abspath(__file__), "--native-worker",
                           os.path.join(root, "rank"),
                           env={"HVDTPU_EAGER_ENGINE": "native"},
                           timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"native (ii) exited {out.returncode}:\n"
                                 f"{out.stderr[-6000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(root, f"rank.{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n = NATIVE_WARMUP + NATIVE_STEPS
    want = {k: 12 * n if k in MAIN_PATH else 0 for k in SOURCES}
    two = {"wall_s": wall, "steps": n, "warmup": NATIVE_WARMUP,
           "ranks": ranks,
           "timed_step_ms": [sum(r["step_ms"][NATIVE_WARMUP:]) / NATIVE_STEPS
                             for r in ranks]}
    emit("native", model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3], library=str(lib),
         build_s=build_s, world1=run, world2=two, card=card_line())
    for r, res in enumerate(ranks):
        if res["losses"] != train_run["losses"][:n]:
            raise AssertionError(
                f"native (ii) rank {r}: losses {res['losses']} differ from "
                f"train's {train_run['losses'][:n]}")
        got = {k: res["launches"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"native (ii) rank {r}: launches {got} != "
                                 f"{want}")
        if res["handles"] != [n_params] * n or not res["grads_on_card"]:
            raise AssertionError(
                f"native (ii) rank {r}: handles a step {res['handles']} "
                f"(want {n_params}), gradients on the card "
                f"{res['grads_on_card']}")
        if min(res["wire_bytes"]) <= 0 or res["world"] != 2:
            raise AssertionError(f"native (ii) rank {r}: nothing crossed "
                                 f"the ring: {res['wire_bytes']}")
    if ranks[0]["sha256"] != ranks[1]["sha256"]:
        raise AssertionError("native (ii): the ranks' parameters differ")
    micro = native_microbench(ranks)
    return {"world1": run, "world2": two, "microbench": micro}


def native_microbench(ranks) -> dict:
    """native (ii)'s microbench leg, read from both ranks' results: each
    rank's goodput and engine counters by size on an earlier line, then
    the reference's goodput table (rank 0's); every result must have been
    exactly world x input on both ranks."""
    from horovod_tpu_torch.bench import collective

    per_rank = [{"rank": r["rank"], "cells": [
        {k: c[k] for k in ("bytes", "iters", "seconds", "goodput",
                           "ops_per_sec", "exact", "device", "engine",
                           "stats")}
        for c in r["microbench"]]} for r in ranks]
    card = card_line()
    emit("native_microbench", world=2, engine="native",
         sizes_kb=list(NATIVE_BENCH_KB), iters=NATIVE_BENCH_ITERS,
         ranks=per_rank, card=card)
    bad = [(r["rank"], c["bytes"]) for r in ranks for c in r["microbench"]
           if not c["exact"] or c["world"] != 2]
    if bad or any(len(r["microbench"]) != len(NATIVE_BENCH_KB)
                  for r in ranks):
        raise AssertionError(f"native (ii) microbench: results not 2 x the "
                             f"input at (rank, bytes) {bad}")
    goodput = {(kb, 2): c["goodput"]
               for kb, c in zip(NATIVE_BENCH_KB, ranks[0]["microbench"])}
    print(collective.goodput_table("native", NATIVE_BENCH_ITERS, [2],
                                   NATIVE_BENCH_KB, goodput), flush=True)
    print(f"(native (ii), payloads on cuda:0, world 2 on one card; {card})",
          flush=True)
    return {"goodput": {str(kb): g for (kb, _), g in goodput.items()},
            "ranks": per_rank}


def native_worker(prefix: str) -> int:
    """``python chip_smoke.py --native-worker PREFIX``, one of phase
    ``native`` (ii)'s two ranks: a gloo world (``init(device="cpu")``; the
    native engine starts there), gpt-small bf16 built as ``train`` builds
    it but on ``cuda:0``, ``NATIVE_WARMUP`` + ``NATIVE_STEPS`` steps of the
    hook optimizer on ``train``'s tokens; writes each step's loss, ms and
    engine counters, the launches, and the parameters' SHA-256 to
    ``PREFIX.<rank>.json``."""
    import hashlib

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _engine_registry
    from horovod_tpu_torch.bench import collective
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import lm_loss

    _load_built_kernels("native worker")
    topo = hvd.init(device="cpu")
    eng = _engine_registry.get_engine()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    size, _, batch, seq = GPT_STEP
    # build_gpt_step's model and tokens (rank 0's slice of a world of one)
    model = gpt(size, device=dev, dtype=torch.bfloat16, max_len=seq,
                attention_impl="flash", remat=False, flash_block_q=512,
                flash_block_k=256, num_kv_heads=None,
                pos_embedding="learned", moe_experts=0, act_store_dtype=None,
                attention_window=None)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.cfg.vocab_size, size=(batch, seq + 1))).to(dev)
    opt = hook_optimizer(model)
    res = {"rank": topo.process_rank, "world": topo.process_count,
           "engine": type(eng).__name__, "losses": [], "step_ms": [],
           "handles": [], "fused_responses": [], "responses": [],
           "cycles": [], "wire_bytes": [], "device_payload_bytes": []}
    fa.reset_launch_counts()
    for _ in range(NATIVE_WARMUP + NATIVE_STEPS):
        before = eng.stats
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = lm_loss(model, toks)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        after = eng.stats
        res["losses"].append(float(loss.detach()))
        res["handles"].append(after["enqueued"] - before["enqueued"])
        for k in ("fused_responses", "responses", "cycles", "wire_bytes",
                  "device_payload_bytes"):
            res[k].append(after[k] - before[k])
    res["launches"] = dict(fa.LAUNCHES)
    res["grads_on_card"] = all(p.grad is None or p.grad.is_cuda
                               for p in model.parameters())
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    res["sha256"] = h.hexdigest()
    del model, opt
    torch.cuda.empty_cache()
    # the collective microbench's CUDA payload leg on this world's engine
    res["microbench"] = [
        collective.measure(kb * 1024, NATIVE_BENCH_ITERS, dev,
                           name=f"bench.{kb}")
        for kb in NATIVE_BENCH_KB]
    with open(f"{prefix}.{topo.process_rank}.json", "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


# ---------------------------------------------------------------------------
# fp8 activation storage
# ---------------------------------------------------------------------------

# the reference's tests/test_fp8.py contract: the first loss within 2% of
# bf16's (same weights: pure storage rounding), every later one within
# 15% + 0.05 (trajectories compound it)
FP8_FIRST_RTOL, FP8_LATER = 0.02, (0.15, 0.05)


def fp8_gates(name, fp8, bf16) -> None:
    if not all(math.isfinite(x) for x in fp8):
        raise AssertionError(f"{name} fp8: non-finite loss {fp8}")
    if abs(fp8[0] - bf16[0]) > FP8_FIRST_RTOL * abs(bf16[0]):
        raise AssertionError(f"{name} fp8 first loss {fp8[0]} vs bf16's "
                             f"{bf16[0]}: over {FP8_FIRST_RTOL}")
    rel, add = FP8_LATER
    for f, b in zip(fp8[1:], bf16[1:]):
        if abs(f - b) > rel * abs(b) + add:
            raise AssertionError(f"{name} fp8 losses {fp8} left bf16's "
                                 f"{bf16} by more than {rel} x + {add}")


def act_store_check() -> dict:
    """``act_store`` on the card against the CPU on ``act_store_grid`` (and
    the gradient, the same grid as cotangent): equal element for element,
    NaN where NaN."""
    import torch

    from horovod_tpu_torch.models.layers import act_store

    def same(a, b):
        a, b = a.double(), b.double()
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b))
                    and torch.equal(a[~nan], b[~nan]))

    out = {}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        x = act_store_grid(dt)
        res = {}
        for dev in ("cpu", "cuda"):
            y = torch.linspace(-3, 3, x.numel()).to(dt).to(dev)
            y.requires_grad_()
            val = act_store(x.to(dev), torch.float8_e4m3fn, dt)
            act_store(y, torch.float8_e4m3fn, dt).backward(x.to(dev))
            res[dev] = (val.cpu(), y.grad.cpu())
        ok = (same(res["cuda"][0], res["cpu"][0])
              and same(res["cuda"][1], res["cpu"][1]))
        out[str(dt)] = {"values": x.numel(), "card_equals_cpu": ok,
                        "nans": int(torch.isnan(res["cpu"][0]).sum())}
        if not ok:
            raise AssertionError(f"act_store on the card differs from the "
                                 f"CPU on the {dt} grid")
    return out


def fp8(fa, train_run, resnet_off) -> None:
    """Phase ``fp8``: gpt-small ``--dtype fp8`` from ``train``'s weights and
    tokens, ResNet-50 fp8 from the ``resnet`` phase's, each against its
    bf16 run; then ``act_store`` card against CPU."""
    from horovod_tpu_torch.train import build_gpt_step, build_step

    step, state, _ = build_gpt_step(GPT_STEP[0], "fp8", *GPT_STEP[2:])
    state, gpt_run = drive(fa, step, state)
    gpt_run["profile"] = profile_step(state, step, gpt_run["step_ms"], top=4)
    del step, state
    release()
    fp8_gates("gpt-small", gpt_run["losses"], train_run["losses"])

    name, _, batch, size = RESNET_STEP
    step, state, static = build_step(name, "fp8", batch, size)
    state, res_run = drive_conv(fa, name, step, state, static, WARMUP, STEPS)
    res_run["profile"] = profile_step(state, step, res_run["step_ms"], top=6)
    del step, state
    release()
    fp8_gates(name, res_run["losses"], resnet_off["losses"])

    def side_by_side(run, bf16, rate):
        return {"fp8_losses": run["losses"], "bf16_losses": bf16["losses"],
                "fp8_decreases": run["losses"][-1] < run["losses"][0],
                "bf16_decreases": bf16["losses"][-1] < bf16["losses"][0],
                "max_rel_loss_diff": max_rel(run["losses"], bf16["losses"]),
                "step_ms": {"fp8": run["step_ms"], "bf16": bf16["step_ms"]},
                rate: {"fp8": run[rate], "bf16": bf16[rate]},
                "mfu": {"fp8": run["mfu"], "bf16": bf16["mfu"]},
                "peak_mem_gib": {"fp8": run["peak_mem_gib"],
                                 "bf16": bf16["peak_mem_gib"]},
                "fp8_profile": run["profile"]}

    emit("fp8", store_dtype="float8_e4m3fn", compute_dtype="bf16",
         gates={"first_rtol": FP8_FIRST_RTOL, "later": FP8_LATER},
         gpt_small=dict(side_by_side(gpt_run, train_run,
                                     "tokens_per_s_per_gpu"),
                        launches=gpt_run["launches"]),
         resnet50=side_by_side(res_run, resnet_off, "images_per_s_per_gpu"),
         act_store=act_store_check())


# ---------------------------------------------------------------------------
# Serving: phases serve_check, serve and sampler_check.  The serving path
# runs no kernel of this repo: decode and prefill attention are fp32
# einsums in the reference (horovod_tpu/models/decode.py:115-168), and so
# in the port; the Dense products are cuBLAS's through F.linear.
# ---------------------------------------------------------------------------

VOCAB = 32000
# serve_check: gpt-small fp32, reference attention, TF32 off
SERVE_CHECK = {"slots": 8, "requests": 12, "prompt": (16, 257), "new": 16}
# logits, engine against a teacher-forced forward and card against CPU:
# |got - want| <= SERVE_LOGIT_RTOL x max |want| (fp32 sums in other
# orders over 768-wide rows and a 32000-wide head)
SERVE_LOGIT_RTOL = 1e-4
# fp32 tokens are held by the margin rule at this gap of the reference's
# top two logits
SERVE_FP32_MARGIN = 1e-3
SERVE_CPU_LAYERS = 2
# serve: gpt-small bf16, 48 requests all enqueued at step 0
SERVE_SLOTS = 16
SERVE_REQUESTS = 48
SERVE_PROMPT = (16, 769)
SERVE_NEW = (16, 129)
SERVE_SAMPLE_EVERY = 4
SERVE_SAMPLING = {"temperature": 0.8, "top_k": 50}
SERVE_PAGE_SIZE = 16
SERVE_PAGES = 512      # half the worst case (16 slots x 64 pages)
# bf16 greedy tokens against a teacher-forced bf16 forward (flash
# kernels): decode attends in fp32 over the bf16 cache, the forward in the
# flash kernels with bf16 P, and the head rounds the logits to bf16 (steps
# of 0.03125 at |logit| 4-8, where the top logits sit), so near ties are
# one or two such steps apart.  Held over whole streams on an NVIDIA H100
# 80GB HBM3 (700 W), the 36 greedy streams (2,293 tokens) show 51 near
# ties in 23 streams, the largest gap 0.03125; the margin is twice that.
# The phase checks that it still rejects a planted fault (``planted_fault``).
SERVE_BF16_MARGIN = 0.0625
# sampler_check
SAMPLER_SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)
SAMPLER_RIDS = ("", "r0", "req-1")
SAMPLER_INDICES = (0, 1, 17, 1000)
SAMPLER_ROWS = 256
SAMPLER_MARGIN = 1e-5
GUMBEL_ULPS = 2
SAMPLER_CPU_REPEATS = 20


def margin_rule(got, want, scores, tol, *, teacher_forced: bool) -> dict:
    """Hold token stream ``got`` against ``want``: equal, or a near tie:
    the reference's score of ``got`` within ``tol`` of its score of
    ``want`` (its top; bf16 logits tie three ways too, so this is the
    top-two rule without the count).  Raises on a violation.

    ``teacher_forced``: the reference's scores come from a forward over
    ``got``'s own history, so both sides share it at every step and the
    whole stream is held, near ties counted.  Otherwise (two engines
    decoding on their own) the histories part at the first near tie, and
    the comparison stops there."""
    import numpy as np

    scores = np.asarray(scores, dtype=np.float64)
    ties, gaps = [], []
    for i, (g, w) in enumerate(zip(list(got), list(want))):
        if g == w:
            continue
        gap = float(scores[i][w] - scores[i][g])
        if not gap <= tol:
            raise AssertionError(
                f"step {i}: token {g} != reference {w}, {gap:.4g} below it "
                f"in the reference's scores (tolerance {tol})")
        ties.append(i)
        gaps.append(gap)
        if not teacher_forced:
            return {"compared": i + 1, "near_ties": ties, "max_gap": gap}
    return {"compared": min(len(got), len(want)), "near_ties": ties,
            "max_gap": max(gaps, default=None)}


def serve_requests(n, prompt, new, sample_every=None, vocab=VOCAB):
    """``n`` requests: prompt lengths ``RandomState(0).randint(*prompt)``,
    budgets ``randint(*new)`` (or ``new`` itself), tokens ``randint(0,
    vocab)``; every ``sample_every``-th request (the 4th, 8th, ...)
    sampled with ``SERVE_SAMPLING``."""
    import numpy as np

    from horovod_tpu_torch.serve import Request

    rng = np.random.RandomState(0)
    lens = rng.randint(*prompt, size=n)
    news = rng.randint(*new, size=n) if isinstance(new, tuple) else [new] * n
    reqs = []
    for i in range(n):
        sampled = sample_every and (i + 1) % sample_every == 0
        reqs.append(Request(
            rid=f"r{i}", prompt=tuple(int(t) for t in rng.randint(
                0, vocab, lens[i])), max_new_tokens=int(news[i]),
            **(SERVE_SAMPLING if sampled else {})))
    return reqs


class LogitTap:
    """Taps the logits the engine's decode functions return (patched into
    ``horovod_tpu_torch.serve.engine`` while entered): a device-side NaN
    flag always, and with ``keep`` the last logits on the host."""

    NAMES = ("assign_slot", "assign_slot_paged", "decode_step",
             "decode_step_paged")

    def __init__(self, keep: bool):
        self.keep, self.last, self.nan = keep, None, None

    def __enter__(self):
        from horovod_tpu_torch.serve import engine

        self._orig = {n: getattr(engine, n) for n in self.NAMES}
        for n, fn in self._orig.items():
            setattr(engine, n, self._wrap(fn, n.startswith("assign")))
        return self

    def __exit__(self, *exc):
        from horovod_tpu_torch.serve import engine

        for n, fn in self._orig.items():
            setattr(engine, n, fn)

    def _wrap(self, fn, admit: bool):
        import torch

        def tapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            logits = out[1] if admit else out[0]
            flag = torch.isnan(logits).any()
            self.nan = flag if self.nan is None else self.nan | flag
            if self.keep:
                self.last = logits.float().cpu()
            return out

        return tapped


def serve_loop(engine, reqs, tap=None, timed: bool = False) -> dict:
    """The scheduler loop of ``tests/test_serve.py`` over ``reqs``, all
    enqueued at step 0: admit (the paged engine's page gate), record,
    evict, step, record, evict (``release_slot`` in paged mode).  Returns
    the tokens by request, with ``tap.keep`` the logits of each emission
    by request, and with ``timed`` CUDA events around every admission and
    step, the host time of each, and ``kv_stats`` at the step of most
    live KV rows (read after the loop)."""
    import torch

    from horovod_tpu_torch.serve import SlotScheduler, prompt_bucket

    sched = SlotScheduler(engine.num_slots)
    for r in reqs:
        sched.enqueue(r)
    paged = engine.paged is not None
    tokens, logits = {}, {r.rid: [] for r in reqs}
    admits_t, steps_t = [], []
    peak = {"live_rows": -1}

    def evict():
        for ev in sched.evict_finished():
            tokens[ev.rid] = list(ev.tokens)
            if paged:
                engine.release_slot(ev.slot)

    def events():
        if not timed:
            return None
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        return ev

    step = 0
    t0 = time.perf_counter()
    while len(tokens) < len(reqs):
        step += 1
        if step > 10_000:
            raise AssertionError(f"serving {len(reqs)} requests did not end")
        for adm in sched.admit(step, can_admit=engine.admission_gate()):
            req = adm.req
            ev, h0 = events(), time.perf_counter()
            tok = engine.admit(adm.slot, req.prompt, adm.resume,
                               total_len=len(req.prompt) + req.max_new_tokens,
                               temperature=req.temperature, top_k=req.top_k,
                               rid=req.rid)
            if ev:
                ev[1].record()
                admits_t.append((ev, time.perf_counter() - h0, prompt_bucket(
                    len(req.prompt), engine.serve_len)))
            if tap is not None and tap.keep:
                logits[req.rid].append(tap.last)
            sched.record(adm.slot, tok)
        evict()
        active = sorted(sched.active)
        if active:
            ev, h0 = events(), time.perf_counter()
            toks = engine.step(active)
            if ev:
                ev[1].record()
                steps_t.append((ev, time.perf_counter() - h0, len(active)))
            for slot in active:
                if tap is not None and tap.keep:
                    logits[sched.active[slot].req.rid].append(tap.last[slot])
                sched.record(slot, toks[slot])
            live = sum(len(a.req.prompt) + len(a.emitted) - 1
                       for a in sched.active.values())
            if timed and live > peak["live_rows"]:
                # no host read here: the paged stats are host state, the
                # contiguous positions are cloned on the card and read
                # after the loop
                peak = {"live_rows": live, "step": step,
                        "active": active,
                        "kv_stats": engine.kv_stats(active) if paged
                        else engine.cache["pos"].clone()}
        evict()
    wall = time.perf_counter() - t0
    if timed and not paged:
        pos, engine.cache["pos"] = engine.cache["pos"], peak["kv_stats"]
        peak["kv_stats"] = engine.kv_stats(peak["active"])
        engine.cache["pos"] = pos
    return {"tokens": tokens, "logits": logits, "steps": step, "wall_s": wall,
            "admits": admits_t, "decode_steps": steps_t, "peak": peak}


def teacher_forced(model, req, toks, device):
    """The model's logits over ``req.prompt + toks[:-1]`` at the positions
    that predict ``toks`` (fp32 on the host): the engine's own history."""
    import torch

    seq = torch.tensor([list(req.prompt) + toks[:-1]], device=device)
    return model(seq)[0, len(req.prompt) - 1:].float().cpu()


def bf16_margins(model, greedy, tokens, device) -> dict:
    """Each greedy request's tokens under the margin rule at
    ``SERVE_BF16_MARGIN`` against the teacher-forced forward; raises
    after the last request, naming every stream that failed."""
    import torch

    out, failed = {}, {}
    with torch.inference_mode():
        for r in greedy:
            want = teacher_forced(model, r, tokens[r.rid], device)
            try:
                out[r.rid] = margin_rule(
                    tokens[r.rid], want.argmax(-1).tolist(), want,
                    SERVE_BF16_MARGIN, teacher_forced=True)
            except AssertionError as e:
                failed[r.rid] = str(e)
    if failed:
        raise AssertionError(f"serve: {len(failed)} of {len(greedy)} greedy "
                             f"streams fail the bf16 margin rule: {failed}")
    return out


def planted_fault(model, reqs, slots, hold) -> dict:
    """A gate against a planted fault: a contiguous engine of ``slots``
    whose decode writes to the last row of every ``SERVE_PAGE_SIZE``-row
    block land one row late (so each such token drops out of every later
    step's history, a fault that shows only after the stream's first
    block boundary) serves ``reqs`` with its logits tapped;
    ``hold(run)``, the gate, must raise."""
    import torch

    from horovod_tpu_torch.models import decode
    from horovod_tpu_torch.serve import SlotEngine

    write_rows = decode._write_rows

    def late(buf, dest, valid, new):
        edge = dest % SERVE_PAGE_SIZE == SERVE_PAGE_SIZE - 1
        write_rows(buf, torch.where(edge, dest + 1, dest).clamp(
            max=buf.shape[1] - 1), valid, new)

    decode._write_rows = late
    try:
        with LogitTap(keep=True) as tap:
            run = serve_loop(SlotEngine(model, slots), reqs, tap)
    finally:
        decode._write_rows = write_rows
    try:
        hold(run)
    except AssertionError as e:
        return {"requests": len(reqs), "rejected": str(e)}
    raise AssertionError("a gate passed a planted fault (decode writes one "
                         "row late at each block boundary)")


def check_stream_logits(name, got, want, tol_rel) -> float:
    """The engine's logits of one request against the reference's, step by
    step: max |got - want| / max |want|; raises past ``tol_rel``."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        rel = (g - w).abs().max().item() / w.abs().max().item()
        worst = max(worst, rel)
        if not rel <= tol_rel:
            raise AssertionError(f"{name} step {i}: logits {rel:.3g} x max "
                                 f"|logit| from the reference's (> {tol_rel})")
    return worst


def serve_check(device: str = "cuda") -> dict:
    """Phase ``serve_check`` (fp32, TF32 off): gpt-small's contiguous
    ``SlotEngine`` (8 slots, 12 greedy requests of 16 tokens) against a
    teacher-forced ``GPT.forward`` (and the same gate against a planted
    fault), and at 2 layers the same engine on the card against the
    CPU."""
    import copy

    import torch

    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.serve import SlotEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reqs = serve_requests(SERVE_CHECK["requests"], SERVE_CHECK["prompt"],
                          SERVE_CHECK["new"])
    model = gpt("small", dtype=torch.float32, attention_impl="reference",
                device=device)

    def hold(run):
        """Every emission's logits within ``SERVE_LOGIT_RTOL`` of the
        teacher-forced forward (the first token's apart), every token by
        the margin rule; raises."""
        rel, margins = {"first": 0.0, "later": 0.0}, []
        with torch.inference_mode():
            for r in reqs:
                toks, got = run["tokens"][r.rid], run["logits"][r.rid]
                want = teacher_forced(model, r, toks, device)
                rel["first"] = max(rel["first"], check_stream_logits(
                    f"{r.rid} first token", got[:1], want[:1],
                    SERVE_LOGIT_RTOL))
                rel["later"] = max(rel["later"], check_stream_logits(
                    f"{r.rid} decode", got[1:], want[1:], SERVE_LOGIT_RTOL))
                margins.append(margin_rule(
                    toks, want.argmax(-1).tolist(), want, SERVE_FP32_MARGIN,
                    teacher_forced=True))
        return rel, margins

    with LogitTap(keep=True) as tap:
        run = serve_loop(SlotEngine(model, SERVE_CHECK["slots"]), reqs, tap)
    rel, margins = hold(run)
    fault = planted_fault(model, reqs, SERVE_CHECK["slots"], hold)
    del model, tap, run
    release()

    # card against CPU at gpt-small's widths, 2 layers, same weights
    cpu = gpt("small", dtype=torch.float32, attention_impl="reference",
              num_layers=SERVE_CPU_LAYERS, device="cpu")
    card = copy.deepcopy(cpu).to(device)
    runs = {}
    for dev, m in (("cpu", cpu), ("card", card)):
        with LogitTap(keep=True) as tap:
            runs[dev] = serve_loop(SlotEngine(m, SERVE_CHECK["slots"]), reqs,
                                   tap)
    step_rel, card_margins = 0.0, []
    for r in reqs:
        want_toks = runs["cpu"]["tokens"][r.rid]
        want_logits = runs["cpu"]["logits"][r.rid]
        m = margin_rule(runs["card"]["tokens"][r.rid], want_toks,
                        torch.stack(want_logits), SERVE_FP32_MARGIN,
                        teacher_forced=False)
        card_margins.append(m)
        n = m["compared"]
        step_rel = max(step_rel, check_stream_logits(
            f"{r.rid} card vs CPU", runs["card"]["logits"][r.rid][:n],
            want_logits[:n], SERVE_LOGIT_RTOL))
    del card, cpu
    release()
    out = {
        "model": "gpt-small", "dtype": "fp32", "tf32": False,
        "attention_impl": "reference", "slots": SERVE_CHECK["slots"],
        "requests": len(reqs), "new_tokens": SERVE_CHECK["new"],
        "logit_rtol": SERVE_LOGIT_RTOL, "margin": SERVE_FP32_MARGIN,
        "first_token_max_rel": rel["first"],
        "decode_max_rel": rel["later"],
        "tokens_compared": sum(m["compared"] for m in margins),
        "tokens": sum(r.max_new_tokens for r in reqs),
        "forward_near_ties": sum(len(m["near_ties"]) for m in margins),
        "planted_fault": fault,
        "card_vs_cpu": {"layers": SERVE_CPU_LAYERS, "step_max_rel": step_rel,
                        "tokens_compared": sum(m["compared"]
                                               for m in card_margins),
                        "streams_stopped_at_a_near_tie": [
                            r.rid for r, m in zip(reqs, card_margins)
                            if m["near_ties"]]},
    }
    emit("serve_check", **out)
    return out


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def serve_record(run, reqs, peak_mem) -> dict:
    """The timed numbers of one traffic run."""
    import torch

    torch.cuda.synchronize()
    new = sum(r.max_new_tokens for r in reqs)
    full = [(ev[0].elapsed_time(ev[1]), host * 1e3)
            for ev, host, n in run["decode_steps"] if n == SERVE_SLOTS]
    by_bucket: dict = {}
    for ev, host, bucket in run["admits"]:
        by_bucket.setdefault(bucket, []).append(ev[0].elapsed_time(ev[1]))
    return {
        "wall_s": run["wall_s"], "steps": run["steps"],
        "requests_per_s": len(reqs) / run["wall_s"],
        "generated_tokens_per_s": new / run["wall_s"],
        "decode_steps": len(run["decode_steps"]),
        "decode_steps_at_16": len(full),
        "decode_step_ms_median_at_16": _median([f[0] for f in full]),
        "decode_step_host_ms_median_at_16": _median([f[1] for f in full]),
        "prefill_ms_by_bucket": {
            str(b): {"median_ms": _median(v), "admissions": len(v)}
            for b, v in sorted(by_bucket.items())},
        "peak": run["peak"], "peak_mem_gib": peak_mem,
    }


def serve(fa, device: str = "cuda") -> dict:
    """Phase ``serve`` (bf16): gpt-small's ``SlotEngine`` with 16 slots,
    contiguous, then paged (512 pages of 16, half the worst case), over 48
    requests enqueued at step 0; the gates and numbers of the module
    docstring.  Each engine is profiled after its run and dropped before
    the next is built, so each run's peak memory is its own."""
    import torch

    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.serve import SlotEngine

    reqs = serve_requests(SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW,
                          SERVE_SAMPLE_EVERY)
    model = gpt("small", device=device)
    modes = {"contiguous": {},
             "paged": {"kv_mode": "paged", "page_size": SERVE_PAGE_SIZE,
                       "num_pages": SERVE_PAGES}}
    tokens, records = {}, {}
    for mode, kw in modes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = SlotEngine(model, SERVE_SLOTS, sample_seed=0, **kw)
        fa.reset_launch_counts()              # the serving path starts here
        with LogitTap(keep=False) as tap:
            run = serve_loop(eng, reqs, tap, timed=True)
            nan = bool(tap.nan)
        launches = dict(fa.LAUNCHES)          # ... and ends here
        records[mode] = serve_record(run, reqs,
                                     torch.cuda.max_memory_allocated() / 2**30)
        records[mode]["kernel_launches"] = launches
        tokens[mode] = run["tokens"]
        if nan:
            raise AssertionError(f"serve {mode}: a NaN logit")
        if any(launches.values()):
            raise AssertionError(f"serve {mode}: kernels of this repo "
                                 f"launched on the serving path: {launches}")
        records[mode]["after_the_run"] = serve_profiles(eng)
        del eng, run
        release_cache()
    for r in reqs:
        toks = tokens["contiguous"][r.rid]
        if len(toks) != r.max_new_tokens or not all(
                0 <= t < VOCAB for t in toks):
            raise AssertionError(f"serve {r.rid}: {len(toks)} tokens for a "
                                 f"budget of {r.max_new_tokens}, or one out "
                                 f"of range")
    differ = [r.rid for r in reqs
              if tokens["paged"][r.rid] != tokens["contiguous"][r.rid]]
    if differ:
        raise AssertionError(f"serve: paged and contiguous streams differ "
                             f"for {differ}")
    greedy = [r for r in reqs if r.temperature == 0]
    margins = bf16_margins(model, greedy, tokens["contiguous"], device)
    fault = planted_fault(
        model, greedy, SERVE_SLOTS,
        lambda run: bf16_margins(model, greedy, run["tokens"], device))
    del model
    release()
    gaps = [m["max_gap"] for m in margins.values() if m["near_ties"]]
    out = {
        "model": "gpt-small", "dtype": "bf16", "pos_embedding": "learned",
        "slots": SERVE_SLOTS, "requests": len(reqs),
        "prompt_range": SERVE_PROMPT, "new_range": SERVE_NEW,
        "sampled_every": SERVE_SAMPLE_EVERY, "sampling": SERVE_SAMPLING,
        "generated_tokens": sum(r.max_new_tokens for r in reqs),
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "page_pool": {"page_size": SERVE_PAGE_SIZE,
                      "num_pages": SERVE_PAGES},
        "paged_equals_contiguous": True,
        "bf16_margin": SERVE_BF16_MARGIN,
        "greedy_tokens_compared": sum(m["compared"]
                                      for m in margins.values()),
        "greedy_tokens": sum(r.max_new_tokens for r in greedy),
        "near_ties": sum(len(m["near_ties"]) for m in margins.values()),
        "streams_with_a_near_tie": len(gaps),
        "max_near_tie_gap": max(gaps, default=None),
        "planted_fault": fault,
        **records,
    }
    emit("serve", **out)
    return out


def release_cache() -> None:
    """Return the blocks of dropped tensors to the card (no check: the
    model of the phase is still alive)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


PROFILE_PROMPT = 480   # 16 x 31 pages of 16 fit the 512-page pool
PROFILE_STEPS = 5


def serve_profiles(eng) -> dict:
    """After a traffic run: 16 requests of ``PROFILE_PROMPT`` tokens in
    every slot, the decode step's host-clock time (median of
    ``PROFILE_STEPS``, each ending in the host read of the tokens) and one
    more step profiled as ``profile_step`` does; then one admission into
    slot 0 timed and profiled the same way."""
    import numpy as np

    eng.reset()
    rng = np.random.RandomState(1)
    prompts = [tuple(int(t) for t in rng.randint(0, VOCAB, PROFILE_PROMPT))
               for _ in range(SERVE_SLOTS)]
    total = PROFILE_PROMPT + 2 * PROFILE_STEPS + 2

    def admit():
        eng.release_slot(0)
        eng.admit(0, prompts[0], total_len=total)

    for slot, p in enumerate(prompts):
        eng.admit(slot, p, total_len=total)
    slots = list(range(SERVE_SLOTS))
    out = {}
    for name, fn in (("decode_step_16", lambda: eng.step(slots)),
                     ("admission_480", admit)):
        times = []
        for _ in range(PROFILE_STEPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = _median(times)
        out[name] = {"host_ms_median": ms, "host_ms": times,
                     "profile": profile_step((), fn, ms, top=8)}
    eng.reset()
    return out


def sampler_check(device: str = "cuda") -> dict:
    """Phase ``sampler_check``: the threefry layer and the sampler on the
    card against the CPU: keys, folds, splits, bits and uniform draws
    equal; Gumbel noise within ``GUMBEL_ULPS`` ulp (at the scale ``max(|g|,
    1)``) of ``-log(-log(u))`` in float64 on those draws; tokens of 256
    rows of 32000 fp32 logits under the margin rule against the float64
    scores.  The CPU's own float32 noise is measured against the same
    float64 values over ``SAMPLER_CPU_REPEATS`` draws, not gated."""
    import numpy as np
    import torch

    from horovod_tpu_torch.ops import prng
    from horovod_tpu_torch.serve import sampling

    keys = 0
    for seed in SAMPLER_SEEDS:
        for rid in SAMPLER_RIDS:
            base = {d: sampling.request_key(seed, rid, device=d)
                    for d in ("cpu", device)}
            outs = {d: [base[d], prng.split(base[d], (3, 4)),
                        prng.random_bits(base[d], (VOCAB,))]
                    + [sampling.token_key(base[d], i)
                       for i in SAMPLER_INDICES] for d in base}
            for a, b in zip(outs["cpu"], outs[device]):
                if not torch.equal(a, b.cpu()):
                    raise AssertionError(f"threefry on the card differs from "
                                         f"the CPU (seed {seed}, rid {rid!r})")
                keys += 1
    # Gumbel noise: the card's against -log(-log(u)) in float64 on the
    # uniform draws, which must be equal bit for bit on both sides.  The
    # CPU's float32 noise is not the reference: on the card's host it has
    # come out 840 ulp from the float64 value (the card's exact) in some
    # runs, so it is only measured (``cpu_gumbel``), over repeats.
    worst_ulps, worst = 0.0, None
    cpu = {"max_ulps": 0.0, "elements_over": 0, "draws": 0}
    for seed in SAMPLER_SEEDS:
        key = {d: prng.prng_key(seed, d) for d in ("cpu", device)}
        u = {d: prng.uniform(key[d], (VOCAB,), prng._F32_TINY, 1.0).cpu()
             for d in key}
        if not torch.equal(u["cpu"], u[device]):
            raise AssertionError(f"uniform draws on the card differ from the "
                                 f"CPU's (seed {seed})")
        exact = -np.log(-np.log(u["cpu"].numpy().astype(np.float64)))
        scale = np.spacing(np.maximum(np.abs(exact), 1.0).astype(np.float32))
        g = prng.gumbel(key[device], (VOCAB,)).cpu().numpy()
        per = np.abs(g - exact) / scale
        i = int(per.argmax())
        if worst is None or per[i] > worst_ulps:
            worst = {"seed": seed, "index": i, "ulps": float(per[i]),
                     "gumbel_card": float(g[i]), "exact": float(exact[i]),
                     "uniform": float(u["cpu"][i])}
        worst_ulps = max(worst_ulps, float(per[i]))
        if per[i] > GUMBEL_ULPS:
            raise AssertionError(f"gumbel on the card {per[i]} ulp from "
                                 f"-log(-log(u)) (> {GUMBEL_ULPS}): {worst}")
        for _ in range(SAMPLER_CPU_REPEATS):
            off = np.abs(prng.gumbel(key["cpu"], (VOCAB,)).numpy()
                         - exact) / scale
            cpu["max_ulps"] = max(cpu["max_ulps"], float(off.max()))
            cpu["elements_over"] += int((off > GUMBEL_ULPS).sum())
            cpu["draws"] += VOCAB
    rng = np.random.RandomState(0)
    logits = torch.from_numpy((rng.randn(SAMPLER_ROWS, VOCAB) * 3)
                              .astype(np.float32))
    temps = rng.choice([0.0, 0.8, 1.0], SAMPLER_ROWS).astype(np.float32)
    topks = rng.choice([0, 50, 1000], SAMPLER_ROWS)
    base = torch.stack([sampling.request_key(0, f"r{i}")
                        for i in range(SAMPLER_ROWS)])
    idx = torch.arange(SAMPLER_ROWS) % 7
    got = sampling.sample_token(logits.to(device), temps, topks,
                                sampling.token_key(base.to(device),
                                                   idx.to(device))).cpu()
    keys_cpu = sampling.token_key(base, idx)
    lt = logits / torch.from_numpy(np.where(temps > 0, temps, 1.0))[:, None]
    k = torch.from_numpy(np.where((topks > 0) & (topks < VOCAB), topks,
                                  VOCAB))
    kth = torch.sort(lt, dim=-1, descending=True).values.gather(
        1, (k - 1)[:, None])
    lt = torch.where(lt < kth, -torch.inf, lt)
    # the reference's scores: the filtered logits plus float64 noise on the
    # CPU's uniform draws (as above), or the logits for greedy rows
    u = prng.uniform(keys_cpu, (VOCAB,), prng._F32_TINY, 1.0).numpy()
    noise = -np.log(-np.log(u.astype(np.float64)))
    differ = 0
    for i in range(SAMPLER_ROWS):
        score = (lt[i].numpy().astype(np.float64) + noise[i]
                 if temps[i] > 0 else logits[i].numpy().astype(np.float64))
        m = margin_rule([int(got[i])], [int(score.argmax())], score[None],
                        SAMPLER_MARGIN, teacher_forced=True)
        differ += len(m["near_ties"])
    out = {"key_checks": keys, "gumbel_max_ulps": worst_ulps,
           "gumbel_worst": worst, "cpu_gumbel": cpu,
           "gumbel_ulp_limit": GUMBEL_ULPS, "rows": SAMPLER_ROWS,
           "vocab": VOCAB, "tokens_differing_at_near_ties": differ,
           "sampled_rows": int((temps > 0).sum())}
    emit("sampler_check", **out)
    return out


# ---------------------------------------------------------------------------
# Phase serve_fleet: the serving plane end to end.  gpt-small bf16 (full
# width and depth) behind the launcher's front door, two ranks on the one
# card, driven through ``python -m horovod_tpu_torch.run --elastic --serve``
# and ``python -m horovod_tpu_torch.serve`` and, last, ``python -m
# horovod_tpu_torch.bench --serve``.  No kernel of this repo runs there.
# ---------------------------------------------------------------------------

FLEET_NP = 2
FLEET_FRONTENDS = 2
FLEET_SIZE = "small"
# extra flags of the workers and of the bench (none on the card)
FLEET_WORKER_ARGS = ()
# the serve phase's requests, submitted open loop at exponential gaps of
# this mean rate (RandomState(1)), after one warm-up request
FLEET_RATE = 8.0
FLEET_WARM = ([7] * 40, 8)
# the leader dies at its 120th serving step: past the warm-up and the
# first arrivals (traffic starts by step ~30), before the 48 requests'
# ~200 decode steps are done
FLEET_KILL = "worker_exit:step=120:rank=0"
FLEET_SWAP_POLL = 8
FLEET_SWAP_SEED = 1
FLEET_SWAP_REQUESTS = 8
FLEET_TIMEOUT = 240
# bench --serve: the same pool at half the serve phase's requests/s (12
# requests: ~3.5-7 s of arrivals at ~1.7-3.5 a second; it was 24 before
# the A13b phases needed the time)
FLEET_BENCH_REQUESTS = 12


class Fleet:
    """One ``hvdrun --elastic --serve`` job in its own process: the
    launcher's stdout and stderr read on threads (each line stamped with
    the host clock), the client built from the printed ingest endpoint
    and the secret this script gave the launcher (``HVDTPU_SECRET``)."""

    def __init__(self, fault: str = "", weights_dir=None, np: int = FLEET_NP,
                 ranks: int = FLEET_NP, launcher_args=()):
        import os
        import secrets
        import threading

        from horovod_tpu_torch.serve import ServeClient

        self.secret = secrets.token_hex(16)
        # the ranks whose summaries stop() reads: np, or the autoscale
        # envelope's ceiling
        self.ranks = ranks
        args = ["--elastic", "--serve", "-np", str(np), "--frontends",
                str(FLEET_FRONTENDS), *launcher_args]
        if weights_dir:
            args += ["--serve-weights-dir", weights_dir,
                     "--serve-swap-poll-steps", str(FLEET_SWAP_POLL)]
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run", *args, "--",
               sys.executable, "-m", "horovod_tpu_torch.serve", "--size",
               FLEET_SIZE, *FLEET_WORKER_ARGS, "--slots", str(SERVE_SLOTS),
               "--page-size",
               str(SERVE_PAGE_SIZE), "--kv-pages", str(SERVE_PAGES),
               "--seed", "0"]
        self.command = " ".join(cmd[1:])
        env = dict(os.environ, HVDTPU_SECRET=self.secret,
                   HVDTPU_FAULT_SPEC=fault)
        self.t0 = time.time()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=env)
        self.out, self.err = [], []
        self.readers = [threading.Thread(target=self._read, args=(f, buf),
                                         daemon=True)
                        for f, buf in ((self.proc.stdout, self.out),
                                       (self.proc.stderr, self.err))]
        for t in self.readers:
            t.start()
        deadline = time.time() + 120
        addr = None
        while addr is None:
            for _, ln in list(self.out):
                if ln.startswith("[serve] ingest endpoint http://"):
                    addr = ln.split("http://", 1)[1].split()[0]
            if addr is None:
                if self.proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(f"no ingest endpoint:\n"
                                         f"{self.stderr()[-4000:]}")
                time.sleep(0.05)
        self.addr = addr
        self.client = ServeClient(addr, self.secret)

    @staticmethod
    def _read(f, buf):
        for ln in f:
            buf.append((time.time(), ln.rstrip("\n")))

    def stdout(self) -> str:
        return "\n".join(ln for _, ln in self.out)

    def stderr(self) -> str:
        return "\n".join(ln for _, ln in self.err)

    def stop(self) -> dict:
        """Drain: the stop sentinel, the launcher's exit, every rank's
        ``serve_summary`` (read back through the ``[rank]`` tags)."""
        self.client.stop()
        rc = self.proc.wait(timeout=FLEET_TIMEOUT)
        for t in self.readers:
            t.join(timeout=10)
        if rc != 0:
            raise AssertionError(f"the serving launcher exited {rc}:\n"
                                 f"{self.stderr()[-6000:]}")
        summaries = {}
        for rank in range(self.ranks):
            got = [r["serve_summary"] for r in tagged(self.stdout(), rank)
                   if "serve_summary" in r]
            if not got:
                raise AssertionError(f"rank {rank} printed no summary:\n"
                                     f"{self.stdout()[-4000:]}")
            summaries[rank] = got[-1]
        return summaries

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def fleet_traffic(client, reqs, gaps, timeout: float = FLEET_TIMEOUT):
    """Submit ``reqs`` open loop (request i at the sum of ``gaps[:i+1]``
    seconds, whatever the backlog) while polling every stream every ~10
    ms; returns each request's result doc with the client's stamps
    (``t_submit``, ``t_first`` token, ``t_done``), and the polls that saw
    a stream grow, as ``(time, rid, tokens, epoch)``."""
    import threading

    submit: dict = {}

    def submitter():
        t = time.perf_counter()
        for r, gap in zip(reqs, gaps):
            t += gap
            delay = t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            client.submit(list(r.prompt), max_new_tokens=r.max_new_tokens,
                          temperature=r.temperature, top_k=r.top_k,
                          rid=r.rid)
            submit[r.rid] = time.time()

    th = threading.Thread(target=submitter, daemon=True)
    th.start()
    docs, first, seen, growth = {}, {}, {}, []
    deadline = time.time() + timeout
    while len(docs) < len(reqs):
        if time.time() > deadline:
            raise AssertionError(f"fleet: {len(docs)}/{len(reqs)} requests "
                                 f"finished in {timeout} s")
        for r in reqs:
            if r.rid in docs or r.rid not in submit:
                continue
            doc = client.poll(r.rid)
            if doc is None:
                continue
            now, n = time.time(), len(doc.get("tokens", ()))
            if n > seen.get(r.rid, 0):
                seen[r.rid] = n
                growth.append((now, r.rid, n, doc.get("epoch")))
                first.setdefault(r.rid, now)
            if doc.get("done"):
                if doc.get("error"):
                    raise AssertionError(f"fleet: {r.rid} rejected: "
                                         f"{doc['error']}")
                docs[r.rid] = dict(doc, t_submit=submit[r.rid],
                                   t_first=first.get(r.rid, now),
                                   t_client_done=now)
        time.sleep(0.01)
    th.join(timeout=10)
    return docs, growth


def fleet_record(docs, reqs, summaries) -> dict:
    """Generated tokens/s and requests/s over ``wall_s`` (first submission
    to the last leader-clock completion stamp), TTFT and TPOT medians and
    p99 (client clock), and the schedule broadcast's host-clock ms on each
    rank."""
    import numpy as np

    t0 = min(d["t_submit"] for d in docs.values())
    t1 = max(d.get("t_done") or d["t_client_done"] for d in docs.values())
    toks = sum(len(d["tokens"]) for d in docs.values())
    ttft = [(d["t_first"] - d["t_submit"]) * 1e3 for d in docs.values()]
    tpot = [(d["t_client_done"] - d["t_first"]) * 1e3
            / max(len(d["tokens"]) - 1, 1) for d in docs.values()
            if len(d["tokens"]) > 1]

    def q(xs, p):
        return float(np.percentile(xs, p)) if xs else None

    return {
        "requests": len(reqs), "generated_tokens": toks, "wall_s": t1 - t0,
        "generated_tokens_per_s": toks / (t1 - t0),
        "requests_per_s": len(reqs) / (t1 - t0),
        "ttft_ms": {"p50": q(ttft, 50), "p99": q(ttft, 99)},
        "tpot_ms": {"p50": q(tpot, 50), "p99": q(tpot, 99)},
        "sched_ms": {str(r): {"p50": q(s.get("sched_ms") or [], 50),
                              "p99": q(s.get("sched_ms") or [], 99),
                              "steps": len(s.get("sched_ms") or [])}
                     for r, s in summaries.items()},
    }


def fleet_gates(name, reqs, docs, summaries) -> None:
    """Every request done with exactly its budget of in-range tokens, both
    ranks' summaries, and no kernel of this repo launched by a rank."""
    for r in reqs:
        toks = docs[r.rid]["tokens"]
        if len(toks) != r.max_new_tokens or not all(
                0 <= t < VOCAB for t in toks):
            raise AssertionError(f"{name} {r.rid}: {len(toks)} tokens for "
                                 f"a budget of {r.max_new_tokens}, or one "
                                 f"out of range")
    for rank, summ in summaries.items():
        if summ.get("kernel_launches"):
            raise AssertionError(f"{name}: rank {rank} launched kernels of "
                                 f"this repo: {summ['kernel_launches']}")


def finite_streams(model, reqs, tokens, device) -> None:
    """The teacher-forced forward over each stream is finite (a NaN logit
    in the engine shows as a stream the forward cannot follow)."""
    import torch

    with torch.inference_mode():
        for r in reqs:
            if not torch.isfinite(teacher_forced(model, r, tokens[r.rid],
                                                 device)).all():
                raise AssertionError(f"{r.rid}: non-finite logits along "
                                     f"its stream")


def serve_fleet(serve_run: dict, device: str = "cuda") -> dict:
    """Phase ``serve_fleet`` (see the module docstring): (a) a clean fleet
    serving the ``serve`` phase's 48 requests open loop, then (c) a
    hot-swap to a second version of the weights in the same fleet, (b) the
    same traffic with the leader killed mid-stream, (d) ``bench --serve``.
    ``serve_run``: the ``serve`` phase's record (its paged requests/s sets
    the bench's arrival rate)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.ops import kernels
    from horovod_tpu_torch.run.rendezvous import KVStoreClient
    from horovod_tpu_torch.serve import Request, publish_weights

    release()
    card = card_line()
    reqs = serve_requests(SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW,
                          SERVE_SAMPLE_EVERY, vocab=VOCAB)
    gaps = np.random.RandomState(1).exponential(1.0 / FLEET_RATE, len(reqs))
    greedy = [r for r in reqs if r.temperature == 0]
    sampled = [r for r in reqs if r.temperature > 0]
    warm = Request(rid="warm", prompt=tuple(FLEET_WARM[0]),
                   max_new_tokens=FLEET_WARM[1])
    os.makedirs(kernels.build_dir(), exist_ok=True)
    root = tempfile.mkdtemp(prefix="fleet_", dir=kernels.build_dir())
    runs = {}
    try:
        # (a) + (c): one fleet
        wdir = os.path.join(root, "weights")
        fleet = Fleet(weights_dir=wdir)
        try:
            fleet_traffic(fleet.client, [warm], [0.0])
            t_traffic = time.time()
            docs_a, _ = fleet_traffic(fleet.client, reqs, gaps)
            # (c) a second version of the weights, published mid-run
            new = gpt(FLEET_SIZE, device=device,
                      generator=torch.Generator().manual_seed(FLEET_SWAP_SEED))
            t_pub = time.time()
            publish_weights(wdir, new.state_dict(), 1,
                            kv=KVStoreClient(fleet.addr, fleet.secret))
            kv = KVStoreClient(fleet.addr, fleet.secret)
            while kv.get("serve", "weight_version") != b"1":
                if time.time() - t_pub > 60:
                    raise AssertionError("the fleet never flipped to "
                                         "weight version 1")
                time.sleep(0.05)
            t_flip = time.time()
            swap_reqs = serve_requests(FLEET_SWAP_REQUESTS, SERVE_PROMPT,
                                       SERVE_NEW, vocab=VOCAB)
            swap_reqs = [Request(rid=f"s{i}", prompt=r.prompt,
                                 max_new_tokens=r.max_new_tokens)
                         for i, r in enumerate(swap_reqs)]
            docs_c, _ = fleet_traffic(fleet.client, swap_reqs,
                                      [0.0] * len(swap_reqs))
            summ_a = fleet.stop()
            wall_a = time.time() - fleet.t0
        finally:
            fleet.close()
        fleet_gates("fleet clean", reqs, docs_a, summ_a)
        flips = {r: s.get("weight_flips") for r, s in summ_a.items()}
        if len({json.dumps(f) for f in flips.values()}) != 1 or \
                len(flips[0]) != 1 or flips[0][0][0] != 1:
            raise AssertionError(f"the ranks' weight flips differ or are "
                                 f"not one flip to version 1: {flips}")
        flip_epoch, flip_step = flips[0][0][1], flips[0][0][2]
        for r in swap_reqs:
            d = docs_c[r.rid]
            if (d["epoch"], d["admitted_step"]) < (flip_epoch, flip_step):
                raise AssertionError(f"{r.rid} admitted at {d['epoch']}/"
                                     f"{d['admitted_step']}, before the flip")
        model = gpt(FLEET_SIZE, device=device)
        tokens_a = {r.rid: docs_a[r.rid]["tokens"] for r in reqs}
        margins_a = bf16_margins(model, greedy, tokens_a, device)
        finite_streams(model, sampled, tokens_a, device)
        margins_c = bf16_margins(new, swap_reqs,
                                 {r.rid: docs_c[r.rid]["tokens"]
                                  for r in swap_reqs}, device)
        del new
        runs["clean"] = {
            "command": fleet.command, "job_wall_s": wall_a,
            "traffic_started_s": t_traffic - fleet.t0,
            **fleet_record(docs_a, reqs, summ_a),
            "epochs": sorted({d["epoch"] for d in docs_a.values()}),
            "greedy_near_ties": sum(len(m["near_ties"])
                                    for m in margins_a.values()),
            "completed_per_rank": {str(r): s["completed"]
                                   for r, s in summ_a.items()},
        }
        runs["swap"] = {
            "publish_to_flip_s": t_flip - t_pub,
            "flip": {"version": 1, "epoch": flip_epoch, "step": flip_step},
            "ranks_agree": True, "requests_after_flip": len(swap_reqs),
            "near_ties": sum(len(m["near_ties"])
                             for m in margins_c.values()),
            "weight_version_per_rank": {str(r): s.get("weight_version")
                                        for r, s in summ_a.items()},
        }

        # (b) the same traffic, the leader killed mid-stream
        fleet = Fleet(fault=FLEET_KILL)
        try:
            fleet_traffic(fleet.client, [warm], [0.0])
            docs_b, growth = fleet_traffic(fleet.client, reqs, gaps)
            summ_b = fleet.stop()
            wall_b = time.time() - fleet.t0
        finally:
            fleet.close()
        fleet_gates("fleet leader kill", reqs, docs_b, summ_b)
        stderr = [(t, ln) for t, ln in fleet.err if not ln.startswith("[")]
        failures = [t for t, ln in stderr if "exited 43" in ln]
        respawns = [t for t, ln in stderr if "elastic: respawned rank" in ln]
        if len(failures) != 1 or len(respawns) != 1:
            raise AssertionError(f"leader kill: {len(failures)} failures, "
                                 f"{len(respawns)} respawns:\n"
                                 f"{fleet.stderr()[-4000:]}")
        late = [rid for rid, d in docs_b.items() if d["epoch"] >= 1]
        if not late:
            raise AssertionError("leader kill: no request finished in "
                                 "epoch >= 1 (the kill was not mid-stream)")
        t_kill = failures[0]
        after = [t for t, _, _, epoch in growth
                 if t > t_kill and epoch is not None and epoch >= 1]
        tokens_b = {r.rid: docs_b[r.rid]["tokens"] for r in reqs}
        between, failed = {}, {}
        with torch.inference_mode():
            for r in greedy:
                want = teacher_forced(model, r, tokens_a[r.rid], device)
                try:
                    between[r.rid] = margin_rule(
                        tokens_b[r.rid], tokens_a[r.rid], want,
                        SERVE_BF16_MARGIN, teacher_forced=False)
                except AssertionError as e:
                    failed[r.rid] = str(e)
        if failed:
            raise AssertionError(f"leader kill: {len(failed)} greedy streams "
                                 f"fail the margin rule against the clean "
                                 f"run's: {failed}")
        margins_b = bf16_margins(model, greedy, tokens_b, device)
        finite_streams(model, sampled, tokens_b, device)
        del model
        release_cache()
        runs["leader_kill"] = {
            "fault_spec": FLEET_KILL, "job_wall_s": wall_b,
            **fleet_record(docs_b, reqs, summ_b),
            "failures": 1, "respawns": 1, "dropped": 0,
            "finished_in_epoch_1_or_later": len(late),
            "kill_to_first_token_s": (min(after) - t_kill) if after
            else None,
            "greedy_equal_to_clean": sum(
                tokens_b[r.rid] == tokens_a[r.rid] for r in greedy),
            "greedy_stopped_at_a_near_tie": [
                rid for rid, m in between.items() if m["near_ties"]],
            "greedy_self_near_ties": sum(len(m["near_ties"])
                                         for m in margins_b.values()),
            "sampled_equal_to_clean_bit_for_bit": sum(
                tokens_b[r.rid] == tokens_a[r.rid] for r in sampled),
            "sampled": len(sampled),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (d) bench --serve at gpt-small, half the serve phase's requests/s
    rate = round(serve_run["paged"]["requests_per_s"] / 2, 2)
    args = ("--serve", "--model", f"gpt-{FLEET_SIZE}", *FLEET_WORKER_ARGS,
            "--serve-slots",
            str(SERVE_SLOTS), "--serve-requests", str(FLEET_BENCH_REQUESTS),
            "--serve-rate", str(rate), "--serve-page-size",
            str(SERVE_PAGE_SIZE), "--serve-kv-pages", str(SERVE_PAGES))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.bench",
                          *args], capture_output=True, text=True,
                         timeout=FLEET_TIMEOUT * 2)
    if out.returncode != 0:
        raise AssertionError(f"bench --serve exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    record = json.loads(out.stdout.strip().splitlines()[-1])
    served = record["serve"]
    if served["total_tokens"] <= 0 or served.get(
            "completed_per_rank", {}).get("0", 0) < FLEET_BENCH_REQUESTS:
        raise AssertionError(f"bench --serve record {record}")
    runs["bench"] = {"command": "python -m horovod_tpu_torch.bench "
                     + " ".join(args), "wall_s": time.perf_counter() - t0,
                     "arrival_rate_per_s": rate,
                     "serve_phase_requests_per_s":
                     serve_run["paged"]["requests_per_s"],
                     "record": record}
    emit("serve_fleet", card=card, model=f"gpt-{FLEET_SIZE}", dtype="bf16",
         np=FLEET_NP, frontends=FLEET_FRONTENDS, slots=SERVE_SLOTS,
         page_pool={"page_size": SERVE_PAGE_SIZE, "num_pages": SERVE_PAGES},
         requests=len(reqs), arrival_rate_per_s=FLEET_RATE,
         bf16_margin=SERVE_BF16_MARGIN, runs=runs)
    for name in ("clean", "leader_kill"):
        r = runs[name]
        print(f"serve_fleet {name}: {r['generated_tokens_per_s']:.1f} "
              f"generated tokens/s, {r['requests_per_s']:.3f} requests/s, "
              f"TTFT p50/p99 {r['ttft_ms']['p50']:.1f}/"
              f"{r['ttft_ms']['p99']:.1f} ms, TPOT p50/p99 "
              f"{r['tpot_ms']['p50']:.2f}/{r['tpot_ms']['p99']:.2f} ms, "
              f"schedule broadcast p50 (rank 0) "
              f"{r['sched_ms']['0']['p50']} ms; {card}", flush=True)
    print(f"serve_fleet recovery: kill to first token "
          f"{runs['leader_kill']['kill_to_first_token_s']} s; swap flip at "
          f"epoch {flip_epoch} step {flip_step}, publish to flip "
          f"{runs['swap']['publish_to_flip_s']:.2f} s; {card}", flush=True)
    b = runs["bench"]["record"]["serve"]
    print(f"serve_fleet bench --serve at {rate} requests/s: "
          f"{b['tokens_per_sec']} generated tokens/s, "
          f"{b['requests_per_sec']} requests/s, TTFT p50/p99 "
          f"{b['ttft_ms']['p50']}/{b['ttft_ms']['p99']} ms, TPOT p50/p99 "
          f"{b['tpot_ms']['p50']}/{b['tpot_ms']['p99']} ms; {card}",
          flush=True)
    return runs


# cuDNN's NCHW <-> NHWC conversion kernels: device time in them means a
# tensor reached a convolution in the other layout
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw")
# device time by family of kernel: the first family whose any substring is
# in the kernel's name (cuDNN's and cuBLAS's sm90 kernels: "xmma", "gemm")
FAMILIES = (("flash", ("flash_",)), ("batch_norm", ("batch_norm",)),
            ("conv_matmul", ("xmma", "gemm", "conv", "cudnn", "cutlass")),
            ("pool", ("pool",)), ("concat", ("CatArray",)),
            ("optimizer", ("multi_tensor",)), ("nccl", ("nccl",)),
            ("reduce", ("reduce",)),
            ("elementwise", ("elementwise", "copy", "fill")))


def hvdrun(*args, env=None, timeout: int = 600):
    """``python -m horovod_tpu_torch.run *args`` (the port's launcher) in
    its own process: ``(completed process, wall seconds)``."""
    import os

    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", *args]
    full_env = dict(os.environ, **(env or {}))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, env=full_env)
    return out, time.perf_counter() - t0


def tagged(stdout: str, rank: int = 0) -> list:
    """The JSON objects rank ``rank`` printed, read back through the
    launcher's ``[rank]`` output tags."""
    tag = f"[{rank}]"
    return [json.loads(ln[len(tag):]) for ln in stdout.splitlines()
            if ln.startswith(tag + "{")]


def launcher_phase() -> dict:
    """``--check-build``, then ``bench --model gpt-nano`` through ``-np 1``
    of the port's launcher: the worker ran on ``cuda:0`` under the
    launcher's rendezvous environment and launched exactly ``NANO_PATH``
    (3 a step); its record is read back through the tagged output."""
    out, _ = hvdrun("--check-build", timeout=120)
    if out.returncode != 0:
        raise AssertionError(f"--check-build exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    report = out.stdout
    print(report, flush=True)
    for want in ("[X] NCCL", "[X] gloo", "[X] CUDA device",
                 "[X] flash-attention kernels built"):
        if want not in report:
            raise AssertionError(f"--check-build lacks {want!r}")
    args = ("--model", "gpt-nano", "--seq-len", str(NANO_STEP[3]),
            "--batch-size", str(NANO_STEP[2]))
    out, wall = hvdrun("-np", "1", sys.executable, "-m",
                       "horovod_tpu_torch.bench", *args)
    if out.returncode != 0:
        raise AssertionError(f"hvdrun -np 1 bench exited {out.returncode}:"
                             f"\n{out.stderr[-4000:]}")
    records = tagged(out.stdout)
    if len(records) != 1:
        raise AssertionError(f"expected one tagged bench record, got "
                             f"{out.stdout[-4000:]}")
    record = records[0]
    env = record["rendezvous_env"]
    want_env = {"HVDTPU_RANK": "0", "HVDTPU_SIZE": "1",
                "HVDTPU_LOCAL_RANK": "0", "HVDTPU_LOCAL_SIZE": "1"}
    if {k: env.get(k) for k in want_env} != want_env \
            or "HVDTPU_COORDINATOR" not in env:
        raise AssertionError(f"the worker saw {env}, not the launcher's "
                             f"rendezvous environment")
    if record["device_index"] != 0:
        raise AssertionError(f"the worker ran on {record['device_index']}")
    from horovod_tpu_torch.bench import _parser
    from horovod_tpu_torch.models import GPT_CONFIGS

    # each kernel of NANO_PATH once per layer and step, over the bench's
    # default warm-up and timed steps
    defaults = _parser().parse_args(["--model", "gpt-nano"])
    want = {n: GPT_CONFIGS[NANO_STEP[0]].num_layers
            * (defaults.warmup + defaults.iters) for n in NANO_PATH}
    if record["attention"] != "kernels" or record["flash_launches"] != want:
        raise AssertionError(f"hvdrun bench launched "
                             f"{record['flash_launches']}, not {want}")
    emit("launcher", check_build=report.splitlines(),
         command="hvdrun -np 1 python -m horovod_tpu_torch.bench "
         + " ".join(args), wall_s=wall, record=record)
    return record


# The elastic run: gpt-small bf16 at full width and depth, 6 steps under
# elastic.run (12 before the serving fleet's phase joined the script: two
# commits fewer a run keep the whole within its time limit), a commit
# every 4 (the replica pushed at each), a sharded save at step 4; step k's
# tokens are RandomState(k)'s, so a replayed step sees its own batch.
ELASTIC_STEPS, ELASTIC_COMMIT_EVERY, ELASTIC_SAVE_AT = 6, 4, 4
# rank 0 dies in its 6th collective (the last step's loss allreduce),
# after the commit of step 4
ELASTIC_FAULT = "worker_exit:step=6:rank=0"
# every replica push of the first incarnation is dropped: the respawned
# worker must restore from the disk tier
ELASTIC_DROP = "replica_push:rank=0:action=drop_replica:count=99"
ELASTIC_RUNS = (("clean", "", "none"),
                ("peer", ELASTIC_FAULT, "peer"),
                ("disk", f"{ELASTIC_FAULT},{ELASTIC_DROP}", "disk"))


def elastic_tokens(k: int, vocab: int, device):
    """Step ``k``'s batch: ``RandomState(k)``'s tokens."""
    import numpy as np
    import torch

    toks = np.random.RandomState(k).randint(
        0, vocab, size=(GPT_STEP[2], GPT_STEP[3] + 1))
    return torch.from_numpy(toks).to(device)


def digest(tensors) -> str:
    """sha256 of the bytes of ``tensors``, in order: equal digests are
    equal values, bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().to("cpu").contiguous().reshape(-1)
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def elastic_worker() -> int:
    """``python chip_smoke.py --elastic-worker``: the worker the
    ``elastic`` phase spawns through ``python -m horovod_tpu_torch.run
    --elastic``.  Loads the kernels the parent built (never builds),
    trains ``ELASTIC_STEPS`` steps of ``GPT_STEP`` under ``elastic.run``
    from an ``elastic.State`` of the model, the optimizer, the step and
    the losses, and prints one JSON line per event (tagged ``[0]`` by the
    launcher): ``pre_allreduce`` just before each step's loss allreduce
    (the point where an injected ``worker_exit`` fires), ``step`` after
    it, ``commit``, ``save``, ``restore`` and the final ``result``."""
    import os

    import torch

    from horovod_tpu_torch import obs, elastic
    from horovod_tpu_torch.ckpt import tree
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import kernels
    from horovod_tpu_torch.train import build_gpt_step

    def say(event, **fields):
        print(json.dumps({"event": event, "t": time.time(), **fields}),
              flush=True)

    missing = [n for n, ok in kernels.built().items() if not ok]
    if missing:
        raise RuntimeError(f"elastic worker: kernels not built: {missing}")
    kernels.build_all()  # loads the parent's libraries; compiles nothing
    ctx = elastic.context()
    ctx.start_heartbeat()
    step, (model, opt, _), _ = build_gpt_step(*GPT_STEP)
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    state = elastic.State(model=model, opt=opt, step=0, losses=[])
    device = next(model.parameters()).device
    say("start", epoch=int(os.environ.get("HVDTPU_ELASTIC_EPOCH", "0")),
        device=str(device))
    fa.reset_launch_counts()   # this incarnation's steps start here
    steps_run = [0]
    step_ms = []

    @elastic.run
    def loop(state):
        if state.last_restore is not None:
            say("restore", **state.last_restore)
        while state.step < ELASTIC_STEPS:
            k = state.step
            toks = elastic_tokens(k, vocab, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, loss = step(state.model, state.opt, toks)
            loss = float(loss)          # waits for the device
            step_ms.append((time.perf_counter() - t0) * 1e3)
            steps_run[0] += 1
            want = {n: layers * steps_run[0] if n in MAIN_PATH else 0
                    for n in fa.LAUNCHES}
            if fa.LAUNCHES != want:
                raise AssertionError(f"launches {fa.LAUNCHES} != {want}")
            say("pre_allreduce", k=k)
            ctx.allreduce(loss, name=f"loss{k}")
            state.losses.append(loss)
            state.step += 1
            say("step", k=k, loss=loss, ms=step_ms[-1])
            if state.step % ELASTIC_COMMIT_EVERY == 0:
                t0 = time.perf_counter()
                state.commit()
                ms = (time.perf_counter() - t0) * 1e3
                say("commit", k=k, commits=state.commits, ms=ms,
                    snapshot_bytes=sum(
                        x.numel() * x.element_size()
                        for x in tree.flatten(state._snapshot)[0]
                        if isinstance(x, torch.Tensor)))
            if state.step == ELASTIC_SAVE_AT:
                t0 = time.perf_counter()
                save = state.save_sharded()
                save.wait()
                say("save", k=k, ms=(time.perf_counter() - t0) * 1e3,
                    bytes=sum(s["bytes"] for s in save.manifest["shards"]),
                    schema=save.manifest["schema"])

    loop(state)
    reg = obs.get_registry()
    push_ms = reg.histogram("ckpt.replica_push_ms")
    opt_state = [t for per in opt.state_dict()["state"].values()
                 for _, t in sorted(per.items())]
    say("result", losses=list(state.losses), steps_run=steps_run[0],
        launches=dict(fa.LAUNCHES), step_ms=step_ms,
        last_restore=state.last_restore,
        params_sha256=digest(model.state_dict().values()),
        adamw_sha256=digest(opt_state),
        replica_pushes=push_ms.count, replica_push_ms_sum=push_ms.sum,
        replica_push_bytes=reg.counter("ckpt.replica_push_bytes").value)
    ctx.stop_heartbeat()
    return 0


def elastic_events(stdout: str) -> list:
    """The worker's events of one elastic run, every incarnation's, in
    the order printed."""
    return [r for r in tagged(stdout) if "event" in r]


def elastic_phase(train_step_ms: float) -> dict:
    """``ELASTIC_RUNS``: the same elastic gpt-small job three times, side
    by side on the card and the host, through ``python -m
    horovod_tpu_torch.run --elastic -np 1 --ckpt-dir D --ckpt-replica
    python chip_smoke.py --elastic-worker`` — clean, with rank 0 killed in
    step 6 (the respawned worker restores from its peer replica), and with
    that kill and every replica push dropped (it restores from the sharded
    manifest on disk).  Their times are taken while the other two run
    (side by side, the phase fits the script's time limit).  Gates: exit 0; the
    faulted runs' 6 losses, parameters and AdamW state equal the clean
    run's bit for bit; every incarnation launched exactly ``MAIN_PATH``,
    each kernel once per layer and step; one respawn in each faulted run
    and none in the clean one; the restore's source; the manifest's
    schema.  Times: commit, replica push, sharded save, restore, time to
    recover (from the dying worker's last line, printed just before the
    allreduce it dies in, to the end of its successor's first step), the
    median step beside ``train``'s, each run's wall time."""
    import os
    import shutil
    import statistics
    import tempfile

    from horovod_tpu_torch.ckpt import sharded
    from horovod_tpu_torch.ops import kernels

    release()
    root = tempfile.mkdtemp(prefix="elastic_", dir=kernels.build_dir())
    runs = {}

    def launch(name, spec):
        return hvdrun("--elastic", "-np", "1", "--ckpt-dir",
                      os.path.join(root, name), "--ckpt-replica",
                      sys.executable, os.path.abspath(__file__),
                      "--elastic-worker", env={"HVDTPU_FAULT_SPEC": spec})

    try:
        with concurrent.futures.ThreadPoolExecutor(len(ELASTIC_RUNS)) as pool:
            launched = [pool.submit(launch, name, spec)
                        for name, spec, _ in ELASTIC_RUNS]
        for (name, spec, source), done in zip(ELASTIC_RUNS, launched):
            ckpt_dir = os.path.join(root, name)
            out, wall = done.result()
            if out.returncode != 0:
                raise AssertionError(
                    f"elastic run {name!r} exited {out.returncode}:\n"
                    f"{out.stderr[-6000:]}")
            events = elastic_events(out.stdout)
            respawns = sum("elastic: respawned rank" in ln
                           for ln in out.stderr.splitlines()
                           if not ln.startswith("["))
            result = [e for e in events if e["event"] == "result"]
            if len(result) != 1:
                raise AssertionError(f"run {name!r}: no result\n"
                                     f"{out.stdout[-4000:]}")
            result = result[0]
            starts = [e for e in events if e["event"] == "start"]
            steps = [e for e in events if e["event"] == "step"]
            restore = result["last_restore"]
            run = {"fault_spec": spec, "wall_s": wall, "respawns": respawns,
                   "incarnations": len(starts),
                   "snapshot_bytes": max(e["snapshot_bytes"] for e in events
                                         if e["event"] == "commit"),
                   "commit_ms": [e["ms"] for e in events
                                 if e["event"] == "commit"],
                   "save": [{k: e[k] for k in ("ms", "bytes", "schema")}
                            for e in events if e["event"] == "save"],
                   "restore": restore,
                   "step_ms_median": statistics.median(result["step_ms"]),
                   **{k: result[k] for k in (
                       "losses", "steps_run", "launches", "params_sha256",
                       "adamw_sha256", "replica_pushes",
                       "replica_push_ms_sum", "replica_push_bytes")}}
            want_respawns = 0 if source == "none" else 1
            if respawns != want_respawns or \
                    run["incarnations"] != want_respawns + 1:
                raise AssertionError(
                    f"run {name!r}: {respawns} respawns, "
                    f"{run['incarnations']} incarnations")
            if restore["source"] != source:
                raise AssertionError(f"run {name!r} restored from "
                                     f"{restore['source']}, not {source}")
            if len(run["losses"]) != ELASTIC_STEPS:
                raise AssertionError(f"run {name!r}: losses {run['losses']}")
            if source != "none":
                # the dying worker's last line, then its successor's first
                # step
                died = max(e["t"] for e in events
                           if e["event"] == "pre_allreduce"
                           and e["t"] < starts[1]["t"])
                first = min(e["t"] for e in steps if e["t"] > starts[1]["t"])
                run["time_to_recover_s"] = first - died
            manifest = sharded.load_manifest(
                ckpt_dir, sharded.latest_step(ckpt_dir))
            run["manifest_schema"] = manifest["schema"]
            if manifest["schema"] != sharded.SCHEMA:
                raise AssertionError(f"run {name!r}: manifest {manifest}")
            runs[name] = run
    finally:
        shutil.rmtree(root, ignore_errors=True)
    clean = runs["clean"]
    for name in ("peer", "disk"):
        for key in ("losses", "params_sha256", "adamw_sha256"):
            if runs[name][key] != clean[key]:
                raise AssertionError(
                    f"run {name!r}: {key} {runs[name][key]} != the clean "
                    f"run's {clean[key]}")
    emit("elastic", card=card_line(), model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3], steps=ELASTIC_STEPS,
         commit_every=ELASTIC_COMMIT_EVERY, save_at=ELASTIC_SAVE_AT,
         train_step_ms=train_step_ms, bit_for_bit=True, runs=runs)
    return runs


# ``obs`` phase: the full-width run's steps and the bundle's grad-norm
# bound (its norm is fp32 sums by bucket; the check's fp64 over every
# element); the elastic gpt-nano runs' shape, steps and faults.  The
# gradient allreduce of step k is the k-th elastic collective, so step=3
# is step 3's.
OBS_STEPS = 6
OBS_GRAD_RTOL = 1e-3
OBS_NANO = ("nano", "bf16", 8, 256)
OBS_ELASTIC_STEPS = 4
OBS_FLIP = "grad_ready:rank=1:step=3:action=flip_bits"
OBS_ABORT = "worker_exit:rank=1:step=3:action=abort"


def _load_built_kernels(who: str) -> None:
    from horovod_tpu_torch.ops import kernels

    missing = [n for n, ok in kernels.built().items() if not ok]
    if missing:
        raise RuntimeError(f"{who}: kernels not built: {missing}")
    kernels.build_all()  # loads the parent's libraries; compiles nothing


def obs_worker(out_path: str) -> int:
    """``python chip_smoke.py --obs-worker OUT``: ``GPT_STEP`` in
    ``bucket`` mode for ``OBS_STEPS`` steps under whatever observability
    the launcher armed (``--health`` builds the plan with the health
    bundle and feeds ``StepHealth``); writes the losses, step times,
    launches, bundles, the reduced gradients' norms and the digest check
    to ``OUT``."""
    import numpy as np
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.obs import divergence
    from horovod_tpu_torch.obs.health import HealthConfig, StepHealth
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import build_gpt_step

    _load_built_kernels("obs worker")
    cfg = HealthConfig.from_env()
    step, (model, plan, toks), _ = build_gpt_step(
        *GPT_STEP, overlap_mode="bucket", health=cfg.enabled)
    sh = StepHealth(plan, rank=basics.rank(), config=cfg) \
        if cfg.enabled else None
    fa.reset_launch_counts()
    res = {"losses": [], "step_ms": [], "bundles": [], "grad_norms": []}
    for k in range(1, OBS_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(model, plan, toks)
        if sh is not None:
            sh.after_step(k, out[3])
        loss = float(out[2])            # waits for the device
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        res["losses"].append(loss)
        if sh is not None:
            res["bundles"].append(out[3].tolist())
            flat = torch.cat([p.grad.reshape(-1).float()
                              for p in model.parameters()])
            res["grad_norms"].append(float(torch.linalg.vector_norm(
                flat, dtype=torch.float64)))
    res["launches"] = dict(fa.LAUNCHES)
    if sh is not None:
        sh.drain()
        on_card = divergence.digest_matrix_host(
            sh._digest(*plan.params)).ravel()
        host, _ = divergence.tree_digest_vector(
            [p.detach() for p in plan.params], plan.layout)
        res["digest_equal"] = bool(np.array_equal(on_card, host))
        res["digest_buckets"] = len(plan.layout.buckets)
        res["checks"] = sh.sentinel.checks
        res["alerts"] = sh.monitor.judge.alerts_total
        res["observed"] = len(sh.observed)
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def obs_elastic_worker() -> int:
    """``python chip_smoke.py --obs-elastic-worker``: one of two elastic
    ranks training ``OBS_NANO`` (``bucket`` mode, health bundle on), its
    gradients averaged over the launcher's KV store by the elastic
    context's allreduce (one collective a step), the divergence sentinel
    every ``HVDTPU_HEALTH_CHECK_STEPS`` steps over the same store.  Prints
    one JSON line: the losses, the sentinel's reports and, on the rank a
    ``flip_bits`` spec targets, the leaf its flipped element lies in."""
    import numpy as np
    import torch

    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.obs.health import HealthConfig, StepHealth
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.testing import faults
    from horovod_tpu_torch.train import build_gpt_step, lm_loss

    _load_built_kernels("obs elastic worker")
    ctx = elastic.context()
    ctx.start_heartbeat()
    ctx.rendezvous()    # this epoch's membership: both ranks
    _, (model, plan, _), _ = build_gpt_step(
        *OBS_NANO, overlap_mode="bucket", health=True)
    names = [n for n, _ in model.named_parameters()]
    sh = StepHealth(plan, rank=ctx.rank, leaf_names=names,
                    config=HealthConfig.from_env())
    device = next(model.parameters()).device
    toks = torch.from_numpy(np.random.RandomState(ctx.rank).randint(
        0, model.cfg.vocab_size,
        size=(OBS_NANO[2], OBS_NANO[3] + 1))).to(device)
    fa.reset_launch_counts()
    sizes = [g.numel() for g in plan._grads]
    losses = []
    for k in range(1, OBS_ELASTIC_STEPS + 1):
        plan.zero_grad()
        loss = lm_loss(model, toks)
        loss.backward()
        flat = torch.cat(plan._grads)
        avg = ctx.allreduce(flat, name=f"grads{k}")
        for g, piece in zip(plan._grads, torch.split(avg, sizes)):
            g.copy_(piece)
        plan.step(loss=loss.detach())
        sh.after_step(k, plan.bundle)
        losses.append(float(loss))
    sh.drain()
    flipped = None
    spec = faults.parse_spec(__import__("os").environ.get(
        faults.SPEC_ENV, ""))
    for sp in spec:
        if sp.action == "flip_bits" and sp.rank == ctx.rank:
            probe = faults.corrupt_grad(
                np.zeros(sum(sizes), np.float32), "flip_bits",
                rank=ctx.rank, step=sp.step, name=f"grads{sp.step}")
            pos = int(np.flatnonzero(probe)[0])
            flipped = _leaf_at(plan, names, pos)
    print(json.dumps({"event": "obs_result", "rank": ctx.rank,
                      "losses": losses, "launches": dict(fa.LAUNCHES),
                      "checks": sh.sentinel.checks, "flipped": flipped,
                      "reports": [{"bucket": r.bucket, "leaf": r.leaf_name,
                                   "minority": list(r.minority_ranks)}
                                  for r in sh.reports]}), flush=True)
    ctx.stop_heartbeat()
    return 0


LINT_STEPS = 3


def lint_worker(out_dir: str) -> int:
    """``python chip_smoke.py --lint-worker DIR``: ``GPT_STEP`` in
    ``bucket`` mode for ``LINT_STEPS`` steps, with torch's flight recorder
    on (the phase arms it); what the recorder holds after the build
    (``DIR/step0.json``, empty at a world of one) and the collective
    schedule dumped after each step (``DIR/step<k>.json``); each step's
    launches, the losses and the plan's buckets' sizes to
    ``DIR/result.json``."""
    import os

    from horovod_tpu_torch.obs.collective_schedule import (
        dump_collective_schedule, read_recorder)
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import build_gpt_step

    _load_built_kernels("lint worker")
    step, (model, plan, toks), _ = build_gpt_step(*GPT_STEP,
                                                  overlap_mode="bucket")
    with open(os.path.join(out_dir, "step0.json"), "w") as f:
        json.dump(read_recorder(allow_empty=True), f)
    res = {"buckets": [b.padded_size for b in plan.layout.buckets],
           "launches": [], "losses": [], "entries": []}
    for k in range(1, LINT_STEPS + 1):
        fa.reset_launch_counts()
        out = step(model, plan, toks)
        res["losses"].append(float(out[2]))      # waits for the device
        res["launches"].append(dict(fa.LAUNCHES))
        res["entries"].append(dump_collective_schedule(
            os.path.join(out_dir, f"step{k}.json")))
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(res, f)
    return 0


def schedule_cli(*dumps) -> int:
    """The schedule CLI over ``dumps``: its exit code.  Run as the module's
    file, which imports nothing of the package (no torch to import)."""
    from horovod_tpu_torch.analysis import schedule

    return subprocess.run([sys.executable, schedule.__file__, *dumps],
                          capture_output=True, text=True,
                          timeout=120).returncode


def lint_phase() -> dict:
    """Phase ``lint`` (in the module docstring's 17)."""
    import os
    import shutil
    import tempfile
    from collections import Counter

    import horovod_tpu_torch
    from horovod_tpu_torch.analysis import schedule
    from horovod_tpu_torch.obs.collective_schedule import recorder_env
    from horovod_tpu_torch.ops import kernels

    release()
    t_phase = time.perf_counter()
    # the checkout's root: the analyzer's configuration and surface
    repo = os.path.dirname(os.path.dirname(os.path.abspath(
        horovod_tpu_torch.__file__)))

    def run_lint():
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.analysis", "--jobs",
             "0", "--no-cache", "--format", "json"],
            capture_output=True, text=True, timeout=600, cwd=repo)
        return out, time.perf_counter() - t0

    root = tempfile.mkdtemp(prefix="lint_", dir=kernels.build_dir())
    try:
        # (i) on the host's cores beside (ii) on the card
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            linted = pool.submit(run_lint)
            out, wall = hvdrun("-np", "1", sys.executable,
                               os.path.abspath(__file__), "--lint-worker",
                               root, env=recorder_env(), timeout=600)
            lint, lint_s = linted.result()
        if lint.returncode != 0:
            raise AssertionError(f"lint (i) exited {lint.returncode}:\n"
                                 f"{lint.stdout[-6000:]}{lint.stderr[-3000:]}")
        doc = json.loads(lint.stdout)
        if not doc["summary"]["baselined"]:
            # the port's baseline holds findings: a run that matched none
            # linted nothing
            raise AssertionError(f"lint (i) saw no finding: {doc['summary']}")
        findings = Counter(f"{f['status']} {f['rule']}"
                           for f in doc["findings"])
        if out.returncode != 0:
            raise AssertionError(f"lint (ii) exited {out.returncode}:\n"
                                 f"{out.stderr[-6000:]}")
        with open(os.path.join(root, "result.json")) as f:
            res = json.load(f)
        dumps = [os.path.join(root, f"step{k}.json")
                 for k in range(LINT_STEPS + 1)]
        scheds = []
        for path in dumps:
            with open(path) as f:
                scheds.append(schedule.extract_schedule(f.read()))
        steps = [scheds[k].since(scheds[k - 1], f"step{k}")
                 for k in range(1, LINT_STEPS + 1)]
        diverged = schedule.diff_schedules(steps)
        if diverged:
            raise AssertionError(f"lint (ii): the steps' schedules differ: "
                                 f"{diverged}")
        buckets = sorted(res["buckets"])
        for s in steps:
            kinds = Counter(i.kind for i in s.instrs)
            sizes = sorted(i.elements for i in s.instrs
                           if i.kind == "all_reduce")
            # the buckets' all_reduces and the loss's (one element)
            if set(kinds) != {"all_reduce"} or s.p2p or \
                    sizes != sorted(buckets + [1]):
                raise AssertionError(
                    f"lint (ii) {s.label}: {dict(kinds)}, p2p {len(s.p2p)}, "
                    f"all_reduce sizes {sizes} against the plan's "
                    f"{len(buckets)} buckets {buckets} and the loss")
        want = {n: 12 if n in MAIN_PATH else 0 for n in SOURCES}
        for k, launches in enumerate(res["launches"], start=1):
            got = {n: launches.get(n, 0) for n in want}
            if got != want:
                raise AssertionError(f"lint (ii) step {k}: launches {got} "
                                     f"!= {want}")
        with open(dumps[-1]) as f:
            last = json.load(f)
        first_bucket = next(
            j for j, e in enumerate(last["entries"])
            if e["profiling_name"].endswith("all_reduce")
            and e["output_sizes"] and e["output_sizes"][0]
            and e["output_sizes"][0][0] == res["buckets"][0])
        dropped = dict(last, entries=last["entries"][:first_bucket]
                       + last["entries"][first_bucket + 1:])
        dropped_path = os.path.join(root, "dropped.json")
        with open(dropped_path, "w") as f:
            json.dump(dropped, f)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            rc_dropped, rc_same = pool.map(
                lambda args: schedule_cli(*args),
                [(f"rank0={dumps[-1]}", f"dropped={dropped_path}"),
                 (f"a={dumps[-1]}", f"b={dumps[-1]}")])
        if (rc_dropped, rc_same) != (1, 0):
            raise AssertionError(f"lint (ii): the schedule CLI exited "
                                 f"{rc_dropped} on the dropped entry (want "
                                 f"1) and {rc_same} on equal dumps (want 0)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"card": card_line(), "rules": len(doc["rules"]),
           "findings": dict(findings), "lint_summary": doc["summary"],
           "lint_s": lint_s, "model": "gpt-small", "dtype": "bf16",
           "overlap": "bucket", "steps": LINT_STEPS,
           "buckets": len(buckets),
           "step_collectives": [len(s.instrs) for s in steps],
           "step_all_reduce_bytes": [s.total_bytes for s in steps],
           "entries": res["entries"], "dumpers": last.get("dumpers"),
           "launches_per_step": res["launches"], "losses": res["losses"],
           "dropped_entry": first_bucket, "cli_rc_dropped": rc_dropped,
           "cli_rc_same": rc_same, "worker_wall_s": wall,
           "phase_wall_s": time.perf_counter() - t_phase}
    emit("lint", **out)
    return out


def _leaf_at(plan, names, pos: int):
    """(bucket, leaf name) of element ``pos`` of the plan's buckets'
    gradients laid end to end."""
    for b in plan.layout.buckets:
        for i, size in zip(b.leaf_indices, b.sizes):
            if pos < size:
                return [b.index, names[i]]
            pos -= size
        pos -= b.pad
    return None


def obs_phase(train_step_ms: float) -> dict:
    """Phase ``obs`` (the module docstring's 17)."""
    import os
    import shutil
    import tempfile

    from horovod_tpu_torch.obs import trace_merge
    from horovod_tpu_torch.ops import kernels

    release()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="obs_", dir=kernels.build_dir())
    want = {n: 12 * OBS_STEPS if n in MAIN_PATH else 0
            for n in SOURCES}
    try:
        d = {k: os.path.join(root, k) + os.sep
             for k in ("metrics", "flightrec", "trace")}
        for path in d.values():
            os.makedirs(path)
        history = os.path.join(root, "live_history.jsonl")
        flags = ("--metrics-dump", d["metrics"], "--flightrec-dump",
                 d["flightrec"], "--trace", d["trace"],
                 "--trace-sample-rate", "1", "--stats-summary",
                 "--live-stats-secs", "0.5", "--live-history-file", history,
                 "--health", "on", "--health-check-steps", "2",
                 "--divergence-action", "halt")
        # the elastic trio (part ii) runs beside the two single-rank runs
        side = concurrent.futures.ThreadPoolExecutor(1)
        elastic = side.submit(obs_elastic_runs, root)
        runs = {}
        for name, extra in (("off", ()), ("on", flags)):
            res_path = os.path.join(root, f"{name}.json")
            out, wall = hvdrun("-np", "1", *extra, sys.executable,
                               os.path.abspath(__file__), "--obs-worker",
                               res_path, timeout=600)
            if out.returncode != 0:
                raise AssertionError(f"obs run {name!r} exited "
                                     f"{out.returncode}:\n"
                                     f"{out.stderr[-6000:]}")
            with open(res_path) as f:
                runs[name] = json.load(f)
            runs[name]["wall_s"] = wall
            runs[name]["stdout"] = out.stdout
        off, on = runs["off"], runs["on"]
        if on["losses"] != off["losses"]:
            raise AssertionError(f"losses with the flags {on['losses']} != "
                                 f"without {off['losses']}")
        for name, run in runs.items():
            got = {n: run["launches"].get(n, 0) for n in want}
            if got != want:
                raise AssertionError(f"obs run {name!r}: launches {got} != "
                                     f"{want}")
        grad_rel = []
        for loss, bundle, norm in zip(on["losses"], on["bundles"],
                                      on["grad_norms"]):
            if bundle[0] != loss or bundle[3] != 0:
                raise AssertionError(f"bundle {bundle[:4]} vs loss {loss}")
            grad_rel.append(abs(bundle[1] - norm) / norm)
        if max(grad_rel) > OBS_GRAD_RTOL:
            raise AssertionError(f"bundle grad_norm off by {grad_rel}")
        if not on["digest_equal"] or on["checks"] != OBS_STEPS // 2:
            raise AssertionError(f"digest {on['digest_equal']}, checks "
                                 f"{on['checks']}")
        dump = json.load(open(os.path.join(d["metrics"],
                                           "metrics.rank.0.json")))
        health = {m["name"]: m["value"] for m in dump["metrics"]
                  if m["name"].startswith("health.") and not m["tags"]
                  and "value" in m}
        if dump["schema"] != "hvdtpu-metrics-v1" or \
                health.get("health.divergence.checks") != OBS_STEPS // 2:
            raise AssertionError(f"metrics dump: {dump['schema']} {health}")
        if "== training health ==" not in on["stdout"]:
            raise AssertionError("the summary has no health section:\n"
                                 + on["stdout"][-3000:])
        waterfall, _ = trace_merge.merged_output_paths(d["trace"])
        events = json.load(open(waterfall))
        events = events["traceEvents"] if isinstance(events, dict) \
            else events
        step_spans = [e for e in events if e.get("name") == "step"]
        if len(step_spans) != OBS_STEPS:
            raise AssertionError(f"{len(step_spans)} step spans")
        rounds = open(history).read().splitlines()
        if not rounds:
            raise AssertionError("no live history round")
        if os.path.exists(os.path.join(d["flightrec"], "postmortem.json")):
            raise AssertionError("a clean run wrote a post-mortem")
        elastic_runs = elastic.result()
    finally:
        side.shutdown(wait=True)
        shutil.rmtree(root, ignore_errors=True)
    import statistics

    # step 1 warms up; the sentinel checks after steps 2, 4 and 6
    checked = [k for k in range(2, OBS_STEPS + 1) if k % 2 == 0]
    plain = [k for k in range(2, OBS_STEPS + 1) if k % 2]
    out = {"card": card_line(), "model": "gpt-small", "dtype": "bf16",
           "overlap": "bucket", "steps": OBS_STEPS,
           "step_ms_off": statistics.median(off["step_ms"][1:]),
           "step_ms_on_without_check": statistics.median(
               on["step_ms"][k - 1] for k in plain),
           "step_ms_on_with_check": statistics.median(
               on["step_ms"][k - 1] for k in checked),
           "step_ms_off_all": off["step_ms"], "step_ms_on_all": on["step_ms"],
           "train_step_ms": train_step_ms,
           "launches_per_run": on["launches"], "losses": on["losses"],
           "grad_norm_rel": grad_rel, "digest_buckets": on["digest_buckets"],
           "health_checks": on["checks"], "health_alerts": on["alerts"],
           "metrics_dump_health": health, "live_rounds": len(rounds),
           "trace_events": len(events),
           "wall_s": {"off": off["wall_s"], "on": on["wall_s"]},
           "elastic": elastic_runs,
           "phase_wall_s": time.perf_counter() - t_phase}
    emit("obs", **out)
    return out


def obs_elastic_runs(root: str) -> dict:
    """Part (ii) of phase ``obs``: the elastic gpt-nano pair, clean, with
    ``OBS_FLIP`` and with ``OBS_ABORT``; the three launchers run side by
    side (six small processes on the card), each with its own store."""
    import os

    cases = (("clean", "", ("--divergence-action", "halt")),
             ("flip", OBS_FLIP, ("--divergence-action", "dump")),
             ("abort", OBS_ABORT, ("--max-elastic-retries", "0",
                                   "--min-workers", "2")))
    procs = {}
    t0 = time.perf_counter()
    for name, spec, extra in cases:
        box = os.path.join(root, f"box_{name}")
        os.makedirs(box)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "--elastic",
               "-np", "2", "--health", "on", "--health-check-steps",
               str(OBS_ELASTIC_STEPS), "--flightrec-dump", box, *extra,
               sys.executable, os.path.abspath(__file__),
               "--obs-elastic-worker"]
        procs[name] = (box, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, HVDTPU_FAULT_SPEC=spec)))
    outs = {}
    try:
        for name, (box, p) in procs.items():
            out, err = p.communicate(timeout=600)
            outs[name] = (box, p.returncode, out, err)
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = {"wall_s": time.perf_counter() - t0}
    for name, (box, rc, stdout, stderr) in outs.items():
        results = {}
        for rank in (0, 1):
            for rec in tagged(stdout, rank):
                if rec.get("event") == "obs_result":
                    results[rank] = rec
        run = {"rc": rc}
        if name == "abort":
            report = os.path.join(box, "postmortem.json")
            if rc == 0 or not os.path.exists(report):
                raise AssertionError(f"abort run: rc {rc}, no post-mortem:"
                                     f"\n{stdout[-3000:]}")
            pm = json.load(open(report))
            if (pm.get("first_failure") or {}).get("rank") != 1:
                raise AssertionError(f"post-mortem blames "
                                     f"{pm.get('first_failure')}")
            run["verdict"] = pm["verdict"]
            runs[name] = run
            continue
        if rc != 0 or sorted(results) != [0, 1]:
            raise AssertionError(f"elastic obs run {name!r} exited {rc}:\n"
                                 f"{stderr[-6000:]}")
        reports = [results[r]["reports"] for r in (0, 1)]
        run.update(losses={r: results[r]["losses"] for r in (0, 1)},
                   reports=reports[0], checks=results[0]["checks"])
        if name == "clean" and any(reports):
            raise AssertionError(f"clean run reported {reports}")
        if name == "flip":
            want = results[1]["flipped"]
            for rep in reports:
                if len(rep) != 1 or rep[0]["minority"] != [1] or \
                        [rep[0]["bucket"], rep[0]["leaf"]] != want:
                    raise AssertionError(f"flip reports {reports}, the "
                                         f"flipped element in {want}")
            for rank in (0, 1):
                # epoch-tagged under the elastic launcher
                ring = json.load(open(os.path.join(
                    box, f"flightrec.e0.rank.{rank}.json")))
                if not any(e["kind"] == "health.divergence"
                           for e in ring["events"]):
                    raise AssertionError(f"rank {rank}'s ring holds no "
                                         f"divergence")
            run["flipped"] = want
        runs[name] = run
    return runs


# --------------------------------------------------------------------------
# A13b: the step anatomy, the bench campaign, the Estimator, autoscale
# --------------------------------------------------------------------------

# compute + collective wait + host gap against the step, and compute
# against MFU x step: the anatomy rounds each to 4 decimals
ANATOMY_RTOL = 1e-3


def anatomy_phase(records: dict) -> dict:
    """Phase ``anatomy``: the ``anatomy`` block of each bench record the
    script took (``records``: name -> (record, the route's flash kernels,
    launches of each a step)): the components tile ``step_ms``, compute is
    MFU x step, the H100's peak and bandwidth are no estimate, and
    ``top_ops`` names the route's kernels at their launches a step (none
    for the serving record, whose decode runs no kernel of this repo).
    Prints each record's host-gap share (ROADMAP C14)."""
    card = card_line()
    out = {}
    for name, (record, path, per_step) in records.items():
        anat = record.get("anatomy")
        if not anat:
            raise AssertionError(f"{name}: record without anatomy: {record}")
        step = anat["step_ms"]
        comp = anat["components_ms"]
        mfu = record["mfu"] if "mfu" in record else record["perf"]["mfu"]
        top = {t["op"]: t["count"] for t in anat.get("top_ops", [])}
        want = {n: per_step for n in path}
        checks = {
            "tile": abs(sum(comp.values()) - step) <= ANATOMY_RTOL * step,
            "compute": abs(comp["compute_ms"] - mfu * step)
            <= ANATOMY_RTOL * comp["compute_ms"] + 1e-4,
            "method": anat["method"]["compute"] == "mfu x step",
            "not_estimate": anat["roofline"]["estimate"] is False,
            "top_ops": top == want,
        }
        if not all(checks.values()):
            raise AssertionError(f"{name}: anatomy gates {checks}: {anat} "
                                 f"(kernels a step wanted {want})")
        out[name] = {"step_ms": step, "mfu": mfu,
                     "components_ms": comp,
                     "host_gap_pct": anat["components_pct"]["host_gap_pct"],
                     "verdict": anat["roofline"]["verdict"],
                     "top_ops": anat.get("top_ops", [])}
    emit("anatomy", card=card, records=out)
    for name, r in out.items():
        print(f"anatomy {name}: step {r['step_ms']:.3f} ms, host gap "
              f"{r['host_gap_pct']}% (compute {r['components_ms']['compute_ms']}"
              f" ms, collective wait "
              f"{r['components_ms']['collective_wait_ms']} ms), "
              f"{r['verdict']}; {card}", flush=True)
    return out


CAMPAIGN_BUCKET_MB = 16
CAMPAIGN_TIMEOUT = 600
# extra flags of the campaign's bench points (none on the card)
CAMPAIGN_ARGS = ()


def campaign_phase(fa, train_run: dict, overlap_runs: dict) -> dict:
    """Phase ``campaign``: ``bench --campaign`` on gpt-small bf16 at full
    width and depth over ``overlap`` in {off, bucket} (16 MB buckets): two
    points, each a bench process on the card; then the same spec again,
    which must run no point and leave the journal as it was."""
    import os
    import shutil
    import tempfile

    from horovod_tpu_torch.bench import campaign
    from horovod_tpu_torch.ops import kernels

    release()
    card = card_line()
    size, dtype, batch, seq = GPT_STEP
    spec = {"name": "gpt_small_overlap", "retry_degraded": 0,
            "point_budget_secs": CAMPAIGN_TIMEOUT // 2,
            "base_args": ["--model", f"gpt-{size}", "--dtype", dtype,
                          "--seq-len", str(seq), "--batch-size", str(batch),
                          "--iters", str(STEPS), "--warmup", str(WARMUP),
                          *CAMPAIGN_ARGS],
            "axes": {"overlap": ["off", "bucket"],
                     "grad_bucket_mb": [CAMPAIGN_BUCKET_MB]}}
    os.makedirs(kernels.build_dir(), exist_ok=True)
    root = tempfile.mkdtemp(prefix="campaign_", dir=kernels.build_dir())
    try:
        spec_path = os.path.join(root, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.bench", "--campaign",
               spec_path]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True,
                             env=dict(os.environ, HVDTPU_RECORD_DIR=root),
                             timeout=CAMPAIGN_TIMEOUT)
        if out.returncode != 0:
            raise AssertionError(f"bench --campaign exited {out.returncode}:"
                                 f"\n{out.stderr[-4000:]}")
        first = {"wall_s": time.perf_counter() - t0,
                 "summary": json.loads(out.stdout.strip().splitlines()[-1]),
                 "journal": campaign.load_journal(root),
                 "stray_records": sorted(
                     f for f in os.listdir(root)
                     if f.startswith("BENCH_") or f.startswith("bench_"))}
        # the same spec again, through the driver's own entry in this
        # process: every point is done, so it must launch none
        log = []
        t0 = time.perf_counter()
        again = campaign.run_campaign(campaign.load_spec(spec_path), root,
                                      log=log.append)
        second = {"wall_s": time.perf_counter() - t0,
                  "summary": campaign.summarize_journal(again),
                  "journal": campaign.load_journal(root),
                  "log": "\n".join(log)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    journal = first["journal"]
    want = {n: train_run["launches_per_step"][n] * (STEPS + WARMUP)
            for n in MAIN_PATH}
    if first["stray_records"]:
        raise AssertionError(f"the clean campaign left degraded records "
                             f"{first['stray_records']}")
    points = {}
    for pid, entry in journal["points"].items():
        rec = entry.get("record") or {}
        ok = (entry["status"] == "done"
              and rec.get("attention") == ("kernels" if want else "plain")
              and rec.get("flash_launches") == want and "anatomy" in rec
              # the sentinel's verdict (None: the dir holds no trajectory)
              and "regression" in rec and "baseline_record" in rec)
        if not ok:
            raise AssertionError(f"campaign point {pid}: {entry}")
        points[pid] = {"tokens_per_s_per_gpu": rec["value"],
                       "step_ms": rec["step_ms"], "mfu": rec["mfu"],
                       "elapsed_s": entry["elapsed_secs"],
                       "host_gap_pct": rec["anatomy"]["components_pct"][
                           "host_gap_pct"]}
    if len(points) != 2:
        raise AssertionError(f"campaign ran {sorted(points)}, not 2 points")
    if (second["journal"] != journal or "running" in second["log"]
            or second["summary"]["done"] != 2):
        raise AssertionError(f"the second campaign run changed the journal "
                             f"or ran a point:\n{second['log']}")
    emit("campaign", card=card, spec=spec, points=points,
         first_wall_s=first["wall_s"], second_wall_s=second["wall_s"],
         spec_sha=journal["spec_sha"], summary=first["summary"],
         regression={pid: {k: (e.get("record") or {}).get(k)
                           for k in ("regression", "baseline_record")}
                     for pid, e in journal["points"].items()})
    same = {"off": train_run["tokens_per_s_per_gpu"],
            "bucket": overlap_runs["bucket"]["tokens_per_s_per_gpu"]}
    for pid, p in points.items():
        mode = "bucket" if "bucket" in pid else "off"
        print(f"campaign {pid}: {p['tokens_per_s_per_gpu']:.1f} "
              f"tokens/s/GPU, step {p['step_ms']:.2f} ms (this call's "
              f"{'train' if mode == 'off' else 'overlap bucket'} phase: "
              f"{same[mode]:.1f}); {card}", flush=True)
    return points


# phase bench_supervisor: a bench whose budget is spent before it starts
# and whose warm-up outlasts the watchdog's first tick (15 s in), so the
# tick finds a budgeted phase; and the longest it may take
SUPERVISOR_ARGS = ("--model", "gpt-small", "--warmup", "100000",
                   "--total-budget-secs", "0")
SUPERVISOR_PHASES = ("init", "build", "warmup")
SUPERVISOR_TIMEOUT = 180


def _checkout_records(repo: str) -> dict:
    """The checkout's record and sidecar files with their mtimes (the
    phase writes none of them)."""
    import glob
    import os

    return {p: os.stat(p).st_mtime_ns for p in
            glob.glob(os.path.join(repo, "**", "BENCH_*.json"),
                      recursive=True)
            + glob.glob(os.path.join(repo, "**", "bench_last_failure.json"),
                        recursive=True)}


def bench_supervisor_phase() -> dict:
    """Phase ``bench_supervisor``: ``python -m horovod_tpu_torch.bench``
    with no budget (``SUPERVISOR_ARGS``) and its record dir and sidecar in
    a temporary directory; the watchdog's daemon thread must give up at
    its first tick (exit 86, no re-exec) while the main thread works on
    the card, leaving a ``gave_up`` sidecar naming the phase and one
    degraded record of it, and nothing in the checkout."""
    import os
    import shutil
    import tempfile

    from horovod_tpu_torch.bench import supervisor
    from horovod_tpu_torch.ops import kernels

    repo = os.path.dirname(os.path.abspath(__file__))
    before = _checkout_records(repo)
    os.makedirs(kernels.build_dir(), exist_ok=True)
    root = tempfile.mkdtemp(prefix="bench_supervisor_",
                            dir=kernels.build_dir())
    try:
        sidecar = os.path.join(root, "sidecar.json")
        env = dict(os.environ, HVDTPU_BENCH_RECORD_DIR=root,
                   HVDTPU_BENCH_SIDECAR=sidecar)
        env.pop("HVDTPU_RECORD_DIR", None)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.bench",
               *SUPERVISOR_ARGS]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=SUPERVISOR_TIMEOUT, cwd=repo)
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(root))
        side = json.load(open(sidecar)) if os.path.exists(sidecar) else None
        rec_path = os.path.join(root, "BENCH_r01.json")
        record = (json.load(open(rec_path)) if os.path.exists(rec_path)
                  else None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    after = _checkout_records(repo)
    tick = supervisor.WATCHDOG_TICK
    emit("bench_supervisor", command=" ".join(cmd[1:]), rc=out.returncode,
         wall_s=wall, files=files, sidecar=side, record=record,
         stderr_tail=out.stderr[-600:], card=card_line())
    problems = []
    if out.returncode != 86:
        problems.append(f"exit {out.returncode}, not 86")
    if "re-exec" in out.stderr:
        problems.append("it re-execed")
    if files != ["BENCH_r01.json", "sidecar.json"]:
        problems.append(f"the record dir holds {files}")
    if not side or side.get("outcome") != "gave_up" or side.get(
            "phase") not in SUPERVISOR_PHASES \
            or side.get("attempt") != 1 \
            or not -2 * tick < side.get("budget_left_secs", 0) <= 0:
        problems.append(f"sidecar {side} (want gave_up at the first tick "
                        f"of {tick} s, attempt 1)")
    if not record or not (record.get("degraded") is True
                          and record.get("rc") == 86
                          and record.get("failure_phase")
                          == (side or {}).get("phase")
                          and record["provenance"]["platform"]
                          in ("gpu", None)):
        problems.append(f"degraded record {record}")
    if after != before:
        problems.append("a record or sidecar was written into the checkout")
    if problems:
        raise AssertionError("bench_supervisor: " + "; ".join(problems)
                             + f"\n{out.stderr[-3000:]}")
    return {"wall_s": wall, "phase": side["phase"],
            "budget_left_secs": side["budget_left_secs"]}


# the reference estimator test's MLP and blobs (tests/test_estimator.py)
EST_MLP = {"features": (16,), "epochs": 5, "batch": 32, "lr": 1e-2,
           "rows": 256}
EST_LOSS_TOL = 1e-5
# gpt-small bf16: 32 sequences of RandomState(0) tokens, 1 epoch of 4 steps
EST_GPT = {"sequences": 32, "batch": 8, "lr": 1e-4}


def est_blobs(n: int, seed: int = 0) -> dict:
    """Two linearly separable 2-D blobs (the reference estimator test's)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    half = n // 2
    x = np.concatenate([rng.randn(half, 2).astype(np.float32) + 2.0,
                        rng.randn(n - half, 2).astype(np.float32) - 2.0])
    y = np.concatenate([np.zeros(half, np.int64),
                        np.ones(n - half, np.int64)])
    return {"features": x, "label": y}


class LaunchLog:
    """The gpt-small fit's loss (next-token cross-entropy): before each
    loss it appends the worker's cumulative flash launches and the host
    clock to ``path`` — between two calls lie one step's backward and the
    next step's forward."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self, logits, labels):
        import torch.nn.functional as F

        from horovod_tpu_torch.ops import flash_attention as fa

        with open(self.path, "a") as f:
            f.write(json.dumps({"t": time.time(),
                                "launches": dict(fa.LAUNCHES)}) + "\n")
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               labels.reshape(-1))


def estimator_phase(fa, train_per_step: dict, device: str = "cuda") -> dict:
    """Phase ``estimator``: (i) the reference test's MLP fit on its blobs
    with ``backend="local"`` on the card (fp32, TF32 off), every epoch's
    loss within ``EST_LOSS_TOL`` of the same fit on the CPU (a launcher
    worker with the GPUs hidden), and ``Model.load`` from the store
    predicting bit for bit what the fitted Model does; (ii) gpt-small bf16
    with ``backend="launcher"``, ``np_workers=1``: finite loss, the
    ``train`` phase's launches a step (``train_per_step``: 12 of each of
    ``MAIN_PATH``) in the worker, the final checkpoint in the store."""
    import functools
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from horovod_tpu_torch.checkpoint import LocalStore, latest_checkpoint_step
    from horovod_tpu_torch.estimator import Estimator, Model
    from horovod_tpu_torch.models import MLP, gpt
    from horovod_tpu_torch.ops import kernels

    release()
    card = card_line()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    on_cpu = device == "cpu"
    os.makedirs(kernels.build_dir(), exist_ok=True)
    root = tempfile.mkdtemp(prefix="estimator_", dir=kernels.build_dir())
    out = {}
    try:
        data = est_blobs(EST_MLP["rows"])
        kw = dict(batch_size=EST_MLP["batch"], epochs=EST_MLP["epochs"],
                  run_id="blobs")
        adam = functools.partial(torch.optim.Adam, lr=EST_MLP["lr"])
        store = LocalStore(os.path.join(root, "mlp"))
        t0 = time.perf_counter()
        card_fit = Estimator(MLP(2, EST_MLP["features"], 2), adam,
                             store=store, use_cpu=on_cpu, **kw).fit(data)
        card_s = time.perf_counter() - t0
        cpu_fit = Estimator(MLP(2, EST_MLP["features"], 2), adam,
                            backend="launcher", np_workers=1, use_cpu=True,
                            timeout=300, **kw).fit(data)
        card_losses = [h["loss"] for h in card_fit.history]
        cpu_losses = [h["loss"] for h in cpu_fit.history]
        diff = max(abs(a - b) for a, b in zip(card_losses, cpu_losses))
        if len(card_losses) != EST_MLP["epochs"] or diff > EST_LOSS_TOL:
            raise AssertionError(f"MLP epoch losses card {card_losses} vs "
                                 f"CPU {cpu_losses}: {diff:.2e}")
        loaded = Model.load(MLP(2, EST_MLP["features"], 2), store, "blobs",
                            device=device)
        pred, again = (m.predict(data["features"])
                       for m in (card_fit, loaded))
        if not np.array_equal(pred, again):
            raise AssertionError("Model.load predicts other outputs than "
                                 "the fitted Model")
        acc = float((card_fit.transform(data)["prediction"]
                     == data["label"]).mean())
        out["mlp"] = {"card_losses": card_losses, "cpu_losses": cpu_losses,
                      "max_loss_diff": diff, "card_fit_s": card_s,
                      "accuracy": acc, "load_bitwise": True}
        del card_fit, cpu_fit, loaded

        # (ii) gpt-small bf16 through the launcher backend
        n, batch = EST_GPT["sequences"], EST_GPT["batch"]
        seq = GPT_STEP[3]
        model = gpt(GPT_STEP[0], device="cpu",
                    dtype={"bf16": torch.bfloat16,
                           "fp32": torch.float32}[GPT_STEP[1]],
                    max_len=seq, attention_impl="flash",
                    generator=torch.Generator().manual_seed(0))
        tokens = np.random.RandomState(0).randint(
            0, model.cfg.vocab_size, (n, seq + 1)).astype(np.int64)
        gdata = {"features": tokens[:, :-1], "label": tokens[:, 1:]}
        log = os.path.join(root, "launches.jsonl")
        gstore = LocalStore(os.path.join(root, "gpt"))
        t0 = time.perf_counter()
        fitted = Estimator(
            model, functools.partial(torch.optim.AdamW, lr=EST_GPT["lr"]),
            loss=LaunchLog(log), batch_size=batch, epochs=1, shuffle=False,
            store=gstore, run_id="gpt_small", backend="launcher",
            np_workers=1, use_cpu=on_cpu, timeout=600).fit(gdata)
        fit_s = time.perf_counter() - t0
        loss = fitted.history[0]["loss"]
        calls = [json.loads(ln) for ln in open(log)]
        steps = n // batch
        per_step = {k: train_per_step.get(k, 0)
                    for k in calls[0]["launches"]}
        first = {k: n if PASS[k] == "fwd" else 0
                 for k, n in per_step.items()}
        deltas = [{k: b["launches"][k] - a["launches"][k]
                   for k in b["launches"]} for a, b in zip(calls, calls[1:])]
        ckpt = latest_checkpoint_step(gstore.checkpoint_dir("gpt_small"))
        if (not math.isfinite(loss) or len(calls) != steps
                or calls[0]["launches"] != first
                or any(d != per_step for d in deltas) or ckpt != 1):
            raise AssertionError(f"gpt-small estimator fit: loss {loss}, "
                                 f"{len(calls)} loss calls (want {steps}), "
                                 f"first {calls[0]}, deltas {deltas}, "
                                 f"checkpoint step {ckpt}")
        step_s = [b["t"] - a["t"] for a, b in zip(calls, calls[1:])]
        out["gpt_small"] = {
            "backend": "launcher", "np_workers": 1, "steps": steps,
            "loss": loss, "fit_wall_s": fit_s,
            "step_ms_between_loss_calls": [x * 1e3 for x in step_s],
            "launches_per_step": per_step, "checkpoint_step": ckpt}
        del fitted, model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    emit("estimator", card=card, **out)
    g = out["gpt_small"]
    print(f"estimator: MLP card vs CPU epoch losses within "
          f"{out['mlp']['max_loss_diff']:.2e}; gpt-small launcher fit "
          f"{g['fit_wall_s']:.1f} s, steps "
          f"{', '.join(f'{x:.1f}' for x in g['step_ms_between_loss_calls'])}"
          f" ms apart, loss {g['loss']:.4f}; {card}", flush=True)
    return out


# hvdrun --serve-autoscale over the serve phase's fleet, on the one card
AUTOSCALE_FLAGS = ("--serve-autoscale", "--max-workers", "2",
                   "--scale-up-queue", "4", "--scale-down-idle-secs", "5",
                   "--scale-cooldown-secs", "5", "--stats-summary")
AUTOSCALE_SHRINK_WAIT = 60


def _pct(xs, q):
    import numpy as np

    return float(np.percentile(xs, q)) if xs else None


def _window(docs, growth, t_lo, t_hi):
    """Generated tokens/s, TTFT p50/p99 and TPOT p50 of one window of a
    fleet's run: the tokens that streamed in [t_lo, t_hi), the requests
    whose first token came in it, those that finished in it."""
    seen, toks = {}, 0
    for t, rid, n, _ in sorted(growth):
        if t_lo <= t < t_hi:
            toks += n - seen.get(rid, 0)
        seen[rid] = n
    ttft = [(d["t_first"] - d["t_submit"]) * 1e3 for d in docs.values()
            if t_lo <= d["t_first"] < t_hi]
    tpot = [(d["t_client_done"] - d["t_first"]) * 1e3
            / max(len(d["tokens"]) - 1, 1) for d in docs.values()
            if t_lo <= d["t_client_done"] < t_hi and len(d["tokens"]) > 1]
    return {"seconds": t_hi - t_lo, "tokens": toks,
            "tokens_per_s": toks / max(t_hi - t_lo, 1e-9),
            "ttft_ms": {"p50": _pct(ttft, 50), "p99": _pct(ttft, 99)},
            "tpot_ms_p50": _pct(tpot, 50)}


def live_worlds(lines) -> list:
    """The serving world sizes the launcher's live digest printed, in
    order, repeats dropped (``world 1``, ``world 1→2``, ...)."""
    import re

    worlds = []
    for _, ln in lines:
        if ln.startswith("[live]"):
            for m in re.finditer(r"world (\d+)(?:→(\d+))?", ln):
                w = int(m.group(2) or m.group(1))
                if not worlds or worlds[-1] != w:
                    worlds.append(w)
    return worlds


def autoscale_phase(device: str = "cuda") -> dict:
    """Phase ``autoscale``: ``hvdrun --elastic --serve --serve-autoscale
    -np 1 --max-workers 2`` with the ``serve_fleet`` phase's fleet; the
    serve phase's 48 requests arrive as a backlog at t = 0.  The queue
    grows the world to 2 ranks on the card, the drain shrinks it back:
    one ``scale_up`` and one ``scale_down``, world tokens 1 -> 2 -> 1 in
    the live digest, no request dropped, every budget met, greedy streams
    by the margin rule against the teacher-forced forward, the summary's
    autoscale section."""
    import re

    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.serve import Request

    release()
    card = card_line()
    reqs = serve_requests(SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW,
                          SERVE_SAMPLE_EVERY, vocab=VOCAB)
    greedy = [r for r in reqs if r.temperature == 0]
    sampled = [r for r in reqs if r.temperature > 0]
    warm = Request(rid="warm", prompt=tuple(FLEET_WARM[0]),
                   max_new_tokens=FLEET_WARM[1])
    fleet = Fleet(np=1, ranks=2, launcher_args=AUTOSCALE_FLAGS)
    try:
        fleet_traffic(fleet.client, [warm], [0.0])
        docs, growth = fleet_traffic(fleet.client, reqs, [0.0] * len(reqs))
        t_drained = time.time()
        deadline = t_drained + AUTOSCALE_SHRINK_WAIT
        # the drain-driven shrink, and the live digest's round after it
        while not (any("elastic: scale down" in ln for _, ln in fleet.err)
                   and live_worlds(fleet.out)[-2:] == [2, 1]):
            if time.time() > deadline or fleet.proc.poll() is not None:
                raise AssertionError(
                    f"no scale down to a world of 1 in the live digest "
                    f"within {AUTOSCALE_SHRINK_WAIT} s of the drain (worlds "
                    f"{live_worlds(fleet.out)}):\n{fleet.stderr()[-4000:]}")
            time.sleep(0.1)
        summaries = fleet.stop()
        wall = time.time() - fleet.t0
    finally:
        fleet.close()
    fleet_gates("autoscale", reqs, docs, {0: summaries[0]})
    ups = [(t, ln) for t, ln in fleet.err if "elastic: scale up" in ln]
    downs = [(t, ln) for t, ln in fleet.err if "elastic: scale down" in ln]
    if len(ups) != 1 or len(downs) != 1:
        raise AssertionError(f"{len(ups)} scale-ups and {len(downs)} "
                             f"scale-downs:\n{fleet.stderr()[-4000:]}")
    worlds = live_worlds(fleet.out)
    if worlds != [1, 2, 1]:
        raise AssertionError(f"world tokens {worlds}, not 1 -> 2 -> 1")
    if not summaries[1].get("released"):
        raise AssertionError(f"rank 1 was not released: {summaries[1]}")
    if "== autoscale / weight hot-swap ==" not in fleet.stdout():
        raise AssertionError("no autoscale section in the summary")
    section = fleet.stdout().split("== autoscale / weight hot-swap ==",
                                   1)[1].strip().split("\n\n")[0]
    model = gpt(FLEET_SIZE, device=device)
    tokens = {r.rid: docs[r.rid]["tokens"] for r in reqs}
    margins = bf16_margins(model, greedy, tokens, device)
    finite_streams(model, sampled, tokens, device)
    del model
    release_cache()
    t_up = ups[0][0]
    up_epoch = int(re.search(r"at epoch (\d+)", ups[0][1]).group(1))
    after = sorted(t for t, _, _, epoch in growth
                   if epoch is not None and epoch >= up_epoch)
    if not after:
        raise AssertionError("no token streamed in the grown world")
    t0 = min(d["t_submit"] for d in docs.values())
    t1 = max(d["t_client_done"] for d in docs.values())
    run = {
        "command": fleet.command, "job_wall_s": wall,
        "worlds": worlds, "scale_up": ups[0][1], "scale_down": downs[0][1],
        "grow_decision_to_first_step_s": after[0] - t_up,
        "drain_to_shrink_s": downs[0][0] - t_drained,
        "before_grow": _window(docs, growth, t0, t_up),
        "after_grow": _window(docs, growth, after[0], t1 + 1e-6),
        "whole": fleet_record(docs, reqs, {0: summaries[0]}),
        "dropped": 0, "released": summaries[1].get("released"),
        "greedy_near_ties": sum(len(m["near_ties"])
                                for m in margins.values()),
        "summary_section": section,
    }
    emit("autoscale", card=card, model=f"gpt-{FLEET_SIZE}", dtype="bf16",
         slots=SERVE_SLOTS, page_pool={"page_size": SERVE_PAGE_SIZE,
                                       "num_pages": SERVE_PAGES},
         requests=len(reqs), flags=list(AUTOSCALE_FLAGS), run=run)
    b, a = run["before_grow"], run["after_grow"]
    print(f"autoscale: grow decision to the grown world's first step "
          f"{run['grow_decision_to_first_step_s']:.2f} s; before the grow "
          f"{b['tokens_per_s']:.1f} tokens/s, TTFT p50/p99 "
          f"{b['ttft_ms']['p50']}/{b['ttft_ms']['p99']} ms, TPOT p50 "
          f"{b['tpot_ms_p50']} ms; after {a['tokens_per_s']:.1f} tokens/s, "
          f"TTFT p50/p99 {a['ttft_ms']['p50']}/{a['ttft_ms']['p99']} ms, "
          f"TPOT p50 {a['tpot_ms_p50']} ms; worlds {worlds}; {card}",
          flush=True)
    return run


def profile_step(state, step, step_ms: float, top: int = 12) -> dict:
    """One more step under torch.profiler: device time by kernel, the
    share of the timed (unprofiled) step the device was busy, the share of
    device time in layout conversions, and the host's busy time by op (the
    profiler's own overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        step(*state)
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = sorted(
        ((ev.self_device_time_total / 1e3, ev.key, ev.count)
         for ev in events
         if ev.device_type == torch.autograd.DeviceType.CUDA
         and not ev.is_user_annotation and ev.self_device_time_total > 0),
        reverse=True,
    )
    cpu = sorted(((ev.self_cpu_time_total / 1e3, ev.key, ev.count)
                  for ev in events if ev.self_cpu_time_total > 0
                  and "Synchronize" not in ev.key),
                 reverse=True)
    busy_ms = sum(r[0] for r in rows)
    flash_ms = sum(r[0] for r in rows if "flash_" in r[1])
    layout_ms = sum(r[0] for r in rows
                    if any(k in r[1] for k in LAYOUT_KERNELS))
    families: dict = {}
    for ms, name, _ in rows:
        fam = next((f for f, keys in FAMILIES
                    if any(k in name for k in keys)), "other")
        families[fam] = families.get(fam, 0.0) + ms
    return dict(device_busy_ms=busy_ms, step_ms=step_ms,
                device_busy_share=busy_ms / step_ms,
                layout_conversion_ms=layout_ms,
                layout_conversion_share=layout_ms / busy_ms if busy_ms else 0,
                device_ms_by_family=families,
                flash_kernels_ms=flash_ms, kernels=len(rows),
                flash=[{"name": n[:60], "ms": ms, "calls": c}
                       for ms, n, c in rows if "flash_" in n],
                host_busy_ms=sum(r[0] for r in cpu),
                top=[{"name": n[:80], "ms": ms, "calls": c}
                     for ms, n, c in rows[:top]],
                host_top=[{"name": n[:80], "ms": ms, "calls": c}
                          for ms, n, c in cpu[:top]])


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if list(argv) == ["--elastic-worker"]:
        return elastic_worker()
    if list(argv) == ["--obs-elastic-worker"]:
        return obs_elastic_worker()
    if len(argv) == 2 and argv[0] == "--obs-worker":
        return obs_worker(argv[1])
    if len(argv) == 2 and argv[0] == "--native-worker":
        return native_worker(argv[1])
    if len(argv) == 2 and argv[0] == "--lint-worker":
        return lint_worker(argv[1])
    if argv:
        print(f"chip_smoke: unknown arguments {list(argv)}", file=sys.stderr)
        return 2
    import signal

    adopt_descendants()
    # a SIGTERM (a caller's time limit) unwinds through the sweep below
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        summary, card, world = smoke()
    except BaseException:
        # whether the phases passed or not, nothing they started outlives
        # the script
        stop_descendants(failed=True)
        raise
    stop_descendants()
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": world}}), flush=True)
    return 0


def smoke() -> tuple:
    """Every phase, in order; the ``kernels`` summary, the card's line
    and the world size."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models as hvd_models
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import kernels

    card = card_line()
    # the native engine's library (phase native) builds beside the kernels
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_lib = pool.submit(native_build_timed)
        t0 = time.perf_counter()
        kernels.build_all()
        build_s = time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(SCALAR_TWIN)) as pool:
        sass = dict(zip(SCALAR_TWIN,
                        pool.map(kernels.sass_counts, SCALAR_TWIN)))
    ptxas = {n: kernels.ptxas_report(n).splitlines()
             for n in kernels.SOURCES}
    emit("build", seconds=build_s, card=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         ptxas=ptxas, sass=sass)
    missing = {n: c for n, c in sass.items() if not all(c.values())}
    if missing:
        raise AssertionError(f"tensor-core libraries without wgmma/TMA "
                             f"instructions: {missing}")
    serialized = {n: [ln for ln in lines if "Performance Loss" in ln]
                  for n, lines in ptxas.items()}
    serialized = {n: lines for n, lines in serialized.items() if lines}
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")

    records = kernel_check(fa)
    skip_ms, skip_ratios, main_ratios = tile_skip(fa)
    emit("tile_skip", shape={**SKIP_SHAPE, "window": SKIP_WINDOW},
         dtype=SKIP_DTYPE, ms=skip_ms, ratios=skip_ratios,
         limits=SKIP_LIMITS,
         main_shape={**MAIN_SHAPE, "ratios": main_ratios,
                     "held": False})
    model_check(hvd_models, fa)
    state, step, run, world = train(hvd, fa)
    emit("profile", **profile_step(state, step, run["step_ms"]))
    del state, step
    release()
    nano_run = train_nano(fa)
    fp32_run = train_fp32(fa)
    fp32_path = [n for n, k in fp32_run["launches_per_step"].items() if k]
    # each record's launches from the run of its shape's route
    runs = {"bf16_main": run, "fp32_main": fp32_run, "bf16_nano": nano_run}
    overlap_runs = overlap(fa, run["losses"])
    spmd_run = spmd(fa, run["losses"])
    rope_remat(fa)
    moe_run = moe_phase(fa)
    release()
    parallel_phase(fa)
    release()
    resnet_off = conv(fa)
    reductions(hvd, fa, run)
    release()
    eager_run = eager(hvd, fa, run)
    release()
    native_run = native(fa, run, eager_run, native_lib)
    release()
    fp8(fa, run, resnet_off)
    release()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        # side by side: lint's runs, spmd's examples and the supervisor's
        # give-up are gates, elastic's times are taken contended already
        # (its three runs go side by side)
        linted = pool.submit(lint_phase)
        examples = pool.submit(spmd_examples)
        supervised = pool.submit(bench_supervisor_phase)
        elastic_phase(run["step_ms"])
        linted.result()
        supervised.result()
        emit("spmd", examples=examples.result(), **spmd_run)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        # side by side: each of these is gates around processes that start
        # on the card (their step times are taken contended); the serving
        # phases after them time traffic and run alone.  The launcher's
        # bench of gpt-nano is the nano step's bench record.
        nano_bench = pool.submit(launcher_phase)
        fp32_bench = pool.submit(bench, "--model", "gpt-small", "--dtype",
                                 "fp32", path=fp32_path)
        campaigned = pool.submit(campaign_phase, fa, run, overlap_runs)
        estimated = pool.submit(estimator_phase, fa,
                                run["launches_per_step"])
        obs_phase(run["step_ms"])
        nano_bench, fp32_bench = nano_bench.result(), fp32_bench.result()
        campaigned.result()
        estimated.result()
    serve_check()
    serve_run = serve(fa)
    sampler_check()
    fleet_runs = serve_fleet(serve_run)
    anatomy_phase({
        "gpt-nano bf16": (nano_bench, NANO_PATH,
                          nano_run["launches_per_step"][NANO_PATH[0]]),
        "gpt-small fp32": (fp32_bench, fp32_path,
                           fp32_run["launches_per_step"][fp32_path[0]]),
        "gpt-small MoE-8": (moe_run["bench"], MAIN_PATH,
                            moe_run["launches_per_step"][MAIN_PATH[0]]),
        "bench --serve gpt-small": (fleet_runs["bench"]["record"], (), 0)})
    autoscale_phase()

    summary = [
        {"name": n, "route": "cuda", "source": SOURCES[n][0],
         "replaces": SOURCES[n][1], "shape": at,
         "launches": runs[at]["launches"][n],
         **({"moe_launches": moe_run["launches"][n],
             "native_launches": native_run["world1"]["launches"][n],
             "spmd_launches": spmd_run["launches"][n]}
            if at == "bf16_main" else {}),
         **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}}
        for n in SOURCES for (name, at), r in records.items() if name == n
    ]
    hvd.shutdown()
    return summary, card, world


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
