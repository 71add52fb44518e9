#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpu_provisioner_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each of which exits non-zero on a failed check:
1. card and build: the card's name and power limit, the nvcc build of every
   kernel from ops/csrc (one nvcc per source, started together), with
   ptxas's registers and spills of the seven tensor-core (bf16) instances
   at head dim 128 (flash_fwd on bf16 K/V and on an int8 cache,
   flash_bwd_dq, flash_bwd_dkv and the three tri kernels; and at the other
   head dims for phases 16 to 25) and the HGMMA instructions in their
   SASS (cuobjdump);
2. each kernel against its plain PyTorch version on the card, at the main
   path's head shapes (Hq 32, Hkv 8, D 128) in bf16 and f32 (the bf16
   flash_fwd and the bf16 and int8 caches' prefill on the tensor cores, f32
   on FMA; flash_decode's split schedule on every cache, its shares' edge
   cases included: DECODE_SPLIT_CASES), then its time
   (CUDA events, L2 flushed before each launch) beside its plain version's,
   one PyTorch library call's (scaled_dot_product_attention, a yardstick the
   port never calls; none for an int8 cache) and its bound (bytes over 3.35
   TB/s or bf16 operations over 989 TFLOP/s, whichever is larger: the H100
   SXM's published peaks); the rows under 0.1 ms (the serving flash_fwd,
   the bf16 and int8 cached prefill, flash_decode on a bf16 and an int8
   cache and at S=5 and 16) also with the kernels' own device time from
   torch.profiler (device_ms, flash_decode's merge launch included; by
   CUDA events behind a spin kernel where three profiler sessions in a row
   record no kernel: device_ms_by; taken
   after phase 8, since a profiler session slows every later launch on
   the host) and the bound share from it, beside the library call's own
   device time (library_device_ms), and ptxas's registers and spills of
   the timed flash_decode instances;
3. exact tokens: Llama-7B width, 2 layers, f32: every ServeEngine stream
   equals generate() on that request alone;
4. the serving path: full Llama-7B (32 layers) in bf16 with the flash
   kernels: after one warm-up pass, three ServeEngine passes of 6 requests
   each (one shared prefix), then generate() with B=2, S0=512, fresh and
   left-padded, and left-padded on an int8 KV cache, with every kernel's
   launch count read across that run (the int8 cache's prefill and decode
   instances count apart: flash_cached_int8, flash_decode_int8);
5. both backward kernels against attention_bwd_plain on the card (bf16 and
   f32, D 128, causal, non-causal, window 1024, a non-zero lse cotangent;
   error relative to the largest plain gradient), then, at the training
   shape (B=8, S=2048 causal, Hq 16, Hkv 8, bf16), the forward kernel
   against attention_plain and both backward kernels against
   attention_bwd_plain, the forward timed beside the plain forward, SDPA's
   forward and its bound (the flash_fwd row's at_train_shape), and each
   backward kernel beside the plain backward, the library yardstick
   (torch.autograd.grad of scaled_dot_product_attention, dQ/dK/dV
   together) and its bound (bound_share = bound / time);
6. exact training: Llama-1B width, 2 layers, f32: one make_train_step with
   the flash kernels and one with dense attention, from the same params and
   batch, agree in loss and every gradient, and again in the loss of a
   second step;
7. the training path: full Llama-1B (16 layers), bf16 activations, f32
   masters, remat, B=8, S=2048, AdamW: one warm-up step, then five timed
   steps on one fixed batch, with the loss falling and every kernel's
   launch count read across the five;
8. long context: the three flattened-triangle kernels (flash_tri.cu;
   the bf16 instances on the tensor cores) called directly against
   their plain versions (bf16 and f32, causal, at (B, S, Hq, Hkv) = (1,
   128, 1, 1), where the persistent grid has more CTAs than tiles, (1, 384,
   2, 1) with an lse cotangent, the ragged (1, 1000, 1, 1) with every row
   of more than one tile cut, (1, 1000, 4, 1) and (2, 200, 8, 8) with an
   lse cotangent, (2, 2048, 16, 8) and (1, 8192, 16, 8));
   flash_attention(triangular=True) and its
   gradients against the rectangular kernels at B=1, S=16384 and 32768,
   Hq/Hkv 8/4 (bench_flash_op's streaming shape) and 32/8 (llama-7b's
   attention at mistral-7b-ish's 32k context), bf16, with every kernel's
   launch count read across the 32k, Hq 32 forward and backward; each tri
   kernel timed at S=32768, Hq 8 beside its rectangular kernel, the SDPA
   yardstick and its bound (bound_share = bound / time), each also at the
   training shape beside its rectangular kernel (the tri/rect ratio);
   flash_attention_with_lse and its gradients
   against the plain versions at the bench twins' own shapes ((1, 8192, 8,
   4) causal, (1, 32768, 8, 4) with window 1024 through a plain version
   built by 1024-query chunks, (8, 4096, 16, 8) causal), one launch of
   each rectangular kernel apiece; then the bench twins
   bench_long_context and bench_flash_op at full size, each with its
   launch counts read and checked against its repetition counts;
9. MoE serving (mixtral-ish: dim 2048, 16 layers, GQA 16/8, 8 experts,
   top-2): the cached prefill and decode kernels at its attention shapes
   against their plain versions (bf16 and f32, plain and int8 cache; the
   bf16 admission and decode step timed: ``at_moe_shape``); at 2 layers in
   f32, route on the card equal to route on the CPU (random, tied and
   overflowing logits), moe_cached_forward flash equal to dense within
   1e-4, greedy generate flash equal to dense, ServeEngine streams equal
   to generate on the bucket-padded prompt, a dropless 4-token block
   equal to four single steps; then full depth in bf16 with the flash
   kernels: after a warm-up pass, three ServeEngine passes of 6 requests
   (100-500 prompt tokens, 32 new each; a shared prefix is refused), 16
   timed decode steps at 4 slots, and generate at B=2, S0=512 left-padded
   on a bf16 and an int8 cache, every kernel's launches read across it;
10. speculation (models/speculative.py, ServeEngine's draft mode): at 2
   layers in f32, llama-7b width target and llama-1b width draft, greedy
   speculative_generate equal to generate at B=1 (fresh prefill) and B=4
   (ragged pad_id), spec_k 4 and 15 (verify blocks of 5 and 16 queries on
   flash_decode), flash equal to dense, ServeEngine with the draft equal
   to ServeEngine without, and a mixtral-ish-width MoE target with the
   dense draft equal to its generate; then full llama-7b with a full
   llama-1b draft in bf16 at bench_speculative's S0 256 and spec_k 4 with
   48 new tokens (SPEC_NEW, half its 96) at B=1 and B=8
   (left-padded): target calls, the accepted
   share, tokens/s beside plain generate's in the same run, host syncs a
   round (torch.cuda.set_sync_debug_mode), flash_decode calls by block
   length, agreement with plain greedy and its first divergence; a
   speculative ServeEngine pass (6 requests, a shared prefix); every
   kernel's launches across the speculative runs and that pass alone,
   plain generate timed before the count starts (``spec`` in
   launches_by_path); flash_decode at the B=8 verify call's shape, and
   flash_fwd and flash_cached at the shapes the B=1 and B=8 prefills gave
   them (target and draft heads), each against its plain version and timed
   (``at_spec_verify``, ``at_spec_prefill``); then the bench_speculative
   twin (self-draft llama-1b) with its launches;
11. resumable training (models/checkpoint.py on torch.distributed.checkpoint,
   default_optimizer(mu_dtype=), the MoE train step, the training bench
   twins): at llama-1b width, 2 layers, f32, flash, two uninterrupted runs
   of 4 steps (bitwise equal or not: the run-to-run spread), then 2 steps,
   a TrainCheckpointManager save, every tensor dropped, restore_latest()
   onto the card (every leaf, params, mu, nu and count, bitwise equal to
   the saved one) and 2 more steps equal to the uninterrupted run's (or
   within its spread), and a restore onto the CPU equal to the card's;
   full llama-1b (bf16, f32 masters, bf16 mu, remat, B=8, S=2048): 4
   uninterrupted steps, then 2 steps, save_train_state (the state's bytes,
   the seconds, the disk's free space: the phase fails if the disk cannot
   hold it), a restore and 2 steps with the same losses, the launches read
   across the resumed steps (``resume``), the bf16-mu step's ms beside
   phase 7's f32-mu step; mixtral-ish at 2 layers in f32, a flash MoE train
   step equal to a dense one in loss and every gradient; mixtral-ish at
   full width and 8 of 16 layers (bf16, f32 masters, remat, B=4, S=2048):
   a warm-up and 5 timed steps, the loss falling, peak memory, the
   launches (``moe_train``); then the bench_train_step twin (mfu against
   the H100's 989e12 bf16 FLOP/s; ``bench_train_step``) and the
   bench_workload twin, at full size;
12. sharded training (parallel/, models/train.py on a mesh), its ranks
   spawned by parallel/launch.py and sharing the one card over gloo (no
   multi-GPU time: every time is labelled so): at llama-1b width, 2
   layers, f32, flash, one step on (sp 2, dp 2) ring and zigzag, (sp 2,
   tp 2) and (tp 2, dp 2) of one 4-rank world, each rank's gradients and
   updated shards against this process's make_train_step (loss 1e-5
   relative, gradients 1e-4 of the largest, params 1e-5 where |g| >=
   1e-7), no rank importing jax; then full-width llama-1b at 4 of 16
   layers (SHARDED_LAYERS; bf16, f32 masters, remat, B=8, S=2048) at sp=2
   over 2 ranks,
   ring then zigzag, and at (sp 2, tp 2) over 4: a warm step and three
   timed, the loss falling and equal on every rank, step ms, bytes staged
   through the host and seconds in the staged collectives a step, peak
   memory, and each rank's launches a step checked (ring: 8/4/4 on seq
   rank 0, 16/8/8 on rank 1; zigzag 40/20/20; ``sharded`` in
   launches_by_path);
13. pipeline and expert parallelism (parallel/pipeline.py,
   make_pipeline_train_step, make_moe_train_step on a mesh), the ranks
   again sharing the card over gloo: flash_fwd, flash_bwd_dq and
   flash_bwd_dkv at the paths' own call shapes (PARALLEL_CALLS) against
   their plain versions; one step at llama-1b width (2 layers, 4 where
   n_chunks 2 needs them) and mixtral-ish width (2 layers, capacity
   factor 0.5, so choices drop), f32, flash, on (pp 2, dp 2), (pp 2, tp 2)
   gpipe and interleaved, (pp 2, sp 2), (ep 2, tp 2), (dp 2, ep 2) and
   (sp 2, ep 2) zigzag of one 4-rank world, against this process's
   single-process step to phase 12's limits; then full-width llama-1b at
   4 of 16 layers (B=8, S=2048, bf16, n_micro 4, no remat) at pp=2 over
   2 ranks, gpipe and interleaved, and at (pp 2, tp 2) over 4, and
   full-width mixtral-ish at 2 of 16 layers (EXPERT_LAYERS; remat, B=4,
   S=2048) at ep=2
   over 2 ranks and (ep 2, tp 2) over 4: a warm step and three timed, the
   loss falling and equal on every rank, step ms, staged bytes, seconds in
   collectives, peak memory and each rank's launches a step checked
   (pipeline 8/8/8, expert 4/2/2; ``pipeline`` and ``expert`` in
   launches_by_path);
14. sharded serving (generate, speculative_generate, ServeEngine and
   cached_forward with ``mesh=``: models/decode.py, moe_serve.py,
   speculative.py, engine.py), the ranks again sharing the card over gloo:
   #1, #4 and #5 at the per-rank shapes (Hq 16/Hkv 4: Llama-7B at tp=2;
   8/4: mixtral-ish at (ep=2, tp=2)), bf16 and f32, plain and int8 caches,
   against their plain versions, the bf16 calls timed
   (``at_tp_serving_shapes``); at 2 layers in f32 (the kernels' f32
   instances) Llama-7B width on tp=2 (data 2 × model 2): generate fresh,
   left-padded, on an int8 cache, self-draft speculation, a ServeEngine
   with a cached prefix, then mixtral-ish width on ep=2 and (ep=2, tp=2),
   one 4-rank world, every rank's tokens equal to this process's
   single-process run and each generate's launches L of #1 or #4 and
   (new - 1)·L of #5 (``serving_exact``); Llama-7B at full width (4 of
   its 32 layers: SERVE_TP_LAYERS; bf16) at tp=2 and mixtral-ish at full
   width (8 of its 16 layers: SERVE_EP_LAYERS) at ep=2 over 2 ranks
   (each depth cut for the script's time): generate
   B=2, S0=512, 32 new (fresh, left-padded, int8 cache), one
   ServeEngine pass of 6 requests after a warm one (a shared prefix,
   dense only; SERVE_PASSES), the launches a rank checked, tokens/s, staged bytes and
   collective seconds a forward, peak a rank (``tp_serving``,
   ``ep_serving``); then entry() on the card, dryrun_multichip(4) and the
   four serving bench twins at fast size with their launches;
15. a save on one mesh restored onto another (models/checkpoint.py with
   ``mesh=``: each leaf a DTensor over the rank's shard, written once by
   torch.distributed.checkpoint, read back as the restoring mesh's
   shards), the ranks again sharing the card over gloo: first flash_fwd
   (#1/#2), flash_bwd_dq (#6) and flash_bwd_dkv (#7) at the call shape of
   the step after the full-width restore (RESUME_CALLS: B=8, S=2048,
   8/4 heads a rank at tp 2, causal) against their plain versions
   (``at_resume_shapes``); then at llama-1b width
   in f32 with the flash kernels, one 4-rank world: 2 layers saved after
   a step at dp 4 and restored at (tp 2, sp 2), and 4 layers pipelined at
   (pp 2, dp 2) with n_chunks 2 restored under its stamp: every rank's
   restored leaves bitwise its shards of the saved tree, the next loss
   within 1e-5 of the old mesh's, a (1, 1) restore of the pipelined state
   and a save onto an existing checkpoint refused on every rank, no CUDA
   tensor handed to a collective; then full-width llama-1b at
   SHARDED_LAYERS layers (bf16, f32 masters and moments, remat, B=8,
   S=2048) saved after a step at dp 2 through TrainCheckpointManager(
   mesh=) and restored at tp 2 over 2 ranks (the disk's free space checked
   first): leaves bitwise, the next loss within 2e-4 relative of
   the dp-2 mesh's, save and restore seconds and GB/s, and the launches a
   rank of the step after the restore checked (8 / 4 / 4 at 4 layers:
   ``resume_mesh`` in launches_by_path); phase 4 also reads its last
   engine back from observability/fleet.py's registry;
16. head dim 64 (the forward kernels' D = 64 instances; phase 1 also
   prints the ptxas registers, spills and HGMMA of the two new
   tensor-core instances and of the timed decode ones): (a) #1/#2 (causal
   and not, a window), #4 on a bf16 and an int8 cache (start, pads,
   window, sinks, ragged S) and #5 on every cache (DECODE_SPLIT_CASES and
   an engine step) at the bench_moe_decode model's Hq 16 / Hkv 8 of 64, in
   bf16 (1e-2) and f32 (1e-4), against their plain versions, then the bf16
   calls timed at its main-path shapes (a fresh prefill at B=8, S=512;
   the twin's prefill and decode step, D64_TWIN) beside SDPA and the
   bound (the ``*_d64`` rows of the kernels line); (b) at that model's
   width, 2 layers, f32: MoE ServeEngine streams equal generate() on the
   bucket-padded prompt and generate flash equals dense, and a dense
   model of the same attention: engine streams (two after a shared
   prefix) equal generate() on each request alone, fresh generate flash
   equals dense; (c) the bench_moe_decode model at full size (bf16): the
   bench_moe_decode twin at (8, 512, 128), a ServeEngine pass of 6
   requests (a shared prefix refused, as the MoE family takes none), a
   left-padded generate on an int8 cache, then bench_decode's fast model
   (dense, 8/4 heads of 64: the MoE family has no fresh prefill): the
   bench_decode twin and an engine pass with a shared prefix, every
   kernel's launches read across the run (the five forward kernels and
   nothing else: ``d64_serving``);
17. head dim 64 in training (the backward and triangle kernels' D = 64
   instances; phase 1 also prints the ptxas registers, spills and HGMMA
   of their tensor-core instances): (a) #6/#7, with #1's forward, at
   D64_BWD_CASES (the training shape (8, 2048, 16/8), the fast
   bench_train_step model's (4, 512, 8/4), ragged S, a window, lse
   cotangents) and #3/#8/#9 called directly at D64_TRI_CASES, in bf16
   (1e-2) and f32 (1e-4; gradients relative to the largest plain one),
   against their plain versions; then #1, #6 and #7 timed at D64_TRAIN
   and the tri kernels at D64_TRI beside their plain versions (at
   D64_TRI_PLAIN for the triangle), SDPA and the bound (the ``*_d64``
   rows of #6-#9; #1's in the flash_fwd_d64 row's at_train_shape); (b) a
   flash train step equal to a dense one at the fast bench_train_step
   model's width (dim 512, 8/4 heads of 64), 2 layers, f32; (c) that model
   at its JAX shape (B=4, S=512; bf16, remat): a warm-up and five steps on
   one batch, the loss falling, then its bench twin, each with its
   launches (``d64_train``, ``bench_train_step_fast``); three steps of
   make_moe_train_step on bench_moe_decode's full model (dim 1024, 8
   layers, 16/8 heads of 64, 8 experts, top-2) at MOE_TRAIN_SHAPE
   (``moe_train_d64``); a triangular=True forward and backward at (1,
   32768, 8/4) against the rectangular kernels, the tri kernels launched
   once each (``d64_long``); (d) the twin of hack/tpu_onchip_checks.py
   (gpu_provisioner_tpu_torch/onchip_checks.py) in this process, every
   check ok;
18. head dims 32 and 16 in serving (the D = 32 and 16 instances of #1/#2,
   #4 and #5): (a) in phase 1, each source's nvcc seconds and the ptxas
   registers, spills and HGMMA of the new tensor-core instances and of
   the timed decode ones (whose C entry is flash_decode_narrow); (b)
   #1/#2 (causal and not, a window, a ragged S through the launch), #4 on
   a bf16 and an int8 cache and #5 on both (SMALL_CACHE_CASES: the fast
   bench_engine model's admission, pads, a window with sinks, a decode
   step at per-row starts, verify blocks of 5 and 16) at head dims 32 (Hq
   8 / Hkv 4) and 16 (4 / 2), bf16 (1e-2) and f32 (1e-4), against their
   plain versions, then the bf16 calls timed (a fresh prefill at B=2,
   S=128; an admission at S=128, ML 512; a decode step at B=2 and a
   verify block of 5) beside SDPA and the bound (the ``*_d32`` and
   ``*_d16`` rows of the kernels line); (c) in f32, tiny (4/2 heads of
   16), the fast bench_engine model (8/4 of 32) and tiny-moe with flash
   against dense: logits, generate, an int8 generate, a ServeEngine pass;
   (d) bf16: the fast bench_moe_decode and bench_engine twins at 8/4 heads
   of 32 and their models through the kernels, then tiny and tiny-moe,
   each head dim's launches read (the five forward kernels, each at least
   once, and nothing else: ``d32_serving``, ``d16_serving``), and the
   forward, the backward and flash_fwd_tri at head dim 48 (which no
   kernel takes) refused, naming it, before any launch;
19. head dims 32 and 16 in training (the D = 32 and 16 instances of #6/#7
   and #3/#8/#9): (a) in phase 1, the ptxas registers, spills and HGMMA
   of their ten tensor-core instances; (b) at each head dim (8/4 heads of
   32, 4/2 of 16) #6/#7, with #1's forward, at small_bwd_cases (causal,
   non-causal, a window, with and without an lse cotangent, a ragged S)
   and #3/#8/#9 called directly at small_tri_cases, bf16 (1e-2) and f32
   (1e-4; gradients relative to the largest plain one), against their
   plain versions, and triangular=True through the wrapper at (1, 8192)
   with RESIDENT_KV_BUDGET lowered for the call (the tri kernels once
   each; against plain and against the rectangular kernels); (c) in bf16
   #1, #6 and #7 timed at the D = 64 rows' training pairs and heads (8,
   2048, 16/8) and the tri kernels at (1, 32768, 8/4), beside their plain
   versions (the triangle's at S=8192), SDPA's torch.autograd.grad and
   the bound (the ``*_d32`` and ``*_d16`` rows of #6-#9; #1's in the
   flash_fwd rows' at_train_shape); (d) in f32, tiny, the fast bench_engine
   model and tiny-moe three train steps with flash against dense (losses
   1e-5 relative, params 1e-4), then bf16 with remat: the fast
   bench_engine model and tiny trained five steps each at (4, 512)
   (``d32_train``, ``d16_train``), tiny-moe three MoE steps
   (``moe_train_d16``); (e) the pp2_tp2_flash pipeline on tiny at 4 layers
   over 4 ranks sharing the card over gloo against the single-process
   step (``d16_pipeline``), and a triangular=True forward and backward
   at (1, 50176, 8/4) at 32 and (1, 98816, 4/2) at 16, where the natural
   budget takes flash_fwd_tri, against the rectangular kernels and timed
   (``d32_long``, ``d16_long``), each path's launches read alone, every
   backward and triangle kernel launched at both head dims;
20. head dims 96 and 80 in serving (the D = 96 and 80 instances of #1/#2,
   #4 and #5, built from flash_fwd_mid.cu and flash_decode_mid.cu): (a) in
   phase 1, the ptxas registers, spills and HGMMA of the new tensor-core
   instances and of the timed decode ones; (b) #1/#2 (causal and not, a
   window, a ragged S through the launch), #4 on a bf16 and an int8 cache
   (MID_CACHE_CASES: an admission after a prefix, generate's left-padded
   prefill, a window with sinks, a ragged S) and #5 on both
   (DECODE_SPLIT_CASES: S = 1, 5 and 16, windows; an engine step) at
   Phi-3-mini's 32/32 heads of 96 and H2O-Danube-1.8B's 32/8 of 80, bf16
   (1e-2) and f32 (1e-4), against their plain versions, then the bf16
   calls timed at generate's shapes (B=2, S0=512, max_len 1024, Danube's
   window of 4096 on #4 and #5; a verify block of 5) and at the D = 128
   rows' (``at_d128_shape``) beside SDPA and the bound (the ``*_d96`` and
   ``*_d80`` rows of the kernels line); (c) in f32 at the two models'
   widths cut to 2 layers, flash against dense: logits, generate, an int8
   generate, a ServeEngine pass; (d) bf16 at full depth (mid_models: 32
   layers at dim 3072, 24 at 2560; random weights): a fresh generate
   (Danube's without its window, which routes a prefill to #4), a
   left-padded one on a bf16 and on an int8 cache and a ServeEngine pass
   of three requests on two slots, each head dim's launches read equal to
   the path's prediction (``d96_serving``, ``d80_serving``), then a
   forward that requires grad, triangular=True and the backward at head
   dim 36 (a row cut mid-chunk, which no source builds; 100 was refused
   here until phase 25 took it into training) refused, naming it, before
   any launch;
21. head dims 96 and 80 in training (the D = 96 and 80 instances of #6/#7
   and #3/#8/#9, built from flash_bwd_mid.cu and flash_tri_mid.cu): (a) in
   phase 1, the ptxas registers, spills and HGMMA of their ten tensor-core
   instances; (b) at Phi-3-mini's 32/32 heads of 96 and H2O-Danube-1.8B's
   32/8 of 80, #6/#7 (with #1's forward) at mid_bwd_cases (causal, non-
   causal, a window of 1024 and at 80 Danube's 4096 at S 5120, with and
   without an lse cotangent, a ragged S) and #3/#8/#9 called directly, bf16
   (1e-2) and f32 (1e-4; gradients relative to the largest plain one),
   against their plain versions, and triangular=True through the wrapper
   at (1, 4096) with RESIDENT_KV_BUDGET lowered for the call; (c) in bf16
   #1, #6 and #7 timed at the D = 128 training rows' pairs and heads (8,
   2048, 16/8) and the tri kernels at (1, 32768, 8/4), beside their plain
   versions, SDPA's torch.autograd.grad, the bound and the D = 128 row's
   time of the same call (the ``*_d96`` and ``*_d80`` rows of #6-#9,
   ``d128_ms``; #1's in the flash_fwd rows' at_train_shape); (d) both
   widths cut to 2 layers, three f32 train steps flash against dense
   (losses 1e-5 relative; the first step's gradients within 1e-4 of the
   largest and its params within 1e-4 where its gradients are at least
   1e-7 and of one sign: train_exact's wide gate, since later steps'
   params move apart by ~lr where a tiny first gradient flipped its sign);
   (e) bf16 with remat, f32 masters
   and AdamW at full width: Danube's 24 layers at (2, 8192), where its
   window masks (``d80_train``), Phi-3-mini at its 32 layers at (4, 4096)
   (``d96_train``: its f32 state alone is ~61 GB of the card's 80), a warm-up
   and five steps each, the loss falling, launches #1 2·L·5 and #6/#7 L·5,
   peak memory; (f) a triangular=True forward and backward at (1, 32768,
   8/4) at each head dim, where the natural budget takes flash_fwd_tri,
   against the rectangular kernels and timed (``d96_long``,
   ``d80_long``), each path's launches read alone;
22. head dim 256 in serving (the D = 256 instances of #1/#2, #4 and #5,
   built from flash_fwd_wide.cu and flash_decode_wide.cu: the forward's
   output in two column halves of 128, one a CTA; the decode's threads
   two columns each): (a) in phase 1, the ptxas registers, spills and
   HGMMA of the two tensor-core instances and of the timed decode ones (R
   = 8 for S = 1, 64 for S = 5); (b) #1/#2, #4 on a bf16 and an int8 cache
   and #5 on both at Gemma-2B's 8/1 heads of 256 (phase 20's cases), bf16
   (1e-2) and f32 (1e-4), against their plain versions, then the bf16
   calls timed at generate's shapes (B=2, S0=512, max_len 1024; a verify
   block of 5) and at the D = 128 rows' (``at_d128_shape``, with the D =
   128 row's time of the same call, ``d128_ms``), and #1 once more at the
   D = 128 training row's (8, 2048, 16/8) (``at_train_shape``) beside
   SDPA and the bound (the ``*_d256`` rows); (c) in f32 at Gemma-2B's
   widths cut to 2 layers, flash against dense: logits, generate, an int8
   generate, a ServeEngine pass; (d) bf16 at full depth (wide_models: 18
   layers at dim 2048, vocab 256000; random weights): a fresh generate, a
   left-padded one on a bf16 and on an int8 cache and a ServeEngine pass,
   the launches read equal to the path's prediction (``d256_serving``),
   tokens/s, peak memory and the parameter count, then a forward that
   requires grad, triangular=True and the backward at head dim 192 (a
   multiple of 16 past 128 that no source builds) refused, naming it,
   before any launch;
23. head dim 256 in training (the D = 256 instances of #6/#7 and
   #3/#8/#9, built from flash_bwd_wide.cu and flash_tri_wide.cu: the
   register-A products in column halves of 128, dQ's two in one CTA, the
   forward's and dK/dV's one a CTA, S and dP whole; the triangle's
   forward and dK/dV rows one (batch, head, half) each): (a) in phase
   1, the ptxas registers, spills and HGMMA of their five tensor-core
   instances (every instance's ptxas with the build's); (b) at Gemma-2B's
   8/1 heads and at the D = 128 training row's 16/8, #6/#7 (with #1's
   forward) at mid_bwd_cases (causal, non-causal, a window of 1024, with
   and without an lse cotangent, a ragged S), and #3/#8/#9 called directly
   at 8/1 (small_tri_cases, S up to 4096), bf16 (1e-2) and f32 (1e-4;
   gradients relative to the largest plain one), against their plain
   versions, and triangular=True through the wrapper at (1, 4096) with
   RESIDENT_KV_BUDGET lowered for the call; (c) in bf16 #1, #6 and #7
   timed at the D = 128 training row's (8, 2048, 16/8) and the tri kernels
   at (1, 32768, 8/4), beside their plain versions, SDPA's
   torch.autograd.grad, the bound and the D = 128 row's time of the same
   call (the ``*_d256`` rows of #6-#9, ``d128_ms``); (d) Gemma-2B's widths
   cut to 2 layers, three f32 train steps flash against dense
   (train_exact's wide gate); (e) bf16 with remat, f32 masters and AdamW
   at full width and depth (18 layers) at WIDE_TRAIN_STEPS (1, 4096), a
   warm-up and WIDE_STEPS steps, the loss falling, launches #1 2·18·steps
   and #6/#7 18·steps and nothing else, peak memory (``d256_train``); (f)
   a triangular=True forward and backward at (1, 32768) at Gemma's own
   8/1 heads, where the natural budget takes flash_fwd_tri, against the
   rectangular kernels and timed (``d256_long``), each path's launches
   read alone;
24. head dim 100 in serving (OpenLLaMA-3B's 32/32 heads of 100: a row of
   no whole number of 16-byte chunks; the D = 100 instances of #1/#2, #4
   and #5, built from flash_fwd_pad.cu and flash_decode_pad.cu: D = 128's
   tile partly filled, bf16 rows copied in 8-byte pieces and int8 rows in
   4-byte ones, S = Q K^T in 7 k-steps, the stores cut at column 100):
   (a) in phase 1, the ptxas registers, spills and HGMMA of the two
   tensor-core instances and of the timed decode ones; (b) #1/#2, #4 on a
   bf16 and an int8 cache and #5 on both at 32/32 heads of 100 (phase
   20's cases), bf16 (1e-2) and f32 (1e-4), against their plain versions,
   the bf16 calls timed at generate's shapes and at the D = 128 rows'
   (``at_d128_shape`` with ``d128_ms``) beside SDPA (the kernels it ran:
   ``library_kernels``, ``library_backend``) and the bound (the
   ``*_d100`` rows); then every entry launched directly once more, in
   bf16 and f32, on self-attention, a bf16, an f32 and an int8 cache and
   the decode with one split and with its merge, its output a view of
   rows 128 wide filled with a sentinel: columns 100..127 keep it and
   columns below 100 agree with the plain version (``pad_stores``); (c)
   in f32 at OpenLLaMA-3B's widths cut to 2 layers, flash against dense:
   logits, generate, an int8 generate, a ServeEngine pass; (d) bf16 at
   full depth (pad_models: 26 layers at dim 3200; random weights): a
   fresh generate, a left-padded one on a bf16 and on an int8 cache and a
   ServeEngine pass, the launches read equal to the path's prediction
   (``d100_serving``), tokens/s, peak memory and the parameter count,
   then at head dim 36, which no source builds, every serving and
   training call refused by name before any launch (``serving_refused``).
   Prints the phase's seconds;
25. head dim 100 in training (the D = 100 instances of #6/#7 and
   #3/#8/#9, built from flash_bwd_pad.cu and flash_tri_pad.cu: D = 128's
   tile partly filled, Q, dO, K and V rows copied in 8-byte pieces, the
   K-major products in 7 k-steps, every store, to the outputs and to the
   triangle's workspace, cut at column 100; the f32 instances 13 columns a
   lane): (a) in phase 1, the ptxas registers, spills and HGMMA of their
   five tensor-core instances; (b) at OpenLLaMA-3B's 32/32 heads and at
   the D = 128 training row's 16/8, #6/#7 (with #1's forward) at
   mid_bwd_cases, and #3/#8/#9 called directly at 32/32 (small_tri_cases,
   S up to 4096), bf16 (1e-2) and f32 (1e-4; gradients relative to the
   largest plain one), against their plain versions, and triangular=True
   through the wrapper at (1, 4096) with RESIDENT_KV_BUDGET lowered for
   the call; then #1, #6 and #7 timed at the D = 128 training row's (8,
   2048, 16/8) and the tri kernels at (1, 32768, 8/4), beside their plain
   versions, SDPA's torch.autograd.grad, the bound and the D = 128 row's
   time of the same call (the ``*_d100`` rows of #6-#9, ``d128_ms``); (c)
   the five entries launched directly in bf16 and f32 at (2, 200) and (2,
   1000), 8/4 heads, each output a view of rows 128 wide filled with the
   sentinel: columns 100..127 keep it and columns below 100 agree with the
   plain versions (``pad_train_stores``, ``at_sentinel_stores``); (d)
   OpenLLaMA-3B's widths cut to 2 layers, three f32 train steps flash
   against dense (train_exact's wide gate); (e) bf16 with remat, f32
   masters and AdamW at full width and depth (26 layers) at
   PAD_RUNS[100].train (4, 2048), a warm-up and PAD_STEPS steps, the loss
   falling, launches #1 2·26·steps and #6/#7 26·steps and nothing else,
   peak memory (``d100_train``); (f) a triangular=True forward and
   backward at (1, 32768) at the model's own 32/32 heads, where the natural
   budget takes flash_fwd_tri, against the rectangular kernels and timed
   (``d100_long``), each path's launches read alone. Prints the phase's
   seconds;
26. head dim 120 in serving (H2O-Danube3-4B's 32/8 heads of 120; the D =
   120 instances of #1/#2, #4 and #5, built from flash_fwd_pad.cu and
   flash_decode_pad.cu beside 100's: D = 128's tile with a zeroed pad
   inside its last k-step, a bf16 row of 15 16-byte chunks copied as D =
   128's 16 with the 16th zero-filled, S = Q K^T in D = 128's 8 k-steps,
   an int8 row of 120 bytes in 8-byte pieces, the decode's score product
   7 whole int8 chunks and a tail of 8 values): (a)
   in phase 1, the ptxas registers, spills and HGMMA of the two
   tensor-core instances and of the timed decode ones; (b) #1/#2, #4 on a
   bf16 and an int8 cache and #5 on both at 32/8 heads of 120 (phase 20's
   cases), bf16 (1e-2) and f32 (1e-4), against their plain versions, the
   bf16 calls timed at generate's shapes and at the D = 128 rows'
   (``at_d128_shape`` with ``d128_ms``) beside SDPA (its backend) and the
   bound (the ``*_d120`` rows); (c) every entry launched directly at 8/2
   heads, its output a view of rows 128 wide filled with the sentinel:
   columns 120..127 keep it (``pad_stores``); (d) in f32 at the model's
   widths cut to 2 layers, flash against dense: logits, generate, an int8
   generate, a ServeEngine pass; (e) bf16 at full depth (pad_models: 24
   layers at dim 3840; random weights): a fresh generate, a left-padded
   one on a bf16 and on an int8 cache and a ServeEngine pass, the launches
   read equal to the path's prediction (``d120_serving``), tokens/s, peak
   memory and the parameter count; (f) at head dims 112 and 36, which no
   source builds, every serving and training call refused by name before
   any launch (``serving_refused``). Prints the phase's seconds;
27. head dim 120 in training (the D = 120 instances of #6/#7 and
   #3/#8/#9, built from flash_bwd_pad.cu and flash_tri_pad.cu beside
   100's: the K-major products in 8 k-steps over the zeroed pad, the dK/dV
   stage's Q and dO chunks copied together, every store whole 8-column
   groups up to column 119; the f32 instances 15 columns a lane): (a) in
   phase 1, the ptxas registers, spills and HGMMA of their five
   tensor-core instances; (b) at H2O-Danube3-4B's 32/8 heads and at the D
   = 128 training row's 16/8, #6/#7 (with #1's forward) at mid_bwd_cases,
   and #3/#8/#9 called directly at 32/8 (small_tri_cases, S up to 4096),
   bf16 (1e-2) and f32 (1e-4; gradients relative to the largest plain
   one), against their plain versions, and triangular=True through the
   wrapper at (1, 4096) with RESIDENT_KV_BUDGET lowered for the call; then
   #1, #6 and #7 timed at (8, 2048, 16/8) and the tri kernels at (1, 32768,
   8/4), beside their plain versions, SDPA's torch.autograd.grad, the bound
   and the D = 128 row's time of the same call (the ``*_d120`` rows of
   #6-#9, ``d128_ms``); (c) the five entries launched directly at 8/2
   heads into sentinel rows 128 wide: columns 120..127 keep it
   (``pad_train_stores``); (d) the model's widths cut to 2 layers, three
   f32 train steps flash against dense (train_exact's wide gate); (e) bf16
   with remat, f32 masters and AdamW at full width and depth (24 layers)
   at PAD_RUNS[120].train (1, 4096), a warm-up and PAD_STEPS steps, the loss
   falling, launches #1 2·24·steps and #6/#7 24·steps and nothing else,
   peak memory (``d120_train``); (f) a triangular=True forward and
   backward at (1, 32768) at the model's own 32/8 heads, where the natural
   budget takes flash_fwd_tri, against the rectangular kernels and timed
   (``d120_long``), each path's launches read alone. Prints the phase's
   seconds.
Phases 2, 16, 18, 20, 22, 24 and 26 check and time the serving kernels
through one function of the head dim (serve_kernels, SERVE_DIMS), phases
17, 19, 21, 23, 25 and 27 the training kernels (train_kernels;
phase_train_kernels at 19, 21, 23, 25 and 27), phases 24 to 27 through one
set of functions of the head dim (phase_pad_*, its runs in PAD_RUNS); then
the phase-2, 9, 10, 14,
16, 18, 20, 22, 24 and 26 rows' device times, the card line, the kernels
line and, last, the device line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"bfloat16": 1e-2, "float32": 1e-4}
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12     # H100 SXM data sheet, dense
SEED = 0


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the tensor-core (bf16) instances of the backward and triangle kernels (the
# serving kernels' are serve_tc_kernels'): row, the mangled name's start
TRAIN_TC = (("flash_bwd_dq", "flash_bwd_dq_tc_kernelI"),
            ("flash_bwd_dkv", "flash_bwd_dkv_tc_kernelI"),
            ("flash_fwd_tri", "flash_fwd_tri_kernelI13__nv_bfloat16"),
            ("flash_bwd_dq_tri", "flash_bwd_dq_tri_kernelI13__nv_bfloat16"),
            ("flash_bwd_dkv_tri", "flash_bwd_dkv_tri_tc_kernelI"))


def train_tc_kernels(_cuda, dims):
    """The tensor-core instances of the backward and triangle rows at each
    head dim of ``dims``: {row: (source, a substring of the mangled name)},
    the source the C entry's (_cuda.entry) and the row suffixed as
    serve_suffix says."""
    return {f"{row}{serve_suffix(D)}": (_cuda.ENTRIES[_cuda.entry(row, D)][0],
                                        f"{part}Li{D}E")
            for D in dims for row, part in TRAIN_TC}


def ptxas_info(log):
    """{mangled kernel: {registers, spill_stores, spill_loads}} from nvcc's
    -Xptxas -v output."""
    import re
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            cur = info.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return info


def hgmma_counts(_cuda, source):
    """{mangled kernel: HGMMA instructions in its SASS} of a built library
    (cuobjdump -sass, which ships with nvcc); fails without cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(Path(tool).exists(), "cuobjdump not found: the SASS of the "
          "tensor-core kernels cannot be checked for HGMMA")
    out = subprocess.run([tool, "-sass", str(_cuda.lib_path(source))],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            cur = line.split("Function : ", 1)[1].strip()
            counts[cur] = 0
        elif cur is not None and "HGMMA" in line:
            counts[cur] += 1
    return counts


def tc_build_report(_cuda, logs, kernels):
    """Per tensor-core instance of ``kernels``: ptxas's registers and
    spills (when this run built its library) and the HGMMA count of its
    SASS; fails when ptxas spilled, or when the SASS holds no HGMMA (the
    tensor-core path is not there) or cannot be read."""
    report = {}
    sass = {}
    for entry, (source, part) in kernels.items():
        if source not in sass:
            sass[source] = hgmma_counts(_cuda, source)
        regs = {k: v for k, v in ptxas_info(logs.get(source, "")).items()
                if part in k}
        hgmma = sum(n for k, n in sass[source].items() if part in k)
        ptxas = next(iter(regs.values()), None)
        report[entry] = {"ptxas": ptxas, "hgmma": hgmma}
        print(f"  {entry} (bf16, {part}): ptxas {ptxas}, "
              f"HGMMA in SASS {hgmma}")
        check(hgmma > 0, f"{entry}: no HGMMA in the SASS of {part}")
        check(ptxas is None or not (ptxas.get("spill_stores")
                                    or ptxas.get("spill_loads")),
              f"{entry}: ptxas spills in {part}")
    return report


def decode_build_report(logs, instances, source):
    """ptxas's registers and spills of the timed flash_decode instances
    ``instances`` ({row: a part of the mangled name}) of ``source`` (when
    this run built the library; FMA kernels: no HGMMA)."""
    info = ptxas_info(logs.get(source, ""))
    report = {row: next((v for k, v in info.items() if part in k), None)
              for row, part in instances.items()}
    for row, ptxas in report.items():
        print(f"  {row} ({instances[row]}): ptxas {ptxas}")
    return report


def time_ms(fn, flush, reps=20, warm=3):
    """Median of per-launch CUDA-event times, the 50 MB L2 flushed before
    each launch (the serving loop reads each layer's cache cold)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


SESSIONS = 3


def profiled(fn, flush, names=None, reps=20):
    """One torch.profiler session of ``reps`` fn() calls, the 50 MB L2
    flushed before each: {kernel: (records, self device µs)} of the
    kernels whose names hold one of ``names``, or of every kernel but the
    flush's fill when ``names`` is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {evt.key: (evt.count,
                      float(getattr(evt, "self_device_time_total", None)
                            or getattr(evt, "self_cuda_time_total", 0.0)))
            for evt in prof.key_averages()
            if getattr(evt, "device_type", None) == DeviceType.CUDA
            and (any(n in evt.key for n in names) if names
                 else "FillFunctor" not in evt.key)}


def device_ms(fn, flush, names=None, reps=20, warm=3):
    """(ms, by): the mean device time of one fn() call in the kernels of
    ``profiled`` (the kernels' own time, without the wrapper's host work
    that time_ms's events may hold), by "profiler". About one session in
    170 loses some or all of its kernel records (measured by
    hack/torch_profiler_sessions.py); one counts only when it holds each
    kernel a whole number of times a call. After SESSIONS sessions that
    do not, the time comes from spun_ms instead, by "spun events"."""
    for _ in range(warm):
        fn()
    for i in range(SESSIONS):
        kernels = profiled(fn, flush, names, reps)
        if kernels and all(c % reps == 0 for c, _ in kernels.values()):
            return sum(us for _, us in kernels.values()) / reps / 1e3, \
                "profiler"
        print(f"torch.profiler session {i + 1} of {SESSIONS} for {names}: "
              f"{reps} calls, kernel records "
              f"{ {k[:40]: c for k, (c, _) in kernels.items()} }",
              file=sys.stderr)
    return spun_ms(fn, flush, reps), "spun events"


SPIN_MS, SPIN_MAX_MS = 1.0, 64.0


def spun_ms(fn, flush, reps=20):
    """Median device time of one fn() call by CUDA events queued behind a
    spin kernel (torch.cuda._sleep): the host queues both events and fn's
    launches while the card spins, so the events hold no host time, only
    fn's kernels and the gaps between them on the card. A call is kept
    only when the host queued it within its spin; one that took longer is
    timed again behind a spin twice as long, from SPIN_MS up to
    SPIN_MAX_MS. Fails when the host took longer than that."""
    import torch
    a, b, s = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s.record()
    torch.cuda._sleep(1 << 20)
    a.record()
    a.synchronize()
    per_ms = (1 << 20) / s.elapsed_time(a)
    spin, times = SPIN_MS, []
    while len(times) < reps:
        flush.zero_()
        torch.cuda._sleep(int(per_ms * spin))
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if host_ms < spin:
            times.append(a.elapsed_time(b))
            continue
        check(spin < SPIN_MAX_MS, f"spun_ms: the host took {host_ms:.3f} "
              f"ms to queue the call, longer than the {spin} ms spin")
        spin *= 2
        print(f"spun_ms: the host took {host_ms:.3f} ms to queue the call; "
              f"spinning {spin} ms", file=sys.stderr)
    return statistics.median(times)


def timing(kernel, plain, library, ops_bytes, flush):
    """ms, plain_ms, library_ms (null without a library call) and the bound
    (bound_ms, bound_by) of one call."""
    ops, nbytes = ops_bytes
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    return {"ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": time_ms(library, flush) if library else None}


def _attended(B, S, Sk, start, pads, window, sinks, causal):
    """keep [B, S, Sk]: key attendable from query, on these inputs."""
    import torch
    st = (start.long().cpu().reshape(-1) if isinstance(start, torch.Tensor)
          else torch.tensor([start])).expand(B)
    qp = (st[:, None] + torch.arange(S))[:, :, None]
    kp = torch.arange(Sk)[None, None, :]
    pad = torch.zeros(B, dtype=torch.long) if pads is None \
        else pads.long().cpu()
    keep = kp >= pad[:, None, None]
    if causal:
        keep = keep & (kp <= qp)
    if window is not None:
        w = kp > qp - window
        if sinks:
            w = w | (kp < (pad + sinks)[:, None, None])
        keep = keep & w
    return keep


def work(B, S, Hq, Hkv, D, Sk, start, pads, window, sinks, causal,
         act_bytes, kv_bytes, int8, lse):
    """(operations, bytes) the call needs on these inputs: 4·D operations
    per attended (query, key) pair and head; each input read once (the
    cache only where some query of the row attends), each output written
    once."""
    keep = _attended(B, S, Sk, start, pads, window, sinks, causal)
    pairs = int(keep.sum()) * Hq
    keys = int(keep.any(dim=1).sum()) * Hkv          # (row, kv head, key)
    nbytes = (2 * B * S * Hq * D * act_bytes          # q in, out
              + 2 * keys * D * kv_bytes                # live K and V
              + (2 * keys * 4 if int8 else 0)          # their scales
              + (B * Hq * S * 4 if lse else 0))
    return 4 * D * pairs, nbytes


# (B, S, start, pads, window, sinks) of flash_decode's split schedule, D 128,
# Hq 32 / Hkv 8, ML 2048: a live range shorter than one share, start 0, a
# pad floor past the first share, a window band and its sinks in different
# shares, per-row starts more than ML / 2 apart, B=1 (the most splits a
# row), S=16 at group 4 (64 rows a unit); each with a bf16 or f32 cache of
# the act dtype and with an int8 cache
DECODE_SPLIT_CASES = (
    (4, 1, [40, 1900, 700, 5], [0, 0, 650, 0], None, 0),
    (2, 1, 0, None, None, 0),
    (2, 1, [1500, 900], [700, 300], None, 0),
    (2, 1, [1800, 1200], [0, 130], 256, 4),
    (2, 5, [1900, 60], [4, 0], None, 0),
    (1, 1, 1500, None, None, 0),
    (2, 16, [1200, 333], [3, 0], 300, 2))
# an engine decode step: 4 slots at their own lengths and pads
DECODE_STARTS, DECODE_PADS = [540, 300, 610, 420], [12, 0, 100, 56]


def device_times(torch, tfa, deferred, dev):
    """device_ms of the rows under 0.1 ms (the kernels' own time; the
    decode's merge launch included), the bound share from it and, where
    the row has one, the library call's own device time, each with the
    way device_ms took it (``device_ms_by``); fails when the kernel's
    wrapper launched nothing while it was timed. Measured after
    every end-to-end phase: a torch.profiler session leaves CUPTI's
    callbacks behind, and every later launch then costs the host more
    (5.8-8.0 µs a launch before one session, 9.6-10.2 after, on the H100
    machine), which would slow the host-bound serving phase."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for r, kernel, library, names in deferred:
        before = sum(tfa.LAUNCHES.values())
        r["device_ms"], r["device_ms_by"] = device_ms(kernel, flush, names)
        check(sum(tfa.LAUNCHES.values()) > before,
              f"device time of {names}: the wrapper launched no kernel")
        r["bound_share"] = r["bound_ms"] / r["device_ms"]
        if library:
            r["library_device_ms"], r["library_device_ms_by"] = device_ms(
                library, flush)
        print(f"device time ({names[0]}, bound {r['bound_ms']:.5f} ms): "
              f"{r['device_ms']:.5f} ms by {r['device_ms_by']}, library "
              f"{r.get('library_device_ms')}")
    del flush


def work_bwd(kernel, B, S, Hq, Hkv, D, causal, window, act_bytes):
    """(operations, bytes) one backward kernel needs on these inputs: per
    attended (query, key) pair and q-head, 6·D operations for dQ (S, dP,
    dS·K) and 8·D for dK/dV (S, dP, Pᵀ·dO, dSᵀ·Q); q, k, v, dO, lse and Δ
    read once, its outputs written once."""
    pairs = int(_attended(B, S, S, 0, None, window, 0, causal).sum()) * Hq
    q_side, kv_side = B * S * Hq * D * act_bytes, B * S * Hkv * D * act_bytes
    reads = 2 * q_side + 2 * kv_side + 2 * B * Hq * S * 4
    if kernel == "flash_bwd_dq":
        return 6 * D * pairs, reads + q_side
    return 8 * D * pairs, reads + 2 * kv_side


# (B, S, Hq, Hkv, causal, window, lse cotangent), D = 128
BWD_CASES = ((2, 512, 32, 8, True, None, False),
             (1, 2048, 16, 8, True, None, False),
             (1, 4096, 32, 8, True, None, False),
             (2, 512, 16, 16, False, None, False),
             (1, 4096, 32, 8, True, 1024, False),
             (2, 512, 32, 8, True, None, True))
TRAIN_SHAPE = (8, 2048, 16, 8)     # llama-1b attention: B, S, Hq, Hkv


def phase_bwd_kernels(torch, tfa, dev):
    """Both backward kernels against attention_bwd_plain, then each timed
    at the training shape. Returns the kernels line's entries."""
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(SEED + 3)
    D = 128

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def err(a, b):
        e = (a.float() - b.float()).abs().max().item()
        return e, e / b.float().abs().max().item()

    worst = {"flash_bwd_dq": (0.0, 0.0), "flash_bwd_dkv": (0.0, 0.0)}
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for B, S, Hq, Hkv, causal, window, cot in BWD_CASES:
            q, dout = rnd(B, S, Hq, D, dtype=dtype), rnd(B, S, Hq, D,
                                                         dtype=dtype)
            k, v = rnd(B, S, Hkv, D, dtype=dtype), rnd(B, S, Hkv, D,
                                                        dtype=dtype)
            g_lse = rnd(B, Hq, S, dtype=torch.float32) if cot else None
            kw = dict(causal=causal, window=window)
            out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
            got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, g_lse,
                                          **kw)
            want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse,
                                           **kw)
            es = [err(a, b) for a, b in zip(got, want)]
            print(f"flash_bwd {dtype} B={B} S={S} Hq={Hq} Hkv={Hkv} "
                  f"causal={causal} window={window} lse_cotangent={cot}: "
                  + ", ".join(f"{n} max|err| {e:.3g} rel {r:.3g}"
                              for n, (e, r) in zip(("dq", "dk", "dv"), es))
                  + f" (tol {tol}, relative)")
            check(all(r <= tol for _, r in es),
                  "a backward kernel disagrees with attention_bwd_plain")
            check(all(a.dtype == dtype for a in got), "gradient dtypes")
            if dtype == torch.bfloat16:
                for name, part in (("flash_bwd_dq", es[:1]),
                                   ("flash_bwd_dkv", es[1:])):
                    worst[name] = tuple(max(x) for x in zip(worst[name],
                                                            *part))
            del q, k, v, dout, out, lse, got, want
    torch.cuda.synchronize()

    # the training shape, bf16: one llama-1b layer's attention, checked
    # against the plain versions, then timed
    bf, (B, S, Hq, Hkv) = torch.bfloat16, TRAIN_SHAPE
    tol = TOL["bfloat16"]
    q, dout = rnd(B, S, Hq, D, dtype=bf), rnd(B, S, Hq, D, dtype=bf)
    k, v = rnd(B, S, Hkv, D, dtype=bf), rnd(B, S, Hkv, D, dtype=bf)
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    ref, rlse = tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                    0)
    (fwd_err, fwd_rel), (lse_err, _) = err(out, ref), err(lse, rlse)
    del ref, rlse
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout)
    es = [err(a, b) for a, b in zip(got, want)]
    del got, want
    print(f"training shape bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} causal: "
          f"flash_fwd max|out-plain| {fwd_err:.3g} rel {fwd_rel:.3g}, "
          f"|lse-plain| {lse_err:.3g} (tol 1e-4); "
          + ", ".join(f"{n} max|err| {e:.3g} rel {r:.3g}"
                      for n, (e, r) in zip(("dq", "dk", "dv"), es))
          + f" (tol {tol}, relative)")
    check(fwd_rel <= tol and lse_err <= 1e-4,
          "flash_fwd disagrees with plain at the training shape")
    check(all(r <= tol for _, r in es), "a backward kernel disagrees with "
          "attention_bwd_plain at the training shape")
    for name, part in (("flash_bwd_dq", es[:1]), ("flash_bwd_dkv", es[1:])):
        worst[name] = tuple(max(x) for x in zip(worst[name], *part))
    delta = tfa._bwd_delta(out, dout, None).contiguous()
    lib_in = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    lib_dout = dout.transpose(1, 2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # the forward at the training shape (the serving row is phase 2's)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    ops, nbytes = work(B, S, Hq, Hkv, D, S, 0, None, None, 0, True, 2, 2,
                       False, True)
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    fwd_train = {
        "shape": list(TRAIN_SHAPE), "max_abs_err": fwd_err,
        "ms": time_ms(lambda: tfa._launch(
            "flash_fwd", q, kh, vh, 0, causal=True, scale=D ** -0.5,
            want_lse=True), flush),
        "plain_ms": time_ms(lambda: tfa.attention_plain(q, kh, vh, 0), flush),
        "bound_ms": max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *[t.detach() for t in lib_in], is_causal=True, enable_gqa=True),
            flush)}
    fwd_train["bound_share"] = fwd_train["bound_ms"] / fwd_train["ms"]
    print(f"flash_fwd at the training shape: {json.dumps(fwd_train)}")
    plain_ms = time_ms(lambda: tfa.attention_bwd_plain(q, k, v, out, lse,
                                                       dout), flush)
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, lib_dout, retain_graph=True), flush)
    rows = []
    for name, replaces in (("flash_bwd_dq", ":916 (_bwd_dq_kernel)"),
                           ("flash_bwd_dkv", ":979 (_bwd_dkv_kernel)")):
        ops, nbytes = work_bwd(name, B, S, Hq, Hkv, D, True, None, 2)
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "gpu_provisioner_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": "gpu_provisioner_tpu/ops/flash_attention.py"
                        + replaces,
            "launches": 0, "max_abs_err": worst[name][0],
            "max_rel_err": worst[name][1], "tolerance": TOL["bfloat16"],
            "ms": time_ms(lambda: tfa._launch_bwd(
                name, q, k, v, dout, lse, delta, causal=True,
                scale=D ** -0.5), flush),
            "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": library_ms,
            "library_note": "dQ, dK and dV in one call; plain_ms likewise"})
        rows[-1]["bound_share"] = rows[-1]["bound_ms"] / rows[-1]["ms"]
        if name == "flash_bwd_dkv":
            rows[-1]["blocks"] = tfa._cuda.bwd_dkv_blocks(B, Hkv, S, 1)
        print(f"{name}: {json.dumps(rows[-1])}")
    del flush, lib_out, lib_in
    return fwd_train, rows


def phase_train_exact(torch, tl, tt, dev, cfg=None, what="llama-1b width"):
    """Llama-1B width (or ``cfg``'s, named ``what``), 2 layers, f32: a
    flash train step == a dense one."""
    cfg = dataclasses.replace(cfg or tl.PRESETS["llama-1b"], n_layers=2,
                              dtype="float32", remat=False)
    g = torch.Generator().manual_seed(SEED + 4)
    batches = [torch.randint(0, cfg.vocab_size, (2, 513), generator=g)
               .to(dev) for _ in range(2)]
    losses, grads = {}, {}
    for impl in ("flash", "dense"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        params, opt = tt.make_train_state(
            c, torch.Generator(dev).manual_seed(SEED), dev)
        step = tt.make_train_step(c, opt)
        first = step(params, batches[0][:, :-1], batches[0][:, 1:]).item()
        grads[impl] = [p.grad.clone() for p in tt.param_leaves(params)]
        second = step(params, batches[1][:, :-1], batches[1][:, 1:]).item()
        losses[impl] = (first, second)
        del params, opt, step
    for i, which in enumerate(("loss", "second-step loss")):
        a, b = losses["flash"][i], losses["dense"][i]
        print(f"exact training ({what}, 2 layers, f32) {which}: "
              f"flash {a!r} dense {b!r} rel {abs(a - b) / abs(b):.3g}")
        check(abs(a - b) <= 1e-5 * abs(b), f"{what} {which}: flash != dense")
    worst = max((a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(grads["flash"], grads["dense"]))
    print(f"exact training ({what}): worst gradient leaf max|flash - "
          f"dense| / max|dense| = {worst:.3g} (tol 1e-4)")
    check(worst <= 1e-4, f"{what}: flash gradients != dense gradients")


def phase_train(torch, tl, tt, tfa, dev):
    """Full Llama-1B: bf16 activations, f32 masters, remat, B=8, S=2048."""
    cfg = dataclasses.replace(tl.PRESETS["llama-1b"], attn_impl="flash",
                              remat=True)
    (B, S, _, _), steps = TRAIN_SHAPE, 5
    params, opt = tt.make_train_state(
        cfg, torch.Generator(dev).manual_seed(SEED), dev)
    step = tt.make_train_step(cfg, opt)
    g = torch.Generator().manual_seed(SEED + 5)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g).to(dev)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    warm = step(params, inp, tgt).item()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(params, inp, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = dict(tfa.LAUNCHES)
    ms = statistics.median(times)
    print(f"train llama-1b bf16 (f32 masters, remat, flash) B={B} S={S}: "
          f"warm-up loss {warm!r}, losses {losses}; step ms {times}, median "
          f"{ms!r} = {B * S / ms * 1e3!r} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches over {steps} steps {launches}")
    check(all(x == x and abs(x) < float("inf") for x in [warm] + losses),
          "a training loss is not finite")
    check(losses[-1] < losses[0] < warm, f"loss did not fall: {losses}")
    L = cfg.n_layers
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps}
    for name, n in want.items():
        check(launches[name] == n,
              f"{name}: {launches[name]} launches on the training path, "
              f"expected {n}")
    return launches, ms


# (B, S, Hq, Hkv, lse cotangent) of the tri kernels against plain, D = 128:
# W < P (S 128; S 1000 at Hq 1, every row of more than one tile cut), an lse
# cotangent, ragged S at GQA groups 4 and 1, then the larger shapes
TRI_CASES = ((1, 128, 1, 1, False), (1, 384, 2, 1, True),
             (1, 1000, 1, 1, False), (1, 1000, 4, 1, False),
             (2, 200, 8, 8, True), (2, 2048, 16, 8, False),
             (1, 8192, 16, 8, False))
# (S, Hq, Hkv) at B=1, bf16: triangle against rectangle, past the plain
# versions' reach; the last is the main path of the launch counts
LONG_SHAPES = ((16384, 8, 4), (16384, 32, 8), (32768, 8, 4), (32768, 32, 8))
LONG_TOL = 2e-2
TRI_TIMED = (1, 32768, 8, 4)       # bench_flash_op's streaming shape
# tri kernel, TPU kernel it replaces, its rectangular counterpart, D·ops
TRI_KERNELS = (("flash_fwd_tri", ":308 (_kernel_tri)", "flash_fwd", 4),
               ("flash_bwd_dq_tri", ":943 (_bwd_dq_kernel_tri)",
                "flash_bwd_dq", 6),
               ("flash_bwd_dkv_tri", ":1020 (_bwd_dkv_kernel_tri)",
                "flash_bwd_dkv", 8))


def work_tri(kernel, B, S, Hq, Hkv, D, ws_bytes, act_bytes=2):
    """(operations, bytes) of one tri kernel on causal inputs: 4, 6 or 8·D
    operations per attended pair and q-head; q, k, v (and dO, lse, Δ for
    the backward) read once, the outputs written once, and the workspace
    partials written once and read once by the fixup."""
    pairs = B * S * (S + 1) // 2 * Hq
    q_side, kv_side = B * S * Hq * D * act_bytes, B * S * Hkv * D * act_bytes
    rows = B * Hq * S * 4
    per_d = next(n for name, _, _, n in TRI_KERNELS if name == kernel)
    if kernel == "flash_fwd_tri":
        nbytes = 2 * q_side + 2 * kv_side + rows
    else:
        nbytes = 2 * q_side + 2 * kv_side + 2 * rows + (
            q_side if kernel == "flash_bwd_dq_tri" else 2 * kv_side)
    return per_d * D * pairs, nbytes + ws_bytes


def tri_ws_bytes(_cuda, kernel, dev, D=128):
    """(workspace bytes written and read back, P): the two slots of each
    of the P CTAs of the bf16 entry at head dim D, as the wrapper
    allocates them (flash_tri_ws_floats), counted once written and once
    read."""
    P = _cuda.tri_ctas(kernel, 1, D, dev.index)
    return 2 * P * _cuda.tri_ws_floats(kernel, 1, D) * 4, P


def phase_tri_kernels(torch, tfa, dev):
    """The three flattened-triangle kernels, called directly (below the
    forward's streaming gate), against attention_plain and
    attention_bwd_plain. Returns the worst bf16 errors by kernel."""
    g = torch.Generator(dev).manual_seed(SEED + 6)
    D = 128

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def rel(a, b):
        e = (a.float() - b.float()).abs().max().item()
        return e, e / b.float().abs().max().item()

    worst = {name: (0.0, 0.0) for name, *_ in TRI_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for B, S, Hq, Hkv, cot in TRI_CASES:
            q, dout = rnd(B, S, Hq, D, dtype=dtype), rnd(B, S, Hq, D,
                                                         dtype=dtype)
            k, v = rnd(B, S, Hkv, D, dtype=dtype), rnd(B, S, Hkv, D,
                                                        dtype=dtype)
            g_lse = rnd(B, Hq, S, dtype=torch.float32) if cot else None
            scale = D ** -0.5
            out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=scale)
            ref, rlse = tfa.attention_plain(q, k.transpose(1, 2),
                                            v.transpose(1, 2), 0)
            (e_out, _), (e_lse, _) = rel(out, ref), rel(lse, rlse)
            del ref, rlse
            delta = tfa._bwd_delta(out, dout, g_lse).contiguous()
            kw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
            dq = tfa._launch_tri("flash_bwd_dq_tri", q, k, v, **kw)
            dk, dv = tfa._launch_tri("flash_bwd_dkv_tri", q, k, v, **kw)
            want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse)
            es = [rel(a, b) for a, b in zip((dq, dk, dv), want)]
            print(f"tri kernels {dtype} B={B} S={S} Hq={Hq} Hkv={Hkv} "
                  f"lse_cotangent={cot}: flash_fwd_tri max|out-plain| "
                  f"{e_out:.3g} |lse-plain| {e_lse:.3g}; "
                  + ", ".join(f"{n} max|err| {e:.3g} rel {r:.3g}"
                              for n, (e, r) in zip(("dq", "dk", "dv"), es))
                  + f" (tol {tol}; backward relative)")
            check(e_out <= tol and e_lse <= 1e-4,
                  "flash_fwd_tri disagrees with attention_plain")
            check(all(r <= tol for _, r in es),
                  "a tri backward kernel disagrees with attention_bwd_plain")
            check(all(a.dtype == dtype for a in (out, dq, dk, dv)),
                  "tri output dtypes")
            if dtype == torch.bfloat16:
                for name, part in (("flash_fwd_tri", [(e_out, 0.0)]),
                                   ("flash_bwd_dq_tri", es[:1]),
                                   ("flash_bwd_dkv_tri", es[1:])):
                    worst[name] = tuple(max(x) for x in zip(worst[name],
                                                            *part))
            del q, k, v, dout, out, lse, dq, dk, dv, want, delta
    torch.cuda.synchronize()
    return worst


# (B, S, Hq, Hkv, window) of the bench twins' attention, D = 128, bf16:
# bench_long_context's layers at S=8192 and its sliding-window model at
# S=32768, then bench_flash_op's op
TWIN_CASES = ((1, 8192, 8, 4, None), (1, 32768, 8, 4, 1024),
              (8, 4096, 16, 8, None))
TWIN_CHUNK = 1024


def plain_windowed(torch, tfa, q, k, v, dout, window):
    """The plain version of windowed causal self-attention and its
    gradients where the S² scores do not fit: attention_plain over chunks
    of TWIN_CHUNK queries at q0, each against keys [q0 - window + 1, q0 +
    TWIN_CHUNK) at start offset q0 - (its first key), in f32 from the
    inputs' values, and autograd's gradients of sum(out · dout) through it.
    Returns (out, lse, dq, dk, dv)."""
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    qf, kf, vf = leaves
    outs, lses = [], []
    for q0 in range(0, q.shape[1], TWIN_CHUNK):
        ks, ke = max(0, q0 - window + 1), q0 + TWIN_CHUNK
        o, lse = tfa.attention_plain(
            qf[:, q0:ke], kf[:, ks:ke].transpose(1, 2),
            vf[:, ks:ke].transpose(1, 2), q0 - ks, window=window)
        outs.append(o)
        lses.append(lse)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 2)
    grads = torch.autograd.grad(out, leaves, dout.float())
    return (out.detach(), lse.detach()) + grads


def plain_causal(torch, tfa, q, k, v, dout):
    """attention_plain, then attention_bwd_plain on its out and lse, one
    batch element at a time (its S² f32 tensors alone on the card).
    Returns (out, lse, dq, dk, dv)."""
    parts = []
    for b in range(q.shape[0]):
        qb, kb, vb, gb = (t[b:b + 1] for t in (q, k, v, dout))
        o, lse = tfa.attention_plain(qb, kb.transpose(1, 2),
                                     vb.transpose(1, 2), 0)
        parts.append((o, lse) + tfa.attention_bwd_plain(qb, kb, vb, o, lse,
                                                        gb))
    return tuple(torch.cat(x) for x in zip(*parts))


def phase_twin_shapes(torch, tfa, dev):
    """flash_attention_with_lse and its gradients at the bench twins'
    shapes (TWIN_CASES) against the plain versions, with the launches of
    each forward and backward (exactly one of each rectangular kernel).
    Returns the worst bf16 errors by kernel: (absolute, relative to the
    largest plain value)."""
    g = torch.Generator(dev).manual_seed(SEED + 8)
    D, bf, tol = 128, torch.bfloat16, TOL["bfloat16"]
    worst = {"flash_fwd": (0.0, 0.0), "flash_bwd_dq": (0.0, 0.0),
             "flash_bwd_dkv": (0.0, 0.0)}
    for B, S, Hq, Hkv, window in TWIN_CASES:
        leaves = [torch.randn(B, S, h, D, generator=g, device=dev).to(bf)
                  .requires_grad_() for h in (Hq, Hkv, Hkv)]
        dout = torch.randn(B, S, Hq, D, generator=g, device=dev).to(bf)
        torch.cuda.synchronize()
        tfa.reset_launches()
        out, lse = tfa.flash_attention_with_lse(*leaves, window=window)
        got = (out, lse) + torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
        launches = {n: c for n, c in tfa.LAUNCHES.items() if c}
        q, k, v = (t.detach() for t in leaves)
        want = (plain_windowed(torch, tfa, q, k, v, dout, window) if window
                else plain_causal(torch, tfa, q, k, v, dout))
        es = [((a.float() - b.float()).abs().max().item(),
               ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item())
              for a, b in zip(got, want)]
        print(f"bench twin shape bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} "
              f"window={window}: max|out-plain| {es[0][0]:.3g} "
              f"|lse-plain| {es[1][0]:.3g}; "
              + ", ".join(f"{n} max|err| {e:.3g} rel {r:.3g}"
                          for n, (e, r) in zip(("dq", "dk", "dv"), es[2:]))
              + f" (tol {tol}; backward relative); launches {launches}")
        check(es[0][0] <= tol and es[1][0] <= 1e-4
              and all(r <= tol for _, r in es[2:]),
              f"flash attention disagrees with plain at B={B} S={S} "
              f"Hq={Hq} window={window}")
        check(launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1},
              f"launches at B={B} S={S} window={window}: {launches}")
        for name, part in (("flash_fwd", es[:1]), ("flash_bwd_dq", es[2:3]),
                           ("flash_bwd_dkv", es[3:])):
            worst[name] = tuple(max(x) for x in zip(worst[name], *part))
        del leaves, dout, out, lse, got, want, q, k, v
        torch.cuda.empty_cache()
    return worst


def twin_launches(bench):
    """The launches each bench twin makes at full size, from its
    repetition counts: bench_long_context trains two 4-layer models with
    remat (two forwards a layer) for WARM_STEPS + TIMED_STEPS steps each,
    windowed in the second (no triangle); bench_flash_op makes one warm
    call and ROUNDS rounds of OP_CALLS calls of the forward and of the
    forward and backward, then one warm call and ROUNDS calls of the
    streaming forward, rectangular and triangular."""
    L = bench.long_context_config(8192).n_layers
    steps = 2 * (bench.WARM_STEPS + bench.TIMED_STEPS)
    calls, streaming = 1 + bench.ROUNDS * bench.OP_CALLS, 1 + bench.ROUNDS
    return ({"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
             "flash_bwd_dkv": L * steps},
            {"flash_fwd": 2 * calls + streaming, "flash_bwd_dq": calls,
             "flash_bwd_dkv": calls, "flash_fwd_tri": streaming})


def phase_long(torch, tfa, _cuda, bench, dev, worst):
    """flash_attention(triangular=True) against the rectangular kernels at
    full width, the launch counts of the 32k, Hq 32 forward and backward,
    the tri kernels' times, and the bench twins. Returns (kernels line
    entries, launches on the long path)."""
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(SEED + 7)
    D, bf = 128, torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def fwd_bwd(leaves, dout, triangular):
        out, lse = tfa.flash_attention_with_lse(*leaves,
                                                triangular=triangular)
        grads = torch.autograd.grad(out, leaves, dout)
        return (out, lse) + grads

    launches = None
    for S, Hq, Hkv in LONG_SHAPES:
        leaves = [rnd(1, S, h, D).requires_grad_() for h in (Hq, Hkv, Hkv)]
        dout = rnd(1, S, Hq, D)
        want = fwd_bwd(leaves, dout, False)
        main = (S, Hq, Hkv) == LONG_SHAPES[-1]
        if main:
            torch.cuda.synchronize()
            tfa.reset_launches()
        got = fwd_bwd(leaves, dout, True)
        if main:
            torch.cuda.synchronize()
            launches = dict(tfa.LAUNCHES)
        errs = [(a.float() - b.float()).abs().max().item()
                / (1.0 if i < 2 else b.float().abs().max().item())
                for i, (a, b) in enumerate(zip(got, want))]
        print(f"triangle vs rectangle bf16 B=1 S={S} Hq={Hq} Hkv={Hkv}: "
              + ", ".join(f"{n} {e:.3g}" for n, e in zip(
                  ("max|out| ", "max|lse|", "dq rel", "dk rel", "dv rel"),
                  errs))
              + f" (tol {LONG_TOL})")
        check(all(e <= LONG_TOL for e in errs) and all(
            bool(torch.isfinite(t).all()) for t in got),
            f"triangular=True disagrees with the rectangular kernels at "
            f"S={S}, Hq={Hq}")
        del leaves, dout, want, got
    print(f"long-path launches (B=1, S={LONG_SHAPES[-1][0]}, Hq "
          f"{LONG_SHAPES[-1][1]}, triangular=True, forward and backward): "
          f"{launches}")
    for name, n in launches.items():
        want_n = 1 if name.endswith("_tri") else 0
        check(n == want_n, f"{name}: {n} launches on the long path, "
              f"expected {want_n}")

    # times at the streaming shape, bf16, beside the rectangular kernels
    B, S, Hq, Hkv = TRI_TIMED
    q, dout = rnd(B, S, Hq, D), rnd(B, S, Hq, D)
    k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    scale = D ** -0.5
    out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=scale)
    delta = tfa._bwd_delta(out, dout, None).contiguous()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kw = dict(flush=flush, reps=5, warm=1)
    bkw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
    tri_fns = {
        "flash_fwd_tri": lambda: tfa._launch_tri("flash_fwd_tri", q, k, v,
                                                 scale=scale),
        "flash_bwd_dq_tri": lambda: tfa._launch_tri("flash_bwd_dq_tri", q,
                                                    k, v, **bkw),
        "flash_bwd_dkv_tri": lambda: tfa._launch_tri("flash_bwd_dkv_tri", q,
                                                     k, v, **bkw)}
    rect_fns = {
        "flash_fwd": lambda: tfa._launch(
            "flash_fwd", q, k.transpose(1, 2), v.transpose(1, 2), 0,
            causal=True, scale=scale, want_lse=True),
        "flash_bwd_dq": lambda: tfa._launch_bwd(
            "flash_bwd_dq", q, k, v, dout, lse, delta, causal=True,
            scale=scale),
        "flash_bwd_dkv": lambda: tfa._launch_bwd(
            "flash_bwd_dkv", q, k, v, dout, lse, delta, causal=True,
            scale=scale)}
    lib_in = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *[t.detach() for t in lib_in], is_causal=True, enable_gqa=True), **kw)
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, dout.transpose(1, 2), retain_graph=True), **kw)
    del lib_out, lib_in

    # the tri kernels against their rectangular counterparts at the
    # training shape (ROADMAP's merge condition), bf16
    Bt, St, Hqt, Hkvt = TRAIN_SHAPE
    qt, doutt = rnd(Bt, St, Hqt, D), rnd(Bt, St, Hqt, D)
    kt, vt = rnd(Bt, St, Hkvt, D), rnd(Bt, St, Hkvt, D)
    out_t, lse_t = tfa._launch_tri("flash_fwd_tri", qt, kt, vt, scale=scale)
    delta_t = tfa._bwd_delta(out_t, doutt, None).contiguous()
    train_fns = {
        "flash_fwd_tri": (
            lambda: tfa._launch_tri("flash_fwd_tri", qt, kt, vt, scale=scale),
            lambda: tfa._launch("flash_fwd", qt, kt.transpose(1, 2),
                                vt.transpose(1, 2), 0, causal=True,
                                scale=scale, want_lse=True)),
        "flash_bwd_dq_tri": (
            lambda: tfa._launch_tri("flash_bwd_dq_tri", qt, kt, vt,
                                    scale=scale, dout=doutt, lse=lse_t,
                                    delta=delta_t),
            lambda: tfa._launch_bwd("flash_bwd_dq", qt, kt, vt, doutt, lse_t,
                                    delta_t, causal=True, scale=scale)),
        "flash_bwd_dkv_tri": (
            lambda: tfa._launch_tri("flash_bwd_dkv_tri", qt, kt, vt,
                                    scale=scale, dout=doutt, lse=lse_t,
                                    delta=delta_t),
            lambda: tfa._launch_bwd("flash_bwd_dkv", qt, kt, vt, doutt,
                                    lse_t, delta_t, causal=True,
                                    scale=scale))}
    at_train = {}
    for name, (tri_fn, rect_fn) in train_fns.items():
        tri_ms, rect_ms = time_ms(tri_fn, **kw), time_ms(rect_fn, **kw)
        at_train[name] = {"shape": list(TRAIN_SHAPE), "ms": tri_ms,
                          "rect_ms": rect_ms, "tri_over_rect": tri_ms / rect_ms}
        print(f"{name} at the training shape B={Bt} S={St} Hq={Hqt} "
              f"Hkv={Hkvt} bf16: {tri_ms:.4f} ms, rectangular "
              f"{rect_ms:.4f} ms, tri/rect {tri_ms / rect_ms:.4f}")
    del qt, doutt, kt, vt, out_t, lse_t, delta_t

    # the plain versions at the largest shape whose S² scores fit
    Bp, Sp, Hqp, Hkvp = TRI_CASES[-1][:4]
    qp, doutp = rnd(Bp, Sp, Hqp, D), rnd(Bp, Sp, Hqp, D)
    kp, vp = rnd(Bp, Sp, Hkvp, D), rnd(Bp, Sp, Hkvp, D)
    outp, lsep = tfa.attention_plain(qp, kp.transpose(1, 2),
                                     vp.transpose(1, 2), 0)
    plain_fwd_ms = time_ms(lambda: tfa.attention_plain(
        qp, kp.transpose(1, 2), vp.transpose(1, 2), 0), **kw)
    plain_bwd_ms = time_ms(lambda: tfa.attention_bwd_plain(
        qp, kp, vp, outp, lsep, doutp), **kw)
    del qp, doutp, kp, vp, outp, lsep

    rows = []
    for name, replaces, rect, _ in TRI_KERNELS:
        ws, P = tri_ws_bytes(_cuda, name, dev)
        ops, nbytes = work_tri(name, B, S, Hq, Hkv, D, ws)
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
        fwd = name == "flash_fwd_tri"
        ms = time_ms(tri_fns[name], **kw)
        rows.append({
            "name": name, "route": "cuda",
            "source": "gpu_provisioner_tpu_torch/ops/csrc/flash_tri.cu",
            "replaces": "gpu_provisioner_tpu/ops/flash_attention.py"
                        + replaces,
            "launches": 0, "max_abs_err": worst[name][0],
            "max_rel_err": worst[name][1], "tolerance": TOL["bfloat16"],
            "ms": ms,
            "rect_ms": time_ms(rect_fns[rect], **kw),
            "plain_ms": plain_fwd_ms if fwd else plain_bwd_ms,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib_fwd_ms if fwd else lib_bwd_ms,
            "bound_share": max(t_b, t_o) / ms,
            "ctas": P,
            **({"at_train_shape": at_train[name]} if name in at_train
               else {}),
            "shape": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal",
            "plain_note": f"plain_ms at B={Bp} S={Sp} Hq={Hqp} Hkv={Hkvp} "
                          "(the S² scores at S=32768 do not fit)"
                          + ("" if fwd else "; dQ+dK+dV, as library_ms")})
        print(f"{name}: {json.dumps(rows[-1])}")
    del flush, q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()

    want_lc, want_fo = twin_launches(bench)
    by_twin = {}
    for name, run, want in (("long_context", bench.bench_long_context,
                             want_lc),
                            ("flash_op", bench.bench_flash_op, want_fo)):
        torch.cuda.synchronize()
        tfa.reset_launches()
        t0 = time.perf_counter()
        res = run(False)
        torch.cuda.synchronize()
        by_twin[name] = dict(tfa.LAUNCHES)
        got = {n: c for n, c in tfa.LAUNCHES.items() if c}
        print(f"bench_{name} (full size, {time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(res)}; launches {got}")
        check(got == want, f"bench_{name} launches {got}, expected {want}")
        if name == "long_context":
            check(all(x == x and abs(x) < float("inf")
                      for x in res["losses"] + res["swa_losses"]),
                  "a long-context training loss is not finite")
        else:
            check(all(v > 0 and v < float("inf") for v in res.values()),
                  f"bench_flash_op: {res}")
        torch.cuda.empty_cache()
    return rows, launches, by_twin


MOE_KERNEL_ROWS = ("flash_cached", "flash_cached_int8", "flash_decode",
                   "flash_decode_int8")


def phase_moe_kernels(torch, tfa, td, dev, deferred):
    """#4 and #5 at the MoE path's attention shapes (mixtral-ish: Hq 16,
    Hkv 8, D 128) against their plain versions, in bf16 and f32, on a plain
    and an int8 cache: an engine admission (a 500-token prompt in the
    512 bucket, ML 2048), generate's ragged prefill (B=2, S0=512, pads 0
    and 200, ML 1024) and an engine decode step (4 slots, ML 2048); then
    the bf16 admission and decode step timed (their device times joining
    ``deferred``). Returns ({row: at_moe_shape entry}, {row: worst bf16
    error})."""
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(SEED + 4)
    Hq, Hkv, D = 16, 8, 128
    bf = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    errs = dict.fromkeys(MOE_KERNEL_ROWS, 0.0)
    entries = {}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def case(name, dtype, B, S, start, pads, ML, timed):
        q = rnd(B, S, Hq, D, dtype=dtype)
        kc, vc = rnd(B, Hkv, ML, D, dtype=dtype), rnd(B, Hkv, ML, D,
                                                     dtype=dtype)
        pl = torch.tensor(pads, dtype=torch.int32, device=dev)
        st = (torch.tensor(start, dtype=torch.int32, device=dev)
              if isinstance(start, list) else start)
        fn = getattr(tfa, "flash_attention_" + name.split("_")[1])
        kp = torch.arange(ML, device=dev)
        qp = torch.as_tensor(st, device=dev).reshape(-1, 1) \
            + torch.arange(S, device=dev)                          # [B|1, S]
        mask = ((kp <= qp[..., None]) & (kp >= pl[:, None, None]))[:, None]
        for int8 in (False, True):
            kw = {"pad_lens": pl}
            k_, v_ = kc, vc
            if int8:
                (k_, kw["k_scale"]), (v_, kw["v_scale"]) = \
                    td._quantize_kv(kc), td._quantize_kv(vc)
            row = name + ("_int8" if int8 else "")
            e = (fn(q, k_, v_, st, **kw).float()
                 - tfa.attention_plain(q, k_, v_, st, **kw)[0].float()
                 ).abs().max().item()
            tol = TOL[str(dtype).split(".")[1]]
            print(f"{row} {dtype} at the MoE shape B={B} S={S} "
                  f"start={start} pads={pads} ML={ML}: max|out-plain| "
                  f"{e:.3g} (tol {tol})")
            check(e <= tol, f"{row} disagrees with plain at the MoE shape")
            if dtype != bf:
                continue
            errs[row] = max(errs[row], e)
            if not timed:
                continue
            library = None if int8 else (
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kc, vc, attn_mask=mask,
                    enable_gqa=True))
            kernel = (lambda k_=k_, v_=v_, kw=kw:
                      fn(q, k_, v_, st, **kw))
            entries[row] = {
                "shape": f"B={B} S={S} start={start} pads={pads} Hq={Hq} "
                         f"Hkv={Hkv} ML={ML}",
                **timing(kernel,
                         lambda k_=k_, v_=v_, kw=kw:
                         tfa.attention_plain(q, k_, v_, st, **kw),
                         library,
                         work(B, S, Hq, Hkv, D, ML, st, pl, None, 0, True, 2,
                              1 if int8 else 2, int8, False), flush)}
            if library is None:
                entries[row]["library_note"] = "no single PyTorch call " \
                                               "attends over an int8 cache"
            deferred.append((entries[row], kernel, library,
                             ("flash_fwd_tc_kernel",) if S > 16
                             else ("flash_decode",)))

    for dtype in (bf, torch.float32):
        case("flash_cached", dtype, 1, 512, 0, [12], 2048, True)
        case("flash_cached", dtype, 2, 512, 0, [0, 200], 1024, False)
        case("flash_decode", dtype, 4, 1, DECODE_STARTS, DECODE_PADS, 2048,
             True)
    torch.cuda.synchronize()
    for row, entry in entries.items():
        print(f"{row} at the MoE shape: {json.dumps(entry)}")
    del flush
    return entries, errs


def phase_moe_exact(torch, tm, tms, td, te, dev):
    """mixtral-ish width, 2 layers, f32, the flash kernels in their f32
    instances: route on the card == route on the CPU; moe_cached_forward
    flash == dense; greedy generate flash == dense; ServeEngine streams ==
    generate on the bucket-padded prompt; a dropless 4-token block == four
    single-token steps."""
    cfg = dataclasses.replace(tm.PRESETS_MOE["mixtral-ish"], n_layers=2,
                              dtype="float32", attn_impl="flash")
    dense = dataclasses.replace(cfg, attn_impl="dense")
    V, k = cfg.vocab_size, cfg.experts_per_token
    g = torch.Generator().manual_seed(SEED + 3)
    S = 512
    cap = tm.capacity(cfg, S)
    rand = torch.randn(2, S, cfg.n_experts, generator=g)
    ties = torch.zeros(2, S, cfg.n_experts)     # all equal: experts 0, 1
    ties[:, 1::2] = rand[:, 1::2].round()       # integer levels: many ties
    overflow = rand.clone()
    overflow[..., 3] += 3.0                      # expert 3 oversubscribed
    for name, logits in (("random", rand), ("ties", ties),
                         ("overflow", overflow)):
        cpu = tm.route(logits, k, cap)
        card = tm.route(logits.to(dev), k, cap)
        same = torch.equal(card[0].cpu(), cpu[0])
        e = (card[1].cpu() - cpu[1]).abs().max().item()
        placed = int(cpu[0].sum())
        print(f"route {name} (B=2, S={S}, cap {cap}): dispatch "
              f"{'equal' if same else 'DIFFERS'}, max|combine| diff {e:.3g}"
              f", {placed} of {2 * S * k} choices placed")
        check(same and e <= 1e-6, f"route {name}: the card differs")
    check(placed < 2 * S * k, "the overflow case dropped nothing")

    params = tm.init_moe_model(cfg, torch.Generator(dev).manual_seed(SEED),
                               dev)
    prompt = torch.randint(1, V, (2, S), generator=g).to(dev)
    pads = torch.tensor([0, 200], dtype=torch.int32, device=dev)
    real = torch.ones(2, S + 4, dtype=torch.bool, device=dev)
    real[1, :200] = False          # pad queries: the kernels emit zeros
    logits = {}
    for c in (dense, cfg):
        cache = td.init_kv_cache(c, 2, 1024, dev)
        lg, cache = tms.moe_cached_forward(params, prompt, cache, c,
                                           pad_lens=pads)
        out = [lg]
        for i in range(4):
            lg, cache = tms.moe_cached_forward(params, prompt[:, i:i + 1],
                                               cache, c, pad_lens=pads)
            out.append(lg)
        logits[c.attn_impl] = torch.cat(out, dim=1)[real]
    e = (logits["flash"] - logits["dense"]).abs().max().item()
    print(f"moe_cached_forward flash vs dense (prefill B=2 S={S} pads 0/200,"
          f" 4 decode steps): max|logits diff| {e:.3g} (tol 1e-4)")
    check(e <= 1e-4, "moe_cached_forward: flash differs from dense")

    ragged = prompt.clone()
    ragged[1, :200] = 0
    streams = {c.attn_impl: td.generate(params, ragged, c,
                                        max_new_tokens=16, max_len=1024,
                                        pad_id=0)
               for c in (dense, cfg)}
    check(torch.equal(streams["flash"], streams["dense"]),
          f"generate: flash {streams['flash'].tolist()} != dense "
          f"{streams['dense'].tolist()}")

    reqs = [torch.randint(1, V, (n,), generator=g).tolist()
            for n in (100, 230, 60, 150)]
    eng = te.ServeEngine(params, cfg, slots=2, max_len=1024,
                         prefill_buckets=(128, 256))
    ids = [eng.submit(p, 8) for p in reqs]
    out = eng.run()
    for rid, p in zip(ids, reqs):
        b = next(b for b in (128, 256) if len(p) <= b)
        want = td.generate(params, torch.tensor([[0] * (b - len(p)) + p]),
                           cfg, max_new_tokens=8, max_len=1024,
                           pad_id=0)[0].tolist()
        check(out[rid] == want, f"MoE engine stream {rid} != generate on "
              f"the bucket-padded prompt: {out[rid]} vs {want}")

    cache = td.init_kv_cache(cfg, 2, 1024, dev)
    _, cache = tms.moe_cached_forward(params, prompt, cache, cfg,
                                      pad_lens=pads)
    steps = td.KVCache(*(t.clone() if isinstance(t, torch.Tensor) else t
                         for t in cache))
    block = torch.randint(1, V, (2, 4), generator=g).to(dev)
    blk, _ = td.family_fns(cfg, pad_lens=pads, dropless_step=True)[1](
        params, block, cache)
    one = []
    for i in range(4):
        lg, steps = tms.moe_cached_forward(params, block[:, i:i + 1], steps,
                                           cfg, pad_lens=pads)
        one.append(lg)
    e_blk = (blk - torch.cat(one, dim=1)).abs().max().item()
    print(f"dropless 4-token block vs four single steps: max|logits diff| "
          f"{e_blk:.3g} (tol 1e-4)")
    check(e_blk <= 1e-4, "the dropless block differs from single steps")
    print(f"MoE exact phase (mixtral-ish width, 2 layers, f32): route card "
          f"== CPU, flash == dense, generate flash == dense "
          f"{streams['flash'].tolist()}, {len(ids)} engine streams == "
          f"generate on the bucket-padded prompt")
    del params, eng


def phase_moe(torch, tm, td, te, tfa, dev):
    """Full mixtral-ish (16 layers, 8 experts, top-2) in bf16 through
    ServeEngine and generate(), every kernel's launches read across it."""
    cfg = dataclasses.replace(tm.PRESETS_MOE["mixtral-ish"],
                              attn_impl="flash")
    t0 = time.perf_counter()
    params = tm.init_moe_model(cfg, torch.Generator(dev).manual_seed(SEED),
                               dev)
    torch.cuda.synchronize()
    print(f"mixtral-ish params on the card in {time.perf_counter() - t0:.1f}"
          f" s ({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    g = torch.Generator().manual_seed(SEED + 5)
    V, new = cfg.vocab_size, 32

    def toks(n):
        return torch.randint(1, V, (n,), generator=g).tolist()

    reqs = [toks(n) for n in (180, 500, 120, 350, 100, 230)]

    def serve():
        eng = te.ServeEngine(params, cfg, slots=4, max_len=2048,
                             prefill_buckets=(128, 256, 512),
                             return_logprobs=True)
        t0 = time.perf_counter()
        ids = [eng.submit(p, new) for p in reqs]
        out = eng.run()
        torch.cuda.synchronize()
        return eng, ids, out, time.perf_counter() - t0

    eng = serve()[0]         # a warm-up pass before the counts are reset
    try:
        eng.submit(reqs[0], 4, prefix=reqs[1][:100])
    except ValueError as err:
        check("dense family" in str(err), f"prefix refusal: {err}")
    else:
        check(False, "an MoE engine took a shared prefix")
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    rates = []
    for _ in range(3):
        eng, ids, out, wall = serve()
        for rid in ids:
            check(len(out[rid]) == new and all(0 <= t < V for t in out[rid]),
                  f"MoE request {rid}: {out[rid]}")
            lps = eng.finished_logprobs[rid]
            check(all(lp <= 0 and lp == lp for lp in lps),
                  f"MoE request {rid} logprobs {lps}")
        rates.append(eng.stats()["tokens_emitted"] / wall)
    print(f"ServeEngine mixtral-ish bf16, smoke-run rate (3 passes after a "
          f"warm-up, each {len(ids)} requests and "
          f"{eng.stats()['tokens_emitted']} tokens, admissions included): "
          f"{rates} tokens/s, median {statistics.median(rates)}")
    eng = te.ServeEngine(params, cfg, slots=4, max_len=2048,
                         prefill_buckets=(128, 256, 512))
    for p in reqs[:4]:
        eng.submit(p, 64)
    for _ in range(4):                           # admits all four
        eng.step()
    walls = []
    for _ in range(16):
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"MoE decode step, 4 active slots: host wall "
          f"{statistics.median(walls):.2f} ms median ({walls})")
    prompt = torch.tensor([toks(512), toks(512)])
    ragged = prompt.clone()
    ragged[1, :200] = 0
    for c in (cfg, dataclasses.replace(cfg, kv_cache_dtype="int8")):
        t0 = time.perf_counter()
        out = td.generate(params, ragged, c, max_new_tokens=new,
                          max_len=1024, pad_id=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(tuple(out.shape) == (2, new) and bool(((out >= 0) & (out < V))
                                                    .all()),
              f"MoE generate {c.kv_cache_dtype}: {tuple(out.shape)}")
        print(f"generate mixtral-ish bf16, {c.kv_cache_dtype} KV cache, B=2 "
              f"S0=512 pad_id: {2 * new} tokens in {wall:.2f} s = "
              f"{2 * new / wall:.1f} tokens/s")
    launches = dict(tfa.LAUNCHES)
    print(f"MoE-path launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in launches.items():
        # the cached prefill and the decode, on both caches; the MoE family
        # has no fresh-prefill path, so no self-attention kernel
        check((n > 0) == (name in MOE_KERNEL_ROWS),
              f"kernel {name}: {n} launches on the MoE path")
    del params, eng
    return launches


def phase_exact(torch, tl, td, te, dev):
    """Llama-7B width, 2 layers, f32: engine streams == solo generate()."""
    cfg = dataclasses.replace(tl.PRESETS["llama-7b"], n_layers=2,
                              dtype="float32", attn_impl="flash")
    params = tl.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    g = torch.Generator().manual_seed(SEED + 1)
    prefix = torch.randint(1, cfg.vocab_size, (90,), generator=g).tolist()
    reqs = [(torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist(),
             pre) for n, pre in ((100, None), (230, None), (60, prefix),
                                 (150, None), (40, prefix))]
    eng = te.ServeEngine(params, cfg, slots=3, max_len=1024,
                         prefill_buckets=(128, 256))
    ids = [eng.submit(p, 8, prefix=pre) for p, pre in reqs]
    out = eng.run()
    for rid, (p, pre) in zip(ids, reqs):
        full = (pre or []) + p
        want = td.generate(params, torch.tensor([full]), cfg,
                           max_new_tokens=8, max_len=1024)[0].tolist()
        check(out[rid] == want, f"engine stream {rid} != generate: "
              f"{out[rid]} vs {want}")
    print(f"exact-token phase (llama-7b width, 2 layers, f32): "
          f"{len(ids)} engine streams == generate; {eng.stats()}")
    del params, eng


def phase_main(torch, tl, td, te, tfa, fleet, dev):
    """Full Llama-7B in bf16 through ServeEngine and generate()."""
    cfg = dataclasses.replace(tl.PRESETS["llama-7b"], attn_impl="flash")
    t0 = time.perf_counter()
    params = tl.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    print(f"llama-7b params on the card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    g = torch.Generator().manual_seed(SEED + 2)
    V, new = cfg.vocab_size, 32

    def toks(n):
        return torch.randint(1, V, (n,), generator=g).tolist()

    prefix = toks(100)
    reqs = [(toks(n), pre) for n, pre in ((180, None), (500, None),
                                          (120, prefix), (350, None),
                                          (100, None), (230, prefix))]

    def serve():
        eng = te.ServeEngine(params, cfg, slots=4, max_len=2048,
                             prefill_buckets=(128, 256, 512),
                             return_logprobs=True)
        t0 = time.perf_counter()
        ids = [eng.submit(p, new, prefix=pre) for p, pre in reqs]
        out = eng.run()
        torch.cuda.synchronize()
        return eng, ids, out, time.perf_counter() - t0

    # one warm-up pass before the counts are reset, so that no timed pass
    # holds the first bf16 cuBLAS calls at these widths
    serve()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    rates = []
    for _ in range(3):
        eng, ids, out, wall = serve()
        for rid in ids:
            check(len(out[rid]) == new,
                  f"request {rid}: {len(out[rid])} tokens")
            check(all(0 <= t < V for t in out[rid]), f"request {rid} vocab")
            lps = eng.finished_logprobs[rid]
            check(all(lp <= 0 and lp == lp for lp in lps),
                  f"request {rid} logprobs {lps}")
        st = eng.stats()
        check(st["prefix_cache_hits"] == 1 and st["prefix_cache_misses"] == 1,
              f"prefix cache {st}")
        rates.append(st["tokens_emitted"] / wall)
    # the engine registered itself at construction: the fleet's scrape
    # reads what the pass emitted
    names = [k for k, e in fleet.ENGINES.items() if e is eng]
    emitted = sum(len(out[rid]) for rid in ids)
    check(len(names) == 1
          and fleet.engine_stats()[names[0]]["tokens_emitted"] == emitted,
          f"fleet registry: {names} for the last pass's engine, stats "
          f"{fleet.engine_stats()}, emitted {emitted}")
    print(f"fleet registry: {names[0]} is the last pass's engine, "
          f"tokens_emitted {emitted} as it emitted")
    print(f"ServeEngine llama-7b bf16, smoke-run rate (3 passes after a "
          f"warm-up, each {len(ids)} requests and {st['tokens_emitted']} "
          f"tokens, admissions included): {rates} tokens/s, median "
          f"{statistics.median(rates)}; stats {st}")
    prompt = torch.tensor([toks(512), toks(512)])
    ragged = prompt.clone()
    ragged[1, :200] = 0
    for name, p, kw in (("fresh", prompt, {}),
                        ("pad_id", ragged, {"pad_id": 0})):
        t0 = time.perf_counter()
        out = td.generate(params, p, cfg, max_new_tokens=new, max_len=1024,
                          **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(tuple(out.shape) == (2, new) and bool(((out >= 0) & (out < V))
                                                    .all()),
              f"generate {name}: {tuple(out.shape)}")
        print(f"generate llama-7b bf16 B=2 S0=512 {name}: {2 * new} tokens "
              f"in {wall:.2f} s = {2 * new / wall:.1f} tokens/s")
    # the same model on an int8 KV cache (kv_cache_dtype="int8"): the
    # prefill through the int8 cache's tensor-core flash_fwd, the decode
    # steps through flash_decode's int8 instance
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    t0 = time.perf_counter()
    out = td.generate(params, ragged, cfg8, max_new_tokens=new, max_len=1024,
                      pad_id=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tuple(out.shape) == (2, new) and bool(((out >= 0) & (out < V))
                                                .all()),
          f"generate int8 cache: {tuple(out.shape)}")
    print(f"generate llama-7b bf16, int8 KV cache, B=2 S0=512 pad_id: "
          f"{2 * new} tokens in {wall:.2f} s = {2 * new / wall:.1f} tokens/s")
    launches = dict(tfa.LAUNCHES)
    print(f"main-path launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in launches.items():
        # no backward and no triangle here
        serving = not name.startswith("flash_bwd") and "_tri" not in name
        check((n > 0) == serving,
              f"kernel {name}: {n} launches on the serving path")
    return launches


# phase 10: bench_speculative's S0 and spec_k, 48 new tokens (half its 96,
# to keep the script inside its time limit: the rounds, and every count
# read from them, follow), and the cache budget, S0 + new +
# spec_k + 1 = 309 rounded up to a multiple of 128 so that the kernels'
# gates hold
SPEC_S0, SPEC_NEW, SPEC_K, SPEC_ML = 256, 48, 4, 384


class SpecTally:
    """While installed: counts flash_attention_decode calls by query block
    length S (1: a draft step, spec_k + 1: a verify block) and keeps each
    S's last (q shape, starts); keeps the last (q shape, k shape, start,
    pads) that the fresh prefill's flash_attention and the cached
    prefill's flash_attention_cached were given, by kernel and query heads
    (``prefill``); sums the proposals the active rows of each spec_round
    were offered and accepted, on the device (no host sync). The kernels'
    own LAUNCHES counts are untouched."""

    def __init__(self, td, ts, tfa):
        self.td, self.ts, self.tfa = td, ts, tfa
        self.decode, self.spec_round = td.flash_attention_decode, \
            ts.spec_round
        self.fwd, self.cached = tfa.flash_attention, td.flash_attention_cached
        self.by_s, self.seen, self.prefill = {}, {}, {}
        self.accepted = self.proposed = 0

    def __enter__(self):
        def decode(q, k_cache, v_cache, start, **kw):
            S = q.shape[1]
            self.by_s[S] = self.by_s.get(S, 0) + 1
            self.seen[S] = (tuple(q.shape), start)
            return self.decode(q, k_cache, v_cache, start, **kw)

        def fwd(q, k, v, **kw):
            self.prefill["flash_fwd", q.shape[2]] = (
                tuple(q.shape), tuple(k.shape), 0, None)
            return self.fwd(q, k, v, **kw)

        def cached(q, k_cache, v_cache, start, **kw):
            self.prefill["flash_cached", q.shape[2]] = (
                tuple(q.shape), tuple(k_cache.shape), start,
                kw.get("pad_lens"))
            return self.cached(q, k_cache, v_cache, start, **kw)

        def spec_round(*args, **kw):
            out = self.spec_round(*args, **kw)
            emit_n = out[2]                  # -1 rolled back, else m + 1
            self.accepted = self.accepted + (emit_n - 1).clamp(min=0).sum()
            self.proposed = self.proposed + (emit_n > 0).sum() * kw["spec_k"]
            return out
        self.td.flash_attention_decode = decode
        self.ts.spec_round = spec_round
        self.tfa.flash_attention = fwd
        self.td.flash_attention_cached = cached
        return self

    def __exit__(self, *exc):
        self.td.flash_attention_decode = self.decode
        self.ts.spec_round = self.spec_round
        self.tfa.flash_attention = self.fwd
        self.td.flash_attention_cached = self.cached


def count_syncs(torch, fn):
    """(fn's result, host syncs fn made), counted by
    torch.cuda.set_sync_debug_mode's warnings."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_spec_exact(torch, tl, tm, td, te, ts, dev):
    """Llama-7B width target and Llama-1B width draft, 2 layers each, f32,
    the flash kernels in their f32 instances: greedy speculative_generate
    == generate at B=1 (fresh prefill) and B=4 (ragged pad_id), spec_k 4
    and 15 (verify blocks of 5 and 16 on flash_decode); flash == dense;
    ServeEngine with the draft == ServeEngine without, request by request;
    an MoE target (mixtral-ish width, 2 layers) with the dense draft ==
    its plain greedy stream."""
    cfg = dataclasses.replace(tl.PRESETS["llama-7b"], n_layers=2,
                              dtype="float32", attn_impl="flash")
    dcfg = dataclasses.replace(tl.PRESETS["llama-1b"], n_layers=2,
                               dtype="float32", attn_impl="flash")
    params = tl.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    draft = tl.init_params(dcfg, torch.Generator(dev).manual_seed(SEED + 1),
                           dev)
    g = torch.Generator().manual_seed(SEED + 8)
    V, new, ML = cfg.vocab_size, 24, SPEC_ML
    one = torch.randint(1, V, (1, 256), generator=g)
    ragged = torch.randint(1, V, (4, 256), generator=g)
    for b, pad in enumerate((0, 37, 100, 190)):
        ragged[b, :pad] = 0
    cases = ((one, {}), (ragged, {"pad_id": 0}))
    for spec_k in (4, 15):
        for prompt, kw in cases:
            want = td.generate(params, prompt, cfg, max_new_tokens=new,
                               max_len=ML, **kw)
            got, st = ts.speculative_generate(
                params, draft, prompt, cfg, dcfg, max_new_tokens=new,
                spec_k=spec_k, max_len=ML, **kw)
            check(torch.equal(got, want),
                  f"speculative (spec_k {spec_k}, B={len(prompt)}) != "
                  f"generate: {got.tolist()} vs {want.tolist()}")
            print(f"speculative == generate: spec_k {spec_k}, "
                  f"B={len(prompt)} {kw or 'fresh'}, target_calls "
                  f"{st['target_calls']} for {new} tokens")
    dense = [dataclasses.replace(c, attn_impl="dense") for c in (cfg, dcfg)]
    flash_out = ts.speculative_generate(params, draft, ragged, cfg, dcfg,
                                        max_new_tokens=new, spec_k=4,
                                        max_len=ML, pad_id=0)[0]
    dense_out = ts.speculative_generate(params, draft, ragged, *dense,
                                        max_new_tokens=new, spec_k=4,
                                        max_len=ML, pad_id=0)[0]
    check(torch.equal(flash_out, dense_out),
          f"speculative flash != dense: {flash_out.tolist()} vs "
          f"{dense_out.tolist()}")
    reqs = [(torch.randint(1, V, (n,), generator=g).tolist(), m)
            for n, m in ((100, 12), (230, 9), (60, 16), (150, 7))]
    prefix = torch.randint(1, V, (90,), generator=g).tolist()
    streams = []
    for kw in ({}, {"draft_params": draft, "draft_cfg": dcfg, "spec_k": 4}):
        eng = te.ServeEngine(params, cfg, slots=3, max_len=1024,
                             prefill_buckets=(128, 256), **kw)
        ids = [eng.submit(p, m, prefix=prefix if i % 2 else None)
               for i, (p, m) in enumerate(reqs)]
        out = eng.run()
        streams.append([out[i] for i in ids])
    check(streams[0] == streams[1],
          f"speculative engine != plain engine: {streams}")
    print(f"speculative flash == dense (B=4, pad_id); ServeEngine with the "
          f"draft == without, {len(reqs)} requests (2 on a prefix)")
    del params
    mcfg = dataclasses.replace(tm.PRESETS_MOE["mixtral-ish"], n_layers=2,
                               dtype="float32", attn_impl="flash")
    mparams = tm.init_moe_model(mcfg, torch.Generator(dev).manual_seed(SEED),
                                dev)
    want = td.generate(mparams, ragged, mcfg, max_new_tokens=new, max_len=ML,
                       pad_id=0)
    got, st = ts.speculative_generate(mparams, draft, ragged, mcfg, dcfg,
                                      max_new_tokens=new, spec_k=4,
                                      max_len=ML, pad_id=0)
    check(torch.equal(got, want), f"MoE-target speculative != generate: "
          f"{got.tolist()} vs {want.tolist()}")
    print(f"MoE target (mixtral-ish width, 2 layers) with the dense draft "
          f"== generate, B=4 pad_id, target_calls {st['target_calls']}")
    del mparams, draft


def agreement(a, b):
    """(share of equal positions, first divergence per row or None)."""
    eq = (a == b)
    first = [None if bool(r.all()) else int((~r).nonzero()[0])
             for r in eq.cpu()]
    return float(eq.float().mean()), first


def phase_spec(torch, tl, td, te, ts, tfa, dev, deferred):
    """Full Llama-7B target with a full Llama-1B draft, bf16, flash:
    speculative_generate at bench_speculative's S0 256 and spec_k 4 with
    SPEC_NEW (48) new tokens at B=1 (fresh prefill) and B=8 (left-padded,
    pad_id) against
    generate in the same call, then a speculative ServeEngine pass. Plain
    generate is timed first, so that every kernel's launches are read
    across the speculative runs and the engine pass alone. Returns (the
    launches, the report, the verify entry, the prefill shapes)."""
    import torch.nn.functional as F
    cfg = dataclasses.replace(tl.PRESETS["llama-7b"], attn_impl="flash")
    dcfg = dataclasses.replace(tl.PRESETS["llama-1b"], attn_impl="flash")
    t0 = time.perf_counter()
    params = tl.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    draft = tl.init_params(dcfg, torch.Generator(dev).manual_seed(SEED + 1),
                           dev)
    torch.cuda.synchronize()
    print(f"llama-7b + llama-1b params on the card in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    g = torch.Generator().manual_seed(SEED + 9)
    V, K, new, ML = cfg.vocab_size, SPEC_K, SPEC_NEW, SPEC_ML
    one = torch.randint(1, V, (1, SPEC_S0), generator=g)
    eight = torch.randint(1, V, (8, SPEC_S0), generator=g)
    for b in range(8):
        eight[b, :12 * b] = 0

    def spec(prompt, kw):
        return ts.speculative_generate(params, draft, prompt, cfg, dcfg,
                                       max_new_tokens=new, spec_k=K,
                                       max_len=ML, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # warm-up: the first bf16 cuBLAS calls at these widths, uncounted
    spec(one[:, :128], {})
    td.generate(params, one[:, :128], cfg, max_new_tokens=4, max_len=ML)
    runs = (("B=1", one, {}), ("B=8", eight, {"pad_id": 0}))
    plain = {name: timed(lambda: td.generate(
        params, prompt, cfg, max_new_tokens=new, max_len=ML, **kw))
        for name, prompt, kw in runs}
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    report, decode_calls, prefill = {}, 0, {}
    for name, prompt, kw in runs:
        B = len(prompt)
        with SpecTally(td, ts, tfa) as tally:
            (got, st), syncs = count_syncs(torch, lambda: spec(prompt, kw))
        (got2, st2), spec_s = timed(lambda: spec(prompt, kw))
        check(tuple(got.shape) == (B, new) and bool(((got >= 0) & (got < V))
                                                    .all()),
              f"speculative {name}: {tuple(got.shape)}")
        check(torch.equal(got, got2) and st["target_calls"]
              == st2["target_calls"], f"speculative {name} not repeatable")
        rounds = st["target_calls"] - 1
        check(tally.by_s.get(K + 1, 0) == cfg.n_layers * rounds
              and tally.by_s.get(1, 0) == dcfg.n_layers * (K + 1) * rounds,
              f"speculative {name}: decode calls by S {tally.by_s}, "
              f"{rounds} rounds")
        share, first = agreement(got, plain[name][0])
        decode_calls += 2 * sum(tally.by_s.values())     # both runs
        prefill.update(tally.prefill)
        report[name] = {
            "target_calls": st["target_calls"],
            "accepted_share": float(tally.accepted) / float(tally.proposed),
            "tokens_per_s": B * new / spec_s,
            "plain_tokens_per_s": B * new / plain[name][1],
            "host_syncs": syncs, "syncs_per_round": syncs / rounds,
            "decode_calls_by_S": dict(tally.by_s),
            "agreement_with_plain": share, "first_divergence": first}
        print(f"speculative llama-7b + llama-1b bf16 {name} S0={SPEC_S0} "
              f"{new} new, spec_k {K}: {json.dumps(report[name])}")
        verify_shape, verify_start = tally.seen[K + 1]
    # two runs a batch: the B=1 prefills on #1 (fresh), the B=8 ones on #4
    # (pads), one launch a layer of each model; every #5 call a launch
    gen = dict(tfa.LAUNCHES)
    L2 = 2 * (cfg.n_layers + dcfg.n_layers)
    check(gen["flash_fwd"] == L2 and gen["flash_cached"] == L2
          and gen["flash_decode"] == decode_calls,
          f"speculative_generate launches {gen}: want flash_fwd and "
          f"flash_cached {L2}, flash_decode {decode_calls}")
    eng = te.ServeEngine(params, cfg, slots=4, max_len=1024,
                         prefill_buckets=(128, 256, 512),
                         draft_params=draft, draft_cfg=dcfg, spec_k=K,
                         return_logprobs=True)
    prefix = torch.randint(1, V, (100,), generator=g).tolist()
    reqs = [(torch.randint(1, V, (n,), generator=g).tolist(), pre)
            for n, pre in ((180, None), (400, None), (120, prefix),
                           (350, None), (100, None), (230, prefix))]
    (ids, out), wall = timed(lambda: (
        [eng.submit(p, 32, prefix=pre) for p, pre in reqs], eng.run()))
    for rid in ids:
        lps = eng.finished_logprobs[rid]
        check(len(out[rid]) == 32 and all(0 <= t < V for t in out[rid])
              and len(lps) == 32 and all(lp <= 0 for lp in lps),
              f"speculative engine request {rid}: {out[rid]}")
    st = eng.stats()
    print(f"speculative ServeEngine llama-7b + llama-1b bf16: "
          f"{st['tokens_emitted']} tokens in {wall:.2f} s = "
          f"{st['tokens_emitted'] / wall:.1f} tokens/s; {st}")
    launches = dict(tfa.LAUNCHES)
    print(f"speculation-path launches {launches} (speculative_generate "
          f"alone {gen}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in launches.items():
        # the fresh prefill, the cached prefill (pads, admissions, prefix
        # suffixes) and the decode; no int8 cache, backward or triangle
        check((n > 0) == (name in ("flash_fwd", "flash_cached",
                                   "flash_decode")),
              f"kernel {name}: {n} launches on the speculation path")
    # the engine admits through #4 and steps through #5
    check(launches["flash_cached"] > gen["flash_cached"]
          and launches["flash_decode"] > gen["flash_decode"],
          f"speculative ServeEngine launches {launches} after {gen}")
    del params, draft, eng

    # the verify call's attention at the shape the B=8 run gave it
    gq = torch.Generator(dev).manual_seed(SEED + 10)
    B, S, Hq, D = verify_shape
    Hkv = cfg.n_kv_heads
    bf = torch.bfloat16
    q = torch.randn(B, S, Hq, D, generator=gq, device=dev).to(bf)
    kc, vc = (torch.randn(B, Hkv, ML, D, generator=gq, device=dev).to(bf)
              for _ in range(2))
    st_ = verify_start.to(torch.int32)
    pads = torch.tensor([12 * b for b in range(B)], dtype=torch.int32,
                        device=dev)
    kp = torch.arange(ML, device=dev)
    mask = ((kp[None, None, :] <= st_[:, None, None].long()
             + torch.arange(S, device=dev)[None, :, None])
            & (kp[None, None, :] >= pads[:, None, None]))[:, None]
    e = (tfa.flash_attention_decode(q, kc, vc, st_, pad_lens=pads).float()
         - tfa.attention_plain(q, kc, vc, st_, pad_lens=pads)[0].float()
         ).abs().max().item()
    check(e <= TOL["bfloat16"], f"flash_decode at the verify shape: {e}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kernel = lambda: tfa.flash_attention_decode(q, kc, vc, st_,  # noqa: E731
                                                pad_lens=pads)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), kc, vc, attn_mask=mask, enable_gqa=True)
    verify = {"shape": f"B={B} S={S} Hq={Hq} Hkv={Hkv} ML={ML}, starts "
                       f"{st_.tolist()}, pads {pads.tolist()}",
              "max_abs_err": e,
              **timing(kernel,
                       lambda: tfa.attention_plain(q, kc, vc, st_,
                                                   pad_lens=pads),
                       library,
                       work(B, S, Hq, Hkv, D, ML, st_, pads, None, 0, True,
                            2, 2, False, False), flush)}
    deferred.append((verify, kernel, library, ("flash_decode",)))
    print(f"flash_decode at the verify shape: {json.dumps(verify)}")
    del flush
    return launches, report, verify, prefill


def spec_prefill_rows(torch, tfa, prefill, dev, deferred):
    """#1 and #4 at the shapes the speculation path's prefills gave them
    (SpecTally.prefill: the B=1 fresh prefill's self-attention and the B=8
    pad_id prefill's cached attention from its start under the rows' pads,
    for the target's and the draft's query heads), bf16, random inputs:
    each against attention_plain within TOL, then timed (device times
    deferred). Returns ({row: {"Hq=..": entry}}, {row: worst error})."""
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(SEED + 11)
    bf = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    entries = {"flash_fwd": {}, "flash_cached": {}}
    errs = dict.fromkeys(entries, 0.0)

    def rnd(shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def case(name, q_shape, k_shape, start, pads):
        """(kernel, plain, library, work, shape) of one recorded call."""
        B, S, Hq, D = q_shape
        q, k, v = rnd(q_shape), rnd(k_shape), rnd(k_shape)
        if name == "flash_fwd":                    # k/v [B, S, Hkv, D]
            kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            Hkv = k_shape[2]
            return (lambda: tfa.flash_attention_with_lse(q, k, v),
                    lambda: tfa.attention_plain(q, kh, vh, 0),
                    lambda: F.scaled_dot_product_attention(
                        q.transpose(1, 2), kh, vh, is_causal=True,
                        enable_gqa=True),
                    work(B, S, Hq, Hkv, D, S, 0, None, None, 0, True, 2, 2,
                         False, True),
                    f"B={B} S={S} Hq={Hq} Hkv={Hkv}, self-attention")
        Hkv, ML = k_shape[1], k_shape[2]           # cache [B, Hkv, ML, D]
        st = int(start)
        kp = torch.arange(ML, device=dev)
        mask = ((kp[None, None, :] <= st + torch.arange(S, device=dev)[
            None, :, None]) & (kp[None, None, :] >= pads[:, None, None])
                )[:, None]
        return (lambda: tfa.flash_attention_cached(q, k, v, st,
                                                   pad_lens=pads),
                lambda: tfa.attention_plain(q, k, v, st, pad_lens=pads),
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k, v, attn_mask=mask,
                    enable_gqa=True),
                work(B, S, Hq, Hkv, D, ML, st, pads, None, 0, True, 2, 2,
                     False, False),
                f"B={B} S={S} Hq={Hq} Hkv={Hkv} ML={ML}, start {st}, pads "
                f"{pads.tolist()}")

    for (name, Hq), args in sorted(prefill.items()):
        kernel, plain, library, ops_bytes, shape = case(name, *args)
        e = (kernel()[0] if name == "flash_fwd" else kernel()).float()
        e = (e - plain()[0].float()).abs().max().item()
        check(e <= TOL["bfloat16"],
              f"{name} at the speculation prefill's shape {shape}: {e}")
        errs[name] = max(errs[name], e)
        entry = {"shape": shape, "max_abs_err": e,
                 **timing(kernel, plain, library, ops_bytes, flush)}
        entries[name][f"Hq={Hq}"] = entry
        deferred.append((entry, kernel, library, ("flash_fwd_tc_kernel",)))
        print(f"{name} at the speculation prefill's shape: "
              f"{json.dumps(entry)}")
    check(all(len(v) == 2 for v in entries.values()),
          f"speculation prefill shapes {sorted(prefill)}")
    del flush
    return entries, errs


def phase_spec_twin(torch, bench, tfa):
    """bench_speculative (self-draft Llama-1B, full size) with its launches:
    the fresh prefill of target and draft (16 layers each) in one warm and
    SPEC_ROUNDS timed calls at each of the two batch sizes."""
    tfa.reset_launches()
    res = bench.bench_speculative(False)
    launches = dict(tfa.LAUNCHES)
    L = bench.speculative_config(False).n_layers
    print(f"bench_speculative (self-draft llama-1b): {json.dumps(res)}; "
          f"launches {launches}")
    check(res["target_calls"] <= -(-(res["new_tokens"] - 1)
                                   // (res["spec_k"] + 1)) + 1,
          f"bench_speculative: self-draft did not accept every proposal: "
          f"{res}")
    check(launches["flash_fwd"] == 2 * L * 2 * (1 + bench.SPEC_ROUNDS)
          and launches["flash_decode"] > 0,
          f"bench_speculative launches {launches}")
    return res, launches


# phase 11: resumable training. (B, S) of the exact resume at llama-1b
# width; the MoE training run's (B, S) and depth (mixtral-ish's 16 layers
# hold ~4.7B params, ×16 B of f32 params, grads and moments ≈ 75 GB, which
# leaves no room for the activations on 80 GB)
RESUME_EXACT_SHAPE = (2, 512)
MOE_TRAIN_SHAPE, MOE_TRAIN_LAYERS = (4, 2048), 8


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def ckpt_leaves(ck, params, opt):
    """The checkpoint tree's tensors (params, mu, nu, count) as CPU
    copies, by name."""
    tree = {"params": params, "opt_state": ck.adam_state_tree(params, opt)}
    return {k: v.detach().cpu().clone() for k, v in _named(tree).items()}


def state_bytes(ck, params, opt):
    tree = {"params": params, "opt_state": ck.adam_state_tree(params, opt)}
    return sum(t.numel() * t.element_size() for t in _named(tree).values())


def same_leaves(a, b):
    """Names of the leaves of a and b that are not equal in dtype, shape and
    every value."""
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not a[k].equal(b[k]))


def held_losses(what, got, want, spread):
    """Losses held bitwise, or within ``spread`` where two uninterrupted
    runs of the same step differed by that much."""
    err = max(abs(a - b) for a, b in zip(got, want))
    print(f"{what}: losses {got} against the uninterrupted {want}: max "
          f"|diff| {err!r} (run-to-run spread {spread!r})")
    check(err <= spread, f"{what}: losses {got} != uninterrupted {want}")


def phase_resume_exact(torch, tl, tt, ck, dev, tmp):
    """Llama-1B width, 2 layers, f32, flash: 4 uninterrupted steps twice,
    then 2 steps, a TrainCheckpointManager save, every tensor dropped,
    restore_latest() onto the card and 2 more steps; the restored leaves
    bitwise equal to the saved ones, the resumed run to the uninterrupted
    one (or within its run-to-run spread), a restore onto the CPU equal."""
    cfg = dataclasses.replace(tl.PRESETS["llama-1b"], n_layers=2,
                              dtype="float32", attn_impl="flash")
    B, S = RESUME_EXACT_SHAPE
    g = torch.Generator().manual_seed(SEED + 11)
    batches = [torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
               .to(dev) for _ in range(4)]

    def fresh():
        return tt.make_train_state(
            cfg, torch.Generator(dev).manual_seed(SEED), dev)

    def run(params, opt, idx):
        step = tt.make_train_step(cfg, opt)
        return [step(params, batches[i][:, :-1], batches[i][:, 1:]).item()
                for i in idx]

    runs = []
    for _ in range(2):
        params, opt = fresh()
        losses = run(params, opt, range(4))
        runs.append((losses, {k: v.detach().clone()
                              for k, v in _named(params).items()}))
        del params, opt
    (want, want_p), (again, again_p) = runs
    spread = max(abs(a - b) for a, b in zip(want, again))
    p_spread = max((want_p[k] - again_p[k]).abs().max().item()
                   for k in want_p)
    same = not same_leaves(want_p, again_p) and want == again
    print(f"resume exact (llama-1b width, 2 layers, f32, flash): two "
          f"uninterrupted runs of 4 steps "
          f"{'bitwise equal' if same else 'differ'}: losses {want} / "
          f"{again}, params max |diff| {p_spread!r}")
    del again_p

    mgr = ck.TrainCheckpointManager(tmp / "exact", cfg, tt.default_optimizer,
                                    device=dev, max_to_keep=2,
                                    save_interval_steps=2)
    params, opt = fresh()
    first = run(params, opt, range(2))
    t0 = time.perf_counter()
    check(mgr.maybe_save(2, params, opt), "the manager did not save step 2")
    save_s = time.perf_counter() - t0
    saved = ckpt_leaves(ck, params, opt)
    del params, opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, opt, step = mgr.restore_latest()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step == 2 and mgr.latest_step() == 2,
          f"restore_latest: step {step}, latest {mgr.latest_step()}")
    bad = same_leaves(saved, ckpt_leaves(ck, params, opt))
    check(not bad, f"restored leaves differ from the saved ones: {bad}")
    resumed = run(params, opt, range(2, 4))
    got_p = {k: v.detach() for k, v in _named(params).items()}
    p_err = max((got_p[k] - want_p[k]).abs().max().item() for k in want_p)
    print(f"resume exact: saved {len(saved)} leaves in {save_s:.2f} s, "
          f"restored on the card in {restore_s:.2f} s, every leaf bitwise "
          f"equal; resumed params max |diff| {p_err!r} (spread "
          f"{p_spread!r})")
    held_losses("resume exact", first + resumed, want, spread)
    check(p_err <= p_spread, f"resumed params differ by {p_err!r}, beyond "
          f"the run-to-run spread {p_spread!r}")
    del params, opt, got_p, want_p
    c_params, c_opt, c_step = ck.restore_train_state(
        tmp / "exact" / "2", cfg, tt.default_optimizer, device="cpu")
    bad = same_leaves(saved, ckpt_leaves(ck, c_params, c_opt))
    check(c_step == 2 and not bad and c_params["embed"].device.type == "cpu",
          f"the restore onto the CPU differs from the card's copy: {bad}")
    print("resume exact: the restore onto the CPU equals the card's copy")
    mgr.close()


def phase_resume(torch, tl, tt, ck, tfa, dev, tmp, f32_ms):
    """Full Llama-1B, bf16 activations, f32 masters, remat, B=8, S=2048,
    default_optimizer(mu_dtype=bf16): 4 uninterrupted steps, then a fresh
    state's 2 steps, save_train_state, a restore into a fresh state and 2
    steps, the launches read across the resumed steps."""
    cfg = dataclasses.replace(tl.PRESETS["llama-1b"], attn_impl="flash",
                              remat=True)
    (B, S, _, _), L = TRAIN_SHAPE, cfg.n_layers
    opt_fn = functools.partial(tt.default_optimizer,
                               mu_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(SEED + 12)
    batches = [torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
               .to(dev) for _ in range(4)]

    def run(params, opt, idx, times):
        step = tt.make_train_step(cfg, opt)
        out = []
        for i in idx:
            t0 = time.perf_counter()
            loss = step(params, batches[i][:, :-1], batches[i][:, 1:])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out.append(loss.item())
        return out

    def fresh():
        return tt.make_train_state(
            cfg, torch.Generator(dev).manual_seed(SEED), dev, optimizer=opt_fn)

    times = []
    params, opt = fresh()
    want = run(params, opt, range(4), times)
    del params, opt
    torch.cuda.empty_cache()
    params, opt = fresh()
    first = run(params, opt, range(2), [])
    need = state_bytes(ck, params, opt)
    free = shutil.disk_usage(tmp).free
    print(f"resume llama-1b: the state is {need / 1e9:.3f} GB, the disk "
          f"under {tmp} has {free / 1e9:.3f} GB free")
    check(need < free, f"the disk has {free / 1e9:.3f} GB free, a "
          f"checkpoint of full llama-1b needs {need / 1e9:.3f} GB")
    path = tmp / "llama-1b"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_train_state(path, params, opt, 2)
    save_s = time.perf_counter() - t0
    written = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    del params, opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, opt, step = ck.restore_train_state(path, cfg, opt_fn, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step == 2 and type(opt).__name__ == "AdamWMu",
          f"restored step {step}, optimizer {type(opt).__name__}")
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    resumed = run(params, opt, range(2, 4), [])
    launches = dict(tfa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(times)
    report = {"state_gb": need / 1e9, "written_gb": written / 1e9,
              "save_s": save_s, "save_gb_per_s": written / 1e9 / save_s,
              "restore_s": restore_s,
              "restore_gb_per_s": written / 1e9 / restore_s,
              "disk_free_gb": free / 1e9, "step_ms": times,
              "step_ms_median": ms, "f32_mu_step_ms": f32_ms,
              "tokens_per_s": B * S / ms * 1e3, "peak_gib": peak}
    print(f"resume llama-1b bf16 (f32 masters, bf16 mu, remat, flash) B={B} "
          f"S={S}: {json.dumps(report)}; launches over the 2 resumed steps "
          f"{launches}")
    held_losses("resume llama-1b", first + resumed, want, 0.0)
    for name, n in {"flash_fwd": 2 * L * 2, "flash_bwd_dq": L * 2,
                    "flash_bwd_dkv": L * 2}.items():
        check(launches[name] == n,
              f"{name}: {launches[name]} launches over the resumed steps, "
              f"expected {n}")
    shutil.rmtree(path)
    return launches, report


def phase_moe_train_exact(torch, tm, dev):
    """mixtral-ish width, 2 layers, f32: a flash MoE train step == a dense
    one in loss and every gradient (the MoE twin of phase 6)."""
    cfg = dataclasses.replace(tm.PRESETS_MOE["mixtral-ish"], n_layers=2,
                              dtype="float32")
    g = torch.Generator().manual_seed(SEED + 13)
    toks = torch.randint(0, cfg.vocab_size, (2, 513), generator=g).to(dev)
    losses, grads = {}, {}
    for impl in ("flash", "dense"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        params, opt = tm.make_moe_train_state(
            c, torch.Generator(dev).manual_seed(SEED), dev)
        losses[impl] = tm.make_moe_train_step(c, opt)(
            params, toks[:, :-1], toks[:, 1:]).item()
        grads[impl] = {k: v.grad for k, v in _named(params).items()}
        del params, opt
    a, b = losses["flash"], losses["dense"]
    worst = max((grads["flash"][k] - grads["dense"][k]).abs().max().item()
                / grads["dense"][k].abs().max().item() for k in grads["dense"])
    print(f"MoE training exact (mixtral-ish width, 2 layers, f32): loss "
          f"flash {a!r} dense {b!r} rel {abs(a - b) / abs(b):.3g}; worst "
          f"gradient leaf max|flash - dense| / max|dense| = {worst:.3g} "
          f"(tol 1e-4)")
    check(abs(a - b) <= 1e-5 * abs(b), "MoE training loss: flash != dense")
    check(worst <= 1e-4, "MoE flash gradients != dense gradients")


def phase_moe_train(torch, tm, tfa, dev, cfg=None, steps=5, what=None):
    """An MoE model at MOE_TRAIN_SHAPE, bf16, f32 masters, remat, flash:
    one warm-up step, then ``steps`` timed steps, the loss falling and the
    launches read across them. ``cfg`` (named ``what``) defaults to
    mixtral-ish at full width and MOE_TRAIN_LAYERS of 16 layers."""
    if cfg is None:
        cfg = dataclasses.replace(tm.PRESETS_MOE["mixtral-ish"],
                                  n_layers=MOE_TRAIN_LAYERS)
        what = (f"mixtral-ish; depth cut to {MOE_TRAIN_LAYERS} of 16 layers:"
                " 16 do not fit beside the activations on 80 GB")
    cfg = dataclasses.replace(cfg, attn_impl="flash", remat=True)
    (B, S), L = MOE_TRAIN_SHAPE, cfg.n_layers
    params, opt = tm.make_moe_train_state(
        cfg, torch.Generator(dev).manual_seed(SEED), dev)
    n = sum(p.numel() for p in _named(params).values())
    step = tm.make_moe_train_step(cfg, opt)
    g = torch.Generator().manual_seed(SEED + 14)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g).to(dev)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    warm = step(params, inp, tgt).item()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(params, inp, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = dict(tfa.LAUNCHES)
    ms = statistics.median(times)
    report = {"layers": L, "head_dim": cfg.head_dim,
              "params": n, "batch": B, "seq_len": S, "warm_loss": warm,
              "losses": losses, "step_ms": times, "step_ms_median": ms,
              "tokens_per_s": B * S / ms * 1e3,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"MoE train bf16 (f32 masters, remat, flash; {what}): "
          f"{json.dumps(report)}; launches over {steps} steps {launches}")
    check(all(x == x and abs(x) < float("inf") for x in [warm] + losses),
          "an MoE training loss is not finite")
    check(losses[-1] < losses[0] < warm, f"MoE loss did not fall: {losses}")
    for name, want in {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
                       "flash_bwd_dkv": L * steps}.items():
        check(launches[name] == want,
              f"{name}: {launches[name]} launches on the MoE training path, "
              f"expected {want}")
    del params, opt, step
    return launches, report


def phase_train_twins(torch, bench, tfa):
    """bench_train_step and bench_workload at full size, each with its
    launches read: TRAIN_WARM + ROUNDS × TRAIN_ITERS steps of 16 layers;
    the workload's dense forward launches none."""
    tfa.reset_launches()
    res = bench.bench_train_step(False)
    launches = dict(tfa.LAUNCHES)
    n, L = (bench.TRAIN_WARM + bench.ROUNDS * bench.TRAIN_ITERS,
            bench.train_step_config(False).n_layers)
    print(f"bench_train_step (llama-1b, bf16 mu): {json.dumps(res)}; "
          f"launches {launches}")
    check(0 < res["mfu"] < 1 and res["tokens_per_s"] > 0,
          f"bench_train_step: {res}")
    for name, want in {"flash_fwd": 2 * L * n, "flash_bwd_dq": L * n,
                       "flash_bwd_dkv": L * n}.items():
        check(launches[name] == want,
              f"bench_train_step {name}: {launches[name]} launches, "
              f"expected {want}")
    tfa.reset_launches()
    work = bench.bench_workload(False)
    print(f"bench_workload (llama-1b forward, dense attention): "
          f"{json.dumps(work)}; launches {dict(tfa.LAUNCHES)}")
    check(work["tokens_per_s"] > 0 and not any(tfa.LAUNCHES.values()),
          f"bench_workload: {work}, launches {dict(tfa.LAUNCHES)}")
    return res, work, launches


def phase_resumable(torch, tl, tm, tt, ck, bench, tfa, dev, f32_ms):
    """Phase 11: the exact resume, the full resume, MoE training and the
    two training bench twins."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ckpt-") as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        phase_resume_exact(torch, tl, tt, ck, dev, tmp)
        torch.cuda.empty_cache()
        resume, resume_report = phase_resume(torch, tl, tt, ck, tfa, dev,
                                             tmp, f32_ms)
        print(f"resume phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_moe_train_exact(torch, tm, dev)
    torch.cuda.empty_cache()
    moe_train, moe_report = phase_moe_train(torch, tm, tfa, dev)
    print(f"MoE training phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    twin, work, twin_launches = phase_train_twins(torch, bench, tfa)
    print(f"training twins phase {time.perf_counter() - t0:.1f} s")
    return {"resume": resume, "moe_train": moe_train,
            "bench_train_step": twin_launches}, {
        "resume": resume_report, "moe_train": moe_report,
        "bench_train_step": twin, "bench_workload": work}


# phase 12: the sharded step's ranks share the one card over gloo. Its
# exact meshes over one 4-rank world (mesh arguments, seq_schedule), the
# batch, and the full-size runs: (ranks, mesh, schedules), B, S, steps
SHARDED_EXACT = ((({"sp": 2}, "ring"), ({"sp": 2}, "zigzag"),
                  ({"sp": 2, "tp": 2}, "ring"), ({"tp": 2}, "ring")),
                 (4, 512))
SHARDED_FULL = ((2, {"sp": 2}, ("ring", "zigzag")),
                (4, {"sp": 2, "tp": 2}, ("ring",)))
SHARDED_SHAPE, SHARDED_WARM, SHARDED_STEPS = (8, 2048), 1, 3
# the full-size runs' depth: 4 of llama-1b's 16 layers (the whole script's
# time; phase 12 took 140-215 s at 16, most of it staging gradients, and
# 147 s at 8, when phase 19 brought the script to 975 s of its 1200)
SHARDED_LAYERS = 4
SHARED = "ranks sharing one H100 over gloo; not a multi-GPU time"
SHARDED_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def sharded_launches(L, n, my, zigzag):
    """Predicted launches a step of one rank of the causal ring over n
    ranks (remat: two forwards a layer): the ring's rank my makes my + 1
    calls a layer, the zigzag's every rank 2n + 1."""
    calls = 2 * n + 1 if zigzag else my + 1
    return {"flash_fwd": 2 * L * calls, "flash_bwd_dq": L * calls,
            "flash_bwd_dkv": L * calls}


# (path, B, S, Hq, Hkv) of the flash calls on phase 12's full-size path
# (Llama-1B, B=8, S=2048, D=128): the ring's 1024-token blocks at sp=2,
# the zigzag's 512-token chunk pairs, the ring's blocks at (sp=2, tp=2)
# with 8/4 heads a rank
SHARDED_CALLS = (("ring", 8, 1024, 16, 8), ("zigzag", 8, 512, 16, 8),
                 ("ring_sp2_tp2", 8, 1024, 8, 4))


def phase_call_shapes(torch, tfa, dev, calls, path, causals=(True, False),
                      lse_cotangent=True, seed=SEED + 23):
    """flash_fwd (#1/#2), flash_bwd_dq (#6) and flash_bwd_dkv (#7) at a
    parallel path's own call shapes ``calls`` ((label, B, S, Hq, Hkv)) in
    bf16, each causal and (where ``causals`` says) full, the backward with
    an lse cotangent where the path has one (the ring's merge gives one),
    against attention_plain and attention_bwd_plain on the same inputs,
    within TOL of the reference's largest value (lse within 1e-4). Returns
    each kernel's worst errors."""
    g = torch.Generator(dev).manual_seed(seed)
    D, bf, tol = 128, torch.bfloat16, TOL["bfloat16"]

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def err(a, b):
        e = (a.float() - b.float()).abs().max().item()
        return e, e / b.float().abs().max().item()

    worst = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0, "tolerance": tol,
                 "shapes": [list(c) for c in calls]}
             for k in SHARDED_KERNELS}
    for label, B, S, Hq, Hkv in calls:
        for causal in causals:
            q, dout = rnd(B, S, Hq, D), rnd(B, S, Hq, D)
            k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
            g_lse = (rnd(B, Hq, S, dtype=torch.float32) if lse_cotangent
                     else None)
            out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
            ref, rlse = tfa.attention_plain(q, k.transpose(1, 2),
                                            v.transpose(1, 2), 0,
                                            causal=causal)
            fwd, (lse_err, _) = err(out, ref), err(lse, rlse)
            del ref, rlse
            got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, g_lse,
                                          causal=causal)
            want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse,
                                           causal=causal)
            es = [err(a, b) for a, b in zip(got, want)]
            del got, want
            print(f"{path} call {label} bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} "
                  f"causal={causal} lse_cotangent={lse_cotangent}: flash_fwd"
                  f" max|err| {fwd[0]:.3g} rel {fwd[1]:.3g}, |lse-plain| "
                  f"{lse_err:.3g} (tol 1e-4); " + ", ".join(
                      f"{n} max|err| {e:.3g} rel {r:.3g}"
                      for n, (e, r) in zip(("dq", "dk", "dv"), es))
                  + f" (tol {tol}, relative)")
            check(fwd[1] <= tol and lse_err <= 1e-4,
                  f"flash_fwd disagrees with attention_plain at the {path} "
                  f"{label} call (causal={causal})")
            check(all(r <= tol for _, r in es),
                  f"a backward kernel disagrees with attention_bwd_plain at "
                  f"the {path} {label} call (causal={causal})")
            for name, part in (("flash_fwd", [fwd]), ("flash_bwd_dq", es[:1]),
                               ("flash_bwd_dkv", es[1:])):
                w = worst[name]
                w["max_abs_err"] = max([w["max_abs_err"]]
                                       + [e for e, _ in part])
                w["max_rel_err"] = max([w["max_rel_err"]]
                                       + [r for _, r in part])
            del q, k, v, dout, g_lse, out, lse
    torch.cuda.synchronize()
    return worst


def phase_sharded_exact(torch, tl, tt, jobs, launch, dev):
    """Llama-1B width, 2 layers, f32, flash: one sharded step on each mesh
    of SHARDED_EXACT (one 4-rank world) against make_train_step in this
    process on the same params and batch; the ranks hold their shards
    against its gradients and params (saved for them)."""
    meshes, (B, S) = SHARDED_EXACT
    cfg = dataclasses.replace(tl.PRESETS["llama-1b"], n_layers=2,
                              dtype="float32", attn_impl="flash")
    params, opt = tt.make_train_state(
        cfg, torch.Generator(dev).manual_seed(SEED + 20), dev)
    inp, tgt = jobs.seeded_batch(cfg, B, S, SEED + 21, dev)
    loss = tt.make_train_step(cfg, opt)(params, inp, tgt).item()
    grads = {k: ({kk: vv.grad for kk, vv in v.items()} if isinstance(v, dict)
                 else v.grad) for k, v in params.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-sharded-") as d:
        ref = str(Path(d) / "reference.pt")
        torch.save({"grads": grads, "params": params}, ref)
        del params, opt, grads
        torch.cuda.empty_cache()
        cases = [{"kind": "mesh", "mesh": meshes[0][0]}] + [
            {"kind": "train", "mesh": mesh,
             "cfg": dataclasses.replace(cfg, seq_schedule=sched),
             "seed": SEED + 20, "batch_shape": (B, S),
             "batch_seed": SEED + 21, "reference": ref}
            for mesh, sched in meshes]
        t0 = time.perf_counter()
        res = launch.spawn_ranks(jobs.run_cases, 4, backend="gloo",
                                 device=dev, timeout_s=300,
                                 args=(cases, dev.type))
    print(f"sharded exact: 4 ranks ({SHARED}) in "
          f"{time.perf_counter() - t0:.1f} s; a rank imported jax: "
          f"{[r[0]['jax_loaded'] for r in res]}")
    check(not any(r[0]["jax_loaded"] for r in res), "a rank imported jax")
    for i, (mesh, sched) in enumerate(meshes, 1):
        got = [r[i] for r in res]
        rel = max(abs(g["losses"][0] - loss) for g in got) / abs(loss)
        worst = {k: max(g[k] for g in got)
                 for k in ("grad_err", "param_err", "param_err_all")}
        print(f"sharded exact {mesh} {sched} (llama-1b width, 2 layers, f32,"
              f" B={B} S={S}): loss {got[0]['losses'][0]!r} vs {loss!r} rel "
              f"{rel:.3g} (tol 1e-5); worst gradient leaf "
              f"{worst['grad_err']:.3g} of its largest (tol 1e-4); params "
              f"{worst['param_err']:.3g} where |g| >= 1e-7 (tol 1e-5; "
              f"{worst['param_err_all']:.3g} over all: AdamW's first update "
              f"is ±lr where the gradient's sign follows the summation "
              f"order); launches a rank "
              f"{[{k: g['launches'][k] for k in SHARDED_KERNELS} for g in got]}")
        check(rel <= 1e-5, f"sharded {mesh} {sched}: loss rel {rel}")
        check(worst["grad_err"] <= 1e-4,
              f"sharded {mesh} {sched}: gradients {worst['grad_err']}")
        check(worst["param_err"] <= 1e-5,
              f"sharded {mesh} {sched}: params {worst['param_err']}")


def phase_sharded(torch, tl, jobs, launch, dev):
    """Full-width Llama-1B at SHARDED_LAYERS layers (bf16, f32 masters,
    remat, flash, B=8, S=2048): at sp=2 over 2 ranks, ring then zigzag,
    and at (sp=2, tp=2) over 4 ranks, SHARDED_WARM + SHARDED_STEPS steps
    each, every rank on the one card."""
    cfg = dataclasses.replace(tl.PRESETS["llama-1b"], attn_impl="flash",
                              remat=True, n_layers=SHARDED_LAYERS)
    L, steps = cfg.n_layers, SHARDED_STEPS
    by_path, report = {}, {}
    for ranks, mesh, scheds in SHARDED_FULL:
        cases = [{"kind": "train", "mesh": mesh,
                  "cfg": dataclasses.replace(cfg, seq_schedule=sched),
                  "seed": SEED + 22, "batch_shape": SHARDED_SHAPE,
                  "warm": SHARDED_WARM, "steps": steps} for sched in scheds]
        t0 = time.perf_counter()
        res = launch.spawn_ranks(jobs.run_cases, ranks, backend="gloo",
                                 device=dev, timeout_s=400,
                                 args=(cases, dev.type))
        wall = time.perf_counter() - t0
        for i, sched in enumerate(scheds):
            key = sched if ranks == 2 else f"{sched}_sp2_tp2"
            got = [r[i] for r in res]
            row = {"ranks": ranks, "mesh": mesh, "layers": L,
                   "batch": SHARDED_SHAPE, "losses": got[0]["losses"],
                   "step_ms_by_rank": [g["step_ms"] for g in got],
                   "staged_bytes_a_step_by_rank": [g["staged_bytes"]
                                                   for g in got],
                   "collective_s_by_rank": [g["comm_s"] for g in got],
                   "peak_gib_by_rank": [(g["peak_bytes"] or 0) / 2**30
                                        for g in got],
                   "launches_a_step_by_rank": [
                       {k: g["launches"][k] / steps for k in SHARDED_KERNELS}
                       for g in got],
                   "what": SHARED}
            report[key] = row
            print(f"sharded llama-1b {key} ({ranks} {SHARED}; "
                  f"{wall:.1f} s for the world): {json.dumps(row)}")
            losses = got[0]["losses"]
            check(all(x == x and abs(x) < float("inf") for x in losses),
                  f"sharded {key}: a loss is not finite")
            check(losses[-1] < losses[SHARDED_WARM] < losses[0],
                  f"sharded {key}: loss did not fall: {losses}")
            check(all(g["losses"] == losses for g in got),
                  f"sharded {key}: ranks disagree on the loss")
            n_seq = mesh["sp"]
            for g in got:
                my = g["coords"]["seq"]
                want = sharded_launches(L, n_seq, my, sched == "zigzag")
                for k, n in want.items():
                    check(g["launches"][k] == n * steps,
                          f"sharded {key} seq rank {my}: {k} launched "
                          f"{g['launches'][k]} times in {steps} steps, "
                          f"expected {n * steps}")
            by_path[key] = {k: [g["launches"][k] for g in got]
                            for k in SHARDED_KERNELS}
    return by_path, report


# phase 13: the pipelined and expert-parallel steps, their ranks sharing the
# one card over gloo. (label, B, S, Hq, Hkv) of their flash calls at full
# size: Llama-1B's pipeline microbatch (B = 8 / n_micro) at 16/8 heads and
# at 8/4 (tp 2 within a stage); mixtral-ish at the expert ranks' batch
# block (the batch is replicated over expert: B 4) at 16/8 and 8/4. Every
# call is causal with no lse cotangent (no ring on these paths).
PARALLEL_CALLS = (("pipeline", 2, 2048, 16, 8),
                  ("pipeline_tp2", 2, 2048, 8, 4),
                  ("expert", 4, 2048, 16, 8), ("expert_tp2", 4, 2048, 8, 4))
# the exact runs of one 4-rank world, one step each at llama-1b / mixtral-ish
# width in f32 (flash) against one single-process step: (name, kind, mesh,
# layers, n_chunks, seq_schedule); the MoE runs at capacity factor
# OVERFLOW_CF (64 slots an expert and row for 128 claims on average: half
# the choices drop), the batch B 4, S 512 with n_micro 2
PARALLEL_EXACT = (("pp2_dp2", "pipeline", {"pp": 2}, 2, 1, "ring"),
                  ("pp2_tp2", "pipeline", {"pp": 2, "tp": 2}, 2, 1, "ring"),
                  ("pp2_tp2_interleaved", "pipeline", {"pp": 2, "tp": 2}, 4,
                   2, "ring"),
                  ("pp2_sp2", "pipeline", {"pp": 2, "sp": 2}, 2, 1, "ring"),
                  ("ep2_tp2", "moe", {"ep": 2, "tp": 2}, 2, 1, "ring"),
                  ("dp2_ep2", "moe", {"ep": 2}, 2, 1, "ring"),
                  ("sp2_ep2_zigzag", "moe", {"sp": 2, "ep": 2}, 2, 1,
                   "zigzag"))
PARALLEL_EXACT_SHAPE, PARALLEL_MICRO, OVERFLOW_CF = (4, 512), 2, 0.5
# the full-size runs: (ranks, name, kind, mesh, n_chunks). Llama-1B at
# SHARDED_LAYERS of its 16 layers as bench.py:213-267 trains it (B 8, S
# 2048, bf16, flash, AdamW; no remat: the pipeline's stage body has none)
# with n_micro 4; mixtral-ish at EXPERT_LAYERS of 16 layers with remat, B 4,
# S 2048, as phase 11 trains it (2, for the script's time; SHARDED_LAYERS
# stays 4, the interleaved pipeline's pp 2 × n_chunks 2)
PARALLEL_FULL = ((2, "pp2", "pipeline", {"pp": 2}, 1),
                 (2, "pp2_interleaved", "pipeline", {"pp": 2}, 2),
                 (2, "ep2", "moe", {"ep": 2}, 1),
                 (4, "pp2_tp2", "pipeline", {"pp": 2, "tp": 2}, 1),
                 (4, "ep2_tp2", "moe", {"ep": 2, "tp": 2}, 1))
PIPELINE_SHAPE, PIPELINE_MICRO = (8, 2048), 4
EXPERT_SHAPE, EXPERT_LAYERS = (4, 2048), 2


def parallel_launches(kind, cfg, n_stages):
    """Predicted launches a step of one rank at full size: a pipeline stage
    applies its n_layers / n_stages layers to each of PIPELINE_MICRO
    microbatches once forward and once backward (the ramp's garbage ticks
    compute nothing, and there is no remat); an expert rank attends its
    whole batch block in every layer, twice forward under remat."""
    if kind == "pipeline":
        calls = PIPELINE_MICRO * cfg.n_layers // n_stages
        return {k: calls for k in SHARDED_KERNELS}
    L = cfg.n_layers
    return {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}


def parallel_cases(tl, tm):
    """(exact configs {name: cfg}, full-size configs {kind: cfg})."""
    llama = dataclasses.replace(tl.PRESETS["llama-1b"], attn_impl="flash")
    mixtral = dataclasses.replace(tm.PRESETS_MOE["mixtral-ish"],
                                  attn_impl="flash")
    exact = {"llama2": dataclasses.replace(llama, n_layers=2,
                                           dtype="float32"),
             "llama4": dataclasses.replace(llama, n_layers=4,
                                           dtype="float32"),
             "mixtral2": dataclasses.replace(mixtral, n_layers=2,
                                             dtype="float32",
                                             capacity_factor=OVERFLOW_CF)}
    full = {"pipeline": dataclasses.replace(llama, n_layers=SHARDED_LAYERS),
            "moe": dataclasses.replace(mixtral, n_layers=EXPERT_LAYERS,
                                       remat=True)}
    return exact, full


def exact_key(kind, layers):
    """The exact run's config and reference, by parallel_cases' names."""
    return "mixtral2" if kind == "moe" else f"llama{layers}"


def parallel_reference(torch, tm, tt, jobs, cfg, dev, path,
                       shape=PARALLEL_EXACT_SHAPE):
    """One single-process step of ``cfg`` from the exact runs' seed and
    batch (of ``shape``), saved to ``path`` as {"grads", "params"};
    returns its loss."""
    g = torch.Generator(dev).manual_seed(SEED + 30)
    moe = isinstance(cfg, tm.MoEConfig)
    params, opt = (tm.make_moe_train_state(cfg, g, dev) if moe
                   else tt.make_train_state(cfg, g, dev))
    step = (tm.make_moe_train_step if moe else tt.make_train_step)(cfg, opt)
    inp, tgt = jobs.seeded_batch(cfg, *shape, SEED + 31, dev)
    loss = step(params, inp, tgt).item()

    def grads(tree):
        return {k: grads(v) if isinstance(v, dict) else v.grad
                for k, v in tree.items()}

    torch.save({"grads": grads(params), "params": params}, path)
    del params, opt
    torch.cuda.empty_cache()
    return loss


def held_exact(name, got, loss, shape=PARALLEL_EXACT_SHAPE):
    """Prints and checks one exact run's ranks against the single-process
    step's ``loss`` (and, on the ranks, its gradients and params)."""
    rel = max(abs(g["losses"][0] - loss) for g in got) / abs(loss)
    worst = {k: max(g[k] for g in got)
             for k in ("grad_err", "param_err", "param_err_all")}
    print(f"parallel exact {name} (f32, B={shape[0]} S={shape[1]}): loss "
          f"{got[0]['losses'][0]!r} vs "
          f"{loss!r} rel {rel:.3g} (tol 1e-5); worst gradient leaf "
          f"{worst['grad_err']:.3g} of its largest (tol 1e-4); params "
          f"{worst['param_err']:.3g} where |g| >= 1e-7 (tol 1e-5; "
          f"{worst['param_err_all']:.3g} over all); launches a rank "
          f"{[{k: g['launches'][k] for k in SHARDED_KERNELS} for g in got]}")
    check(rel <= 1e-5, f"parallel exact {name}: loss rel {rel}")
    check(worst["grad_err"] <= 1e-4,
          f"parallel exact {name}: gradients {worst['grad_err']}")
    check(worst["param_err"] <= 1e-5,
          f"parallel exact {name}: params {worst['param_err']}")


def held_full(name, kind, ranks, mesh, cfg, got, wall, steps):
    """Prints one full-size run and checks its falling loss, its ranks'
    agreement and each rank's launches a step against parallel_launches;
    returns its report row."""
    shape = PIPELINE_SHAPE if kind == "pipeline" else EXPERT_SHAPE
    row = {"ranks": ranks, "mesh": mesh, "layers": cfg.n_layers,
           "batch": shape, "losses": got[0]["losses"],
           "step_ms_by_rank": [g["step_ms"] for g in got],
           "staged_bytes_a_step_by_rank": [g["staged_bytes"] for g in got],
           "collective_s_by_rank": [g["comm_s"] for g in got],
           "peak_gib_by_rank": [(g["peak_bytes"] or 0) / 2**30 for g in got],
           "launches_a_step_by_rank": [
               {k: g["launches"][k] / steps for k in SHARDED_KERNELS}
               for g in got],
           "what": SHARED}
    if kind == "pipeline":
        row["n_micro"] = PIPELINE_MICRO
    print(f"parallel {cfg.n_layers}-layer {name} ({ranks} {SHARED}; "
          f"{wall:.1f} s for the world): {json.dumps(row)}")
    losses = got[0]["losses"]
    check(all(x == x and abs(x) < float("inf") for x in losses),
          f"parallel {name}: a loss is not finite")
    check(losses[-1] < losses[SHARDED_WARM] < losses[0],
          f"parallel {name}: loss did not fall: {losses}")
    check(all(g["losses"] == losses for g in got),
          f"parallel {name}: ranks disagree on the loss")
    want = parallel_launches(kind, cfg, mesh.get("pp", 1))
    for g in got:
        for k, n in want.items():
            check(g["launches"][k] == n * steps,
                  f"parallel {name} rank {g['coords']}: {k} launched "
                  f"{g['launches'][k]} times in {steps} steps, expected "
                  f"{n * steps}")
    return row


def phase_parallel(torch, tl, tm, tt, jobs, launch, dev):
    """The exact runs (PARALLEL_EXACT, one step each against the
    single-process step, saved for the ranks to cut) and the full-size
    runs of PARALLEL_FULL over 4 ranks in one world, then those over 2
    ranks in another; returns ({"pipeline": {name: launches by rank},
    "expert": {...}} a kernel, the report)."""
    exact, full = parallel_cases(tl, tm)
    steps = SHARDED_STEPS
    shared = {"warm": SHARDED_WARM, "steps": steps, "seed": SEED + 32}

    def full_case(kind, mesh, n_chunks):
        cfg = full[kind]
        shape = PIPELINE_SHAPE if kind == "pipeline" else EXPERT_SHAPE
        case = {"kind": kind, "mesh": mesh, "cfg": cfg, "batch_shape": shape,
                **shared}
        if kind == "pipeline":
            case.update(n_micro=PIPELINE_MICRO, n_chunks=n_chunks)
        return case

    by_path, report = {"pipeline": {}, "expert": {}}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-parallel-") as d:
        losses, paths = {}, {}
        t0 = time.perf_counter()
        for name, cfg in exact.items():
            paths[name] = str(Path(d) / f"{name}.pt")
            losses[name] = parallel_reference(torch, tm, tt, jobs, cfg, dev,
                                              paths[name])
        print(f"parallel references (single process): "
              f"{time.perf_counter() - t0:.1f} s")
        cases = []
        for name, kind, mesh, layers, n_chunks, sched in PARALLEL_EXACT:
            key = exact_key(kind, layers)
            cases.append({"kind": kind, "mesh": mesh,
                          "cfg": dataclasses.replace(exact[key],
                                                     seq_schedule=sched),
                          "seed": SEED + 30,
                          "batch_shape": PARALLEL_EXACT_SHAPE,
                          "batch_seed": SEED + 31, "reference": paths[key],
                          "n_micro": PARALLEL_MICRO, "n_chunks": n_chunks})
        fours = [f for f in PARALLEL_FULL if f[0] == 4]
        cases += [full_case(kind, mesh, nc) for _, _, kind, mesh, nc in fours]
        t0 = time.perf_counter()
        res = launch.spawn_ranks(jobs.run_cases, 4, backend="gloo",
                                 device=dev, timeout_s=900,
                                 args=(cases, dev.type))
        wall = time.perf_counter() - t0
    for i, (name, kind, mesh, layers, _, _) in enumerate(PARALLEL_EXACT):
        held_exact(f"{name} {mesh}", [r[i] for r in res],
                   losses[exact_key(kind, layers)])
    results = {f[1]: [r[len(PARALLEL_EXACT) + i] for r in res]
               for i, f in enumerate(fours)}
    walls = {f[1]: wall for f in fours}
    twos = [f for f in PARALLEL_FULL if f[0] == 2]
    t0 = time.perf_counter()
    res = launch.spawn_ranks(
        jobs.run_cases, 2, backend="gloo", device=dev, timeout_s=900,
        args=([full_case(kind, mesh, nc) for _, _, kind, mesh, nc in twos],
              dev.type))
    wall = time.perf_counter() - t0
    results.update({f[1]: [r[i] for r in res] for i, f in enumerate(twos)})
    walls.update({f[1]: wall for f in twos})
    for ranks, name, kind, mesh, _ in PARALLEL_FULL:
        got = results[name]
        report[name] = held_full(name, kind, ranks, mesh, full[kind], got,
                                 walls[name], steps)
        path = "pipeline" if kind == "pipeline" else "expert"
        by_path[path][name] = {k: [g["launches"][k] for g in got]
                               for k in SHARDED_KERNELS}
    return by_path, report


# phase 14: sharded serving, the ranks sharing the one card over gloo. The
# per-rank attention shapes (Hq, Hkv) of the serving meshes: Llama-7B at
# tp=2 (16/4) and mixtral-ish at (ep=2, tp=2) (8/4); at ep=2 alone the
# attention stays whole (16/8: phase 9's shape)
SERVE_TP_HEADS = {"llama-7b tp2": (16, 4), "mixtral-ish ep2 tp2": (8, 4)}
SERVE_KERNEL_ROWS = ("flash_fwd", "flash_cached", "flash_cached_int8",
                     "flash_decode", "flash_decode_int8")
# the exact runs (f32, 2 layers): B, S0, new tokens, max_len, spec_k
SERVE_EXACT = (4, 256, 8, 384, 4)
# the full-size runs, as phase 4 serves: B, S0, new tokens, max_len
SERVE_FULL = (2, 512, 32, 1024)
# engine passes after the warm one: one keeps the script inside its time
# limit as it grows (every pass is checked alike)
SERVE_PASSES = 1
# Llama-7B's depth at tp=2 in the full-size runs, 4 of its 32 layers, and
# mixtral-ish's at ep=2, 8 of its 16, which keep the script inside its
# time limit with phases 17-22 (at 32 the tp=2 world took 60-100 s of the
# phase, at 16 with mixtral-ish's ep=2 82 s, at 8 and 16 ~98 s on a slow
# host; every launch count follows the layers)
SERVE_TP_LAYERS, SERVE_EP_LAYERS = 4, 8


def serve_launches(L, new, fresh, int8):
    """Predicted launches of one rank's generate: the prefill's L (#1 on a
    fresh cache, else #4) and (new - 1)·L of #5, on the int8 instances
    with an int8 cache."""
    sfx = "_int8" if int8 else ""
    return {"flash_fwd" if fresh else "flash_cached" + sfx: L,
            "flash_decode" + sfx: (new - 1) * L}


def is_int8(prog):
    return prog.get("cfg", {}).get("kv_cache_dtype") == "int8"


def phase_serve_kernels(torch, tfa, td, dev, deferred):
    """#1, #4 and #5 at the sharded serving path's per-rank shapes
    (SERVE_TP_HEADS, D 128) against their plain versions, in bf16 and f32,
    #4 and #5 on a plain and an int8 cache: generate's fresh prefill (B=2,
    S=512, #1 at 16/4 only: the MoE family has no fresh path), its ragged
    prefill (B=2, S=512, pads 0 and 200, ML 1024) and decode step (B=2,
    starts 530 and 700, the same pads), an engine admission after a
    cached prefix (B=1, S=256 at 128, pad 28, ML 2048, 16/4); the bf16
    calls timed beside their plain versions, SDPA and their bounds (device
    times deferred). Returns ({row: {label: entry}}, {row: worst bf16
    error})."""
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(SEED + 40)
    D, bf = 128, torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    errs = dict.fromkeys(SERVE_KERNEL_ROWS, 0.0)
    entries = {r: {} for r in SERVE_KERNEL_ROWS}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def fresh(label, dtype, Hq, Hkv, B, S):
        q = rnd(B, S, Hq, D, dtype=dtype)
        k, v = rnd(B, S, Hkv, D, dtype=dtype), rnd(B, S, Hkv, D, dtype=dtype)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        kernel = lambda: tfa.flash_attention_with_lse(q, k, v)
        plain = lambda: tfa.attention_plain(q, kh, vh, 0)
        out, lse = kernel()
        ref, rlse = plain()
        e = (out.float() - ref.float()).abs().max().item()
        el = (lse - rlse).abs().max().item()
        tol = TOL[str(dtype).split(".")[1]]
        print(f"flash_fwd {dtype} at the {label} rank's shape B={B} S={S} "
              f"Hq={Hq} Hkv={Hkv}: max|out-plain| {e:.3g}, |lse-plain| "
              f"{el:.3g} (tol {tol}, 1e-4)")
        check(e <= tol and el <= 1e-4,
              f"flash_fwd disagrees with plain at the {label} shape")
        if dtype != bf:
            return
        errs["flash_fwd"] = max(errs["flash_fwd"], e)
        library = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kh, vh, is_causal=True, enable_gqa=True)
        entry = {"shape": f"B={B} S={S} Hq={Hq} Hkv={Hkv}, self-attention",
                 "max_abs_err": e,
                 **timing(kernel, plain, library,
                          work(B, S, Hq, Hkv, D, S, 0, None, None, 0, True,
                               2, 2, False, True), flush)}
        entries["flash_fwd"][f"{label} fresh prefill"] = entry
        deferred.append((entry, kernel, library, ("flash_fwd_tc_kernel",)))

    def cached(label, what, dtype, Hq, Hkv, B, S, start, pads, ML):
        q = rnd(B, S, Hq, D, dtype=dtype)
        kc, vc = (rnd(B, Hkv, ML, D, dtype=dtype) for _ in range(2))
        pl = torch.tensor(pads, dtype=torch.int32, device=dev)
        st = (torch.tensor(start, dtype=torch.int32, device=dev)
              if isinstance(start, list) else start)
        name = "flash_decode" if S <= tfa.DECODE_MAX_S else "flash_cached"
        fn = getattr(tfa, "flash_attention_" + name.split("_")[1])
        kp = torch.arange(ML, device=dev)
        qp = torch.as_tensor(st, device=dev).reshape(-1, 1) \
            + torch.arange(S, device=dev)
        mask = ((kp <= qp[..., None]) & (kp >= pl[:, None, None]))[:, None]
        for int8 in (False, True):
            kw = {"pad_lens": pl}
            k_, v_ = kc, vc
            if int8:
                (k_, kw["k_scale"]), (v_, kw["v_scale"]) = \
                    td._quantize_kv(kc), td._quantize_kv(vc)
            row = name + ("_int8" if int8 else "")
            kernel = (lambda k_=k_, v_=v_, kw=kw: fn(q, k_, v_, st, **kw))
            plain = (lambda k_=k_, v_=v_, kw=kw:
                     tfa.attention_plain(q, k_, v_, st, **kw)[0])
            e = (kernel().float() - plain().float()).abs().max().item()
            tol = TOL[str(dtype).split(".")[1]]
            print(f"{row} {dtype} at the {label} rank's {what} B={B} S={S}"
                  f" start={start} pads={pads} Hq={Hq} Hkv={Hkv} ML={ML}: "
                  f"max|out-plain| {e:.3g} (tol {tol})")
            check(e <= tol, f"{row} disagrees with plain at the {label} "
                  f"{what} shape")
            if dtype != bf:
                continue
            errs[row] = max(errs[row], e)
            library = None if int8 else (
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kc, vc, attn_mask=mask,
                    enable_gqa=True))
            entry = {"shape": f"B={B} S={S} start={start} pads={pads} "
                              f"Hq={Hq} Hkv={Hkv} ML={ML}",
                     "max_abs_err": e,
                     **timing(kernel, plain, library,
                              work(B, S, Hq, Hkv, D, ML, st, pl, None, 0,
                                   True, 2, 1 if int8 else 2, int8, False),
                              flush)}
            if library is None:
                entry["library_note"] = "no single PyTorch call attends " \
                                        "over an int8 cache"
            entries[row][f"{label} {what}"] = entry
            deferred.append((entry, kernel, library,
                             ("flash_fwd_tc_kernel",) if S > 16
                             else ("flash_decode",)))

    for dtype in (bf, torch.float32):
        for label, (Hq, Hkv) in SERVE_TP_HEADS.items():
            if label.startswith("llama"):
                fresh(label, dtype, Hq, Hkv, 2, 512)
                cached(label, "admission", dtype, Hq, Hkv, 1, 256, 128,
                       [28], 2048)
            cached(label, "ragged prefill", dtype, Hq, Hkv, 2, 512, 0,
                   [0, 200], 1024)
            cached(label, "decode step", dtype, Hq, Hkv, 2, 1, [530, 700],
                   [0, 200], 1024)
    torch.cuda.synchronize()
    for row, by in entries.items():
        for label, entry in by.items():
            print(f"{row} at {label}: {json.dumps(entry)}")
    del flush
    return entries, errs


def serve_exact_programs(cfg, moe):
    """The exact runs' programs (SERVE_EXACT) and the request stream of the
    dense engine: numpy prompts from seed SEED + 41."""
    import numpy as np
    B, S0, new, ML, K = SERVE_EXACT
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 41)
    prompt = rng.integers(1, V, (B, S0), dtype=np.int32)
    padded = prompt.copy()
    padded[1, :100] = 0
    padded[2, :37] = 0
    progs = [{"name": "padded", "kind": "generate", "prompt": padded,
              "new": new, "max_len": ML, "pad_id": 0},
             {"name": "int8", "kind": "generate", "prompt": padded,
              "new": new, "max_len": ML, "pad_id": 0,
              "cfg": {"kv_cache_dtype": "int8"}}]
    if moe:
        return progs
    prefix = rng.integers(1, V, (90,)).tolist()
    reqs = [(rng.integers(1, V, (n,)).tolist(), new, pre)
            for n, pre in ((100, None), (230, None), (60, prefix),
                           (150, None), (40, prefix))]
    return [{"name": "fresh", "kind": "generate", "prompt": prompt,
             "new": new, "max_len": ML}] + progs + [
        {"name": "spec", "kind": "speculative", "prompt": prompt,
         "new": new, "max_len": ML, "spec_k": K},
        {"name": "engine", "kind": "engine", "requests": reqs, "slots": 2,
         "max_len": 1024, "buckets": (128, 256)}]


def serve_single(torch, td, ts, params, cfg, progs, dev):
    """The single-process port's tokens of each program (the engine's:
    generate on each request alone)."""
    out = {}
    for p in progs:
        c = dataclasses.replace(cfg, **p.get("cfg", {}))
        if p["kind"] == "engine":
            out[p["name"]] = [
                td.generate(params, torch.tensor([(pre or []) + t]), c,
                            max_new_tokens=n, max_len=p["max_len"],
                            device=dev)[0].tolist()
                for t, n, pre in p["requests"]]
            continue
        x = torch.from_numpy(p["prompt"]).to(dev)
        if p["kind"] == "speculative":
            out[p["name"]] = ts.speculative_generate(
                params, params, x, c, c, max_new_tokens=p["new"],
                spec_k=p["spec_k"], max_len=p["max_len"],
                device=dev)[0].cpu().numpy()
        else:
            out[p["name"]] = td.generate(
                params, x, c, max_new_tokens=p["new"], max_len=p["max_len"],
                pad_id=p.get("pad_id"), device=dev).cpu().numpy()
    return out


def held_serving(name, prog, ranks, want, L, new):
    """Checks every rank's tokens of one program against the single-process
    ``want`` and a generate program's launches against serve_launches;
    returns the launches by rank."""
    import numpy as np
    for r in ranks:
        got = r["programs"][prog["name"]]
        if prog["kind"] == "engine":
            check(got["out"] == want, f"{name} {prog['name']} rank "
                  f"{r['coords']}: engine streams {got['out']} != "
                  f"generate {want}")
        else:
            rows = slice(*got["rows"])
            check(np.array_equal(got["out"], want[rows]),
                  f"{name} {prog['name']} rank {r['coords']}: "
                  f"{got['out'].tolist()} != {want[rows].tolist()}")
        if prog["kind"] == "generate":
            expect = serve_launches(L, new, prog.get("pad_id") is None,
                                    is_int8(prog))
            for k in SERVE_KERNEL_ROWS:
                check(got["launches"][k] == expect.get(k, 0) * len(got["ms"]),
                      f"{name} {prog['name']} rank {r['coords']}: {k} "
                      f"launched {got['launches'][k]}, expected "
                      f"{expect.get(k, 0) * len(got['ms'])}")
    return [{k: r["programs"][prog["name"]]["launches"][k]
             for k in SERVE_KERNEL_ROWS} for r in ranks]


def phase_serve_exact(torch, tl, tm, td, ts, jobs, launch, dev):
    """Llama-7B width and mixtral-ish width, 2 layers, f32, flash (the
    kernels' f32 instances): generate fresh, left-padded and left-padded on
    an int8 cache, self-draft speculative_generate and a ServeEngine with a
    cached prefix on tp=2 (data 2 × model 2), then left-padded generate on
    both caches for the MoE model on ep=2 (data 2 × expert 2) and (ep=2,
    tp=2), one 4-rank world; every rank's tokens equal this process's
    single-process run (speculation plain greedy's too) and each
    generate's launches the prediction. Returns {run: launches by rank}."""
    import numpy as np
    llama = dataclasses.replace(tl.PRESETS["llama-7b"], n_layers=2,
                                dtype="float32", attn_impl="flash")
    mixtral = dataclasses.replace(tm.PRESETS_MOE["mixtral-ish"], n_layers=2,
                                  dtype="float32", attn_impl="flash")
    runs = {}
    for key, cfg, moe in (("llama", llama, False), ("mixtral", mixtral,
                                                    True)):
        progs = serve_exact_programs(cfg, moe)
        g = torch.Generator(dev).manual_seed(SEED + 42)
        params = (tm.init_moe_model if moe else tl.init_params)(cfg, g, dev)
        t0 = time.perf_counter()
        runs[key] = (cfg, progs, serve_single(torch, td, ts, params, cfg,
                                              progs, dev))
        print(f"serving exact {key}: single process "
              f"{time.perf_counter() - t0:.1f} s")
        del params
        torch.cuda.empty_cache()
    cases = [{"kind": "mesh", "mesh": {"tp": 2}},
             {"kind": "serving", "mesh": {"tp": 2}, "cfg": llama,
              "programs": runs["llama"][1], "seed": SEED + 42}]
    meshes = {"ep2": {"ep": 2}, "ep2_tp2": {"ep": 2, "tp": 2}}
    cases += [{"kind": "serving_moe", "mesh": m, "cfg": mixtral,
               "programs": runs["mixtral"][1], "seed": SEED + 42}
              for m in meshes.values()]
    t0 = time.perf_counter()
    res = launch.spawn_ranks(jobs.run_cases, 4, backend="gloo", device=dev,
                             timeout_s=400, args=(cases, dev.type))
    print(f"serving exact: 4 ranks ({SHARED}) in "
          f"{time.perf_counter() - t0:.1f} s; a rank imported jax: "
          f"{[r[0]['jax_loaded'] for r in res]}")
    check(not any(r[0]["jax_loaded"] for r in res), "a rank imported jax")
    B, S0, new = SERVE_EXACT[:3]
    launches = {}
    for i, (name, key) in enumerate((("tp2", "llama"), ("ep2", "mixtral"),
                                     ("ep2_tp2", "mixtral")), 1):
        cfg, progs, want = runs[key]
        ranks = [r[i] for r in res]
        for prog in progs:
            launches[f"{name} {prog['name']}"] = held_serving(
                name, prog, ranks, want[prog["name"]], cfg.n_layers, new)
        print(f"serving exact {name} ({key} width, 2 layers, f32, B={B} "
              f"S0={S0} new={new}): every rank's tokens == the single "
              f"process's in {[p['name'] for p in progs]}")
    plain = runs["llama"][2]["fresh"]
    for r in res:
        spec = r[1]["programs"]["spec"]
        check(np.array_equal(spec["out"], plain[slice(*spec["rows"])]),
              f"rank {r[1]['coords']}: sharded speculative != plain greedy")
    for prog in ("spec", "engine"):
        print(f"serving exact tp2 {prog}: launches by rank "
              f"{launches['tp2 ' + prog]}")
    return launches


def serve_full_programs(cfg, moe):
    """The full-size programs (SERVE_FULL; phase 4's and phase 9's
    shapes): left-padded generate on both caches (and fresh, dense family),
    then SERVE_PASSES ServeEngine passes of 6 requests after a warm one
    (one shared prefix, dense family)."""
    import numpy as np
    B, S0, new, ML = SERVE_FULL
    rng = np.random.default_rng(SEED + 43)
    V = cfg.vocab_size
    prompt = rng.integers(1, V, (B, S0), dtype=np.int32)
    padded = prompt.copy()
    padded[1, :200] = 0
    prefix = None if moe else rng.integers(1, V, (100,)).tolist()
    reqs = [(rng.integers(1, V, (n,)).tolist(), new, pre)
            for n, pre in ((180, None), (500, None), (120, prefix),
                           (350, None), (100, None), (230, prefix))]
    progs = [] if moe else [{"name": "fresh", "kind": "generate",
                             "prompt": prompt, "new": new, "max_len": ML}]
    return progs + [
        {"name": "padded", "kind": "generate", "prompt": padded, "new": new,
         "max_len": ML, "pad_id": 0},
        {"name": "int8", "kind": "generate", "prompt": padded, "new": new,
         "max_len": ML, "pad_id": 0, "cfg": {"kv_cache_dtype": "int8"}},
        {"name": "engine", "kind": "engine", "requests": reqs, "slots": 4,
         "max_len": 2048, "buckets": (128, 256, 512), "warm": 1,
         "runs": SERVE_PASSES}]


def phase_serve_full(torch, tl, tm, jobs, launch, dev):
    """Llama-7B at full width and SERVE_TP_LAYERS of its 32 layers in bf16
    at tp=2 and mixtral-ish at full width and SERVE_EP_LAYERS of its 16
    layers at ep=2, each over 2 ranks
    sharing the card: serve_full_programs'
    runs, each generate's launches against serve_launches, every engine
    pass's #4 launches one L a request (its prefix cached in the warm pass)
    and its #5 a multiple of L; tokens/s, bytes staged and seconds in the
    collectives a forward, and peak memory a rank. Returns (launches by
    path, the report)."""
    import numpy as np
    B, _, new, _ = SERVE_FULL
    runs = (("tp_serving", "serving", dataclasses.replace(
                tl.PRESETS["llama-7b"], attn_impl="flash",
                n_layers=SERVE_TP_LAYERS), {"tp": 2}),
            ("ep_serving", "serving_moe", dataclasses.replace(
                tm.PRESETS_MOE["mixtral-ish"], attn_impl="flash",
                n_layers=SERVE_EP_LAYERS), {"ep": 2}))
    cases = [{"kind": kind, "mesh": mesh, "cfg": cfg, "seed": SEED,
              "programs": serve_full_programs(cfg, kind == "serving_moe")}
             for _, kind, cfg, mesh in runs]
    t0 = time.perf_counter()
    res = launch.spawn_ranks(jobs.run_cases, 2, backend="gloo", device=dev,
                             timeout_s=900, args=(cases, dev.type))
    wall = time.perf_counter() - t0
    by_path, report = {}, {}
    for i, (path, kind, cfg, mesh) in enumerate(runs):
        progs = cases[i]["programs"]
        ranks = [r[i] for r in res]
        L = cfg.n_layers
        by_path[path] = {}
        for prog in progs:
            got = [r["programs"][prog["name"]] for r in ranks]
            runs = len(got[0]["ms"])
            if prog["kind"] == "generate":
                for g in got:
                    out = g["out"]
                    check(out.shape == (B, new) and bool(((out >= 0) & (
                        out < cfg.vocab_size)).all()),
                          f"{path} {prog['name']}: {out.shape}")
                check(all(np.array_equal(g["out"], got[0]["out"])
                          for g in got),
                      f"{path} {prog['name']}: the ranks' rows differ")
                expect = serve_launches(L, new, prog.get("pad_id") is None,
                                        is_int8(prog))
                tokens, forwards = B * new * runs, new * runs
            else:
                reqs = prog["requests"]
                expect = {"flash_cached": L * len(reqs) * runs}
                for g in got:
                    check(g["out"] == got[0]["out"] and all(
                        len(s) == n for s, (_, n, _) in zip(g["out"], reqs)),
                          f"{path} engine streams {g['out']}")
                    check(g["launches"]["flash_decode"] % L == 0
                          and g["launches"]["flash_decode"] > 0,
                          f"{path} engine: flash_decode "
                          f"{g['launches']['flash_decode']}")
                tokens = sum(n for _, n, _ in reqs) * runs
                forwards = None
            for g in got:
                for k in SERVE_KERNEL_ROWS:
                    if k == "flash_decode" and prog["kind"] == "engine":
                        continue
                    check(g["launches"][k] == expect.get(k, 0),
                          f"{path} {prog['name']}: {k} launched "
                          f"{g['launches'][k]}, expected {expect.get(k, 0)}")
            ms = sum(got[0]["ms"])
            row = {"ranks": 2, "mesh": mesh, "layers": L, "runs": runs,
                   "ms_by_run": got[0]["ms"],
                   "tokens_per_s": tokens / ms * 1e3,
                   "staged_bytes_by_rank": [g["staged_bytes"] for g in got],
                   "collective_s_by_rank": [g["comm_s"] for g in got],
                   "peak_gib_by_rank": [(g["peak_bytes"] or 0) / 2**30
                                        for g in got],
                   "launches_by_rank": [{k: g["launches"][k]
                                         for k in SERVE_KERNEL_ROWS}
                                        for g in got],
                   "what": SHARED}
            if forwards:
                row["staged_bytes_a_forward"] = got[0]["staged_bytes"] \
                    / forwards
                row["collective_s_a_forward"] = got[0]["comm_s"] / forwards
            else:
                row["engine_stats"] = got[0]["stats"]
            report[f"{path} {prog['name']}"] = row
            by_path[path][prog["name"]] = [
                {k: g["launches"][k] for k in SERVE_KERNEL_ROWS}
                for g in got]
            print(f"{path} {cfg.n_layers}-layer {prog['name']} ({SHARED}; "
                  f"{wall:.1f} s for the world of both paths): "
                  f"{json.dumps(row)}")
    return by_path, report


def phase_serve_surfaces(torch, bench, entry, tfa):
    """entry() on the card, dryrun_multichip(4) with its ranks sharing the
    card, and the four serving bench twins at fast=True with their
    launches. Returns (the twins' dicts, their launches)."""
    fn, (params, tokens) = entry.entry()
    logits = fn(params, tokens)
    check(tuple(logits.shape) == (2, 32, 256)
          and bool(torch.isfinite(logits).all()),
          f"entry(): logits {tuple(logits.shape)}")
    print(f"entry() on the card: logits {tuple(logits.shape)} finite")
    t0 = time.perf_counter()
    entry.dryrun_multichip(4)
    print(f"dryrun_multichip(4) ({SHARED}): {time.perf_counter() - t0:.1f} s")
    twins, launches = {}, {}
    for name in ("bench_decode", "bench_moe_decode", "bench_engine",
                 "bench_cached_prefill"):
        tfa.reset_launches()
        t0 = time.perf_counter()
        twins[name] = getattr(bench, name)(True)
        launches[name] = dict(tfa.LAUNCHES)
        print(f"{name}(fast) in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps(twins[name])}; launches {launches[name]}")
        # bench_moe_decode's fast budget (S0 + new = 144 tokens) tiles at
        # block 144 (_auto_block), in the JAX section as here: its prefill
        # takes #4 (the MoE family has no fresh prefill), its steps #5
        kernels = {"bench_decode": ("flash_fwd", "flash_decode"),
                   "bench_moe_decode": ("flash_cached", "flash_decode"),
                   "bench_engine": ("flash_cached", "flash_decode"),
                   "bench_cached_prefill": ("flash_cached",)}[name]
        check(all(launches[name][k] > 0 for k in kernels),
              f"{name}: launches {launches[name]}")
    check(twins["bench_engine"]["engine_tokens"]
          == sum(8 + 8 * (i % 4) for i in range(bench.ENGINE_SHAPE[True][2])),
          f"bench_engine tokens {twins['bench_engine']}")
    return twins, launches


# phase 15: a save on one mesh restored onto another, the ranks sharing the
# card over gloo. The exact f32 cases of one 4-rank world (llama-1b width:
# 2 layers dense, 4 pipelined), their batch, and the full-width run (8 of
# llama-1b's 16 layers, as phase 12 runs it): save mesh, restore mesh,
# batch
MESH_RESUME_EXACT = (4, 512)
MESH_RESUME_FULL = ({}, {"tp": 2}, SHARDED_SHAPE)
# the flash calls of the step after the full-width restore: the whole
# batch (dp 1) at tp 2, llama-1b's 16/8 heads halved, causal, no ring
RESUME_CALLS = (("resume_tp2", *SHARDED_SHAPE, 8, 4),)


def held_mesh_resume(name, ranks, rtol, atol=0.0):
    """The checks every rank of a mesh-resume case passes: its restored
    leaves bitwise its shards of the saved tree, step and count 1, no CUDA
    tensor in a collective, the restored mesh's next loss within rtol
    (plus atol) of the old mesh's, and every rank's losses equal."""
    for r in ranks:
        first, old, new = r["losses"]
        check(not r["differ"], f"{name}: restored leaves differ from the "
              f"saved shards on {r['coords_restore']}: {r['differ']}")
        check(r["step"] == 1 and r["count"] == 1,
              f"{name}: restored step {r['step']}, count {r['count']}")
        check(not any(r["cuda_collectives"].values()),
              f"{name}: CUDA tensors in collectives "
              f"{r['cuda_collectives']}")
        check(abs(new - old) <= atol + rtol * abs(old),
              f"{name}: next loss {new!r} on the restored mesh, {old!r} on "
              "the old one")
        check(r["losses"] == ranks[0]["losses"],
              f"{name}: ranks disagree on the losses")
    for r in ranks:
        for msg, what in zip(r.get("refusals", ()), ("pipeline layout",
                                                      "already exists")):
            check(msg is not None and what in msg,
                  f"{name}: a refusal did not raise on "
                  f"{r['coords_restore']}: {msg}")


def phase_mesh_resume(torch, tl, jobs, launch, dev):
    """Phase 15: the exact f32 cases over one 4-rank world (llama-1b
    width, 2 layers, flash: a step at dp 4, a save, the next step, a
    restore at (tp 2, sp 2) and its next step; 4 layers at (pp 2, dp 2),
    n_chunks 2: a save and a restore under its stamp; each with the
    layout refusal and a save onto the existing checkpoint, on every
    rank), then full-width llama-1b at SHARDED_LAYERS layers over 2 ranks
    (bf16, f32 masters and moments, remat, flash): a step at dp 2, a save
    through TrainCheckpointManager(mesh=), the next step, restore_latest
    at tp 2 and its next step. Returns (launches a rank of the step after
    the full-width restore, the report)."""
    B, S = MESH_RESUME_EXACT
    cfg = dataclasses.replace(tl.PRESETS["llama-1b"], n_layers=2,
                              dtype="float32", attn_impl="flash")
    report = {"what": SHARED}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-mesh-ckpt-") as d:
        tmp = Path(d)
        cases = [
            {"kind": "checkpoint", "cfg": cfg, "directory": str(tmp / "a"),
             "save_mesh": {}, "restore_mesh": {"tp": 2, "sp": 2},
             "seed": SEED + 50, "batch_shape": (B, S), "refusals": True},
            {"kind": "checkpoint_pipeline",
             "cfg": dataclasses.replace(cfg, n_layers=4),
             "directory": str(tmp / "p"), "save_mesh": {"pp": 2},
             "restore_mesh": {"pp": 2}, "seed": SEED + 51,
             "batch_shape": (B, S), "n_micro": 2, "n_chunks": 2,
             "refusals": True}]
        t0 = time.perf_counter()
        res = launch.spawn_ranks(jobs.run_cases, 4, backend="gloo",
                                 device=dev, timeout_s=400,
                                 args=(cases, dev.type))
        wall = time.perf_counter() - t0
        for i, name in enumerate(("dp4 -> (tp2, sp2)",
                                  "(pp2, dp2) n_chunks 2 -> itself")):
            ranks = [r[i] for r in res]
            row = {k: ranks[0][k] for k in ("losses", "save_s", "restore_s",
                                            "bytes_written")}
            row["refusals"] = ranks[0]["refusals"]
            report[f"exact {name}"] = row
            print(f"mesh resume exact {name} (llama-1b width, f32, flash, "
                  f"B={B} S={S}; 4 {SHARED}; {wall:.1f} s for the world): "
                  f"{json.dumps(row)}; every rank's leaves bitwise its "
                  f"shards of the saved tree: "
                  f"{all(not r['differ'] for r in ranks)}")
            held_mesh_resume(f"mesh resume exact {name}", ranks, 1e-5)
        shutil.rmtree(tmp / "a")
        shutil.rmtree(tmp / "p")

        save_mesh, restore_mesh, shape = MESH_RESUME_FULL
        full = dataclasses.replace(tl.PRESETS["llama-1b"], attn_impl="flash",
                                   remat=True, n_layers=SHARDED_LAYERS)
        shapes = tl.init_params(full, None, "meta",
                                dtype=getattr(torch, full.param_dtype))
        n = sum(t.numel() for t in _named(shapes).values())
        need, free = n * 12, shutil.disk_usage(tmp).free
        print(f"mesh resume llama-1b ({SHARDED_LAYERS} layers): {n} params, "
              f"the state (f32 params, mu, nu) {need / 1e9:.3f} GB; the disk "
              f"under {tmp} has {free / 1e9:.3f} GB free")
        check(need < free, f"the disk has {free / 1e9:.3f} GB free, the "
              f"checkpoint needs {need / 1e9:.3f} GB")
        t0 = time.perf_counter()
        res = launch.spawn_ranks(jobs.run_cases, 2, backend="gloo",
                                 device=dev, timeout_s=500, args=([{
                                     "kind": "checkpoint", "cfg": full,
                                     "directory": str(tmp / "full"),
                                     "save_mesh": save_mesh,
                                     "restore_mesh": restore_mesh,
                                     "seed": SEED + 52, "batch_shape": shape,
                                     "manager": True}], dev.type))
        wall = time.perf_counter() - t0
    ranks = [r[0] for r in res]
    r0 = ranks[0]
    row = {"layers": SHARDED_LAYERS, "batch": shape, "params": n,
           "state_gb": need / 1e9, "losses": r0["losses"],
           "save_s": r0["save_s"], "written_gb": r0["bytes_written"] / 1e9,
           "save_gb_per_s": r0["bytes_written"] / 1e9 / r0["save_s"],
           "restore_s": r0["restore_s"],
           "restore_gb_per_s": r0["bytes_written"] / 1e9 / r0["restore_s"],
           "peak_gib_by_rank": [(r["peak_bytes"] or 0) / 2**30
                                for r in ranks],
           "launches_after_restore_by_rank": [
               {k: r["launches"][k] for k in SHARDED_KERNELS}
               for r in ranks],
           "world_s": wall, "what": SHARED}
    report["llama-1b dp2 -> tp2"] = row
    print(f"mesh resume llama-1b bf16 (f32 masters and moments, remat, flash)"
          f" saved at dp 2 through TrainCheckpointManager(mesh=), restored at"
          f" tp 2 ({SHARED}): {json.dumps(row)}; beside phase 11's "
          f"single-card save and restore")
    # one step moves the loss by ~4e-4 relative (10.8812 -> 10.8766 on the
    # card at 8 layers): a restore of the state before the step, or a fresh
    # init, fails this bound
    held_mesh_resume("mesh resume llama-1b", ranks, 2e-4)
    L = SHARDED_LAYERS
    for r in ranks:
        for k, want in {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                        "flash_bwd_dkv": L}.items():
            check(r["launches"][k] == want,
                  f"mesh resume llama-1b on {r['coords_restore']}: {k} "
                  f"launched {r['launches'][k]} times in the step after the "
                  f"restore, expected {want}")
    return {k: [r["launches"][k] for r in ranks]
            for k in SHARDED_KERNELS}, report


# phase 16: head dim 64. The bench_moe_decode model (bench.py:491-494 of the
# JAX package: dim 1024, 8 layers, 16/8 heads of 64, hidden 2816, 8
# experts, top-2) serves at its own heads; the MoE family takes no fresh
# prefill and no shared prefix, so bench_decode's fast model (dense, 8/4
# heads of 64: the JAX one) drives #1/#2 and a prefix at head dim 64
D64_ROWS = ("flash_fwd", "flash_cached", "flash_cached_int8", "flash_decode",
            "flash_decode_int8")
# (B, S, start, pads, window, sinks) of #4 at head dim 64, each on a bf16
# (f32) and an int8 cache of 2048: the twin's prefill, generate's
# left-padded prefill, an engine admission after a prefix, a window with
# sinks, and a ragged S with both
D64_CACHED_CASES = ((8, 512, 0, None, None, 0), (2, 512, 0, [0, 200], None, 0),
                    (1, 256, 128, [28], None, 0), (1, 256, 900, [7], 256, 4),
                    (2, 200, 400, [0, 37], 256, 4))
# the bench_moe_decode twin's prefill and decode step: B, S0, max_len
D64_TWIN = (8, 512, 640)


def phase_d64_exact(torch, tl, tm, td, te, bench, dev):
    """Phase 16 (b): at the bench_moe_decode model's width (dim 1024, 16/8
    heads of 64), 2 layers, f32 (the kernels' f32 instances): MoE
    ServeEngine streams equal generate() on the bucket-padded prompt and
    greedy generate flash equals dense (left-padded); a dense model of the
    same attention (hidden 2816): ServeEngine streams, two of them after a
    shared prefix, equal generate() on each request alone, and a fresh
    generate (the f32 flash_fwd at head dim 64) flash equals dense."""
    moe = dataclasses.replace(bench.moe_decode_config(False), n_layers=2,
                              dtype="float32")
    dense = tl.LlamaConfig(vocab_size=moe.vocab_size, dim=moe.dim,
                           n_layers=2, n_heads=moe.n_heads,
                           n_kv_heads=moe.n_kv_heads,
                           hidden_dim=moe.hidden_dim, dtype="float32",
                           attn_impl="flash")
    check(moe.head_dim == dense.head_dim == 64,
          f"head dims {moe.head_dim}, {dense.head_dim}")
    g = torch.Generator().manual_seed(SEED + 62)
    V = moe.vocab_size

    def toks(n):
        return torch.randint(1, V, (n,), generator=g).tolist()

    params = tm.init_moe_model(moe, torch.Generator(dev).manual_seed(SEED),
                               dev)
    ragged = torch.tensor([toks(512), toks(512)])
    ragged[1, :200] = 0
    streams = [td.generate(params, ragged, c, max_new_tokens=8,
                           max_len=1024, pad_id=0, device=dev)
               for c in (moe, dataclasses.replace(moe, attn_impl="dense"))]
    check(torch.equal(*streams), f"MoE generate at head dim 64: flash "
          f"{streams[0].tolist()} != dense {streams[1].tolist()}")
    reqs = [toks(n) for n in (100, 230, 60, 150)]
    eng = te.ServeEngine(params, moe, slots=2, max_len=1024,
                         prefill_buckets=(128, 256), device=dev)
    ids = [eng.submit(p, 8) for p in reqs]
    out = eng.run()
    for rid, p in zip(ids, reqs):
        b = next(b for b in (128, 256) if len(p) <= b)
        want = td.generate(params, torch.tensor([[0] * (b - len(p)) + p]),
                           moe, max_new_tokens=8, max_len=1024,
                           pad_id=0, device=dev)[0].tolist()
        check(out[rid] == want, f"MoE engine stream {rid} at head dim 64 "
              f"!= generate on the bucket-padded prompt: {out[rid]} vs "
              f"{want}")
    del params, eng
    params = tl.init_params(dense, torch.Generator(dev).manual_seed(SEED),
                            dev)
    fresh = torch.tensor([toks(256), toks(256)])
    streams = [td.generate(params, fresh, c, max_new_tokens=8, max_len=512,
                           device=dev)
               for c in (dense, dataclasses.replace(dense, attn_impl="dense"))]
    check(torch.equal(*streams), f"generate at head dim 64: flash "
          f"{streams[0].tolist()} != dense {streams[1].tolist()}")
    prefix = toks(90)
    dreqs = [(toks(n), pre) for n, pre in ((100, None), (230, None),
                                           (60, prefix), (150, None),
                                           (40, prefix))]
    eng = te.ServeEngine(params, dense, slots=3, max_len=1024,
                         prefill_buckets=(128, 256), device=dev)
    ids = [eng.submit(p, 8, prefix=pre) for p, pre in dreqs]
    out = eng.run()
    for rid, (p, pre) in zip(ids, dreqs):
        want = td.generate(params, torch.tensor([(pre or []) + p]), dense,
                           max_new_tokens=8, max_len=1024,
                           device=dev)[0].tolist()
        check(out[rid] == want, f"engine stream {rid} at head dim 64 != "
              f"generate: {out[rid]} vs {want}")
    print(f"head-dim-64 exact phase (dim 1024, 16/8 heads of 64, 2 layers, "
          f"f32): MoE generate flash == dense, {len(reqs)} MoE engine "
          f"streams == generate on the bucket-padded prompt; dense generate "
          f"flash == dense, {len(dreqs)} engine streams (2 after a prefix) "
          f"== generate; {eng.stats()}")
    del params, eng


def phase_d64_serving(torch, tl, tm, td, te, tfa, bench, dev):
    """Phase 16 (c): the bench_moe_decode model at full size (bf16,
    flash): the bench_moe_decode twin at (8, 512, 128), a ServeEngine
    pass of 6 requests (a shared prefix refused: the MoE family takes
    none), a left-padded generate on an int8 cache; then bench_decode's
    fast model (dense, 8/4 heads of 64): the bench_decode twin at fast
    size (its fresh prefill on #1) and a ServeEngine pass of 6 requests
    with a shared prefix. Every kernel's launches are read across the run:
    the five forward kernels' head-dim-64 instances and nothing else.
    Returns (launches, report)."""
    tfa.reset_launches()
    t0 = time.perf_counter()
    twin = bench.bench_moe_decode(False)
    report = {"bench_moe_decode": twin,
              "bench_moe_decode_s": time.perf_counter() - t0}
    print(f"bench_moe_decode (full: 16/8 heads of 64) in "
          f"{report['bench_moe_decode_s']:.1f} s: {json.dumps(twin)}")
    check(twin["decode_tokens_per_s"] > 0, f"bench_moe_decode {twin}")
    cfg = bench.moe_decode_config(False)
    params = tm.init_moe_model(cfg, torch.Generator(dev).manual_seed(SEED),
                               dev)
    g = torch.Generator().manual_seed(SEED + 63)
    V, new = cfg.vocab_size, 32

    def toks(n, vocab=V):
        return torch.randint(1, vocab, (n,), generator=g).tolist()

    def serve(params, cfg, reqs, prefix=None):
        eng = te.ServeEngine(params, cfg, slots=4, max_len=1024,
                             prefill_buckets=(128, 256, 512),
                             return_logprobs=True, device=dev)
        t0 = time.perf_counter()
        ids = [eng.submit(p, new, prefix=prefix if i % 3 == 2 else None)
               for i, p in enumerate(reqs)]
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for rid in ids:
            lps = eng.finished_logprobs[rid]
            check(len(out[rid]) == new
                  and all(0 <= t < cfg.vocab_size for t in out[rid])
                  and all(lp <= 0 and lp == lp for lp in lps),
                  f"head-dim-64 request {rid}: {out[rid]} {lps}")
        return eng, eng.stats()["tokens_emitted"] / wall

    reqs = [toks(n) for n in (180, 500, 120, 350, 100, 230)]
    eng, report["moe_engine_tokens_per_s"] = serve(params, cfg, reqs)
    try:
        eng.submit(reqs[0], 4, prefix=reqs[1][:100])
    except ValueError as e:
        check("dense family" in str(e), f"prefix refusal: {e}")
    else:
        check(False, "an MoE engine took a shared prefix")
    ragged = torch.tensor([toks(512), toks(512)])
    ragged[1, :200] = 0
    t0 = time.perf_counter()
    out = td.generate(params, ragged,
                      dataclasses.replace(cfg, kv_cache_dtype="int8"),
                      max_new_tokens=new, max_len=1024, pad_id=0, device=dev)
    torch.cuda.synchronize()
    report["moe_int8_generate_tokens_per_s"] = \
        2 * new / (time.perf_counter() - t0)
    check(tuple(out.shape) == (2, new) and bool(((out >= 0) & (out < V))
                                                .all()),
          f"head-dim-64 int8 generate: {tuple(out.shape)}")
    del params, eng
    t0 = time.perf_counter()
    report["bench_decode_fast"] = bench.bench_decode(True)
    print(f"bench_decode (fast: 8/4 heads of 64) in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(report['bench_decode_fast'])}")
    dcfg = bench.decode_config(True)
    check(dcfg.head_dim == cfg.head_dim == 64,
          f"head dims {dcfg.head_dim}, {cfg.head_dim}")
    params = tl.init_params(dcfg, torch.Generator(dev).manual_seed(SEED),
                            dev)
    dreqs = [toks(n, dcfg.vocab_size) for n in (180, 500, 120, 350, 100, 230)]
    eng, report["dense_engine_tokens_per_s"] = serve(
        params, dcfg, dreqs, prefix=toks(100, dcfg.vocab_size))
    st = eng.stats()
    check(st["prefix_cache_hits"] == 1 and st["prefix_cache_misses"] == 1,
          f"head-dim-64 prefix cache {st}")
    del params, eng
    launches = dict(tfa.LAUNCHES)
    report["launches"] = launches
    print(f"head-dim-64 serving: {json.dumps(report)}")
    for name, n in launches.items():
        check((n > 0) == (name in D64_ROWS),
              f"kernel {name}: {n} launches on the head-dim-64 path")
    return launches, report


# phase 17: head dim 64 in training. The fast bench_train_step model (JAX
# bench.py:228-231: dim 512, 4 layers, 8/4 heads of 64, B=4, S=512) and
# bench_moe_decode's full model (16/8 heads of 64) train at their own
# heads: #1, #6 and #7 at head dim 64, timed at the training shape at
# that head dim; the triangle kernels (#3, #8, #9) at head dim 64, timed
# at the long-context twin's heads, and one triangular=True pass at 32k
D64_TRAIN = (8, 2048, 16, 8)       # B, S, Hq, Hkv of #1, #6, #7 timed
D64_TRI = (1, 32768, 8, 4)         # of #3, #8, #9 timed and the long path
D64_TRI_PLAIN = (1, 8192, 8, 4)    # their plain versions' (S² must fit)
# (B, S, Hq, Hkv, causal, window, lse cotangent) of #6/#7 against plain:
# the training shape, the fast model's, ragged S at GQA 4/1 and 4/2, a
# window that skips tiles
D64_BWD_CASES = ((8, 2048, 16, 8, True, None, False),
                 (4, 512, 8, 4, True, None, True),
                 (1, 1000, 4, 1, True, None, False),
                 (2, 333, 8, 2, False, None, True),
                 (1, 4096, 16, 8, True, 1024, False))
# (B, S, Hq, Hkv, lse cotangent) of #3/#8/#9 against plain: W < P, rows cut
# into many pieces, whole rows beside cut ones, the plain timing shape
D64_TRI_CASES = ((1, 128, 1, 1, False), (1, 1000, 4, 1, False),
                 (2, 200, 8, 8, True), (2, 2048, 16, 8, False),
                 D64_TRI_PLAIN + (False,))
D64_TRAIN_ROWS = ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_tri",
                  "flash_bwd_dq_tri", "flash_bwd_dkv_tri")


def phase_d64_train_kernels(torch, tfa, _cuda, dev):
    """Phase 17 (a): #6/#7 (with #1's forward) and #3/#8/#9 at head dim 64
    against their plain versions, bf16 within 1e-2 and f32 within 1e-4
    (gradients relative to the largest plain one; D64_BWD_CASES,
    D64_TRI_CASES); then, in bf16, #1, #6 and #7 timed at D64_TRAIN and the
    tri kernels at D64_TRI (their plain versions at D64_TRI_PLAIN) beside
    SDPA and the bound. Returns (the #1 training-shape dict, the *_d64
    rows of #6-#9, the worst bf16 error of #1)."""
    return train_kernels(torch, tfa, _cuda, dev, 64, D64_BWD_CASES,
                         D64_TRI_CASES, SEED + 71)


def train_kernels(torch, tfa, _cuda, dev, D, bwd_cases, tri_cases, seed):
    """#6/#7 (with #1's forward) at ``bwd_cases`` (B, S, Hq, Hkv, causal,
    window, lse cotangent) and #3/#8/#9 at ``tri_cases`` (B, S, Hq, Hkv,
    lse cotangent) at head dim D against their plain versions, bf16 within
    1e-2 and f32 within 1e-4 (gradients relative to the largest plain
    one); then, in bf16, #1, #6 and #7 timed at D64_TRAIN's pairs and
    heads and the tri kernels at D64_TRI's (their plain versions at
    D64_TRI_PLAIN) beside SDPA and the bound. Returns (the #1
    training-shape dict, the ``*_d{D}`` rows of #6-#9, the worst bf16 error
    of #1)."""
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(seed)
    bf = torch.bfloat16
    scale = D ** -0.5
    worst = dict.fromkeys(("flash_fwd",) + D64_TRAIN_ROWS, (0.0, 0.0))

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def rel(a, b):
        e = (a.float() - b.float()).abs().max().item()
        return e, e / b.float().abs().max().item()

    def held(names, dtype, what, errs, out_err=None):
        tol = TOL[str(dtype).split(".")[1]]
        print(f"head dim {D} {dtype} {what}: "
              + ("" if out_err is None else
                 f"max|out-plain| {out_err[0]:.3g} |lse-plain| "
                 f"{out_err[1]:.3g}; ")
              + ", ".join(f"{n} max|err| {e:.3g} rel {r:.3g}"
                          for n, (e, r) in zip(("dq", "dk", "dv"), errs))
              + f" (tol {tol}; backward relative)")
        check((out_err is None or (out_err[0] <= tol and out_err[1] <= 1e-4))
              and all(r <= tol for _, r in errs),
              f"a head-dim-{D} kernel disagrees with plain: {what}")
        if dtype == bf:
            parts = [(names[1], errs[:1]), (names[2], errs[1:])]
            if out_err is not None:
                parts.append((names[0], [(out_err[0], 0.0)]))
            for name, part in parts:
                worst[name] = tuple(max(x) for x in zip(worst[name], *part))

    for dtype in (bf, torch.float32):
        for B, S, Hq, Hkv, causal, window, cot in bwd_cases:
            q, dout = rnd(B, S, Hq, D, dtype=dtype), rnd(B, S, Hq, D,
                                                         dtype=dtype)
            k, v = rnd(B, S, Hkv, D, dtype=dtype), rnd(B, S, Hkv, D,
                                                        dtype=dtype)
            g_lse = rnd(B, Hq, S, dtype=torch.float32) if cot else None
            kw = dict(causal=causal, window=window)
            out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
            ref, ref_lse = tfa.attention_plain(
                q, k.transpose(1, 2), v.transpose(1, 2), 0, **kw)
            fwd = ((out.float() - ref.float()).abs().max().item(),
                   (lse - ref_lse).abs().max().item())
            del ref, ref_lse
            got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, g_lse,
                                          **kw)
            want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse,
                                           **kw)
            check(all(a.dtype == dtype for a in got), "gradient dtypes")
            held(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), dtype,
                 f"B={B} S={S} Hq={Hq} Hkv={Hkv} causal={causal} "
                 f"window={window} lse_cotangent={cot}",
                 [rel(a, b) for a, b in zip(got, want)], fwd)
            del q, k, v, dout, out, lse, got, want
        for B, S, Hq, Hkv, cot in tri_cases:
            q, dout = rnd(B, S, Hq, D, dtype=dtype), rnd(B, S, Hq, D,
                                                         dtype=dtype)
            k, v = rnd(B, S, Hkv, D, dtype=dtype), rnd(B, S, Hkv, D,
                                                        dtype=dtype)
            g_lse = rnd(B, Hq, S, dtype=torch.float32) if cot else None
            out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=scale)
            ref, ref_lse = tfa.attention_plain(q, k.transpose(1, 2),
                                               v.transpose(1, 2), 0)
            fwd = ((out.float() - ref.float()).abs().max().item(),
                   (lse - ref_lse).abs().max().item())
            del ref, ref_lse
            delta = tfa._bwd_delta(out, dout, g_lse).contiguous()
            kw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
            got = (tfa._launch_tri("flash_bwd_dq_tri", q, k, v, **kw),
                   *tfa._launch_tri("flash_bwd_dkv_tri", q, k, v, **kw))
            want = tfa.attention_bwd_plain(q, k, v, out, lse, dout, g_lse)
            check(all(a.dtype == dtype for a in (out,) + got),
                  "tri output dtypes")
            held(("flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri"),
                 dtype, f"tri kernels B={B} S={S} Hq={Hq} Hkv={Hkv} "
                 f"lse_cotangent={cot}",
                 [rel(a, b) for a, b in zip(got, want)], fwd)
            del q, k, v, dout, out, lse, delta, got, want
    torch.cuda.synchronize()

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    src = "gpu_provisioner_tpu_torch/ops/csrc/"
    tpu = "gpu_provisioner_tpu/ops/flash_attention.py:"
    rows = []

    def source_of(kernel):   # the source of kernel's C entry at head dim D
        return _cuda.ENTRIES[_cuda.entry(kernel, D)][0] + ".cu"

    def row(name, source, replaces, shape, ms, plain_ms, library_ms,
            ops_bytes, **extra):
        ops, nbytes = ops_bytes
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
        r = {"name": f"{name}_d{D}", "route": "cuda",
             "source": src + source,
             "replaces": f"{tpu}{replaces}, head dim {D}", "launches": 0,
             "max_abs_err": worst[name][0], "max_rel_err": worst[name][1],
             "tolerance": TOL["bfloat16"], "shape": shape, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
             "bound_by": "bytes" if t_b >= t_o else "operations",
             "library_ms": library_ms, "bound_share": max(t_b, t_o) / ms,
             **extra}
        rows.append(r)
        print(f"{r['name']}: {json.dumps(r)}")

    # #1, #6 and #7 at the training shape's pairs and heads at head dim D
    B, S, Hq, Hkv = D64_TRAIN
    q, dout = rnd(B, S, Hq, D), rnd(B, S, Hq, D)
    k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    delta = tfa._bwd_delta(out, dout, None).contiguous()
    lib_in = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    ops, nbytes = work(B, S, Hq, Hkv, D, S, 0, None, None, 0, True, 2, 2,
                       False, True)
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    fwd_train = {
        "shape": list(D64_TRAIN), "head_dim": D,
        "max_abs_err": worst["flash_fwd"][0],
        "ms": time_ms(lambda: tfa._launch(
            "flash_fwd", q, kh, vh, 0, causal=True, scale=scale,
            want_lse=True), flush),
        "plain_ms": time_ms(lambda: tfa.attention_plain(q, kh, vh, 0), flush),
        "bound_ms": max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *[t.detach() for t in lib_in], is_causal=True, enable_gqa=True),
            flush)}
    fwd_train["bound_share"] = fwd_train["bound_ms"] / fwd_train["ms"]
    print(f"flash_fwd at head dim {D}, the training shape: "
          f"{json.dumps(fwd_train)}")
    plain_ms = time_ms(lambda: tfa.attention_bwd_plain(q, k, v, out, lse,
                                                       dout), flush)
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, dout.transpose(1, 2), retain_graph=True), flush)
    for name, replaces in (("flash_bwd_dq", "916 (_bwd_dq_kernel)"),
                           ("flash_bwd_dkv", "979 (_bwd_dkv_kernel)")):
        row(name, source_of(name), replaces,
            f"B={B} S={S} causal Hq={Hq} Hkv={Hkv} D={D}",
            time_ms(lambda name=name: tfa._launch_bwd(
                name, q, k, v, dout, lse, delta, causal=True, scale=scale),
                flush), plain_ms, library_ms,
            work_bwd(name, B, S, Hq, Hkv, D, True, None, 2),
            library_note="dQ, dK and dV in one call; plain_ms likewise")
    del q, k, v, dout, out, lse, delta, lib_in, lib_out, kh, vh

    # the tri kernels at the long-context twin's heads, 32k
    B, S, Hq, Hkv = D64_TRI
    q, dout = rnd(B, S, Hq, D), rnd(B, S, Hq, D)
    k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    out, lse = tfa._launch_tri("flash_fwd_tri", q, k, v, scale=scale)
    delta = tfa._bwd_delta(out, dout, None).contiguous()
    kw = dict(flush=flush, reps=5, warm=1)
    bkw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
    tri_fns = {
        "flash_fwd_tri": lambda: tfa._launch_tri("flash_fwd_tri", q, k, v,
                                                 scale=scale),
        "flash_bwd_dq_tri": lambda: tfa._launch_tri("flash_bwd_dq_tri", q,
                                                    k, v, **bkw),
        "flash_bwd_dkv_tri": lambda: tfa._launch_tri("flash_bwd_dkv_tri", q,
                                                     k, v, **bkw)}
    rect_fns = {
        "flash_fwd_tri": lambda: tfa._launch(
            "flash_fwd", q, k.transpose(1, 2), v.transpose(1, 2), 0,
            causal=True, scale=scale, want_lse=True),
        "flash_bwd_dq_tri": lambda: tfa._launch_bwd(
            "flash_bwd_dq", q, k, v, dout, lse, delta, causal=True,
            scale=scale),
        "flash_bwd_dkv_tri": lambda: tfa._launch_bwd(
            "flash_bwd_dkv", q, k, v, dout, lse, delta, causal=True,
            scale=scale)}
    lib_in = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *[t.detach() for t in lib_in], is_causal=True, enable_gqa=True), **kw)
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, dout.transpose(1, 2), retain_graph=True), **kw)
    del lib_out, lib_in
    Bp, Sp, Hqp, Hkvp = D64_TRI_PLAIN
    qp, doutp = rnd(Bp, Sp, Hqp, D), rnd(Bp, Sp, Hqp, D)
    kp, vp = rnd(Bp, Sp, Hkvp, D), rnd(Bp, Sp, Hkvp, D)
    outp, lsep = tfa.attention_plain(qp, kp.transpose(1, 2),
                                     vp.transpose(1, 2), 0)
    plain_fwd_ms = time_ms(lambda: tfa.attention_plain(
        qp, kp.transpose(1, 2), vp.transpose(1, 2), 0), **kw)
    plain_bwd_ms = time_ms(lambda: tfa.attention_bwd_plain(
        qp, kp, vp, outp, lsep, doutp), **kw)
    del qp, doutp, kp, vp, outp, lsep
    for name, replaces, _, _ in TRI_KERNELS:
        ws, P = tri_ws_bytes(_cuda, name, dev, D)
        fwd = name == "flash_fwd_tri"
        row(name, source_of(name), replaces[1:], f"B={B} S={S} Hq={Hq} "
            f"Hkv={Hkv} D={D} bf16 causal", time_ms(tri_fns[name], **kw),
            plain_fwd_ms if fwd else plain_bwd_ms,
            lib_fwd_ms if fwd else lib_bwd_ms,
            work_tri(name, B, S, Hq, Hkv, D, ws), ctas=P,
            rect_ms=time_ms(rect_fns[name], **kw),
            plain_note=f"plain_ms at B={Bp} S={Sp} Hq={Hqp} Hkv={Hkvp} (the "
                       "S² scores at S=32768 do not fit)"
                       + ("" if fwd else "; dQ+dK+dV, as library_ms"))
    del flush, q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()
    return fwd_train, rows, worst["flash_fwd"][0]


def phase_d64_train(torch, tl, tm, tt, tfa, bench, dev):
    """Phase 17 (c): the fast bench_train_step model at its JAX heads (8/4
    of 64), bf16, remat, flash, at the twin's (B, S): one warm-up step
    and five on one batch, the loss finite and falling, its launches
    (``d64_train``); then the twin itself (``bench_train_step_fast``);
    three steps of make_moe_train_step on bench_moe_decode's full model
    (16/8 heads of 64) at MOE_TRAIN_SHAPE (``moe_train_d64``); then one
    triangular=True forward and backward at D64_TRI against the
    rectangular kernels within LONG_TOL (the tri kernels once each, no
    rectangular launch: ``d64_long``). Returns (launches by path,
    report)."""
    cfg = bench.train_step_config(True)
    check(cfg.head_dim == 64 and (cfg.n_heads, cfg.n_kv_heads) == (8, 4),
          f"the fast bench_train_step model: {cfg}")
    (B, S), steps, L = bench.TRAIN_STEP_SHAPE[True], 5, cfg.n_layers
    by_path, report = {}, {}
    params, opt = tt.make_train_state(
        cfg, torch.Generator(dev).manual_seed(SEED), dev)
    step = tt.make_train_step(cfg, opt)
    g = torch.Generator().manual_seed(SEED + 72)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g).to(dev)
    warm = step(params, toks[:, :-1], toks[:, 1:]).item()
    torch.cuda.synchronize()
    tfa.reset_launches()
    losses = [step(params, toks[:, :-1], toks[:, 1:]).item()
              for _ in range(steps)]
    torch.cuda.synchronize()
    by_path["d64_train"] = dict(tfa.LAUNCHES)
    report["d64_train"] = {"batch": B, "seq_len": S, "warm_loss": warm,
                           "losses": losses}
    print(f"train the fast bench_train_step model (8/4 heads of 64, bf16, "
          f"remat, flash) B={B} S={S}: warm-up loss {warm!r}, losses "
          f"{losses}; launches over {steps} steps {by_path['d64_train']}")
    check(all(x == x and abs(x) < float("inf") for x in [warm] + losses),
          "a head-dim-64 training loss is not finite")
    check(losses[-1] < losses[0] < warm, f"loss did not fall: {losses}")
    del params, opt, step
    tfa.reset_launches()
    twin = bench.bench_train_step(True)
    by_path["bench_train_step_fast"] = dict(tfa.LAUNCHES)
    report["bench_train_step_fast"] = twin
    print(f"bench_train_step (fast: 8/4 heads of 64): {json.dumps(twin)}; "
          f"launches {by_path['bench_train_step_fast']}")
    check(0 < twin["mfu"] < 1 and twin["tokens_per_s"] > 0,
          f"bench_train_step fast: {twin}")
    n = bench.TRAIN_WARM + bench.ROUNDS * bench.TRAIN_ITERS
    for path, k in (("d64_train", steps), ("bench_train_step_fast", n)):
        for name, want in {"flash_fwd": 2 * L * k, "flash_bwd_dq": L * k,
                           "flash_bwd_dkv": L * k}.items():
            check(by_path[path][name] == want,
                  f"{path}: {name} launched {by_path[path][name]} times, "
                  f"expected {want}")
    torch.cuda.empty_cache()
    moe = bench.moe_decode_config(False)
    by_path["moe_train_d64"], report["moe_train_d64"] = phase_moe_train(
        torch, tm, tfa, dev, cfg=moe, steps=3,
        what="bench_moe_decode's model at full size: 8 layers, 16/8 heads "
             "of 64, 8 experts, top-2")
    torch.cuda.empty_cache()

    # the long path at head dim 64: triangular=True at 32k against the
    # rectangular kernels, the triangle's launches read alone
    Bl, Sl, Hq, Hkv = D64_TRI
    gl = torch.Generator(dev).manual_seed(SEED + 73)
    leaves = [torch.randn(Bl, Sl, h, 64, generator=gl, device=dev)
              .to(torch.bfloat16).requires_grad_() for h in (Hq, Hkv, Hkv)]
    dout = torch.randn(Bl, Sl, Hq, 64, generator=gl, device=dev).to(
        torch.bfloat16)

    def fwd_bwd(triangular):
        out, lse = tfa.flash_attention_with_lse(*leaves,
                                                triangular=triangular)
        return (out, lse) + torch.autograd.grad(out, leaves, dout)

    want = fwd_bwd(False)
    torch.cuda.synchronize()
    tfa.reset_launches()
    got = fwd_bwd(True)
    torch.cuda.synchronize()
    by_path["d64_long"] = dict(tfa.LAUNCHES)
    errs = [(a.float() - b.float()).abs().max().item()
            / (1.0 if i < 2 else b.float().abs().max().item())
            for i, (a, b) in enumerate(zip(got, want))]
    report["d64_long"] = dict(zip(("out", "lse", "dq_rel", "dk_rel",
                                   "dv_rel"), errs))
    print(f"triangle vs rectangle at head dim 64, bf16 B={Bl} S={Sl} "
          f"Hq={Hq} Hkv={Hkv}: {json.dumps(report['d64_long'])} (tol "
          f"{LONG_TOL}); launches {by_path['d64_long']}")
    check(all(e <= LONG_TOL for e in errs) and all(
        bool(torch.isfinite(t).all()) for t in got),
        "triangular=True disagrees with the rectangular kernels at head "
        "dim 64")
    for name, n in by_path["d64_long"].items():
        want_n = 1 if name.endswith("_tri") else 0
        check(n == want_n, f"{name}: {n} launches on the head-dim-64 long "
              f"path, expected {want_n}")
    del leaves, dout, want, got
    torch.cuda.empty_cache()
    return by_path, report


def phase_onchip_twin(torch, onchip, dev):
    """Phase 17 (d): the twin of hack/tpu_onchip_checks.py in this process
    (gpu_provisioner_tpu_torch/onchip_checks.py): every check ok."""
    lines = onchip.run(dev)
    failed = [line["check"] for line in lines if not line["ok"]]
    print(f"on-card checks: {len(lines)} checks, {len(failed)} failed")
    check(not failed, f"on-card checks failed: {failed}")
    return len(lines)


# phase 18: head dims 32 and 16 in serving. The fast bench_engine and
# bench_moe_decode models (JAX bench.py:486-490 and :529-531: dim 256, 8/4
# heads of 32) and the tiny / tiny-moe presets (dim 64, 4/2 heads of 16)
# serve at their own heads through the D = 32 and 16 instances of #1/#2,
# #4 and #5 (phase 19 trains them)
SMALL_HEADS = {32: (8, 4), 16: (4, 2)}     # head dim: its models' Hq, Hkv
SMALL_ML = 512                             # the fast bench_engine max_len
# (B, S, start, pads, window, sinks) of #4 and #5 at ML 512: the fast
# bench_engine model's admission (S=128 at start 0, a 192-token prompt),
# a left-padded prefill after a prefix, a window with sinks, a ragged S;
# a decode step at per-row starts and pads, a window with sinks, verify
# blocks of 5 and 16
SMALL_CACHE_CASES = (
    (1, 128, 0, None, None, 0), (1, 192, 0, None, None, 0),
    (2, 192, 64, [0, 37], None, 0), (1, 128, 300, [7], 128, 4),
    (2, 200, 100, [0, 20], 128, 4), (2, 1, [300, 37], [0, 5], None, 0),
    (2, 1, [480, 200], [0, 130], 128, 4), (2, 5, [400, 60], [3, 0], None, 0),
    (1, 16, 200, None, None, 0))
SMALL_STARTS, SMALL_PADS = [300, 200], [0, 12]   # the timed decode step


def small_logits(torch, td, fwd, params, cfg, dev, g):
    """max |flash - dense| of the f32 logits of a 128-token prompt through
    ``fwd`` (decode.cached_forward or moe_serve.moe_cached_forward: #4 on
    an empty cache) and one decode step after it (#5), each side on its
    own cache of max_len 256."""
    toks = torch.randint(1, cfg.vocab_size, (2, 129), generator=g).to(dev)
    outs = []
    for impl in ("flash", "dense"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        cache = td.init_kv_cache(c, 2, 256, device=dev)
        a, cache = fwd(params, toks[:, :128], cache, c)
        b, _ = fwd(params, toks[:, 128:], cache, c)
        outs.append(torch.cat([a, b], dim=1))
    return (outs[0] - outs[1]).abs().max().item()


def phase_small_exact(torch, tl, tm, td, te, tms, bench, dev):
    """Phase 18 (c): in f32 (the kernels' f32 instances), the tiny preset
    (4/2 heads of 16), the fast bench_engine model (8/4 of 32) and
    tiny-moe (4/2 of 16) with flash attention against dense on the card:
    the logits of a prompt and a decode step within 1e-4 on an f32 cache
    and 2e-2 on an int8 one (a value that the two sides' hidden states,
    1e-6 apart, put on either side of a quantisation boundary lands one
    step apart: at dim 256, one V element a quantum apart where its
    attention weight is 1 moves the logits by 7.4e-3 a layer, ROADMAP
    Queue C 2); greedy generate (fresh for the dense family, left-padded)
    and an int8-cache generate token-equal; a ServeEngine pass (the dense
    family with a shared prefix) with streams equal to dense's."""
    models = (("tiny", tl.PRESETS["tiny"], tl.init_params, td.cached_forward),
              ("fast bench_engine", bench.engine_config(True), tl.init_params,
               td.cached_forward),
              ("tiny-moe", tm.PRESETS_MOE["tiny-moe"], tm.init_moe_model,
               tms.moe_cached_forward))
    return serve_exact(torch, tm, td, te, models, SMALL_HEADS, dev,
                       SEED + 82)


def serve_exact(torch, tm, td, te, models, head_dims, dev, seed):
    """Each of ``models`` ((name, config, init, cached forward)) in f32
    with flash attention against dense on the card, its head dim one of
    ``head_dims``: phase_small_exact's checks. Returns the report."""
    g = torch.Generator().manual_seed(seed)
    report = {}
    for name, cfg, init, fwd in models:
        cfg = dataclasses.replace(cfg, dtype="float32", attn_impl="flash")
        check(cfg.head_dim in head_dims, f"{name}: head dim {cfg.head_dim}")
        moe = isinstance(cfg, tm.MoEConfig)
        V = cfg.vocab_size
        params = init(cfg, torch.Generator(dev).manual_seed(SEED), dev)

        def toks(n):
            return torch.randint(1, V, (n,), generator=g).tolist()

        def both(fn):
            return [fn(dataclasses.replace(cfg, attn_impl=impl))
                    for impl in ("flash", "dense")]

        logits = [small_logits(torch, td, fwd, params,
                               dataclasses.replace(cfg, kv_cache_dtype=kv),
                               dev, g) for kv in ("auto", "int8")]
        check(logits[0] <= 1e-4 and logits[1] <= 2e-2, f"{name}: flash "
              f"logits differ from dense by {logits} (f32, int8 cache)")
        fresh = torch.tensor([toks(128), toks(128)])
        ragged = torch.tensor([toks(128), toks(128)])
        ragged[1, :37] = 0
        runs = {"generate": lambda c: td.generate(
                    params, ragged if moe else fresh, c, max_new_tokens=8,
                    max_len=256, pad_id=0 if moe else None, device=dev),
                "int8 generate": lambda c: td.generate(
                    params, ragged, dataclasses.replace(
                        c, kv_cache_dtype="int8"), max_new_tokens=8,
                    max_len=256, pad_id=0, device=dev)}
        for what, fn in runs.items():
            a, b = both(fn)
            check(torch.equal(a, b), f"{name} {what}: flash {a.tolist()} != "
                  f"dense {b.tolist()}")
        prefix = None if moe else toks(40)
        reqs = [(toks(n), prefix if i % 3 == 2 else None)
                for i, n in enumerate((100, 60, 128, 30, 80))]

        def serve(c):
            eng = te.ServeEngine(params, c, slots=2, max_len=512,
                                 prefill_buckets=(128, 256), device=dev)
            ids = [eng.submit(p, 6, prefix=pre) for p, pre in reqs]
            out = eng.run()
            return [out[i] for i in ids]

        a, b = both(serve)
        check(a == b, f"{name} engine streams: flash {a} != dense {b}")
        report[name] = {"head_dim": cfg.head_dim, "heads": [
            cfg.n_heads, cfg.n_kv_heads], "max_logit_diff": logits}
        print(f"head dim {cfg.head_dim} exact ({name}, f32): logits flash - "
              f"dense {logits} (f32, int8 cache); generate, int8 generate "
              f"and {len(reqs)} engine streams flash == dense")
        del params
    return report


def phase_small_serving(torch, tl, tm, td, te, tfa, bench, dev):
    """Phase 18 (d), bf16: the fast bench_moe_decode twin at (2, 128, 16
    new) (its prefill on #4, its steps on #5: a budget of 144 tiles at
    block 144) and the fast bench_engine twin, both at 8/4 heads of 32,
    then their models through the kernels: a fresh and an int8-cache
    generate of the bench_engine model and a generate of the
    bench_moe_decode model at max_len 256; then tiny and tiny-moe (4/2
    heads of 16): a fresh and an int8-cache generate, an engine pass with
    a shared prefix, an MoE generate. The five forward kernels' launches
    are read across each head dim's run, each at least once and nothing
    else launched; then the forward, the backward (rectangular and
    triangular=True) and flash_fwd_tri at head dim 48, which no kernel
    takes, raise ValueError naming it, with no launch. Returns ({32:
    launches, 16: launches}, report)."""
    g = torch.Generator().manual_seed(SEED + 83)
    launches, report = {}, {}

    def gen(params, cfg, B=2, S0=128, new=16, pads=False, int8=False):
        prompt = torch.randint(1, cfg.vocab_size, (B, S0), generator=g)
        if pads:
            prompt[1, :37] = 0
        if int8:
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        t0 = time.perf_counter()
        out = td.generate(params, prompt, cfg, max_new_tokens=new,
                          max_len=256, pad_id=0 if pads else None,
                          device=dev)
        torch.cuda.synchronize()
        check(tuple(out.shape) == (B, new)
              and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              f"generate at head dim {cfg.head_dim}: {tuple(out.shape)}")
        return B * new / (time.perf_counter() - t0)

    tfa.reset_launches()
    for name in ("bench_moe_decode", "bench_engine"):
        t0 = time.perf_counter()
        report[name] = getattr(bench, name)(True)
        print(f"{name} (fast: 8/4 heads of 32) in "
              f"{time.perf_counter() - t0:.1f} s: {json.dumps(report[name])}")
    check(report["bench_engine"]["engine_tokens"]
          == sum(8 + 8 * (i % 4) for i in range(bench.ENGINE_SHAPE[True][2])),
          f"bench_engine tokens {report['bench_engine']}")
    cfg = bench.engine_config(True)
    moe = bench.moe_decode_config(True)
    check(cfg.head_dim == moe.head_dim == 32,
          f"head dims {cfg.head_dim}, {moe.head_dim}")
    params = tl.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    report["engine_model_generate_tokens_per_s"] = gen(params, cfg)
    report["engine_model_int8_generate_tokens_per_s"] = gen(
        params, cfg, pads=True, int8=True)
    params = tm.init_moe_model(moe, torch.Generator(dev).manual_seed(SEED),
                               dev)
    report["moe_model_generate_tokens_per_s"] = gen(params, moe, pads=True)
    launches[32] = dict(tfa.LAUNCHES)

    tfa.reset_launches()
    tiny = dataclasses.replace(tl.PRESETS["tiny"], attn_impl="flash")
    tiny_moe = dataclasses.replace(tm.PRESETS_MOE["tiny-moe"],
                                   attn_impl="flash")
    params = tl.init_params(tiny, torch.Generator(dev).manual_seed(SEED), dev)
    report["tiny_generate_tokens_per_s"] = gen(params, tiny)
    report["tiny_int8_generate_tokens_per_s"] = gen(params, tiny, pads=True,
                                                    int8=True)
    eng = te.ServeEngine(params, tiny, slots=2, max_len=512,
                         prefill_buckets=(128, 256), device=dev)
    prefix = torch.randint(1, tiny.vocab_size, (40,), generator=g).tolist()
    t0 = time.perf_counter()
    for i, n in enumerate((100, 60, 128, 30)):
        eng.submit(torch.randint(1, tiny.vocab_size, (n,),
                                 generator=g).tolist(), 8,
                   prefix=prefix if i % 2 else None)
    eng.run()
    torch.cuda.synchronize()
    report["tiny_engine_tokens_per_s"] = \
        eng.stats()["tokens_emitted"] / (time.perf_counter() - t0)
    params = tm.init_moe_model(tiny_moe, torch.Generator(dev).manual_seed(
        SEED), dev)
    report["tiny_moe_generate_tokens_per_s"] = gen(params, tiny_moe,
                                                   pads=True)
    launches[16] = dict(tfa.LAUNCHES)
    del params, eng
    for D, counts in launches.items():
        print(f"head dim {D} launches: {counts}")
        for name, n in counts.items():
            check((n > 0) == (name in D64_ROWS),
                  f"kernel {name}: {n} launches on the head-dim-{D} path")

    # a head dim no kernel is built for (48) is refused by name before a
    # launch, forward, backward and triangle alike (32 and 16 train since
    # phase 19's kernels)
    Hq, Hkv = SMALL_HEADS[32]
    gq = torch.Generator(dev).manual_seed(SEED + 84)
    q, k, v = (torch.randn(1, 128, h, 48, generator=gq, device=dev)
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    lse = torch.zeros(1, Hq, 128, device=dev)
    tfa.reset_launches()
    for what, fn in (
            ("flash_attention", lambda: tfa.flash_attention(q, k, v)),
            ("flash_attention_bwd", lambda: tfa.flash_attention_bwd(
                q, k, v, q, lse, q)),
            ("triangular=True backward", lambda: tfa.flash_attention_bwd(
                q, k, v, q, lse, q, triangular=True)),
            ("flash_fwd_tri", lambda: tfa._launch_tri(
                "flash_fwd_tri", q, k, v, scale=1.0))):
        try:
            fn()
        except ValueError as e:
            check("head dim 48" in str(e), f"{what} at head dim 48: {e}")
        else:
            check(False, f"{what} ran at head dim 48")
    check(not any(tfa.LAUNCHES.values()),
          f"a launch at head dim 48: {tfa.LAUNCHES}")
    report["refusals"] = ("head dim 48: flash_attention, flash_attention_bwd"
                          ", triangular=True backward, flash_fwd_tri")
    print(f"head dims 32 and 16 serving: {json.dumps(report)}")
    return launches, report


# phase 19: head dims 32 and 16 in training. tiny (4/2 heads of 16), the
# fast bench_engine model (8/4 of 32) and tiny-moe train through the D = 32
# and 16 instances of #6/#7 and #3/#8/#9: the D = 64 atom partly filled,
# the K-major products in D / 16 k-steps, the register-A ones m64n64k16
# the new tensor-core instances: (source, a substring of the mangled name)
SMALL_TRI_S = 8192                 # the triangle through the wrapper
SMALL_TRAIN_SHAPE = (4, 512)       # B, S of the bf16 training steps
SMALL_PIPELINE_SHAPE = (4, 128)    # tests/test_parallel_extra.py:176's
# (B, S, Hq, Hkv) of the triangular=True pass at each head dim, long enough
# that the natural budget takes flash_fwd_tri: 2 S D 2 bytes past
# RESIDENT_KV_BUDGET (S > 49152 at D = 32, > 98304 at D = 16) and S a
# multiple of 512 (the JAX block rule)
SMALL_LONG = {32: (1, 50176, 8, 4), 16: (1, 98816, 4, 2)}


def small_bwd_cases(Hq, Hkv):
    """(B, S, Hq, Hkv, causal, window, lse cotangent) of #6/#7 at a small
    head dim: causal, non-causal and a window of 100, with and without an
    lse cotangent, at (2, 256), and a ragged S (a zero-filled last tile)."""
    return ((2, 256, Hq, Hkv, True, None, False),
            (2, 256, Hq, Hkv, True, None, True),
            (2, 256, Hq, Hkv, False, None, False),
            (2, 256, Hq, Hkv, False, None, True),
            (2, 256, Hq, Hkv, True, 100, True),
            (1, 333, Hq, Hkv, True, None, True))


def small_tri_cases(Hq, Hkv, S=SMALL_TRI_S):
    """(B, S, Hq, Hkv, lse cotangent) of #3/#8/#9 called directly: W < P,
    rows cut into many pieces at a ragged S, B 2, and S (the wrapper's)."""
    return ((1, 128, Hq, Hkv, False), (1, 1000, Hq, Hkv, True),
            (2, 200, Hq, Hkv, True), (1, S, Hq, Hkv, False))


# phase 19 (b), (c): phase_train_kernels at 8/4 heads of 32 and 4/2 of 16
SMALL_TRAIN_SPECS = {
    D: (Hq, Hkv, small_bwd_cases(Hq, Hkv), small_tri_cases(Hq, Hkv),
        SMALL_TRI_S, SEED + 90 + D) for D, (Hq, Hkv) in SMALL_HEADS.items()}


def tri_through_wrapper(torch, tfa, dev, D, Hq, Hkv, seed, S=SMALL_TRI_S):
    """triangular=True through flash_attention_with_lse and autograd at (1,
    S, Hq, Hkv), bf16, with tfa.RESIDENT_KV_BUDGET lowered to 0
    for the call and restored after (as tests/test_ops.py:74 lowers JAX's):
    the three tri kernels once each and nothing else, out and lse within
    1e-2 and 1e-4 of the plain versions and the gradients within 1e-2 of
    the largest plain one, and all of them within LONG_TOL of the
    rectangular kernels. Returns {name: (abs, rel) error} of each output
    against plain."""
    g = torch.Generator(dev).manual_seed(seed)
    bf = torch.bfloat16
    leaves = [torch.randn(1, S, h, D, generator=g, device=dev).to(bf)
              .requires_grad_() for h in (Hq, Hkv, Hkv)]
    dout = torch.randn(1, S, Hq, D, generator=g, device=dev).to(bf)

    def fwd_bwd(triangular):
        out, lse = tfa.flash_attention_with_lse(*leaves,
                                                triangular=triangular)
        return (out, lse) + torch.autograd.grad(out, leaves, dout)

    rect = fwd_bwd(False)
    budget = tfa.RESIDENT_KV_BUDGET
    tfa.RESIDENT_KV_BUDGET = 0
    try:
        tfa.reset_launches()
        got = fwd_bwd(True)
        torch.cuda.synchronize()
        launches = {n: c for n, c in tfa.LAUNCHES.items() if c}
    finally:
        tfa.RESIDENT_KV_BUDGET = budget
    q, k, v = (t.detach() for t in leaves)
    out, lse = tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                   0)
    plain = (out, lse) + tfa.attention_bwd_plain(q, k, v, out, lse, dout)
    names = ("out", "lse", "dq", "dk", "dv")

    def errs(a, b, i):
        e = (a.float() - b.float()).abs().max().item()
        return e, e / (1.0 if i < 2 else b.float().abs().max().item())

    vs_plain = {n: errs(a, b, i) for i, (n, a, b) in
                enumerate(zip(names, got, plain))}
    vs_rect = {n: errs(a, b, i)[1] for i, (n, a, b) in
               enumerate(zip(names, got, rect))}
    print(f"triangular=True through the wrapper at head dim {D}, bf16 B=1 "
          f"S={S} Hq={Hq} Hkv={Hkv}, budget lowered to 0: launches "
          f"{launches}; against plain {json.dumps(vs_plain)} (tol 1e-2, lse "
          f"1e-4; gradients relative); against the rectangular kernels "
          f"{json.dumps(vs_rect)} (tol {LONG_TOL})")
    check(launches == {"flash_fwd_tri": 1, "flash_bwd_dq_tri": 1,
                       "flash_bwd_dkv_tri": 1},
          f"triangular=True at head dim {D} launched {launches}")
    check(vs_plain["lse"][0] <= 1e-4 and all(
        r <= TOL["bfloat16"] for n, (_, r) in vs_plain.items() if n != "lse"),
        f"the tri kernels at head dim {D} disagree with plain: {vs_plain}")
    check(all(e <= LONG_TOL for e in vs_rect.values()),
          f"the tri kernels at head dim {D} disagree with the rectangular "
          f"ones: {vs_rect}")
    return {"flash_fwd_tri": vs_plain["out"], "flash_bwd_dq_tri":
            vs_plain["dq"], "flash_bwd_dkv_tri": max(vs_plain["dk"],
                                                     vs_plain["dv"])}


def phase_train_kernels(torch, tfa, _cuda, dev, specs):
    """Phases 19 (b), (c) and 21 (b), (c): at each head dim D of ``specs``
    ({D: (Hq, Hkv, #6/#7 cases, #3/#8/#9 cases, S of the wrapper's
    triangle, seed)}: SMALL_TRAIN_SPECS, MID_TRAIN_SPECS), #6/#7 (with #1's
    forward) and #3/#8/#9 against their plain versions, bf16 (1e-2) and
    f32 (1e-4), then timed in bf16 at the D = 64 rows' pairs and heads
    beside their plain versions, SDPA and the bound (train_kernels), and
    the triangle through the wrapper with the budget lowered
    (tri_through_wrapper). Returns ({D: the #1 training-shape dict}, the
    ``*_d{D}`` rows of #6-#9, {D: #1's worst bf16 error})."""
    fwd_train, rows, fwd_err = {}, [], {}
    for D, (Hq, Hkv, bwd_cases, tri_cases, tri_S, seed) in specs.items():
        fwd_train[D], r, fwd_err[D] = train_kernels(
            torch, tfa, _cuda, dev, D, bwd_cases, tri_cases, seed)
        for name, (e, rel) in tri_through_wrapper(
                torch, tfa, dev, D, Hq, Hkv, seed + 1, tri_S).items():
            row = next(x for x in r if x["name"] == f"{name}_d{D}")
            row["max_abs_err"] = max(row["max_abs_err"], e)
            row["max_rel_err"] = max(row["max_rel_err"], rel)
        rows += r
        torch.cuda.empty_cache()
    return fwd_train, rows, fwd_err


def phase_small_train_exact(torch, tl, tm, tt, bench, dev):
    """Phase 19 (d): tiny (4/2 heads of 16), the fast bench_engine model
    (8/4 of 32, 2 layers) and tiny-moe (make_moe_train_step) flash against
    dense in f32 (train_exact)."""
    models = (("tiny", tl.PRESETS["tiny"], False),
              ("fast bench_engine", bench.engine_config(True), False),
              ("tiny-moe", tm.PRESETS_MOE["tiny-moe"], True))
    for name, cfg, _ in models:
        check(cfg.head_dim in SMALL_HEADS, f"{name}: head dim {cfg.head_dim}")
    return train_exact(torch, tm, tt, models, dev, SEED + 92)


def train_exact(torch, tm, tt, models, dev, seed, wide=False):
    """In f32 (the kernels' f32 instances), each of ``models`` ((name,
    config, MoE or not): make_moe_train_step for MoE) takes three train
    steps with attn_impl "flash" and again with "dense", from the same
    params and batches of (2, 256): every loss within 1e-5 relative, the
    params after the third step within 1e-4 where each step's dense
    gradient is 0 or at least 1e-7 in size (elsewhere AdamW moves an
    element by about lr·sign(g), and a gradient that rounds to the other
    sign moves it by up to 2·lr; those elements are counted, fewer than
    one in a thousand). ``wide`` (phase 21's widths, where elements whose
    gradients pass 1e-7 still move apart by ~lr once the two runs' params
    differ after the first step): the first step's gradient leaves within
    1e-4 of their largest value (phase 6's gate at Llama-1B's width) and
    its params within 1e-4 where its two gradients are 0 or at least 1e-7
    and of one sign (Adam's first step is lr·g / (|g| + eps)), those left
    out counted; the later steps' gradient errors and params reported.
    Returns {name: report}."""
    g = torch.Generator().manual_seed(seed)
    report = {}
    for name, cfg, moe in models:
        cfg = dataclasses.replace(cfg, dtype="float32", remat=False)
        batches = [torch.randint(0, cfg.vocab_size, (2, 257), generator=g)
                   .to(dev) for _ in range(3)]
        losses, params, steady = {}, {}, {}
        flash_steps, grad_errs, first = [], [], {}
        for impl in ("flash", "dense"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            state = (tm.make_moe_train_state if moe else tt.make_train_state)
            p, opt = state(c, torch.Generator(dev).manual_seed(SEED), dev)
            step = (tm.make_moe_train_step if moe
                    else tt.make_train_step)(c, opt)
            losses[impl], ok = [], None
            for i, b in enumerate(batches):
                losses[impl].append(step(p, b[:, :-1], b[:, 1:]).item())
                gr = {k: v.grad for k, v in _named(p).items()}
                now = {k: (x.abs() >= 1e-7) | (x == 0) for k, x in gr.items()}
                ok = now if ok is None else {k: ok[k] & now[k] for k in ok}
                if not wide:
                    continue
                if impl == "flash":   # its gradients (and first params)
                    flash_steps.append(
                        ({k: x.clone() for k, x in gr.items()},
                         {k: x.detach().clone() for k, x in _named(p).items()}
                         if i == 0 else None))
                    continue
                (fg, fp), flash_steps[i] = flash_steps[i], None
                grad_errs.append(max((fg[k] - x).abs().max().item()
                                     / max(x.abs().max().item(), 1e-30)
                                     for k, x in gr.items()))
                if i == 0:
                    keep = {k: now[k] & (torch.sign(fg[k]) == torch.sign(x))
                            for k, x in gr.items()}
                    first = {"param_err": max(
                        (fp[k] - x.detach())[keep[k]].abs().max().item()
                        if keep[k].any() else 0.0
                        for k, x in _named(p).items()),
                        "excluded": sum(int((~m).sum())
                                        for m in keep.values())}
                del fg, fp
            params[impl], steady[impl] = _named(p), ok
            del p, opt, step
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(losses["flash"], losses["dense"]))
        diff = {k: (params["flash"][k] - params["dense"][k]).detach().abs()
                for k in params["dense"]}
        worst = max(d[steady["dense"][k]].max().item() if
                    steady["dense"][k].any() else 0.0
                    for k, d in diff.items())
        worst_all = max(d.max().item() for d in diff.values())
        excluded = sum(int((~m).sum()) for m in steady["dense"].values())
        n = sum(d.numel() for d in diff.values())
        report[name] = {"head_dim": cfg.head_dim,
                        "heads": [cfg.n_heads, cfg.n_kv_heads],
                        "losses": losses, "loss_rel": rel,
                        "param_err": worst, "param_err_all": worst_all,
                        "excluded": excluded, "params": n}
        print(f"head dim {cfg.head_dim} exact training ({name}, f32, 3 "
              f"steps): losses flash {losses['flash']} dense "
              f"{losses['dense']} (worst rel {rel:.3g}, tol 1e-5); params "
              f"max|flash - dense| {worst:.3g} ({worst_all:.3g} over all, "
              f"{excluded} of {n} elements with a gradient under 1e-7 left "
              f"out; tol 1e-4" + (", not held: wide)" if wide else ")"))
        check(rel <= 1e-5, f"{name}: flash losses != dense losses")
        if wide:
            report[name].update(grad_errs=grad_errs, first_step=first)
            print(f"  first step: gradients max|flash - dense| / max|dense| "
                  f"{grad_errs[0]:.3g} over every leaf (tol 1e-4; steps 2 "
                  f"and 3: {grad_errs[1]:.3g}, {grad_errs[2]:.3g}); params "
                  f"max|flash - dense| {first['param_err']:.3g} (tol 1e-4; "
                  f"{first['excluded']} of {n} elements with a gradient "
                  f"under 1e-7 or of two signs left out)")
            check(grad_errs[0] <= 1e-4,
                  f"{name}: flash gradients != dense gradients")
            check(first["param_err"] <= 1e-4,
                  f"{name}: flash params != dense params after one step")
            continue
        check(worst <= 1e-4, f"{name}: flash params != dense params")
        check(excluded < n // 1000, f"{name}: {excluded} of {n} left out")
    return report


def long_pass(torch, tfa, dev, D, shape, seed):
    """triangular=True forward and backward at ``shape`` (B, S, Hq, Hkv)
    and head dim D, bf16, the natural budget: against the rectangular
    kernels within LONG_TOL, the tri kernels once each and no rectangular
    launch (the counts read alone), then the pass timed (CUDA events,
    median of 5). Returns (launches, report)."""
    B, S, Hq, Hkv = shape
    check(tfa.tri_dispatch(S, D, 2, causal=True, triangular=True,
                           window=None) == (True, True),
          f"tri_dispatch at S={S}, head dim {D}")
    g = torch.Generator(dev).manual_seed(seed)
    leaves = [torch.randn(B, S, h, D, generator=g, device=dev)
              .to(torch.bfloat16).requires_grad_() for h in (Hq, Hkv, Hkv)]
    dout = torch.randn(B, S, Hq, D, generator=g, device=dev).to(
        torch.bfloat16)

    def fwd_bwd(triangular=True):
        out, lse = tfa.flash_attention_with_lse(*leaves,
                                                triangular=triangular)
        return (out, lse) + torch.autograd.grad(out, leaves, dout)

    want = fwd_bwd(False)
    torch.cuda.synchronize()
    tfa.reset_launches()
    got = fwd_bwd()
    torch.cuda.synchronize()
    launches = dict(tfa.LAUNCHES)
    errs = [(a.float() - b.float()).abs().max().item()
            / (1.0 if i < 2 else b.float().abs().max().item())
            for i, (a, b) in enumerate(zip(got, want))]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    report = dict(zip(("out", "lse", "dq_rel", "dk_rel", "dv_rel"), errs))
    report.update(shape=[B, S, Hq, Hkv, D],
                  ms=time_ms(fwd_bwd, flush, reps=5, warm=1),
                  rect_ms=time_ms(lambda: fwd_bwd(False), flush, reps=5,
                                  warm=1))
    print(f"triangle vs rectangle at head dim {D}, bf16 B={B} S={S} Hq={Hq} "
          f"Hkv={Hkv}: {json.dumps(report)} (tol {LONG_TOL}); launches "
          f"{launches}")
    check(all(e <= LONG_TOL for e in errs) and all(
        bool(torch.isfinite(t).all()) for t in got),
        f"triangular=True disagrees with the rectangular kernels at head "
        f"dim {D}")
    for name, n in launches.items():
        want_n = 1 if name.endswith("_tri") else 0
        check(n == want_n, f"{name}: {n} launches on the head-dim-{D} long "
              f"path, expected {want_n}")
    del leaves, dout, want, got, flush
    torch.cuda.empty_cache()
    return launches, report


# what a bf16 training run must leave of the card's free memory at its
# allocated peak (train_steps): a run that comes closer would go out of
# memory on a card with a little less free or a little more fragmented.
# The allocator's reserved peak is reported, not held to it: a cudaMalloc
# that fails first frees the cached blocks and is retried (alloc_retries)
TRAIN_HEADROOM_GB = 4.0


def train_steps(torch, tt, tfa, cfg, what, dev, shape=SMALL_TRAIN_SHAPE,
                steps=5):
    """``cfg`` in bf16 (f32 masters, remat, flash) at ``shape`` (B, S): a
    warm-up step and ``steps`` on one batch, the loss finite and falling,
    the launches read across the steps and checked (#1 twice a layer under
    remat, #6 and #7 once), and the peak memory of the run from the state's
    making on, allocated and reserved, and the allocator's retries beside
    the card's free memory before it: the allocated peak at least
    TRAIN_HEADROOM_GB under it. Returns (launches, report)."""
    cfg = dataclasses.replace(cfg, attn_impl="flash", remat=True)
    (B, S), L = shape, cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    free, base = torch.cuda.mem_get_info(dev)[0], torch.cuda.memory_reserved(
        dev)
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    params, opt = tt.make_train_state(
        cfg, torch.Generator(dev).manual_seed(SEED), dev)
    step = tt.make_train_step(cfg, opt)
    g = torch.Generator().manual_seed(SEED + 93)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g).to(dev)
    warm = step(params, toks[:, :-1], toks[:, 1:]).item()
    torch.cuda.synchronize()
    tfa.reset_launches()
    t0 = time.perf_counter()
    losses = [step(params, toks[:, :-1], toks[:, 1:]).item()
              for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = dict(tfa.LAUNCHES)
    report = {"head_dim": cfg.head_dim, "layers": L, "batch": B,
              "seq_len": S, "warm_loss": warm, "losses": losses,
              "step_ms": ms,
              "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
              "reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9,
              "alloc_retries": torch.cuda.memory_stats(dev).get(
                  "num_alloc_retries", 0) - retries,
              "free_gb_before": free / 1e9,
              "headroom_gb": (free + base - torch.cuda.max_memory_allocated(
                  dev)) / 1e9}
    print(f"train {what} (bf16, remat, flash) B={B} S={S}: "
          f"{json.dumps(report)}; launches over {steps} steps {launches}")
    check(all(x == x and abs(x) < float("inf") for x in [warm] + losses),
          f"{what}: a training loss is not finite")
    check(losses[-1] < losses[0] < warm, f"{what}: loss did not fall: "
          f"{losses}")
    check(report["headroom_gb"] >= TRAIN_HEADROOM_GB,
          f"{what}: the allocated peak came within "
          f"{report['headroom_gb']:.2f} GB of the card's free memory, under "
          f"the {TRAIN_HEADROOM_GB} GB kept")
    for name, n in launches.items():
        want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
                "flash_bwd_dkv": L * steps}.get(name, 0)
        check(n == want, f"{what}: {name} launched {n} times, expected "
              f"{want}")
    del params, opt, step
    torch.cuda.empty_cache()
    return launches, report


def small_pipeline(torch, tl, tm, tt, jobs, launch, dev):
    """The pp2_tp2_flash pipeline (tests/test_parallel_extra.py:176's twin)
    on tiny at 4 layers, f32, one step of (pp 2, tp 2) over 4 ranks sharing
    the card over gloo (n_micro 2, B=4, S=128) against this process's
    single-process step: loss within 1e-5 relative, each rank's gradients
    within 1e-4 of the largest and params within 1e-5 where |g| >= 1e-7
    (held_exact), and each rank's launches of #1, #6 and #7 (2 microbatches
    through its 2 layers, forward and backward once: 4 each). Returns the
    launches by rank."""
    cfg = dataclasses.replace(tl.PRESETS["tiny"], n_layers=4,
                              dtype="float32", attn_impl="flash")
    with tempfile.TemporaryDirectory(prefix="chip_smoke-pipeline-") as d:
        path = str(Path(d) / "tiny4.pt")
        loss = parallel_reference(torch, tm, tt, jobs, cfg, dev, path,
                                  shape=SMALL_PIPELINE_SHAPE)
        case = {"kind": "pipeline", "mesh": {"pp": 2, "tp": 2}, "cfg": cfg,
                "seed": SEED + 30, "batch_shape": SMALL_PIPELINE_SHAPE,
                "batch_seed": SEED + 31, "reference": path,
                "n_micro": PARALLEL_MICRO, "n_chunks": 1}
        t0 = time.perf_counter()
        res = launch.spawn_ranks(jobs.run_cases, 4, backend="gloo",
                                 device=dev, timeout_s=600,
                                 args=([case], dev.type))
        wall = time.perf_counter() - t0
    got = [r[0] for r in res]
    print(f"pp2_tp2_flash on tiny at 4 layers ({SHARED}; {wall:.1f} s for "
          f"the world):")
    held_exact("pp2_tp2_flash {'pp': 2, 'tp': 2}", got, loss,
               SMALL_PIPELINE_SHAPE)
    want = PARALLEL_MICRO * cfg.n_layers // 2
    for gr in got:
        for k in SHARDED_KERNELS:
            check(gr["launches"][k] == want,
                  f"pp2_tp2_flash rank {gr['coords']}: {k} launched "
                  f"{gr['launches'][k]} times, expected {want}")
    return {k: [gr["launches"][k] for gr in got] for k in SHARDED_KERNELS}


def phase_small_train(torch, tl, tm, tt, tfa, jobs, launch, bench, dev):
    """Phase 19 (d) bf16 and (e): each head dim's main path, its launches
    read alone. At 32: the fast bench_engine model trained (``d32_train``)
    and a triangular=True pass at (1, 50176, 8/4) (``d32_long``); at 16:
    tiny trained (``d16_train``), tiny-moe through make_moe_train_step at
    MOE_TRAIN_SHAPE (``moe_train_d16``), the pp2_tp2_flash pipeline on tiny
    (``d16_pipeline``, a list by rank) and a triangular=True pass at (1,
    98816, 4/2) (``d16_long``). Every one of #6, #7, #3, #8 and #9 launches
    at each head dim. Returns ({D: {path: launches}}, report)."""
    by_dim, report = {32: {}, 16: {}}, {}
    engine = bench.engine_config(True)
    check(engine.head_dim == 32, f"the fast bench_engine model: {engine}")
    by_dim[32]["d32_train"], report["d32_train"] = train_steps(
        torch, tt, tfa, engine, "the fast bench_engine model (8/4 heads of "
        "32)", dev)
    by_dim[32]["d32_long"], report["d32_long"] = long_pass(
        torch, tfa, dev, 32, SMALL_LONG[32], SEED + 94)
    tiny = tl.PRESETS["tiny"]
    check(tiny.head_dim == 16, f"tiny: {tiny}")
    by_dim[16]["d16_train"], report["d16_train"] = train_steps(
        torch, tt, tfa, tiny, "tiny (4/2 heads of 16)", dev)
    by_dim[16]["moe_train_d16"], report["moe_train_d16"] = phase_moe_train(
        torch, tm, tfa, dev, cfg=tm.PRESETS_MOE["tiny-moe"], steps=3,
        what="tiny-moe: 2 layers, 4/2 heads of 16, 4 experts, top-2")
    torch.cuda.empty_cache()
    by_dim[16]["d16_pipeline"] = small_pipeline(torch, tl, tm, tt, jobs,
                                                launch, dev)
    by_dim[16]["d16_long"], report["d16_long"] = long_pass(
        torch, tfa, dev, 16, SMALL_LONG[16], SEED + 95)
    for D, paths in by_dim.items():
        for name in D64_TRAIN_ROWS:
            n = sum(sum(c) if isinstance(c, list) else c
                    for c in (v.get(name, 0) for v in paths.values()))
            check(n > 0, f"{name}: no launch at head dim {D}")
    print(f"head dims 32 and 16 in training: {json.dumps(report)}")
    return by_dim, report


# The serving kernels' checks and timed rows at one head dim, by ServeDim:
# phases 2 (D = 128), 16 (64), 18 (32, 16), 20 (96, 80) and 22 (256) each call
# serve_kernels with theirs. The checks run in groups, each group's
# self-attention cases (B, S, causal, window) and cache cases (B, S,
# start, pads, window, sinks, int8) in bf16 and then in f32, from one
# generator seeded with ``seed``; the timed calls, in bf16 at
# ``timed_ML``: a fresh prefill (B, S), an admission (B, S, start, pads)
# and a decode step (B, starts, pads) on a bf16 and an int8 cache of the
# same values (#4 and #5 under ``window``, the path's sliding window),
# verify blocks of S queries at the step's starts, and with ``at`` #1, #4
# and #5 once more at the shapes of head dim ``ref``'s rows (ref, Hq, Hkv,
# fresh, admission, step, max_len), so that a row reads beside that one.
@dataclasses.dataclass(frozen=True)
class ServeDim:
    D: int
    Hq: int
    Hkv: int
    ML: int
    seed: int
    groups: tuple
    fresh: tuple
    admission: tuple
    step: tuple
    timed_ML: int
    verify: tuple = ()
    window: int | None = None
    at: tuple | None = None


def both_caches(cases):
    """Each (B, S, start, pads, window, sinks) case on a bf16 (f32) and
    then on an int8 cache."""
    return tuple((*c, int8) for c in cases for int8 in (False, True))


# phase 20: head dims 96 and 80 in serving. Llama-family configs at
# Phi-3-mini-4k's widths (the Hugging Face config.json of
# microsoft/Phi-3-mini-4k-instruct: hidden 3072, 32 layers, 32/32 heads of
# 96, intermediate 8192, vocab 32064, rope_theta 10000) and at
# H2O-Danube-1.8B's (that of h2oai/h2o-danube-1.8b-base: hidden 2560, 24
# layers, 32/8 heads of 80, intermediate 6912, vocab 32000, sliding window
# 4096), written out as LlamaConfig literals (the JAX package has no such
# preset; no file is fetched: the weights are seeded at random) and served
# through the D = 96 and 80 instances of #1/#2, #4 and #5
MID_HEADS = {96: (32, 32, None), 80: (32, 8, 4096)}   # Hq, Hkv, window


def mid_models(tl):
    """{head dim: the full-size bf16 flash config at that head dim}."""
    return {
        # microsoft/Phi-3-mini-4k-instruct (config.json)
        96: tl.LlamaConfig(vocab_size=32064, dim=3072, n_layers=32,
                           n_heads=32, n_kv_heads=32, hidden_dim=8192,
                           max_seq_len=4096, rope_theta=10000.0,
                           attn_impl="flash"),
        # h2oai/h2o-danube-1.8b-base (config.json)
        80: tl.LlamaConfig(vocab_size=32000, dim=2560, n_layers=24,
                           n_heads=32, n_kv_heads=8, hidden_dim=6912,
                           max_seq_len=16384, rope_theta=10000.0,
                           sliding_window=4096, attn_impl="flash")}


# phase 22: head dim 256 in serving. A Llama config at Gemma-2B's widths
# (the Hugging Face config.json of google/gemma-2b: hidden 2048, 18 layers,
# 8/1 heads of 256, intermediate 16384, vocab 256000, max_position 8192,
# rms_norm_eps 1e-6, rope_theta 10000): the JAX package's Llama block at
# those widths (SwiGLU, an untied output, no embedding scaling; nothing
# Gemma-specific, which the JAX package has none of), written out as a
# LlamaConfig literal, ~3.03e9 parameters (no file is fetched: the weights
# are seeded at random), served through the D = 256 instances of #1/#2, #4
# and #5 (flash_fwd_wide.cu, flash_decode_wide.cu); #1 timed once more at
# the D = 128 training row's pairs and heads
WIDE_HEADS = {256: (8, 1, None)}      # Hq, Hkv, window
WIDE_TRAIN_SHAPE = (8, 2048, 16, 8)   # B, S, Hq, Hkv


def wide_models(tl):
    """{head dim: the full-size bf16 flash config at that head dim}."""
    # google/gemma-2b (config.json)
    return {256: tl.LlamaConfig(vocab_size=256000, dim=2048, n_layers=18,
                                n_heads=8, n_kv_heads=1, hidden_dim=16384,
                                max_seq_len=8192, rope_theta=10000.0,
                                norm_eps=1e-6, attn_impl="flash")}


# phases 24 and 26: head dims 100 and 120 in serving, D = 128's tile with
# a zeroed pad inside its last k-step (flash_fwd_pad.cu,
# flash_decode_pad.cu). 100: a Llama config at OpenLLaMA-3B's widths (the
# Hugging Face config.json of openlm-research/open_llama_3b and
# open_llama_3b_v2: hidden 3200, 26 layers, 32/32 heads of 100,
# intermediate 8640, vocab 32000, max_position 2048, rms_norm_eps 1e-6,
# rope_theta 10000; ~3.43e9 parameters), rows of no whole number of
# 16-byte chunks copied in 8-byte (bf16) and 4-byte (int8) pieces. 120: a
# Llama config at H2O-Danube3-4B's widths (the Hugging Face config.json of
# h2oai/h2o-danube3-4b-base and the H2O-Danube3 technical report,
# arXiv:2407.09276, Table 1: hidden 3840, 24 layers, 32/8 heads of 120,
# intermediate 10240, vocab 32000, max_position 8192, rope_theta 100000,
# rms_norm_eps 1e-5, an untied output; ~3.96e9 parameters), bf16 rows of 15
# whole chunks copied as D = 128's 16, the 16th zero-filled, int8 rows of
# 120 bytes in 8-byte pieces. Both written out as LlamaConfig literals (no
# file is fetched: the weights are seeded at random)
PAD_HEADS = {100: (32, 32, None), 120: (32, 8, None)}   # Hq, Hkv, window


# Each pad head dim's runs: the model's name, the base of its seeds (phases
# 26 and 27 draw 20 past phases 24 and 25), the Hq, Hkv of its sentinel
# stores (8/2 at 120, Danube3's group of 4), the head dims refused by name
# after its serving paths (serving_refused), and the (B, S) of its bf16
# training steps
@dataclasses.dataclass(frozen=True)
class PadRun:
    model: str
    seed: int
    stores: tuple
    refused: tuple
    train: tuple


PAD_RUNS = {100: PadRun("OpenLLaMA-3B", SEED, (8, 4), (36,), (4, 2048)),
            120: PadRun("H2O-Danube3-4B", SEED + 20, (8, 2), (112, 36),
                        (1, 4096))}


def pad_models(tl):
    """{head dim: the full-size bf16 flash config at that head dim}."""
    return {
        # openlm-research/open_llama_3b (config.json)
        100: tl.LlamaConfig(vocab_size=32000, dim=3200, n_layers=26,
                            n_heads=32, n_kv_heads=32, hidden_dim=8640,
                            max_seq_len=2048, rope_theta=10000.0,
                            norm_eps=1e-6, attn_impl="flash"),
        # h2oai/h2o-danube3-4b-base (config.json; arXiv:2407.09276 Table 1)
        120: tl.LlamaConfig(vocab_size=32000, dim=3840, n_layers=24,
                            n_heads=32, n_kv_heads=8, hidden_dim=10240,
                            max_seq_len=8192, rope_theta=100000.0,
                            norm_eps=1e-5, attn_impl="flash")}


# the self-attention checks of phase 18's head dims (S=200 tiles for no JAX
# block: the launch itself) and of phase 20's (and 22's)
SMALL_FWD_CASES = ((2, 128, True, None), (2, 128, False, None),
                   (1, 512, True, 200), (2, 200, False, None))
MID_FWD_CASES = ((2, 512, True, None), (2, 512, False, None),
                 (1, 4096, True, 1024), (2, 200, False, None))
# (B, S, start, pads, window, sinks) of #4 at head dims 96, 80, 256 and 100, ML
# 2048:
# an engine admission after a prefix, generate's left-padded prefill, a
# window with sinks, a ragged S with both
MID_CACHE_CASES = ((1, 256, 128, [28], None, 0), (2, 512, 0, [0, 37], None, 0),
                   (1, 256, 900, [7], 256, 4), (2, 200, 400, [0, 37], 256, 4))
SERVE_DIMS = {
    # phase 2: Llama-7B's heads; the rows without a head-dim suffix
    128: ServeDim(
        128, 32, 8, 2048, SEED,
        groups=((((2, 512, True, None), (1, 4096, True, None),
                  (1, 4096, True, 1024), (2, 512, False, None)),
                 ((1, 128, 0, [40], None, 0, False),
                  (2, 512, 0, [0, 200], None, 0, False),
                  (1, 512, 512, None, None, 0, False),
                  (2, 256, 300, [0, 100], None, 0, True),
                  (1, 256, 900, [7], 256, 4, False),
                  (4, 1, [600, 300, 1500, 100], [0, 20, 0, 5], None, 0,
                   False),
                  (2, 5, 1000, None, None, 0, False),
                  (2, 1, [700, 64], [0, 9], None, 0, True),
                  (2, 5, [1400, 300], [4, 0], 300, 4, False))),
                # then the int8 cache's prefill on the tensor cores (start
                # 0; ragged S, window and sinks), the split decode's edge
                # cases on every cache
                ((), ((1, 128, 0, [40], None, 0, True),
                      (2, 200, 400, [0, 37], 256, 4, True))
                 + both_caches(DECODE_SPLIT_CASES))),
        fresh=(2, 512), admission=(1, 256, 128, [28]),
        step=(4, DECODE_STARTS, DECODE_PADS), timed_ML=2048, verify=(5, 16)),
    # phase 16: the bench_moe_decode model's 16/8 heads, timed at its twin's
    # prefill and decode step (D64_TWIN)
    64: ServeDim(
        64, 16, 8, 2048, SEED + 61,
        groups=((((8, 512, True, None), (2, 512, False, None),
                  (1, 4096, True, 1024), (2, 1024, False, 300)),
                 both_caches(D64_CACHED_CASES + DECODE_SPLIT_CASES + (
                     (4, 1, DECODE_STARTS, DECODE_PADS, None, 0),))),),
        fresh=(8, 512), admission=(8, 512, 0, None), step=(8, 600, None),
        timed_ML=640),
    # phase 18: the fast bench_engine model's 8/4 heads of 32, tiny's 4/2 of
    # 16, timed at the bench_engine model's shapes and at the D = 64 rows'
    **{D: ServeDim(
        D, Hq, Hkv, SMALL_ML, SEED + 81 + 4 * (D == 16),
        groups=((SMALL_FWD_CASES, both_caches(SMALL_CACHE_CASES)),),
        fresh=(2, 128), admission=(1, 128, 0, None),
        step=(2, SMALL_STARTS, SMALL_PADS), timed_ML=SMALL_ML, verify=(5,),
        at=(64, 16, 8, (8, 512), (8, 512, 0, None), (8, 600, None), 640))
       for D, (Hq, Hkv) in SMALL_HEADS.items()},
    # phases 20, 22, 24 and 26: at the models' own heads (MID_HEADS,
    # WIDE_HEADS, PAD_HEADS), timed at generate's fresh and left-padded
    # prefills (B=2, S0=512) and a decode step of theirs (max_len 1024) and
    # at the D = 128 rows' shapes
    **{D: ServeDim(
        D, Hq, Hkv, 2048,
        SEED + {96: 91, 80: 95, 256: 111, 100: 131, 120: 151}[D],
        groups=((MID_FWD_CASES, both_caches(
            MID_CACHE_CASES + DECODE_SPLIT_CASES
            + ((4, 1, DECODE_STARTS, DECODE_PADS, None, 0),))),),
        fresh=(2, 512), admission=(2, 512, 0, [0, 37]),
        step=(2, [560, 523], [0, 37]), timed_ML=1024, verify=(5,),
        window=window, at=(128, 32, 8, (2, 512), (1, 256, 128, [28]),
                           (4, DECODE_STARTS, DECODE_PADS), 2048))
       for D, (Hq, Hkv, window) in {**MID_HEADS, **WIDE_HEADS,
                                    **PAD_HEADS}.items()},
}
# the rows of each head dim and the TPU kernel each replaces
SERVE_ROWS = {
    "flash_fwd": "70 (_kernel_resident), :202 (_kernel)",
    "flash_cached": "468 (_kernel_cached)",
    "flash_cached_int8": "468 (_kernel_cached), int8 cache",
    "flash_decode": "660 (_kernel_decode)",
    "flash_decode_int8": "660 (_kernel_decode), int8 cache"}


def serve_suffix(D):
    """A head dim's row suffix: none at 128 (phase 2's rows), _d<D> else."""
    return "" if D == 128 else f"_d{D}"


def serve_tc_kernels(_cuda, D):
    """The tensor-core instances of the serving rows at head dim D: {row:
    (source, a substring of the mangled name)}."""
    src, sfx = _cuda.entry("flash_fwd", D), serve_suffix(D)
    return {f"flash_fwd{sfx}": (src, "flash_fwd_tc_kernelI13__nv_bfloat16"
                                     f"Li{D}E"),
            f"flash_cached_int8{sfx}": (src, f"flash_fwd_tc_kernelIaLi{D}E")}


def serve_decode_instances(tfa, D):
    """The flash_decode instances of the timed rows at head dim D (the
    decode step and its verify blocks, R from the rows of a unit): {row:
    a substring of the mangled name}."""
    spec, sfx = SERVE_DIMS[D], serve_suffix(D)
    out = {}
    for S in (1,) + spec.verify:
        R = tfa._decode_rows(S * (spec.Hq // spec.Hkv))[0]
        tag = "" if S == 1 else f"_s{S}"
        out[f"flash_decode{sfx}{tag}"] = \
            f"flash_decode_kernelI13__nv_bfloat16S1_Li{D}ELi{R}E"
        out[f"flash_decode_int8{sfx}{tag}"] = \
            f"flash_decode_kernelI13__nv_bfloat16aLi{D}ELi{R}E"
    return out


def serve_build_report(_cuda, tfa, logs, D):
    """(tensor-core report, decode ptxas) of the serving instances at head
    dim D (tc_build_report, decode_build_report)."""
    return (tc_build_report(_cuda, logs, serve_tc_kernels(_cuda, D)),
            decode_build_report(logs, serve_decode_instances(tfa, D),
                                _cuda.entry("flash_decode", D)))


def serve_reports(rows, report):
    """Adds a head dim's serve_build_report to its rows: the tensor-core
    instances' ptxas and HGMMA, the timed decode instances' ptxas (their
    verify blocks' too)."""
    tc, dec = report
    for r in rows:
        r.update(tc.get(r["name"], {}))
        if r["name"] in dec:
            r["ptxas"] = dec[r["name"]]
        for S, v in r.get("verify_blocks", {}).items():
            if f"{r['name']}_s{S[2:]}" in dec:
                v["ptxas"] = dec[f"{r['name']}_s{S[2:]}"]


def serve_kernels(torch, tfa, td, dev, deferred, D):
    """#1/#2, #4 on a bf16 and an int8 cache and #5 on both at head dim D
    (SERVE_DIMS[D]) against their plain versions, bf16 within 1e-2 and f32
    within 1e-4 (lse within 1e-4); then the bf16 calls timed beside their
    plain versions, SDPA (none for an int8 cache) and the bound, their
    device times joining ``deferred``. Returns the head dim's rows of the
    kernels line (launches filled later)."""
    import torch.nn.functional as F
    spec = SERVE_DIMS[D]
    Hq, Hkv = spec.Hq, spec.Hkv
    g = torch.Generator(dev).manual_seed(spec.seed)
    bf = torch.bfloat16
    errs = dict.fromkeys(SERVE_ROWS, 0.0)

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def ints(x):
        return (torch.tensor(x, dtype=torch.int32, device=dev)
                if isinstance(x, list) else x)

    def held(row, dtype, what, e, e_lse=None):
        tol = TOL[str(dtype).split(".")[1]]
        print(f"{row} at head dim {D}, {dtype} {what}: max|out-plain| {e:.3g}"
              + ("" if e_lse is None else f" |lse-plain| {e_lse:.3g}")
              + f" (tol {tol})")
        check(e <= tol and (e_lse is None or e_lse <= 1e-4),
              f"{row} disagrees with plain at head dim {D}: {what}")
        if dtype == bf:
            errs[row] = max(errs[row], e)

    def cache(dtype, B, Hkv, ml, int8):
        kc, vc = rnd(B, Hkv, ml, D, dtype=dtype), rnd(B, Hkv, ml, D,
                                                     dtype=dtype)
        if not int8:
            return kc, vc, {}
        (k8, ks), (v8, vs) = td._quantize_kv(kc), td._quantize_kv(vc)
        return k8, v8, {"k_scale": ks, "v_scale": vs}

    for fwd_cases, cache_cases in spec.groups:
        for dtype in (bf, torch.float32):
            for B, S, causal, window in fwd_cases:
                q = rnd(B, S, Hq, D, dtype=dtype)
                k, v = rnd(B, S, Hkv, D, dtype=dtype), rnd(B, S, Hkv, D,
                                                            dtype=dtype)
                kw = dict(causal=causal, window=window)
                if S % tfa._auto_block(S) == 0:
                    out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
                else:      # no JAX block tiles S: the launch itself
                    out, lse = tfa._launch(
                        "flash_fwd", q, k.transpose(1, 2), v.transpose(1, 2),
                        0, scale=D ** -0.5, want_lse=True, **kw)
                ref, ref_lse = tfa.attention_plain(
                    q, k.transpose(1, 2), v.transpose(1, 2), 0, **kw)
                held("flash_fwd", dtype, f"B={B} S={S} causal={causal} "
                     f"window={window}", err(out, ref), err(lse, ref_lse))
                del q, k, v, out, lse, ref, ref_lse
            for B, S, start, pads, window, sinks, int8 in cache_cases:
                q = rnd(B, S, Hq, D, dtype=dtype)
                kc, vc, kw = cache(dtype, B, Hkv, spec.ML, int8)
                kw.update(window=window, sinks=sinks)
                if pads is not None:
                    kw["pad_lens"] = ints(pads)
                st = ints(start)
                decode = S <= tfa.DECODE_MAX_S
                if decode:
                    got = tfa.flash_attention_decode(q, kc, vc, st, **kw)
                elif isinstance(start, list):   # per-row starts: the launch
                    got, _ = tfa._launch("flash_fwd", q, kc, vc, st,
                                         causal=True, scale=D ** -0.5, **kw)
                else:
                    got = tfa.flash_attention_cached(q, kc, vc, st, **kw)
                row = ("flash_decode" if decode else "flash_cached") \
                    + ("_int8" if int8 else "")
                held(row, dtype, f"B={B} S={S} start={start} pads={pads} "
                     f"window={window} sinks={sinks}",
                     err(got, tfa.attention_plain(q, kc, vc, st, **kw)[0]))
    torch.cuda.synchronize()

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    src = "gpu_provisioner_tpu_torch/ops/csrc/"
    tpu = "gpu_provisioner_tpu/ops/flash_attention.py:"
    sfx = serve_suffix(D)
    rows = []

    def mask(B, S, starts, pads, ml, window):
        """[B, 1, S, ml]: key attendable from query (SDPA's attn_mask)."""
        st = torch.as_tensor(starts, device=dev).reshape(-1).expand(B)
        pd = torch.zeros(B, dtype=torch.long, device=dev) if pads is None \
            else torch.as_tensor(pads, device=dev)
        qp = (st[:, None] + torch.arange(S, device=dev))[:, :, None]
        kp = torch.arange(ml, device=dev)
        keep = (kp <= qp) & (kp >= pd[:, None, None])
        if window:
            keep = keep & (kp > qp - window)
        return keep[:, None]

    def calls(Hq, Hkv, fresh, admission, step, ml, window, verify=()):
        """{(row, S of a verify block or None): (shape, kernel, plain,
        library, (ops, bytes), names)} of the timed calls at these shapes,
        #4 and #5 on one bf16 cache and its int8 copy."""
        out = {}
        B, S = fresh
        q, k, v = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        out["flash_fwd", None] = (
            f"B={B} S={S} causal Hq={Hq} Hkv={Hkv} D={D}",
            lambda: tfa.flash_attention_with_lse(q, k, v),
            lambda: tfa.attention_plain(q, k.transpose(1, 2),
                                        v.transpose(1, 2), 0),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True),
            work(B, S, Hq, Hkv, D, S, 0, None, None, 0, True, 2, 2, False,
                 True), ("flash_fwd_tc_kernel",))
        kc, vc, _ = cache(bf, max(admission[0], step[0]), Hkv, ml, False)
        (k8, ks), (v8, vs) = td._quantize_kv(kc), td._quantize_kv(vc)
        blocks = [("flash_cached", None, admission)] + [
            ("flash_decode", n, (step[0], n) + tuple(step[1:]))
            for n in (1,) + tuple(verify)]
        for name, n, (B, S, start, pads) in blocks:
            qq = rnd(B, S, Hq, D)
            st, pl = ints(start), ints(pads)
            fn = tfa.flash_attention_cached if name == "flash_cached" \
                else tfa.flash_attention_decode
            m = mask(B, S, start, pads, ml, window)
            for int8 in (False, True):
                kk, vv = (k8[:B], v8[:B]) if int8 else (kc[:B], vc[:B])
                kw = dict(pad_lens=pl, window=window)
                if int8:
                    kw.update(k_scale=ks[:B], v_scale=vs[:B])
                out[name + ("_int8" if int8 else ""), None if n == 1 else n] \
                    = (f"B={B} S={S} start={start} pads={pads} "
                       f"window={window} ML={ml} Hq={Hq} Hkv={Hkv} D={D}",
                       lambda fn=fn, qq=qq, kk=kk, vv=vv, st=st, kw=kw:
                           fn(qq, kk, vv, st, **kw),
                       lambda qq=qq, kk=kk, vv=vv, st=st, kw=kw:
                           tfa.attention_plain(qq, kk, vv, st, **kw),
                       None if int8 else (
                           lambda qq=qq, kk=kk, vv=vv, m=m:
                           F.scaled_dot_product_attention(
                               qq.transpose(1, 2), kk, vv, attn_mask=m,
                               enable_gqa=True)),
                       work(B, S, Hq, Hkv, D, ml, st, pl, window, 0, True, 2,
                            1 if int8 else 2, int8, False),
                       ("flash_fwd_tc_kernel",) if name == "flash_cached"
                       else ("flash_decode",))
        return out

    def timed(r, shape, kernel, plain, library, ops_bytes, names):
        """Adds the shape and timing()'s keys to entry ``r``, its device
        times measured last (device_times). Returns ``r``."""
        r.update(shape=shape, **timing(kernel, plain, library, ops_bytes,
                                       flush))
        deferred.append((r, kernel, library, names))
        return r

    for (name, S), c in calls(Hq, Hkv, spec.fresh, spec.admission,
                              spec.step, spec.timed_ML, spec.window,
                              spec.verify).items():
        if S is not None:       # a verify block of the decode row before it
            r = next(r for r in rows if r["name"] == name + sfx)
            v = r.setdefault("verify_blocks", {})[f"S={S}"] = timed({}, *c)
            print(f"{r['name']} verify block S={S}: {json.dumps(v)}")
            continue
        kernel = "flash_decode" if name.startswith("flash_decode") \
            else "flash_fwd"
        r = timed({"name": name + sfx, "route": "cuda",
                   "source": f"{src}{tfa._cuda.entry(kernel, D)}.cu",
                   "replaces": tpu + SERVE_ROWS[name]
                   + ("" if D == 128 else f", head dim {D}"),
                   "launches": 0, "max_abs_err": errs[name],
                   "tolerance": TOL["bfloat16"]}, *c)
        if c[3] is None:
            r["library_note"] = "no single PyTorch call attends over an " \
                                "int8 cache"
        rows.append(r)
        print(f"{r['name']}: {json.dumps(r)}")
    if spec.at:
        ref, Hq2, Hkv2, fresh, admission, step, ml = spec.at
        at = calls(Hq2, Hkv2, fresh, admission, step, ml, None)
        for name in ("flash_fwd", "flash_cached", "flash_decode"):
            shape, kernel, plain, _, ops_bytes, names = at[name, None]
            r = next(r for r in rows if r["name"] == name + sfx)
            v = r[f"at_d{ref}_shape"] = timed(
                {}, f"as the head-dim-{ref} {name} row: {shape}", kernel,
                plain, None, ops_bytes, names)
            print(f"{r['name']} at the head-dim-{ref} row's shape: "
                  f"{json.dumps(v)}")
    del flush
    return rows


def engine_steps(slots, news):
    """(admissions, decode steps) of a ServeEngine pass over requests of
    ``news`` new tokens each (>= 2; no eos), ``slots`` at a time: an
    admission emits a request's first token, every step one token for each
    live slot (ServeEngine.step)."""
    queue, live, steps = list(news), [], 0
    while queue or live:
        while queue and len(live) < slots:
            live.append(queue.pop(0) - 1)
        steps += 1
        live = [n - 1 for n in live if n > 1]
    return len(news), steps


def phase_mid_exact(torch, tl, tm, td, te, dev):
    """Phase 20 (b): at Phi-3-mini's and H2O-Danube-1.8B's widths (96 and
    80, mid_models) cut to 2 layers, f32 (the kernels' f32 instances),
    flash against dense on the card (serve_exact: logits within 1e-4 on an
    f32 cache and 2e-2 on an int8 one, generate fresh, left-padded and on
    an int8 cache token-equal, a ServeEngine pass with a shared prefix
    stream-equal)."""
    models = tuple((f"{name} width, 2 layers", dataclasses.replace(
        cfg, n_layers=2), tl.init_params, td.cached_forward)
        for name, cfg in zip(("Phi-3-mini", "H2O-Danube-1.8B"),
                             mid_models(tl).values()))
    return serve_exact(torch, tm, td, te, models, MID_HEADS, dev, SEED + 92)


def serve_paths(torch, tl, td, te, tfa, dev, models, seed):
    """bf16 at full depth, each of ``models`` ({head dim: (name, config)})
    through generate (B=2, S0=512, 16 new, max_len 1024: fresh, left-padded
    on a bf16 and on an int8 cache) and a ServeEngine pass of three
    requests on two slots (buckets 256, 512); every kernel's launches read
    across each model's run equal to what the path predicts (L a prefill,
    L a decode step, L an engine admission: serve_launches, engine_steps)
    and nothing else launched. A windowed config prefills through #4 (in
    the JAX package as here), so its fresh generate runs without its
    window: at these lengths, under the window, the same attention.
    Returns ({D: launches}, {D: report}: parameters, tokens/s, peak
    memory)."""
    g = torch.Generator().manual_seed(seed)
    B, S0, new, ml = 2, 512, 16, 1024
    news, slots = (8, 6, 5), 2
    launches, report = {}, {}
    for D, (name, cfg) in models.items():
        check(cfg.head_dim == D, f"head dim {cfg.head_dim}, expected {D}")
        L = cfg.n_layers
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tl.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                dev)
        torch.cuda.synchronize()
        rep = report[D] = {
            "params": sum(t.numel() for t in _named(params).values()),
            "init_s": time.perf_counter() - t0}
        want: dict = {}

        def gen(what, c, pads=False, fresh=False):
            prompt = torch.randint(1, c.vocab_size, (B, S0), generator=g)
            if pads:
                prompt[1, :37] = 0
            t0 = time.perf_counter()
            out = td.generate(params, prompt, c, max_new_tokens=new,
                              max_len=ml, pad_id=0 if pads else None,
                              device=dev)
            torch.cuda.synchronize()
            rep[what + "_tokens_per_s"] = B * new / (time.perf_counter() - t0)
            check(tuple(out.shape) == (B, new)
                  and bool(((out >= 0) & (out < c.vocab_size)).all()),
                  f"{what} at head dim {D}: {tuple(out.shape)}")
            int8 = c.kv_cache_dtype == "int8"
            for k, n in serve_launches(L, new, fresh, int8).items():
                want[k] = want.get(k, 0) + n

        tfa.reset_launches()
        gen("generate", dataclasses.replace(cfg, sliding_window=None),
            fresh=True)
        gen("padded_generate", cfg, pads=True)
        gen("int8_generate", dataclasses.replace(cfg, kv_cache_dtype="int8"),
            pads=True)
        eng = te.ServeEngine(params, cfg, slots=slots, max_len=ml,
                             prefill_buckets=(256, 512), device=dev)
        t0 = time.perf_counter()
        ids = [eng.submit(torch.randint(1, cfg.vocab_size, (n,),
                                        generator=g).tolist(), m)
               for n, m in zip((300, 200, 480), news)]
        out = eng.run()
        torch.cuda.synchronize()
        rep["engine_tokens_per_s"] = sum(news) / (time.perf_counter() - t0)
        rep["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check([len(out[i]) for i in ids] == list(news),
              f"engine streams at head dim {D}: {[out[i] for i in ids]}")
        admissions, steps = engine_steps(slots, news)
        want["flash_cached"] = want.get("flash_cached", 0) + L * admissions
        want["flash_decode"] = want.get("flash_decode", 0) + L * steps
        launches[D] = dict(tfa.LAUNCHES)
        print(f"head dim {D} ({name} width, {L} layers, bf16): launches "
              f"{launches[D]}, predicted {want}; {json.dumps(rep)}")
        for kernel, n in launches[D].items():
            check(n == want.get(kernel, 0), f"{kernel}: {n} launches on the "
                  f"head-dim-{D} path, predicted {want.get(kernel, 0)}")
        del params, eng
        torch.cuda.empty_cache()
    return launches, report


def training_refused(torch, tfa, dev, D, Hq, Hkv, seed):
    """At head dim D, which the backward and triangle kernels do not take,
    a forward whose input requires grad, triangular=True and the backward
    (rectangular and triangle) raise ValueError naming it, with no launch.
    Returns the report's line."""
    gq = torch.Generator(dev).manual_seed(seed)
    tfa.reset_launches()
    q, k, v = (torch.randn(1, 256, h, D, generator=gq, device=dev)
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    lse = torch.zeros(1, Hq, 256, device=dev)
    for what, fn in (
            ("a forward that requires grad", lambda: tfa.flash_attention(
                q.clone().requires_grad_(), k, v)),
            ("triangular=True", lambda: tfa.flash_attention(
                q, k, v, triangular=True)),
            ("flash_attention_bwd", lambda: tfa.flash_attention_bwd(
                q, k, v, q, lse, q)),
            ("triangular=True backward", lambda: tfa.flash_attention_bwd(
                q, k, v, q, lse, q, triangular=True))):
        try:
            fn()
        except ValueError as e:
            check(f"head dim {D}" in str(e), f"{what} at head dim {D}: {e}")
        else:
            check(False, f"{what} ran at head dim {D}")
    check(not any(tfa.LAUNCHES.values()),
          f"a training launch at head dim {D}: {tfa.LAUNCHES}")
    return (f"head dim {D}: a forward that requires grad, triangular=True, "
            "flash_attention_bwd, triangular=True backward")


def phase_mid_serving(torch, tl, td, te, tfa, dev):
    """Phase 20 (c), bf16, full depth: the Phi-3-mini-width and
    H2O-Danube-width models (mid_models) through serve_paths (Danube's
    fresh generate without its window). Then, at head dim 36 (a row cut
    mid-chunk, 4 mod 8 as 100 is, which no source builds; 100 trains since
    phase 25, 96 and 80 in phase 21), a training call refused by name
    before any launch (training_refused). Returns ({96: launches, 80:
    launches}, report)."""
    models = {D: ("Phi-3-mini" if D == 96 else "H2O-Danube", cfg)
              for D, cfg in mid_models(tl).items()}
    launches, report = serve_paths(torch, tl, td, te, tfa, dev, models,
                                   SEED + 93)
    report["refusals"] = training_refused(torch, tfa, dev, 36, 32, 8,
                                          SEED + 94)
    return launches, report


# phase 21: head dims 96 and 80 in training, at the phase-20 models' heads
# (MID_HEADS). #6/#7 checked causal and not, with a window of 1024 and at
# 80 Danube's own 4096 where it masks (S 5120), with and without an lse
# cotangent, at a ragged S; #3/#8/#9 and the wrapper's triangle at S 4096
# (the plain versions' S² scores of 32 q-heads in f32 must fit); the bf16
# training runs at full width, Danube at its 24 layers (B=2, S=8192: its
# window masks), Phi-3-mini at its 32 (B=4, S=4096: its f32 masters,
# gradients and AdamW moments alone are ~61 GB of the card's 80, its peak
# ~76 GB); the long pass at the long-context twin's (1, 32768, 8/4), where the
# natural budget takes flash_fwd_tri at both head dims
MID_TRI_S = 4096
MID_TRAIN_SHAPE = {96: (4, 4096), 80: (2, 8192)}   # B, S
MID_LONG = (1, 32768, 8, 4)


def mid_bwd_cases(Hq, Hkv, window):
    """(B, S, Hq, Hkv, causal, window, lse cotangent) of #6/#7 at head dims
    96 and 80: causal and not, with and without an lse cotangent, a window
    of 1024, a ragged S, and the model's own window where it masks."""
    return ((2, 1024, Hq, Hkv, True, None, False),
            (2, 1024, Hq, Hkv, True, None, True),
            (2, 1024, Hq, Hkv, False, None, True),
            (1, 4096, Hq, Hkv, True, 1024, True),
            (1, 333, Hq, Hkv, True, None, True)) + (
        ((1, window + 1024, Hq, Hkv, True, window, True),) if window else ())


MID_TRAIN_SPECS = {
    D: (Hq, Hkv, mid_bwd_cases(Hq, Hkv, window),
        small_tri_cases(Hq, Hkv, MID_TRI_S), MID_TRI_S, SEED + 100 + D)
    for D, (Hq, Hkv, window) in MID_HEADS.items()}


def phase_mid_train_exact(torch, tl, tm, tt, dev):
    """Phase 21 (d): Phi-3-mini's and H2O-Danube-1.8B's widths (mid_models)
    cut to 2 layers, three f32 train steps flash against dense
    (train_exact, wide: the first step's gradients and params held)."""
    models = tuple((f"{name} width, 2 layers",
                    dataclasses.replace(cfg, n_layers=2), False)
                   for name, cfg in zip(("Phi-3-mini", "H2O-Danube-1.8B"),
                                        mid_models(tl).values()))
    return train_exact(torch, tm, tt, models, dev, SEED + 102, wide=True)


def phase_mid_train(torch, tl, tt, tfa, dev):
    """Phase 21 (e), (f): each head dim's main path, its launches read
    alone: the Phi-3-mini-width (32 layers) and H2O-Danube-width (24
    layers) models trained in bf16 (f32 masters, remat, AdamW) at
    MID_TRAIN_SHAPE
    (``d96_train``, ``d80_train``: a warm-up and five steps, the loss
    falling, #1 2·L·5 launches and #6/#7 L·5, peak memory), then a
    triangular=True pass at MID_LONG (``d96_long``, ``d80_long``). Every
    one of #6, #7, #3, #8 and #9 launches at each head dim. Returns ({D:
    {path: launches}}, report)."""
    by_dim, report = {D: {} for D in MID_HEADS}, {}
    for D, cfg in mid_models(tl).items():
        check(cfg.head_dim == D, f"head dim {cfg.head_dim}, expected {D}")
        name = "Phi-3-mini" if D == 96 else "H2O-Danube-1.8B"
        by_dim[D][f"d{D}_train"], report[f"d{D}_train"] = train_steps(
            torch, tt, tfa, cfg, f"{name} width ({cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads of {D}, {cfg.n_layers} layers)", dev,
            MID_TRAIN_SHAPE[D])
        by_dim[D][f"d{D}_long"], report[f"d{D}_long"] = long_pass(
            torch, tfa, dev, D, MID_LONG, SEED + 103 + D)
    for D, paths in by_dim.items():
        for name in D64_TRAIN_ROWS:
            n = sum(v.get(name, 0) for v in paths.values())
            check(n > 0, f"{name}: no launch at head dim {D}")
    print(f"head dims 96 and 80 in training: {json.dumps(report)}")
    return by_dim, report


def wide_train_shape(torch, tfa, dev, D=256):
    """Phase 22 (a): #1 at head dim D (under no_grad: the serving kernel)
    at the D = 128 training row's pairs and heads (WIDE_TRAIN_SHAPE,
    causal), in bf16 against its plain version (1e-2, lse 1e-4), timed
    beside it, SDPA, the bound (4·D operations a pair·head) and the same
    call at head dim 128 (``d128_ms``). Returns the entry
    (``at_train_shape`` of the flash_fwd_d256 row)."""
    import torch.nn.functional as F
    B, S, Hq, Hkv = WIDE_TRAIN_SHAPE
    g = torch.Generator(dev).manual_seed(SEED + 112)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev)
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    with torch.no_grad():
        out, lse = tfa.flash_attention_with_lse(q, k, v)
        ref, ref_lse = tfa.attention_plain(q, kh, vh, 0)
        e = (out.float() - ref.float()).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        del out, lse, ref, ref_lse
        check(e <= TOL["bfloat16"] and e_lse <= 1e-4,
              f"flash_fwd at head dim {D}, the training shape: "
              f"{e:.3g}, lse {e_lse:.3g}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        q2, k2, v2 = (t[..., :128].contiguous() for t in (q, k, v))
        r = {"shape": f"B={B} S={S} causal Hq={Hq} Hkv={Hkv} D={D} "
                      "(no_grad)",
             "d128_ms": time_ms(lambda: tfa.flash_attention_with_lse(
                 q2, k2, v2), flush),
             "max_abs_err": e, "lse_err": e_lse,
             **timing(lambda: tfa.flash_attention_with_lse(q, k, v),
                      lambda: tfa.attention_plain(q, kh, vh, 0),
                      lambda: F.scaled_dot_product_attention(
                          q.transpose(1, 2), kh, vh, is_causal=True,
                          enable_gqa=True),
                      work(B, S, Hq, Hkv, D, S, 0, None, None, 0, True, 2,
                           2, False, True), flush)}
    print(f"flash_fwd_d{D} at the training shape: {json.dumps(r)}")
    return r


def beside_d128(rows, by_name):
    """Adds to each row's ``at_d128_shape`` (head dims 256 and 100) the D =
    128 row's time of the same call in this run (``by_name``: the D = 128
    rows; ``d128_ms``, its device time ``d128_device_ms``)."""
    for r in rows:
        if "at_d128_shape" in r:
            ref = by_name[r["name"].rsplit("_d", 1)[0]]
            r["at_d128_shape"].update(d128_ms=ref["ms"],
                                      d128_device_ms=ref.get("device_ms"))


def phase_wide_exact(torch, tl, tm, td, te, dev):
    """Phase 22 (b): Gemma-2B's widths (wide_models) cut to 2 layers, f32
    (the kernels' f32 instances), flash against dense on the card
    (serve_exact: logits within 1e-4 on an f32 cache and 2e-2 on an int8
    one, generate fresh, left-padded and on an int8 cache token-equal, a
    ServeEngine pass with a shared prefix stream-equal)."""
    models = tuple((f"{name} width, 2 layers", dataclasses.replace(
        cfg, n_layers=2), tl.init_params, td.cached_forward)
        for name, cfg in zip(("Gemma-2B",), wide_models(tl).values()))
    return serve_exact(torch, tm, td, te, models, WIDE_HEADS, dev, SEED + 113)


def phase_wide_serving(torch, tl, td, te, tfa, dev):
    """Phase 22 (c), bf16, full depth: the Gemma-2B-width model
    (wide_models, 18 layers) through serve_paths (generate fresh,
    left-padded and on an int8 cache, a ServeEngine pass; launches equal
    to the prediction, tokens/s, peak memory, parameters); then, at head
    dim 192 (a multiple of 16 past 128 that no source builds; 256 trains
    in phase 23), a training call refused by name before any launch
    (training_refused). Returns ({256: launches}, report)."""
    models = {D: ("Gemma-2B", cfg) for D, cfg in wide_models(tl).items()}
    launches, report = serve_paths(torch, tl, td, te, tfa, dev, models,
                                   SEED + 114)
    report["refusals"] = training_refused(torch, tfa, dev, 192, 8, 1,
                                          SEED + 115)
    return launches, report


# phase 24 (b): the stores of the D = 100 entries. Outputs are written into
# a view of rows 128 wide filled with SENTINEL (exact in bf16 and f32, far
# from any output of these inputs); the cases (row, S, start, max_len), B=2,
# pads 0 and 37: the prefill at start 256 and decode blocks at per-row
# starts on a cache of 512, whose planned splits are several (the merge
# launch writes the output), and on a cache of 64, one tile, whose plan is
# one split (the split kernel writes it)
SENTINEL = 4096.0
PAD_STORE_CASES = (("flash_cached", 128, 256, 512),
                   ("flash_decode", 1, [300, 450], 512),
                   ("flash_decode", 5, [300, 450], 512),
                   ("flash_decode", 1, [40, 50], 64),
                   ("flash_decode", 5, [40, 50], 64))


def sentinel_rows(torch, shape, dtype, dev, width=128):
    """A [..., width] tensor of ``shape``'s leading dims filled with
    SENTINEL, whose [..., :shape[-1]] view a launch writes (``out=``)."""
    return torch.full(tuple(shape[:-1]) + (width,), SENTINEL, dtype=dtype,
                      device=dev)


def sentinel_held(torch, errs, row, D, dtype, what, fulls, refs, rel=False):
    """Fails unless every tensor of ``fulls`` (sentinel_rows, written by one
    launch of ``row`` at head dim D) kept the sentinel in its columns D..
    and agrees in its first D columns with its plain ``refs`` (bf16 1e-2,
    f32 1e-4; with ``rel`` relative to the largest plain value, as the
    gradients are held). Keeps the worst error in errs[row][dtype] (and
    its relative one under dtype + " rel")."""
    torch.cuda.synchronize()
    kept = all(bool((f[..., D:] == SENTINEL).all()) for f in fulls)
    e = max((f[..., :D].float() - r.float()).abs().max().item()
            for f, r in zip(fulls, refs))
    r = max(((f[..., :D].float() - x.float()).abs().max()
             / x.float().abs().max()).item() for f, x in zip(fulls, refs))
    tol = TOL[str(dtype).split(".")[1]]
    width = fulls[0].shape[-1]
    print(f"{row} at head dim {D}, {dtype} {what}: columns {D}..{width - 1}"
          f" kept the sentinel: {kept}; max|out-plain| {e:.3g} rel {r:.3g} "
          f"(tol {tol}{', relative' if rel else ''})")
    check(kept, f"{row} at head dim {D} ({dtype} {what}) stored past "
          f"column {D}")
    check((r if rel else e) <= tol, f"{row} disagrees with plain at head "
          f"dim {D}, {dtype} {what}: {e:.3g} (rel {r:.3g})")
    by = errs.setdefault(row, {})
    by[str(dtype)] = max(by.get(str(dtype), 0.0), e)
    by[f"{dtype} rel"] = max(by.get(f"{dtype} rel", 0.0), r)


def pad_stores(torch, tfa, td, dev, D, Hq, Hkv, seed, width=128):
    """Phase 24 (b): each C entry at head dim D launched directly
    (tfa._launch, which counts no launch) in bf16 and in f32: flash_fwd on
    causal self-attention (B=2, S=192, a ragged last query tile) and
    PAD_STORE_CASES on a cache of the act dtype and on an int8 one, every
    output ``out`` a [B, S, Hq, D] view of rows ``width`` wide filled with
    SENTINEL. Fails unless columns D..width-1 keep the sentinel, the
    columns below D agree with the plain version (bf16 1e-2, f32 1e-4) and
    the decode ran with one split and with several (sentinel_held).
    Returns {row: {dtype: max|out - plain|, ...}}."""
    g = torch.Generator(dev).manual_seed(seed)
    B = 2
    errs: dict = {}
    splits = set()

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def launch(row, dtype, what, q, k, v, start, **kw):
        full = sentinel_rows(torch, q.shape, dtype, dev, width)
        kernel = "flash_decode" if row.startswith("flash_decode") \
            else "flash_fwd"
        if kernel == "flash_decode":
            n = tfa._decode_plan(B, q.shape[1], Hq, Hkv, k.shape[2],
                                 tfa._sm_count(dev))[2]
            splits.add(n)
            what += f" splits={n}"
        tfa._launch(kernel, q, k, v, start, causal=True, scale=D ** -0.5,
                    out=full[..., :D], **kw)
        ref = tfa.attention_plain(q, k, v, start, **kw)[0]
        sentinel_held(torch, errs, row, D, dtype, what, [full], [ref])

    for dtype in (torch.bfloat16, torch.float32):
        S = 192
        q, k, v = (rnd(B, S, h, D, dtype=dtype) for h in (Hq, Hkv, Hkv))
        launch("flash_fwd", dtype, f"self-attention S={S}", q,
               k.transpose(1, 2), v.transpose(1, 2), 0)
        for int8 in (False, True):
            for ml in sorted({c[3] for c in PAD_STORE_CASES}):
                kc, vc = (rnd(B, Hkv, ml, D, dtype=dtype) for _ in range(2))
                kw = {"pad_lens": torch.tensor([0, 37], dtype=torch.int32,
                                               device=dev)}
                if int8:
                    (kc, kw["k_scale"]), (vc, kw["v_scale"]) = \
                        td._quantize_kv(kc), td._quantize_kv(vc)
                for row, S, start, case_ml in PAD_STORE_CASES:
                    if case_ml != ml:
                        continue
                    st = (torch.tensor(start, dtype=torch.int32, device=dev)
                          if isinstance(start, list) else start)
                    launch(row + ("_int8" if int8 else ""), dtype,
                           f"S={S} start={start} max_len={ml}",
                           rnd(B, S, Hq, D, dtype=dtype), kc, vc, st, **kw)
    check(1 in splits and max(splits) > 1, f"the decode's splits {splits}: "
          "one split and several must both store")
    return errs


def pad_train_stores(torch, tfa, dev, D, Hq, Hkv, seed, width=128):
    """Phase 25 (c): the five training entries at head dim D launched
    directly (tfa._launch_bwd, tfa._launch_tri) in bf16 and in f32 on
    causal self-attention, B=2, at S=200 (a ragged last tile: the
    triangle's rows, fewer tiles than its persistent CTAs, are cut into
    pieces that its fixup launch merges and stores) and at S=1000, every
    output (dQ, dK and dV, the triangle's out) a view of rows ``width``
    wide filled with SENTINEL, from the plain forward's out and lse. Fails
    unless columns D..width-1 keep the sentinel and the columns below D
    agree with the plain versions (sentinel_held: the forward absolute, the
    gradients relative to the largest plain value). Returns {row: {dtype:
    max|out - plain|, dtype rel: relative}}."""
    g = torch.Generator(dev).manual_seed(seed)
    B, scale = 2, D ** -0.5
    errs: dict = {}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        for S in (200, 1000):
            what = f"B={B} S={S} Hq={Hq} Hkv={Hkv} causal"
            q, dout = (rnd(B, S, Hq, D, dtype=dtype) for _ in range(2))
            k, v = (rnd(B, S, Hkv, D, dtype=dtype) for _ in range(2))
            out, lse = tfa.attention_plain(q, k.transpose(1, 2),
                                           v.transpose(1, 2), 0)
            lse = lse.contiguous()
            delta = tfa._bwd_delta(out, dout, None).contiguous()
            dq, dk, dv = tfa.attention_bwd_plain(q, k, v, out, lse, dout)
            kw = dict(causal=True, scale=scale)
            tri = dict(scale=scale, dout=dout, lse=lse, delta=delta)
            for row, outs, refs, fn in (
                    ("flash_bwd_dq", [q], [dq], lambda o: tfa._launch_bwd(
                        "flash_bwd_dq", q, k, v, dout, lse, delta, **kw,
                        out=o[0])),
                    ("flash_bwd_dkv", [k, v], [dk, dv],
                     lambda o: tfa._launch_bwd(
                         "flash_bwd_dkv", q, k, v, dout, lse, delta, **kw,
                         out=o)),
                    ("flash_fwd_tri", [q], [out], lambda o: tfa._launch_tri(
                        "flash_fwd_tri", q, k, v, scale=scale, out=o[0])),
                    ("flash_bwd_dq_tri", [q], [dq],
                     lambda o: tfa._launch_tri("flash_bwd_dq_tri", q, k, v,
                                               **tri, out=o[0])),
                    ("flash_bwd_dkv_tri", [k, v], [dk, dv],
                     lambda o: tfa._launch_tri("flash_bwd_dkv_tri", q, k, v,
                                               **tri, out=o))):
                fulls = [sentinel_rows(torch, t.shape, dtype, dev, width)
                         for t in outs]
                fn(tuple(f[..., :D] for f in fulls))
                sentinel_held(torch, errs, row, D, dtype, what, fulls, refs,
                              rel=row != "flash_fwd_tri")
            del q, dout, k, v, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return errs


def phase_pad_exact(torch, tl, tm, td, te, dev, D):
    """Phase 24 or 26 (c): the model at head dim D (pad_models) cut to 2
    layers, f32 (the kernels' f32 instances), flash against dense on the
    card (serve_exact: logits within 1e-4 on an f32 cache and 2e-2 on an
    int8 one, generate fresh, left-padded and on an int8 cache token-equal,
    a ServeEngine pass with a shared prefix stream-equal)."""
    run = PAD_RUNS[D]
    models = ((f"{run.model} width, 2 layers", dataclasses.replace(
        pad_models(tl)[D], n_layers=2), tl.init_params, td.cached_forward),)
    return serve_exact(torch, tm, td, te, models, PAD_HEADS, dev,
                       run.seed + 133)


def phase_pad_serving(torch, tl, td, te, tfa, dev, D):
    """Phase 24 or 26 (d), bf16, full depth: the model at head dim D
    (pad_models: OpenLLaMA-3B's 26 layers, H2O-Danube3-4B's 24) through
    serve_paths (generate fresh, left-padded and on an int8 cache, a
    ServeEngine pass; launches equal to the prediction, tokens/s, peak
    memory, parameters); then, at the head dims of PAD_RUNS[D].refused
    (which no source builds), every serving and training call refused by
    name before any launch (serving_refused). Returns ({D: launches},
    report)."""
    run, (Hq, Hkv, _) = PAD_RUNS[D], PAD_HEADS[D]
    launches, report = serve_paths(torch, tl, td, te, tfa, dev,
                                   {D: (run.model, pad_models(tl)[D])},
                                   run.seed + 134)
    report["refusals"] = [serving_refused(torch, tfa, td, dev, R, Hq, Hkv,
                                          run.seed + 135 + 2 * i)
                          for i, R in enumerate(run.refused)]
    return launches, report


def sdpa_backend(kernels):
    """The scaled_dot_product_attention backend whose kernels these are
    (the names one profiler session of the call recorded): cuDNN, flash,
    memory-efficient, or math (plain matrix products and a softmax)."""
    text = " ".join(kernels).lower()
    if "cudnn" in text:
        return "cudnn"
    if "flash" in text:
        return "flash"
    if "fmha" in text or "efficient" in text:
        return "efficient"
    return "math"


def library_backends(torch, deferred, rows):
    """For each of ``rows`` with a library call in ``deferred``: the
    kernels one profiler session of that call ran, the longest first
    (``library_kernels``, names cut to 96 characters), and the SDPA
    backend they are (``library_backend``). After device_times, as every
    profiler session is."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=torch.device(
        "cuda"))
    for r, _, library, _ in deferred:
        if library is None or not any(r is x for x in rows):
            continue
        kernels = profiled(library, flush, None, reps=2)
        names = sorted(kernels, key=lambda k: -kernels[k][1])
        r["library_kernels"] = [n[:96] for n in names[:4]]
        r["library_backend"] = sdpa_backend(names)
        print(f"{r['name']}: SDPA ran {r['library_backend']} "
              f"({r['library_kernels']})")
    del flush


# phase 23: head dim 256 in training, at the phase-22 model's heads
# (WIDE_HEADS). #6/#7 checked as phase 21's at Gemma-2B's 8/1 heads and at
# the D = 128 training row's 16/8; #3/#8/#9 and the wrapper's triangle at
# S 4096 at 8/1; the bf16 training run at full width and depth (18 layers)
# at (1, 4096): the f32 masters, gradients and AdamW moments of 3.03e9
# parameters are ~48.5 GB, the f32 logits [4096, 256000] and their
# gradient ~4.2 GB each; the long pass at (1, 32768) with Gemma's own 8/1
# heads, where the natural budget takes flash_fwd_tri (at D = 256 in bf16
# from S > 6144)
WIDE_TRI_S = 4096
WIDE_TRAIN_STEPS = (1, 4096)          # B, S of the bf16 training steps
WIDE_STEPS = 5
WIDE_LONG = (1, 32768, 8, 1)
WIDE_TRAIN_SPECS = {
    D: (Hq, Hkv, mid_bwd_cases(Hq, Hkv, window)
        + mid_bwd_cases(*WIDE_TRAIN_SHAPE[2:], None),
        small_tri_cases(Hq, Hkv, WIDE_TRI_S), WIDE_TRI_S, SEED + 120)
    for D, (Hq, Hkv, window) in WIDE_HEADS.items()}


def phase_wide_train_exact(torch, tl, tm, tt, dev):
    """Phase 23 (d): Gemma-2B's widths (wide_models) cut to 2 layers,
    three f32 train steps flash against dense (train_exact, wide: the
    first step's gradients and params held)."""
    models = tuple((f"{name} width, 2 layers",
                    dataclasses.replace(cfg, n_layers=2), False)
                   for name, cfg in zip(("Gemma-2B",),
                                        wide_models(tl).values()))
    return train_exact(torch, tm, tt, models, dev, SEED + 122, wide=True)


def phase_wide_train(torch, tl, tt, tfa, dev):
    """Phase 23 (e), (f): the main path at head dim 256, its launches
    read alone: the Gemma-2B-width model (wide_models, 18 layers) trained
    in bf16 (f32 masters, remat, AdamW) at WIDE_TRAIN_STEPS (``d256_train``:
    a warm-up and WIDE_STEPS steps, the loss falling, #1 2·L·steps
    launches and #6/#7 L·steps, peak memory), then a triangular=True pass
    at WIDE_LONG (``d256_long``). Every one of #6, #7, #3, #8 and #9
    launches. Returns ({256: {path: launches}}, report)."""
    by_dim, report = {D: {} for D in WIDE_HEADS}, {}
    for D, cfg in wide_models(tl).items():
        check(cfg.head_dim == D, f"head dim {cfg.head_dim}, expected {D}")
        by_dim[D][f"d{D}_train"], report[f"d{D}_train"] = train_steps(
            torch, tt, tfa, cfg, f"Gemma-2B width ({cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads of {D}, {cfg.n_layers} layers)", dev,
            WIDE_TRAIN_STEPS, WIDE_STEPS)
        by_dim[D][f"d{D}_long"], report[f"d{D}_long"] = long_pass(
            torch, tfa, dev, D, WIDE_LONG, SEED + 123)
    for D, paths in by_dim.items():
        for name in D64_TRAIN_ROWS:
            n = sum(v.get(name, 0) for v in paths.values())
            check(n > 0, f"{name}: no launch at head dim {D}")
    print(f"head dim 256 in training: {json.dumps(report)}")
    return by_dim, report


# phases 25 and 27: head dims 100 and 120 in training, at the phase-24 and
# 26 models' heads (PAD_HEADS). #6/#7 checked as phase 21's at the model's
# heads and at the D = 128 training row's 16/8; #3/#8/#9 called directly
# and the wrapper's triangle (the budget lowered: the natural one takes
# flash_fwd_tri in bf16 only from S > 15728 at 100, S > 13107 at 120) at S
# 4096 at the model's heads; the five entries' stores against the sentinel
# (pad_train_stores); the bf16 training run at full width and depth at
# PAD_RUNS[D].train: OpenLLaMA-3B's (4, 2048), S its
# max_position_embeddings, the f32 masters, gradients and AdamW moments of
# 3.43e9 parameters ~54.9 GB; H2O-Danube3-4B's (1, 4096), those of 3.96e9
# parameters ~63.4 GB, activations with remat and the f32 logits [4096,
# 32000] and their gradient a few GB more; the long pass at (1, 32768) with
# the model's own heads, where the natural budget takes flash_fwd_tri
PAD_TRI_S = 4096
PAD_STEPS = 5
PAD_TRAIN_SPECS = {
    D: (Hq, Hkv, mid_bwd_cases(Hq, Hkv, window)
        + mid_bwd_cases(*WIDE_TRAIN_SHAPE[2:], None),
        small_tri_cases(Hq, Hkv, PAD_TRI_S), PAD_TRI_S,
        PAD_RUNS[D].seed + 140)
    for D, (Hq, Hkv, window) in PAD_HEADS.items()}


def phase_pad_train_exact(torch, tl, tm, tt, dev, D):
    """Phase 25 or 27 (d): the model at head dim D (pad_models) cut to 2
    layers, three f32 train steps flash against dense (train_exact, wide:
    the first step's gradients and params held)."""
    run = PAD_RUNS[D]
    models = ((f"{run.model} width, 2 layers",
               dataclasses.replace(pad_models(tl)[D], n_layers=2), False),)
    return train_exact(torch, tm, tt, models, dev, run.seed + 142, wide=True)


def phase_pad_train(torch, tl, tt, tfa, dev, D):
    """Phase 25 or 27 (e), (f): the main path at head dim D, its launches
    read alone: the model (pad_models) trained in bf16 (f32 masters, remat,
    AdamW) at PAD_RUNS[D].train (``d<D>_train``: a warm-up and PAD_STEPS
    steps, the loss falling, #1 2·L·steps launches and #6/#7 L·steps, peak
    memory), then a triangular=True pass at (1, 32768) at the model's heads
    (``d<D>_long``). Every one of #6, #7, #3, #8 and #9 launches. Returns
    ({D: {path: launches}}, report)."""
    run, cfg, (Hq, Hkv, _) = PAD_RUNS[D], pad_models(tl)[D], PAD_HEADS[D]
    check(cfg.head_dim == D, f"head dim {cfg.head_dim}, expected {D}")
    paths, report = {}, {}
    paths[f"d{D}_train"], report[f"d{D}_train"] = train_steps(
        torch, tt, tfa, cfg, f"{run.model} width ({Hq}/{Hkv} heads of {D}, "
        f"{cfg.n_layers} layers)", dev, run.train, PAD_STEPS)
    paths[f"d{D}_long"], report[f"d{D}_long"] = long_pass(
        torch, tfa, dev, D, (1, 32768, Hq, Hkv), run.seed + 143)
    for name in D64_TRAIN_ROWS:
        n = sum(v.get(name, 0) for v in paths.values())
        check(n > 0, f"{name}: no launch at head dim {D}")
    print(f"head dim {D} in training: {json.dumps(report)}")
    return {D: paths}, report


def serving_refused(torch, tfa, td, dev, D, Hq, Hkv, seed):
    """At head dim D, which no source builds, the serving calls (a forward
    under no_grad, a cached prefill on a bf16 and on an int8 cache, a decode
    step) raise ValueError naming it, with no launch; then the training
    calls (training_refused). Returns the report's line."""
    g = torch.Generator(dev).manual_seed(seed)
    tfa.reset_launches()
    q, k, v = (torch.randn(1, 128, h, D, generator=g, device=dev)
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    kc, vc = (torch.randn(1, Hkv, 256, D, generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    (k8, ks), (v8, vs) = td._quantize_kv(kc), td._quantize_kv(vc)
    with torch.no_grad():
        for what, fn in (
                ("flash_attention", lambda: tfa.flash_attention(q, k, v)),
                ("flash_attention_cached", lambda: tfa.flash_attention_cached(
                    q, kc, vc, 64)),
                ("flash_attention_cached on an int8 cache",
                 lambda: tfa.flash_attention_cached(
                     q, k8, v8, 64, k_scale=ks, v_scale=vs)),
                ("flash_attention_decode", lambda: tfa.flash_attention_decode(
                    q[:, :1], kc, vc, 200))):
            try:
                fn()
            except ValueError as e:
                check(f"head dim {D}" in str(e), f"{what} at head dim {D}: "
                      f"{e}")
            else:
                check(False, f"{what} ran at head dim {D}")
    check(not any(tfa.LAUNCHES.values()),
          f"a serving launch at head dim {D}: {tfa.LAUNCHES}")
    return (f"head dim {D}: flash_attention, flash_attention_cached (bf16, "
            "int8), flash_attention_decode; "
            + training_refused(torch, tfa, dev, D, Hq, Hkv, seed + 1))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "gpu_provisioner_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gpu_provisioner_tpu_torch import bench, entry
    from gpu_provisioner_tpu_torch import onchip_checks as onchip
    from gpu_provisioner_tpu_torch.models import checkpoint as ck
    from gpu_provisioner_tpu_torch.models import decode as td
    from gpu_provisioner_tpu_torch.models import engine as te
    from gpu_provisioner_tpu_torch.models import llama as tl
    from gpu_provisioner_tpu_torch.models import moe as tm
    from gpu_provisioner_tpu_torch.models import moe_serve as tms
    from gpu_provisioner_tpu_torch.models import speculative as ts
    from gpu_provisioner_tpu_torch.models import train as tt
    from gpu_provisioner_tpu_torch.observability import fleet
    from gpu_provisioner_tpu_torch.ops import _cuda
    from gpu_provisioner_tpu_torch.ops import flash_attention as tfa
    from gpu_provisioner_tpu_torch.parallel import jobs, launch

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}"
          f"; tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
          f"(seconds a source: {json.dumps(_cuda.BUILD_SECONDS)})")
    for name, log in logs.items():
        for fn, info in ptxas_info(log).items():
            print(f"  {name}: {fn}: {info}")
    serve_report = {}
    for D in SERVE_DIMS:     # phases 2, 16, 18, 20, 22, 24 and 26
        print(f"serving instances at head dim {D}:")
        serve_report[D] = serve_build_report(_cuda, tfa, logs, D)
    print("training instances at head dim 128:")
    tc_report = tc_build_report(_cuda, logs, train_tc_kernels(_cuda, [128]))
    print("head dim 64 in training (phase 17):")
    d64_tc_report = tc_build_report(_cuda, logs, train_tc_kernels(_cuda, [64]))
    print("head dims 32 and 16 in training (phase 19):")
    small_train_tc_report = tc_build_report(
        _cuda, logs, train_tc_kernels(_cuda, SMALL_HEADS))
    print("head dims 96 and 80 in training (phase 21):")
    mid_train_tc_report = tc_build_report(
        _cuda, logs, train_tc_kernels(_cuda, MID_HEADS))
    print("head dim 256 in training (phase 23):")
    wide_train_tc_report = tc_build_report(
        _cuda, logs, train_tc_kernels(_cuda, WIDE_HEADS))
    print("head dims 100 and 120 in training (phases 25 and 27):")
    pad_train_tc_report = tc_build_report(
        _cuda, logs, train_tc_kernels(_cuda, PAD_HEADS))

    t0 = time.perf_counter()
    deferred = []
    rows = serve_kernels(torch, tfa, td, dev, deferred, 128)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_exact(torch, tl, td, te, dev)
    print(f"exact phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve = phase_main(torch, tl, td, te, tfa, fleet, dev)
    print(f"main phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()      # the serving params are gone
    t0 = time.perf_counter()
    fwd_train, bwd_rows = phase_bwd_kernels(torch, tfa, dev)
    fwd = next(r for r in rows if r["name"] == "flash_fwd")
    fwd["max_abs_err"] = max(fwd["max_abs_err"], fwd_train["max_abs_err"])
    fwd["at_train_shape"] = fwd_train
    rows += bwd_rows
    print(f"backward kernel phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_exact(torch, tl, tt, dev)
    print(f"exact training phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train, f32_ms = phase_train(torch, tl, tt, tfa, dev)
    print(f"training phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst = phase_tri_kernels(torch, tfa, dev)
    twin_worst = phase_twin_shapes(torch, tfa, dev)
    tri_rows, long, by_twin = phase_long(torch, tfa, _cuda, bench, dev,
                                         worst)
    rows += tri_rows
    print(f"long-context phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_shape, moe_errs = phase_moe_kernels(torch, tfa, td, dev, deferred)
    phase_moe_exact(torch, tm, tms, td, te, dev)
    torch.cuda.empty_cache()
    moe = phase_moe(torch, tm, td, te, tfa, dev)
    print(f"MoE phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_spec_exact(torch, tl, tm, td, te, ts, dev)
    torch.cuda.empty_cache()
    spec, spec_report, spec_verify, spec_prefill = phase_spec(
        torch, tl, td, te, ts, tfa, dev, deferred)
    torch.cuda.empty_cache()
    prefill_rows, prefill_errs = spec_prefill_rows(torch, tfa, spec_prefill,
                                                   dev, deferred)
    spec_twin, by_twin["bench_speculative"] = phase_spec_twin(torch, bench,
                                                              tfa)
    print(f"speculation phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumable, resumable_report = phase_resumable(
        torch, tl, tm, tt, ck, bench, tfa, dev, f32_ms)
    print(f"resumable-training phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded_errs = phase_call_shapes(torch, tfa, dev, SHARDED_CALLS,
                                     "sharded")
    torch.cuda.empty_cache()
    phase_sharded_exact(torch, tl, tt, jobs, launch, dev)
    torch.cuda.empty_cache()
    sharded, sharded_report = phase_sharded(torch, tl, jobs, launch, dev)
    print(f"sharded-training phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parallel_errs = phase_call_shapes(torch, tfa, dev, PARALLEL_CALLS,
                                      "parallel", causals=(True,),
                                      lse_cotangent=False, seed=SEED + 33)
    torch.cuda.empty_cache()
    parallel, parallel_report = phase_parallel(torch, tl, tm, tt, jobs,
                                               launch, dev)
    print(f"pipeline and expert phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t14 = t0 = time.perf_counter()
    serve_shapes, serve_errs = phase_serve_kernels(torch, tfa, td, dev,
                                                   deferred)
    print(f"sharded serving kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_exact = phase_serve_exact(torch, tl, tm, td, ts, jobs, launch, dev)
    print(f"sharded serving exact {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving, serving_report = phase_serve_full(torch, tl, tm, jobs, launch,
                                               dev)
    print(f"sharded serving full size {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_twins, by_serve_twin = phase_serve_surfaces(torch, bench, entry,
                                                      tfa)
    print(f"entry, dry run and serving twins {time.perf_counter() - t0:.1f}"
          f" s; sharded serving phase {time.perf_counter() - t14:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resume_errs = phase_call_shapes(torch, tfa, dev, RESUME_CALLS, "resume",
                                    causals=(True,), lse_cotangent=False,
                                    seed=SEED + 53)
    torch.cuda.empty_cache()
    mesh_resume, mesh_resume_report = phase_mesh_resume(torch, tl, jobs,
                                                        launch, dev)
    print(f"mesh resume phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t16 = t0 = time.perf_counter()
    d64_rows = serve_kernels(torch, tfa, td, dev, deferred, 64)
    print(f"head-dim-64 kernels {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_d64_exact(torch, tl, tm, td, te, bench, dev)
    print(f"head-dim-64 exact {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d64, d64_report = phase_d64_serving(torch, tl, tm, td, te, tfa, bench,
                                        dev)
    print(f"head-dim-64 full size {time.perf_counter() - t0:.1f} s; head "
          f"dim 64 phase {time.perf_counter() - t16:.1f} s")
    torch.cuda.empty_cache()
    t17 = t0 = time.perf_counter()
    d64_train_fwd, d64_train_rows, d64_fwd_err = phase_d64_train_kernels(
        torch, tfa, _cuda, dev)
    print(f"head-dim-64 training kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_exact(torch, tl, tt, dev, cfg=bench.train_step_config(True),
                      what="the fast bench_train_step model's width, 8/4 "
                           "heads of 64")
    print(f"head-dim-64 exact training {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d64t, d64t_report = phase_d64_train(torch, tl, tm, tt, tfa, bench, dev)
    print(f"head-dim-64 training full size {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d64t_report["onchip_checks"] = phase_onchip_twin(torch, onchip, dev)
    print(f"on-card checks {time.perf_counter() - t0:.1f} s; head dim 64 "
          f"training phase {time.perf_counter() - t17:.1f} s")
    torch.cuda.empty_cache()
    t18 = t0 = time.perf_counter()
    small_rows = [r for D in SMALL_HEADS
                  for r in serve_kernels(torch, tfa, td, dev, deferred, D)]
    print(f"head dims 32 and 16 kernels {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    small_exact = phase_small_exact(torch, tl, tm, td, te, tms, bench, dev)
    print(f"head dims 32 and 16 exact {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    small, small_report = phase_small_serving(torch, tl, tm, td, te, tfa,
                                              bench, dev)
    small_report["exact"] = small_exact
    print(f"head dims 32 and 16 serving {time.perf_counter() - t0:.1f} s; "
          f"head dims 32 and 16 phase {time.perf_counter() - t18:.1f} s")
    torch.cuda.empty_cache()
    t19 = t0 = time.perf_counter()
    small_train_fwd, small_train_rows, small_fwd_err = phase_train_kernels(
        torch, tfa, _cuda, dev, SMALL_TRAIN_SPECS)
    print(f"head dims 32 and 16 training kernels "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    small_train_exact = phase_small_train_exact(torch, tl, tm, tt, bench,
                                                dev)
    print(f"head dims 32 and 16 exact training "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    small_train, small_train_report = phase_small_train(
        torch, tl, tm, tt, tfa, jobs, launch, bench, dev)
    small_train_report["exact"] = small_train_exact
    print(f"head dims 32 and 16 training paths {time.perf_counter() - t0:.1f}"
          f" s; head dims 32 and 16 training phase "
          f"{time.perf_counter() - t19:.1f} s")
    torch.cuda.empty_cache()
    t20 = t0 = time.perf_counter()
    mid_rows = [r for D in MID_HEADS
                for r in serve_kernels(torch, tfa, td, dev, deferred, D)]
    print(f"head dims 96 and 80 kernels {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mid_exact = phase_mid_exact(torch, tl, tm, td, te, dev)
    print(f"head dims 96 and 80 exact {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mid, mid_report = phase_mid_serving(torch, tl, td, te, tfa, dev)
    mid_report["exact"] = mid_exact
    print(f"head dims 96 and 80 serving {time.perf_counter() - t0:.1f} s; "
          f"head dims 96 and 80 phase {time.perf_counter() - t20:.1f} s")
    torch.cuda.empty_cache()
    t21 = t0 = time.perf_counter()
    mid_train_fwd, mid_train_rows, mid_fwd_err = phase_train_kernels(
        torch, tfa, _cuda, dev, MID_TRAIN_SPECS)
    print(f"head dims 96 and 80 training kernels "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mid_train_exact = phase_mid_train_exact(torch, tl, tm, tt, dev)
    print(f"head dims 96 and 80 exact training "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mid_train, mid_train_report = phase_mid_train(torch, tl, tt, tfa, dev)
    mid_train_report["exact"] = mid_train_exact
    print(f"head dims 96 and 80 training paths {time.perf_counter() - t0:.1f}"
          f" s; head dims 96 and 80 training phase "
          f"{time.perf_counter() - t21:.1f} s")
    torch.cuda.empty_cache()
    t22 = t0 = time.perf_counter()
    wide_rows = serve_kernels(torch, tfa, td, dev, deferred, 256)
    wide_fwd_train = wide_train_shape(torch, tfa, dev)
    print(f"head dim 256 kernels {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wide_exact = phase_wide_exact(torch, tl, tm, td, te, dev)
    print(f"head dim 256 exact {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wide, wide_report = phase_wide_serving(torch, tl, td, te, tfa, dev)
    wide_report["exact"] = wide_exact
    print(f"head dim 256 serving {time.perf_counter() - t0:.1f} s; head "
          f"dim 256 phase {time.perf_counter() - t22:.1f} s")
    torch.cuda.empty_cache()
    t23 = t0 = time.perf_counter()
    wide_train_fwd, wide_train_rows, wide_fwd_err = phase_train_kernels(
        torch, tfa, _cuda, dev, WIDE_TRAIN_SPECS)
    print(f"head dim 256 training kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide_train_exact = phase_wide_train_exact(torch, tl, tm, tt, dev)
    print(f"head dim 256 exact training {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wide_train, wide_train_report = phase_wide_train(torch, tl, tt, tfa, dev)
    wide_train_report["exact"] = wide_train_exact
    print(f"head dim 256 training paths {time.perf_counter() - t0:.1f} s; "
          f"head dim 256 training phase {time.perf_counter() - t23:.1f} s")
    torch.cuda.empty_cache()
    pad = {}     # phases 24 and 25 at head dim 100, 26 and 27 at 120
    for D, (ps, pt) in zip(PAD_HEADS, ((24, 25), (26, 27))):
        run, p = PAD_RUNS[D], {}
        t_phase = t0 = time.perf_counter()
        p["rows"] = serve_kernels(torch, tfa, td, dev, deferred, D)
        p["stores"] = pad_stores(torch, tfa, td, dev, D, *run.stores,
                                 run.seed + 132)
        print(f"head dim {D} kernels {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        exact = phase_pad_exact(torch, tl, tm, td, te, dev, D)
        print(f"head dim {D} exact {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        p["served"], p["report"] = phase_pad_serving(torch, tl, td, te, tfa,
                                                     dev, D)
        p["report"].update(exact=exact, stores=p["stores"])
        print(f"head dim {D} serving {time.perf_counter() - t0:.1f} s; "
              f"head dim {D} phase ({ps}) "
              f"{time.perf_counter() - t_phase:.1f} s")
        torch.cuda.empty_cache()
        t_phase = t0 = time.perf_counter()
        p["train_fwd"], p["train_rows"], p["fwd_err"] = phase_train_kernels(
            torch, tfa, _cuda, dev, {D: PAD_TRAIN_SPECS[D]})
        p["train_stores"] = pad_train_stores(torch, tfa, dev, D, *run.stores,
                                             run.seed + 141)
        print(f"head dim {D} training kernels {time.perf_counter() - t0:.1f}"
              " s")
        t0 = time.perf_counter()
        exact = phase_pad_train_exact(torch, tl, tm, tt, dev, D)
        print(f"head dim {D} exact training {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        p["trained"], p["train_report"] = phase_pad_train(torch, tl, tt, tfa,
                                                          dev, D)
        p["train_report"].update(exact=exact, stores=p["train_stores"])
        print(f"head dim {D} training paths {time.perf_counter() - t0:.1f} s;"
              f" head dim {D} training phase ({pt}) "
              f"{time.perf_counter() - t_phase:.1f} s")
        torch.cuda.empty_cache()
        pad[D] = p
    pad_rows = [r for p in pad.values() for r in p["rows"]]
    pad_train_rows = [r for p in pad.values() for r in p["train_rows"]]
    t0 = time.perf_counter()
    device_times(torch, tfa, deferred, dev)
    library_backends(torch, deferred, pad_rows)
    print(f"device-time phase {time.perf_counter() - t0:.1f} s")
    for r in rows:      # the bench twins' shapes count in the worst errors
        if r["name"] in twin_worst:
            e, rel = twin_worst[r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], e)
            if "max_rel_err" in r:
                r["max_rel_err"] = max(r["max_rel_err"], rel)
    # each kernel's launches on its own path: serving for the forward
    # kernels, training for the backward ones, the long path for the
    # triangle (every count kept, the bench twins' and MoE serving's too)
    for r in rows:
        name = r["name"]
        r["launches_by_path"] = {"serve": serve[name], "train": train[name],
                                 "long": long[name], "moe": moe[name],
                                 "spec": spec[name],
                                 **{k: v[name] for k, v in by_twin.items()},
                                 **{k: v[name] for k, v in resumable.items()}}
        if name in SHARDED_KERNELS:
            r["launches_by_path"]["sharded"] = {
                k: v[name] for k, v in sharded.items()}
            r["at_sharded_shapes"] = sharded_errs[name]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   sharded_errs[name]["max_abs_err"])
            r["launches_by_path"].update(
                {k: {run: v[name] for run, v in runs.items()}
                 for k, runs in parallel.items()})
            r["launches_by_path"]["resume_mesh"] = mesh_resume[name]
            r["at_resume_shapes"] = resume_errs[name]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   resume_errs[name]["max_abs_err"])
            r["at_parallel_shapes"] = parallel_errs[name]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   parallel_errs[name]["max_abs_err"])
        if name in SERVE_KERNEL_ROWS:
            r["at_tp_serving_shapes"] = serve_shapes[name]
            r["max_abs_err"] = max(r["max_abs_err"], serve_errs[name])
            r["launches_by_path"]["serving_exact"] = {
                run: [g[name] for g in ranks]
                for run, ranks in serve_exact.items()}
            for path, runs in serving.items():
                r["launches_by_path"][path] = {
                    run: [g[name] for g in ranks]
                    for run, ranks in runs.items()}
            # bench_decode's fast model runs at head dim 64, bench_engine's
            # and bench_moe_decode's at 32 (the D = 64 and D = 32 rows
            # take their launches)
            r["launches_by_path"]["bench_cached_prefill"] = \
                by_serve_twin["bench_cached_prefill"][name]
        if name in moe_shape:
            r["at_moe_shape"] = moe_shape[name]
            r["max_abs_err"] = max(r["max_abs_err"], moe_errs[name])
        r["launches"] = (long if name.endswith("_tri") else train
                         if name.startswith("flash_bwd") else serve)[name]
        r.update(tc_report.get(name, {}))
        if name == "flash_decode":
            r["at_spec_verify"] = spec_verify
            r["max_abs_err"] = max(r["max_abs_err"], spec_verify["max_abs_err"])
        if name in prefill_rows:
            r["at_spec_prefill"] = prefill_rows[name]
            r["max_abs_err"] = max(r["max_abs_err"], prefill_errs[name])
    serve_reports(rows, serve_report[128])
    # the head-dim-64 instances: launches across phase 16's full-size run
    # (and the fast bench_decode twin of phase 14), ptxas of the timed ones
    serve_reports(d64_rows, serve_report[64])
    for r in d64_rows:
        name = r["name"][:-len("_d64")]
        r["launches"] = d64[name]
        r["launches_by_path"] = {
            "d64_serving": d64[name],
            "bench_decode_fast": by_serve_twin["bench_decode"][name]}
        if name == "flash_fwd":     # and its training paths (phase 17)
            r["at_train_shape"] = d64_train_fwd
            r["max_abs_err"] = max(r["max_abs_err"], d64_fwd_err)
            r["launches_by_path"].update(
                {k: v[name] for k, v in d64t.items() if k != "d64_long"})
    # the head-dim-64 training and triangle instances: launches on their
    # own path (training for the backward, the 32k triangle pass for the
    # tri kernels), every phase-17 path's count kept
    for r in d64_train_rows:
        name = r["name"][:-len("_d64")]
        r["launches_by_path"] = {k: v[name] for k, v in d64t.items()}
        r["launches"] = d64t["d64_long" if name.endswith("_tri")
                             else "d64_train"][name]
        check(r["launches"] > 0, f"{r['name']}: no launch on its path")
        r.update(d64_tc_report.get(r["name"], {}))
    # the head-dim-32 and 16 instances: launches across phase 18's runs
    # at each head dim (and the fast bench_engine and bench_moe_decode
    # twins of phase 14, at 32), ptxas of the timed ones
    for D in SMALL_HEADS:
        serve_reports(small_rows, serve_report[D])
    for r in small_rows:
        name, D = r["name"].rsplit("_d", 1)
        r["launches"] = small[int(D)][name]
        r["launches_by_path"] = {f"d{D}_serving": small[int(D)][name]}
        if D == "32":
            r["launches_by_path"].update(
                {k: by_serve_twin[k][name]
                 for k in ("bench_engine", "bench_moe_decode")})
        check(r["launches"] > 0, f"{r['name']}: no launch on its path")
        if name == "flash_fwd":     # and its training paths (phase 19)
            r["at_train_shape"] = small_train_fwd[int(D)]
            r["max_abs_err"] = max(r["max_abs_err"], small_fwd_err[int(D)])
            r["launches_by_path"].update(
                {k: v.get(name, 0) for k, v in small_train[int(D)].items()})
    # the head-dim-96 and 80 instances: launches across phase 20's
    # full-size runs, ptxas of the timed ones
    for D in MID_HEADS:
        serve_reports(mid_rows, serve_report[D])
    for r in mid_rows:
        name, D = r["name"].rsplit("_d", 1)
        r["launches"] = mid[int(D)][name]
        r["launches_by_path"] = {f"d{D}_serving": mid[int(D)][name]}
        check(r["launches"] > 0, f"{r['name']}: no launch on its path")
        if name == "flash_fwd":     # and its training paths (phase 21)
            r["at_train_shape"] = mid_train_fwd[int(D)]
            r["max_abs_err"] = max(r["max_abs_err"], mid_fwd_err[int(D)])
            r["launches_by_path"].update(
                {k: v.get(name, 0) for k, v in mid_train[int(D)].items()})
    # the head-dim-32, 16, 96 and 80 training and triangle instances:
    # launches on their own path (training for the backward, the
    # triangular=True pass for the tri kernels), every phase-19 or 21
    # path's count at that head dim; at 96 and 80 also the D = 128 row's
    # time of the same call (phase 5's #6/#7, phase 8's tri rows)
    by_name = {r["name"]: r for r in rows}
    train_paths = {**small_train, **mid_train, **wide_train,
                   **{D: p["trained"][D] for D, p in pad.items()}}
    for r in small_train_rows + mid_train_rows + wide_train_rows \
            + pad_train_rows:
        name, D = r["name"].rsplit("_d", 1)
        paths = train_paths[int(D)]
        r["launches_by_path"] = {k: v.get(name, 0) for k, v in paths.items()}
        r["launches"] = paths[f"d{D}_long" if name.endswith("_tri")
                              else f"d{D}_train"][name]
        check(r["launches"] > 0, f"{r['name']}: no launch on its path")
        r.update({**small_train_tc_report, **mid_train_tc_report,
                  **wide_train_tc_report, **pad_train_tc_report}.get(
                      r["name"], {}))
        if int(D) in {**MID_HEADS, **WIDE_HEADS, **PAD_HEADS}:
            r["d128_ms"] = by_name[name]["ms"]
        if int(D) in pad:     # the sentinel stores (phases 25, 27)
            r["at_sentinel_stores"] = pad[int(D)]["train_stores"][name]
    # the head-dim-256 instances: launches across phase 22's full-size
    # run, ptxas of the timed ones; beside each timed call at the D = 128
    # rows' shapes the D = 128 row's time of the same call in this run
    serve_reports(wide_rows, serve_report[256])
    beside_d128(wide_rows, by_name)
    for r in wide_rows:
        name = r["name"][:-len("_d256")]
        r["launches"] = wide[256][name]
        r["launches_by_path"] = {"d256_serving": wide[256][name]}
        check(r["launches"] > 0, f"{r['name']}: no launch on its path")
        if name == "flash_fwd":     # and its training paths (phase 23)
            r["at_train_shape"] = wide_fwd_train
            r["at_train_shape_with_lse"] = wide_train_fwd[256]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   wide_fwd_train["max_abs_err"],
                                   wide_fwd_err[256])
            r["launches_by_path"].update(
                {k: v.get(name, 0) for k, v in wide_train[256].items()})
    # the head-dim-100 and 120 instances: launches across phase 24's or
    # 26's full-size run, ptxas of the timed ones, the D = 128 row's time
    # beside each call at its shapes, the bf16 errors of the sentinel
    # launches, and the forward's training paths (phase 25 or 27)
    for D, p in pad.items():
        serve_reports(p["rows"], serve_report[D])
        beside_d128(p["rows"], by_name)
        served, stores = p["served"][D], p["stores"]
        for r in p["rows"]:
            name = r["name"][:-len(f"_d{D}")]
            r["launches"] = served[name]
            r["launches_by_path"] = {f"d{D}_serving": served[name]}
            check(r["launches"] > 0, f"{r['name']}: no launch on its path")
            r["at_sentinel_stores"] = stores[name]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   stores[name]["torch.bfloat16"])
            if name == "flash_fwd":
                r["at_train_shape"] = p["train_fwd"][D]
                r["max_abs_err"] = max(r["max_abs_err"], p["fwd_err"][D])
                r["launches_by_path"].update(
                    {k: v.get(name, 0) for k, v in p["trained"][D].items()})
    rows += d64_rows + d64_train_rows + small_rows + small_train_rows \
        + mid_rows + mid_train_rows + wide_rows + wide_train_rows + pad_rows \
        + pad_train_rows
    print(f"head dim 64: {json.dumps(d64_report)}")
    print(f"head dim 64 in training: {json.dumps(d64t_report)}")
    print(f"head dims 32 and 16: {json.dumps(small_report)}")
    print(f"head dims 32 and 16 in training: "
          f"{json.dumps(small_train_report)}")
    print(f"head dims 96 and 80: {json.dumps(mid_report)}")
    print(f"head dims 96 and 80 in training: {json.dumps(mid_train_report)}")
    print(f"head dim 256: {json.dumps(wide_report)}")
    print(f"head dim 256 in training: {json.dumps(wide_train_report)}")
    for D, p in pad.items():
        print(f"head dim {D}: {json.dumps(p['report'])}")
        print(f"head dim {D} in training: {json.dumps(p['train_report'])}")
    print(f"speculation: {json.dumps(spec_report)}; bench_speculative "
          f"{json.dumps(spec_twin)}")
    print(f"resumable training: {json.dumps(resumable_report)}")
    print(f"sharded training ({SHARED}): {json.dumps(sharded_report)}")
    print(f"pipeline and expert training ({SHARED}): "
          f"{json.dumps(parallel_report)}")
    print(f"sharded serving ({SHARED}): {json.dumps(serving_report)}; "
          f"serving twins (fast) {json.dumps(serve_twins)}")
    print(f"mesh resume ({SHARED}): {json.dumps(mesh_resume_report)}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
