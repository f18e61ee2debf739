#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

  1. Card line and kernel build: prints the card's name and power limit,
     requires a CUDA device, builds ``kernels/csrc/*.cu`` with nvcc (all
     sources in parallel).
  2. Kernels vs their plain PyTorch versions on the card: every mask x
     every profile of the four device presets, tiled to N = 1,048,576, to
     the replay's N = 1,860 and to a ragged N = 1,863 (and the same with
     bits set above the model's blocks, and an unaligned view), compared
     exactly; the fused picks on random fleets of both sizes (ties,
     nothing fitting, every host full, high mask bits; integer and
     probability weights), compared exactly; then
     each kernel is timed at both sizes beside a launch floor (one
     one-element ``zero_()`` in the same CUDA-graph harness).
  3. The replay on the card equals the replay on the CPU (Alibaba-shaped
     trace at scale 0.1, all five policies, GRMU with and without defrag
     and consolidation, MCC/MECC through the kernels and the tables), and
     so do the five policies' telemetry (``replay_with_telemetry``: the
     decisions, the rejection reasons and every telemetry series).
  4. The main path: full-scale trace replay (``TraceConfig(scale=1.0,
     seed=1)``: 8,063 VMs, 1,860 GPUs, 9,326 events) for FF, BF, MCC,
     MECC and GRMU.  Each result's digest must equal the JAX reference's
     (``DIGESTS``); the MCC/MECC pick kernels must launch once per
     arrival, the score kernels never, and give the tables path's
     decisions.  Then ``torch.profiler`` over a replay of the first 1,000
     events of each policy: the device's busy share and the host
     operations that cost the most.  ``make_replay`` runs on the card
     through captured CUDA graphs (one graph launch per event).
  4b. Telemetry, chunk streaming and the synthetic workload.  (a) The
     full-scale trace with telemetry on, all five policies: each result
     digest equals ``DIGESTS`` (telemetry changes no decision), each
     telemetry digest (``telemetry_digest``) equals ``TELE_DIGESTS``, and
     the MCC/MECC picks still launch once per arrival, the score kernels
     never; events/s, then ``torch.profiler`` over the first 1,000 events
     of MCC and GRMU with telemetry on, whose copies to the host (each a
     host synchronisation) must number phase 4's (``replay_rate.py
     --telemetry`` profiles every policy).  (b) GRMU at the DB
     point on the pow2-padded scale-0.1 trace with telemetry on:
     rejection reasons ``ANCHOR_REASONS`` (``BENCH_batched_engine.json``,
     "telemetry").  (c) ``make_chunked_replay`` of all five policies at
     ``CHUNK_EVENTS`` (1,000) events a chunk, cuts inside hours, defrag,
     consolidation and MECC windows: each digest equals ``DIGESTS``; then
     GRMU chunked with telemetry under a ``Recorder`` on a temporary
     file: its telemetry digest equals the unchunked one, and the file
     holds one ``chunk.step`` span per chunk.  (d) The JAX ladder's
     synthetic rung ``synth:20000x512`` (``SYNTH_CFG``, padded to a
     multiple of 4,096 events, 11 chunks of 4,096): GRMU DB accepts
     17,862, and GRMU DB and MECC (through ``ecc_pick``) equal
     ``SYNTH_DIGESTS``; events/s for both.
  4c. The replay's graph runners (``run_graph_path``): through captured
     graphs, the full-scale replays of all five policies equal
     ``DIGESTS``, with telemetry also ``TELE_DIGESTS``, chunked at 1,000
     events ``DIGESTS``, and ``synth:20000x512`` ``SYNTH_DIGESTS``; one
     pick per MCC/MECC arrival and replay; host synchronisations per
     replay (torch's sync debug mode) at most the consolidating
     step-ends; device memory flat from one replay to the next.  Prints
     events/s through the graphs and through the eager loop
     (``run_events``, over the trace's first EAGER_PREFIX events, whose
     outputs must equal the graphs' over them) in this process, graphs
     per runner and capture seconds.
  4d. The sharded fleet (``run_sharded``; ``repro_torch.core.sharded``).
     (a) One rank over NCCL on the card, in this process: the full-scale
     trace padded with ``pad_events(shards=1)``, the five policies (GRMU
     as in ``DIGESTS``, MCC/MECC through the tables) through the sharded
     runners' graphs equal ``DIGESTS``, with no pick or score kernel
     launch, host synchronisations at most the consolidating step-ends
     and device memory flat; events/s sharded and unsharded on the same
     trace in turns, graphs per runner; with telemetry ``DIGESTS`` and
     ``TELE_DIGESTS``, chunked at 1,000 events ``DIGESTS``.  The group is
     destroyed after (a).  (b) GLOO_FLEETS (K = 2) ranks over gloo on the
     CPU (``sharded.spawn_fleet``, one process per rank) on the scale-0.1
     trace padded with ``shards=K``, GRMU (defrag, consolidation) and
     MECC: each equals the card's unsharded replay of that trace.
  2b. The attention kernels vs their plain version (``flash_attention_ref``)
     on the card: TinyLlama's heads (H 32 / KV 4, hd 64), hd 128 with GQA
     4:1, MHA, MQA, hd 32, causal and non-causal with Sq != Sk, a 96-key
     window, a ragged S = 1000, the requests' prefill (B 8, S 128), and
     the zoo's other head dims (hd 16 with the smoke heads H 4 / KV 2;
     StableLM-3B's H 32 / KV 32 / hd 80 at a ragged S 1000; H 32 / KV 32 /
     hd 112, causal with a 300-key window over a ragged S 1000, the shape
     of Zamba2-7B's shared attention), and at the (q/k, v) head-dim pair
     (192, 128) of DeepSeek-V2's MLA (``PAIR_ATTN_CASES``: H 16 causal over
     a ragged S 1000, H 8 / KV 2 non-causal Sq 200 over Sk 333), in
     bf16 (``fa_fwd_wgmma<hd, hd_v, false>``; 3e-2, within half a bf16
     ulp of the plain version in float32) and float32 (``split_bf16x3`` of
     q, k and v, then ``fa_fwd_wgmma<hd, hd_v, true>``; 2e-5), each dtype
     reaching only its own kernels; in float32 also a long accumulation
     (non-causal, Sq 1024 over Sk 16,384).  The split kernel is held bit
     for bit against ``ref.split_bf16x3`` (normal, tiny and zero inputs, a
     ragged length and an unaligned view).  Then the same check at the slice's
     prefill shape (B 4, S 4096, H 32, KV 4, hd 64, causal) in both dtypes,
     where each kernel, the plain version and PyTorch's
     ``scaled_dot_product_attention`` (timed only) are timed, and in
     float32 the kernel and the plain version are held against the float64
     function (``attention_f64``, the kernel within 2e-5).  Then, in bf16,
     the same check, timings and bound at each phase 5c model's prefill
     shape (B 4, S 4096: H 32 / KV 32 / hd 128, H 32 / KV 8 / hd 128,
     H 32 / KV 32 / hd 80, H 12 / KV 2 / hd 128) and at every one of
     phase 5d's (``MODEL_ATTN_SHAPES``, H 8 / hd 64 for Whisper: its
     encoder at B 4, S 4096 and at B 8, S 1,500, both non-causal, its
     decoder's causal B 8, S 448 and its cross attention Sq 448 over
     Sk 1,500; Scout's causal prefill B 4, S 4096, H 40 / KV 8 / hd 128;
     DeepSeek-V2's causal prefill B 4, S 4096, H 128, q/k 192 against v
     128, SDPA there without ``enable_gqa``; the plain version with chunks
     that divide the lengths, ``plain_attention``),
     and at Zamba2-7B's windowed prefill shape (B 2, S 8,192, H 32 / KV
     32, hd 112, causal, window 4,096; SDPA, which has no window
     argument, over a boolean band mask), and in float32 at StableLM-3B's
     float32 prefill shape (B 1, S 4096, H 32 / KV 32 / hd 80) and at
     DeepSeek-V2's (B 1, S 4096, H 128, 192 / 128): the kernel within
     2e-5 of the plain version and of the float64 function, timed beside
     both.
  2c. The attention backward kernels (``csrc/flash_attention_bwd_sm90.cu``:
     ``fa_bwd_dq_wgmma`` then ``fa_bwd_dkdv_wgmma``, on the tensor cores
     with TMA; bf16 directly, float32 on the bf16 planes of q, k, v and do
     that four ``split_bf16x3`` launches make) vs their plain version
     (``ref.flash_attention_bwd_ref``) at every ``BWD_CASES`` case, bf16
     and float32: every hd of ``HEAD_DIMS`` and the (192, 128) pair, GQA
     groups 1, 4, 5 and 8, causal, non-causal with Sq != Sk, windows,
     ragged S (``hold_attention_bwd``): the forward's output with its lse
     equals serving's bit for bit, two backward launches are bitwise
     equal, the lse within LSE_TOL of float64 logsumexp, bf16 gradients
     within half a bf16 ulp of the plain backward in float32 plus
     BWD_F32_ATOL of max |grad|, float32 within BWD_F32_TOL of float64
     autograd and of the plain version.  Then at TinyLlama's training
     attention shape (``TRAIN_ATTN_SHAPE``: B 4, S 4096, H 32, KV 4, hd
     64, causal), both dtypes held the same way (float32 against the
     plain version, not float64), and in both the kernel, the plain
     backward and SDPA's backward (timed only) timed beside the bound
     (``attention_bwd_bound_ms``: 10 hd flops a pair), and each kernel's
     device ms, float32's splits too (profiler, ``bwd_kernel_ms``).
  2d. The p_bf16 routes (JAX's ``flags.ATTN_P_BF16``: each key chunk's p
     rounded to bf16 against the chunk's row max, times bf16(v);
     ``fa_fwd_wgmma<hd, hd_v, F32, true>``, ``fa_bwd_dq_wgmma`` /
     ``fa_bwd_dkdv_wgmma<hd, hd_v, F32, true>``).  With the flag off, the
     float32-p routes' results at TinyLlama's shape (phase 2b's and 2c's
     inputs) keep the parent commit's SHA-256 (``DEFAULT_ROUTE_DIGESTS``).
     With it on, the forward at ``PB_FWD_CASES`` (TinyLlama's prefill,
     hd 128 / 80 and MLA's pair over two key chunks, Zamba2's window, the
     tie cases) and the backward at ``PB_BWD_CASES`` (phase 2c's, the tie
     cases and the training shape), both dtypes: two launches bitwise
     equal, and the kernel's relative L2 distance from its plain version
     at most ``PB_SHARE`` of the flag's own effect; the bf16 forward's and
     the plain version's half-ulps from the p_bf16 function run in
     float64 reported.  The tie cases (``PB_TIE_CASES``: q and k from {-1,
     0, 1}, exactly tied chunk maxima in many rows) also hold dQ and dK on
     the tied rows alone within ``PB_SHARE`` and nearer to the plain
     version than the rule that gives the max's cotangent whole to the
     first maximal key (``hold_pbf16_ties``), and the forward's chunk
     statistics equal ``ref.chunk_max_stats`` (``hold_pbf16_mstat``).  Then
     timed at TinyLlama's prefill and training shapes beside the
     float32-p route, the plain version, SDPA and the bound, the backward
     by kernel (``time_pbf16``).
  5. The serving path at full width: TinyLlama-1.1B (22 layers, bf16,
     random weights from a seeded generator) through
     ``registry.make_step``.  Prefill of 4 x 4096 tokens (tokens/s, the
     attention kernel's share of device time and prefill's ten costliest
     device operations, 22 launches per call, logits vs the same prefill
     with the plain attention within PREFILL_TOL); then 8 requests of
     128-token prompts: first token from ``prefill``, cache filled by
     ``decode_step`` over the prompt, 32 greedy tokens (decode tokens/s;
     prefill's logits vs the teacher-forced decode's within 0.15).  A
     2-layer float32 model's prefill on the card equals the CPU's.  The
     float32 path: TinyLlama-1.1B in float32, prefill of 1 x 4096 tokens
     (22 float32 kernel launches and 66 splits per call, no bf16 one; wall
     time, the kernels' share of device time, logits vs the same prefill
     with the plain attention).
  5b. The bf16 kernel's accuracy against the float64 function, beside
     the float32 plain version rounded to bf16: error size, mean signed
     error toward larger magnitude and the direction of roundings that
     differ from the float64 value's, at the prefill shape and layer by
     layer in a full-width prefill; then prefill logits on five seeds with
     each as the model's attention, against float64 attention.  Fails
     if the kernel is further from float64 than the plain version
     (``ACCURACY_LOGITS_RATIO``).
  5c. The dense zoo at full width (``run_zoo``, after 5b): DeepSeek-7B,
     Mistral-NeMo-12B, StableLM-3B and Qwen2-VL-2B, one at a time, each
     in bf16 with random weights drawn on the card from a seeded
     generator and freed before the next.  Each as phase 5 serves
     TinyLlama (``serve_model``): prefill 4 x 4096 through
     ``registry.make_step`` with exactly ``n_layers`` bf16 kernel launches
     per call and no other route (tokens/s, the kernel's share of device
     time, logits vs the plain attention within PREFILL_TOL, or else
     phase 5b's float64 logits gate on five seeds); then 8 requests of
     32-token prompts and 8 greedy tokens (cut from phase 5's 128 + 32
     for time; prefill vs teacher-forced decode within 0.15); the peak
     device memory.  StableLM-3B also runs the float32 prefill 1 x 4096
     (32 float32 kernel and 96 split launches per call).
  5d. Whisper-base and Llama-4 Scout at full width (``run_5d``, after
     5c), bf16, random weights drawn on the card.  Whisper
     (``serve_whisper``; 6 + 6 layers, hd 64), its path counted from 0
     with every attention call's (causal, Sq, Sk) recorded (``ServedPath``):
     (a) prefill of 4 x 4096 frames through ``registry.make_step`` (the
     encoder, the last state's logits), 6 non-causal launches a call,
     logits vs the plain attention within PREFILL_TOL; (b) ``encode``
     over 8 x 1,500 frames (6 launches, Sq = Sk) and ``lm_forward`` over
     8 x 448 tokens with that ``encoder_out`` (6 causal 448 / 448 and 6
     cross 448 / 1,500 launches), logits vs the same calls with the plain
     attention within PREFILL_TOL or else phase 5b's float64 gate; (c) a
     cache of exactly the 1,500 encoder positions, ``xk`` / ``xv`` filled
     from (b)'s states (``fill_cross_cache``), 32 of (b)'s tokens
     teacher-forced through make_step's decode (within 0.15 of (b)'s
     logits at the same positions) and 8 greedy ones; tokens/s, the
     kernel's share of (a)'s and (b)'s device time, peak memory.  Scout
     (``get_config("llama4_scout_17b_a16e").scaled(n_layers=8)``, listed
     as ``reduced``) through ``serve_model`` as phase 5c: 8 launches per
     prefill call, logits vs plain within PREFILL_TOL or the float64 gate,
     8 requests of 32 + 8 tokens, peak memory, layer 0's routing of the
     prefill batch (``first_layer_routing``: tokens per expert, the share
     dropped at C = 1,280); its teacher-forced check on the served model
     in bf16, the decode steps taking prefill's routes at a capacity
     where nothing drops (``moe_teacher_forced``; at the served capacity
     a decode step and the request prefill drop different tokens, and
     those numbers are reported).
  5e. RWKV-6-3B and Zamba2-7B at full width, RWKV-6's depth cut to
     SUBQ_LAYERS (``run_5e``, after 5d), bf16, random weights drawn on the
     card, each through ``serve_model``.  Zamba2 (81 Mamba-2 layers, the
     shared attention + SwiGLU block before each of 13 groups of 6, window
     4,096, MHA 32 at hd 112): prefill 2 x 8,192 (``prefill_shape``),
     exactly 13 windowed bf16 launches a call,
     each held against the plain version on its q, k, v within 3e-2
     (``windowed_calls_vs_plain``), logits vs plain attention within
     PREFILL_TOL or the float64 gate; the requests' prefill 13 launches;
     its teacher-forced check
     (``hybrid_teacher_forced``): the bf16 figures reported, the gate the
     float32 model at full width cut to HYBRID_F32_LAYERS layers on a
     float32 cache.  RWKV-6 (8 of its 32 layers, d 2,560, H 40, hd 64; no
     attention, 0 launches on every route): one warm-up and one timed
     prefill of 4 x 4096 (a per-token loop), its device profile over
     RWKV_PROFILE.  Both: 8 requests of 32 + 8 tokens, long_500k uncut
     (``decode_long``: a 524,288-position cache, 32 steps at its last
     positions, ms per step, its bytes equal to a 4,096-position
     cache's), tokens/s, peak memory.  Then the float32 card-vs-CPU check
     (``check_subq_card_vs_cpu``: narrow variants at the models' head dims,
     prefill, 100 decode steps past the hybrid's ring, the caches; within
     1e-4 / 1e-3 or twice what half a float32 ulp of noise moves the CPU
     run, ``half_ulp_noise``).
  5f. DeepSeek-V2 (MLA + MoE) at full width (``run_5f``, after 5e), bf16,
     random weights drawn on the card: ``get_config("deepseek_v2_236b")
     .scaled(n_layers=DSV2_LAYERS)`` (4 of 60 layers, listed as
     ``reduced``) through ``serve_model`` as phase 5d serves Scout:
     prefill 4 x 4096 with 4 launches of the kernel's (192, 128)
     instantiation a call, each held against the plain version on its own
     q, k, v (``pair_calls_vs_plain``), logits vs plain attention within
     PREFILL_TOL or the float64 gate, 8 requests of 32 + 8 tokens against
     a 4,096-position latent cache (its bytes beside the K/V it expands
     to, ``latent_cache``), layer 0's routing (160 experts, top-6), the
     teacher-forced check with prefill's routes at a capacity where
     nothing drops (``mla_teacher_forced``: the bf16 figures reported, the
     0.15 gated on the float32 model at full width cut to DSV2_F32_LAYERS
     layers, as 5e gates the hybrid), peak memory.  Then the
     float32 narrow variant (``mla_card_vs_cpu``: MLA_SMALL, the real
     head dims, 2 layers; the float32 route at the pair): prefill, 32
     decode steps on a float32 latent cache and the cache, card == CPU
     within CARD_CPU_TOL.
  5g. Training (``run_training``, after 5f).  (a) TinyLlama-1.1B at full
     width (22 layers, bf16, random weights drawn on the card) through
     ``launch.train.train_loop`` and the registry's train step:
     ``train_4k``'s seq 4096 with its global batch cut from 256 to TRAIN_B
     (8, listed as ``reduced``) in TRAIN_MICRO (2) micro-batches, remat
     "full", dense CE, AdamW's defaults; one warm-up step, TRAIN_STEPS (3)
     timed (tokens/s, each step's loss and grad norm, finite), exactly 88
     forward launches (22 layers x 2 micro-batches x the forward and its
     recompute) and 44 backward launches a step; one more step profiled
     (device ms, the ten costliest device operations, the attention
     kernels' share); peak memory.  (b) Card vs CPU: TinyLlama's width
     cut to 2 layers, float32, 3 steps of 2 x 256 on each on the same
     weights and batches: losses, grad norms, AdamW's moments and the
     parameters within CARD_CPU_TOL (parameters within PARAM_ATOL_LR lr
     where |m| exceeds PARAM_KEEP of its max), the float32 forward, split
     and backward launches counted (10 splits a layer and step: three a
     forward, four a backward).  (c) (a) in float32 (the weights drawn
     in float32; the float32 GEMMs without TF32): 88 float32 forward, 440
     split and 44 float32 backward launches a step, the splits' ms beside
     the backward's by kernel.
  6. The placement service (``run_service``; after phase 4c).  (a) The
     full-scale trace as a request stream (8,604 requests, 8,063
     arrivals) through ``PlacementService.for_trace`` at micro-batches of
     64, all five policies (GRMU as in ``DIGESTS``), after one stream each
     that captures the graphs: each result (the final snapshot through
     ``result_from_arrays``) equals ``DIGESTS``, MCC/MECC launch their
     pick once per arrival (8,063) and nothing else launches, the runners
     hold graphs, device memory is flat across the five streams, and (a
     third stream, torch's sync debug mode) host synchronisations number
     at most one per batch plus GRMU's consolidating step-ends; one JSON
     line per policy with arrivals/s, p50 / p99 decision latency,
     batches, graphs and capture seconds.  (b) The flash crowd at
     ``BENCH_serve.json``'s size (600 VMs, 32 GPUs, 72 h, seed 2, GRMU):
     online == offline, 373 accepted; the ("GRMU", "FF") ladder at
     slo_s=0 degrades once and ends on FF.  (c) Checkpoint at half the
     full-scale GRMU stream, restore into a fresh service: the decisions
     equal the uninterrupted stream's.  (d) The ("ILP", "GRMU", "FF")
     ladder on tests/test_serve.py's small stream at slo_s=0: card ==
     CPU.  (e) ``sweep_heavy_capacity`` at full scale, GRMU DB, over
     ``SWEEP_FRACS``: equals the JAX sweep's ``SWEEP_ACCEPTED``; seconds
     per capacity.
  7. The pod tools (``run_pod_tools``, after 5g).  (a) The meta roofline
     and memory fit (``launch.dryrun.lower_cell``: flops, bytes and live
     bytes counted on meta tensors, terms at the H100's peaks) of
     TinyLlama's bf16 prefill (phase 5's cell: its profiled device ms;
     the peak of one prefill after the model's init, ``prefill_peak``)
     and of 5g (a) / (c)'s train steps (their profiled device ms and
     peaks): terms, dominant, bound, counted flops, bound / measured
     device ms, fit peak / measured peak.  (b) ``launch.hillclimb.
     measure`` on 5g (a)'s cell (TinyLlama at full width, bf16, 8 x 4096)
     under remat "full" / "dots" / "none" x n_micro 2 / 4
     (``HILLCLIMB_REMAT``, ``HILLCLIMB_MICRO``; the flags set and
     restored by the tool, 5g's own assert untouched): a variant whose
     fit exceeds ``hillclimb.FIT_SHARE`` of the card is reported and not
     run; each that runs must launch 2 / 2 / 1 forward and 1 backward
     attention call a layer and micro-batch every timed step, peak under
     80 GB, and give every remat mode's first loss at its n_micro bit
     for bit; tokens/s, device ms a step (CUDA events), peak beside the
     fit, counted flops.  (c) ``train.grad_compress``: ``compress`` /
     ``decompress`` of a float32 tree of TinyLlama's parameter shapes on
     the card == the CPU bit for bit, ``cross_pod_int8`` over a one-rank
     NCCL group == the no-group path.  (d) ``launch.elastic.
     apply_rescale`` of TinyLlama's full-width parameters onto a
     one-device ``DeviceMesh`` on cuda:0 (``plan_rescale``'s specs):
     every DTensor's local tensor equals the parameter bit for bit, with
     ``sharding.placements`` of its spec; the group is then destroyed.
     (e) The sharded step (``run_sharded_step``): (i) 5g (a)'s cell on a
     1 x 1 ("data", "model") NCCL ``DeviceMesh``, every parameter and
     moment a DTensor under ``DEFAULT_RULES`` (``registry.shard_model`` /
     ``shard_opt_state``, ``make_step(mesh=)``), the attention kernels on
     local shards: its first step equals the plain step bit for bit
     (loss, gradients, parameters, moments) with 88 forward and 44
     backward launches, then tokens/s; (ii) the production-mesh dry-run
     of TinyLlama's train_4k, prefill_32k and decode_32k on 16x16 and
     2x16x16 (``launch.roofline --pod / --multi-pod``, one subprocess a
     cell, each its own fake group of 256 / 512 ranks): per-device peak,
     flops, collective bytes by kind, dominant term.
     7 (b) also runs JAX's one-card p_bf16 variants (``p_bf16``,
     ``ce+pbf16``) at 5g (a)'s cut (88 p_bf16 forward and 44 backward
     launches a step, tokens/s beside the baseline row) and the float32
     p_bf16 route's training path (TinyLlama cut to 2 layers, 2 x 4096):
     the p_bf16 kernels' main path (``hillclimb_pbf16_on_card``).
  8. repro-lint's graph gate on the card (``run_lint_gate``,
     ``repro_torch.lint.graph_gate`` with ``device="cuda"``): the lint
     fixture (8 VMs, 6 mixed A30 / A100 / H100 GPUs) through every policy
     x variant, plain, chunked in 16-event chunks and sharded (one NCCL
     rank here; two gloo ranks run on the CPU), and MCC / MECC on the
     fixture's single-model cut through the pick kernels; each event's
     aten operations recorded: no float64, no host synchronisation in a
     captured key, every event of a key and its capture the same
     operations; each key's captured graph read through libcuda (no
     device-to-host memcpy node) and its pick launches (exactly one
     ``mcc_pick`` / ``ecc_pick`` per MCC / MECC arrival key, none in any
     other key); the graphs' replay equal to the eager one.  One line
     per key with its graph's kernel, memcpy and memset nodes.
  9. The ``repro_torch.examples`` scripts on the card at the JAX scripts'
     defaults (``run_examples``): ``paper_eval`` (five policies on the
     full-scale trace, replayed on the card) and ``quickstart`` print the
     JAX scripts' lines exactly (``PAPER_EVAL_JAX`` / ``QUICKSTART_JAX``);
     ``sweep_on_device``'s sweep equals its sequential cross-check;
     ``serve_with_grmu``'s online decisions equal the offline replay's
     where no tier switched; ``train_lm`` trains 200 steps and returns 0.
  10. Prints the kernel table as one JSON line (the picks' rows add the
     service's launches, ``service_launches``; every mask kernel's row
     its launches on the sharded path, ``sharded_launches``; the
     attention rows their launches and head dim per serving path,
     phases 5, 5c, 5d, 5e and 5f (DeepSeek-V2's the pair [192, 128]), the
     head dims and pairs phase 2b checked and the times at each phase 5c
     model's prefill shape, phase 5d's and 5f's attention shapes and
     Zamba2's, in float32 StableLM-3B's and DeepSeek-V2's; the forward
     rows also their launches on phase 5g's training paths,
     ``train_launches``), the backward's rows (bf16 and float32: launches
     on phase 5g's paths and per full-width train step, the head dims
     phase 2c checked, times at TinyLlama's training attention shape
     beside the plain backward, SDPA's backward and the bound, and by
     kernel, ``ms_by_kernel``; the bf16 forward's and backward's rows
     also their launches in each phase 7 (b) variant's timed steps,
     ``hillclimb_launches``, and in phase 7 (e)'s compared sharded step,
     ``sharded_step_launches``; the p_bf16 routes' four rows their
     launches on phase 7 (b)'s p_bf16 runs and phase 2d's times and
     shares of the flag's effect), the card line again, and
     as its last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present, or when
the port's sources are not beside this script.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
# One H100's peaks and the attention kernels' flop and byte formulas: the
# port's roofline (launch/dryrun.py) and this script's bounds share them
# (the tests read attention_pairs from here too).
from repro_torch.launch.dryrun import (  # noqa: E402
    PEAK_BYTES_PER_S, attention_bound_ms, attention_bwd_bound_ms,
    attention_pairs, head_dims_of)

# sha256 of (accepted_ids, intra, inter, hourly series reprs) of the JAX
# reference replay (repro.core.batched.replay, CPU) on
# TraceConfig(scale=1.0, seed=1) with the default heavy capacity 558;
# GRMU runs with defrag=True, consolidation_interval=24.0.  Pinned against
# the JAX package by tests/test_torch_boundary.py.
DIGESTS = {
    "FF": "5a02708aed3fafc68a88f8795399f329b56cdf151cdff263b33ee047697454ae",
    "BF": "392536a6e6888b11876a9a5c9f856550b189cb677896380eaddcf1a09d61d266",
    "MCC": "7b0a872c9253222ab4f81a74e59376d0aadc608adcc94037a194dff0af6706f0",
    "MECC": "7b0a872c9253222ab4f81a74e59376d0aadc608adcc94037a194dff0af6706f0",
    "GRMU": "f5f4baa0c60658f914265fcbb961a8ec2a96b046a41be59d83ecc9afe41b62a2",
}
GRMU_FULL = dict(defrag=True, consolidation_interval=24.0)
GRMU_DB = dict(defrag=False, consolidation_interval=None)

# sha256 of the telemetry output arrays (``telemetry_digest``) of the JAX
# replay with telemetry=True on the same trace and settings as DIGESTS.
# Pinned against the JAX package by tests/test_torch_boundary.py.
TELE_DIGESTS = {
    "FF": "72af53c86af97cc98ba0604777d027ede0cfd7b40af1aafd33cab96a8efa2dbc",
    "BF": "e0aa7e92886e117a0fcf1de927f317ad33d3029f7782cebd94c7cf1d11d2e870",
    "MCC": "3196f667a78c7121b11a1b6b352e6921e08df41f716e033b1260323483d50875",
    "MECC": "3196f667a78c7121b11a1b6b352e6921e08df41f716e033b1260323483d50875",
    "GRMU": "3a0853de0aa44d11cf7ebdfb84a8cb41bbe962fdf10ea95a1e46887a9e29276d",
}
# Phase 4b (b): GRMU DB on the pow2-padded TraceConfig(scale=0.1, seed=1)
# trace (BENCH_batched_engine.json, "telemetry").
ANCHOR_REASONS = {"no_slot": 70, "capacity": 0, "basket_quota": 220,
                  "frozen": 0}
# Phase 4b (c): chunk length of the full-scale chunked replays.
CHUNK_EVENTS = 1000
# Phase 4b (d): the JAX ladder's rung synth:20000x512 (benchmarks/
# batched_engine.py: seed 1, streamed in chunks of 4,096 events), and
# result digests of the JAX replay of it, padded to a multiple of the
# chunk (GRMU DB at the default heavy capacity 154; MECC).  Pinned by
# tests/test_torch_boundary.py.
SYNTH_CFG = dict(n_vms=20000, n_gpus=512, seed=1)
SYNTH_CHUNK = 4096
SYNTH_ACCEPTED_GRMU_DB = 17862
SYNTH_DIGESTS = {
    "GRMU-DB":
        "3d4ca5141d01d14b9ed95d9f935f5c1f2c81b1920a930ac4df62509215fb4518",
    "MECC":
        "3ef85caeca1918f77a2e3552862cee74799b142375947070adb2c51b9f33c932",
}

# Phase 4c: the eager loop is held against the graphs over the trace's
# first EAGER_PREFIX events.  Phase 4d (b): the gloo fleets' sizes.
EAGER_PREFIX = 1000
GLOO_FLEETS = (2,)
# Phase 6: the placement service.  (a) the full-scale trace's request
# stream (8,604 requests, 8,063 arrivals) at micro-batches of 64; (b) the
# flash crowd at BENCH_serve.json's size (GRMU accepts 373 online and
# offline); (d) tests/test_serve.py's small synthetic stream; (e) the
# sweep's capacities (benchmarks/batched_engine.py) and the accepted
# counts per reference profile of the JAX sweep (repro.core.batched.
# sweep_heavy_capacity, GRMU DB, CPU) at full scale.  Pinned by
# tests/test_torch_boundary.py.
SERVE_BATCH = 64
SERVE_REQUESTS, SERVE_ARRIVALS = 8604, 8063
FLASH_CFG = dict(n_vms=600, n_gpus=32, horizon_hours=72.0, seed=2)
FLASH_ACCEPTED = 373
SERVE_SMALL = dict(n_vms=200, n_gpus=12, horizon_hours=30.0,
                   mean_duration_hours=6.0, seed=5)
ILP_LADDER = dict(tiers=("ILP", "GRMU", "FF"), micro_batch=16, slo_s=0.0,
                  ilp_window=4, ilp_time_limit=2.0)
SWEEP_FRACS = (0.2, 0.25, 0.3, 0.35, 0.4)
SWEEP_ACCEPTED = [[1454, 491, 1318, 937, 491, 433],
                  [1454, 491, 1318, 937, 491, 539],
                  [1448, 484, 1305, 925, 485, 649],
                  [1368, 465, 1223, 854, 449, 760],
                  [1270, 436, 1140, 782, 424, 868]]

N_BIG, N_MAIN = 1 << 20, 1860
N_RAG = 1863                      # not a multiple of 4: a scalar tail
H_MAIN = 1213                     # the replay's hosts at full scale
KERNELS = {
    "mcc": "src/repro/kernels/policy_score.py:77",
    "ecc": "src/repro/kernels/policy_score.py:94",
    "cc": "src/repro/kernels/cc_score.py:41",
    "frag": "src/repro/kernels/frag_score.py:49",
    # The picks fuse the replay's whole MCC/MECC arrival scoring (the TPU
    # kernel, its host-headroom mask and argmax) into one launch.
    "mcc_pick": "src/repro/kernels/policy_score.py:77",
    "ecc_pick": "src/repro/kernels/policy_score.py:94",
}
SOURCE = "src/repro_torch/kernels/csrc/mask_scores.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:82"
ARCH = "tinyllama_1_1b"
PREFILL_B, PREFILL_S = 4, 4096          # SHAPES["prefill_32k"] cut for time
F32_PREFILL_B = 1                       # the float32 prefill: 1 x 4096
N_REQ, PROMPT, GEN, MAX_SEQ = 8, 128, 32, 4096
# Phase 5c: the dense zoo at full width, in this order; ZOO_F32 also runs
# the float32 prefill.  Its requests are phase 5's cut from 128 + 32 to 32
# prompt + 8 generated tokens, for time.
ZOO = ("deepseek_7b", "mistral_nemo_12b", "stablelm_3b", "qwen2_vl_2b")
ZOO_F32 = "stablelm_3b"
ZOO_PROMPT, ZOO_GEN = 32, 8
# Phase 5d: Whisper-base (encoder-decoder) and Llama-4 Scout (MoE) at full
# width.  Whisper: (a) the prefill cell's frames, PREFILL_B x PREFILL_S;
# (b) its own shapes, 30 s of audio (1,500 frames) and its 448-token
# decoder context, WHISPER_B of each; (c) decode against a cache of exactly
# the 1,500 encoder positions, WHISPER_PROMPT teacher-forced and
# WHISPER_GEN generated tokens.  Scout keeps its width and its 48 layers
# are cut to SCOUT_LAYERS: 106.7B parameters do not fit one card, 8
# layers are 18.7B (37.3 GB in bf16; its init peaks near 60 GB, a float32
# draw of one (8, 16, 5120, 8192) expert stack).
WHISPER = "whisper_base"
WHISPER_B, WHISPER_FRAMES, WHISPER_TOKENS = 8, 1500, 448
WHISPER_PROMPT, WHISPER_GEN = 32, 8
SCOUT = "llama4_scout_17b_a16e"
SCOUT_LAYERS = 8
# Phase 5e: the sub-quadratic models at full width, in this order.  A
# windowed model prefills prefill_shape(cfg): Zamba2-7B 2 x 8,192, the same
# tokens per call, since at S 4,096 its 4,096-key window masks nothing.
# RWKV-6's prefill is a per-token loop, host-bound (~20 s a 4 x 4096 call
# on the H100 machine's host): one timed call after a warm-up over
# RWKV_WARMUP tokens (the loop's shapes are the same at any S), its device
# profile over RWKV_PROFILE (B, S) tokens (the profiler's cost grows with
# the loop's ~8 events a token and layer).  long_500k runs
# uncut: LONG_PROMPT tokens decoded at the cell's last positions.  The
# hybrid's teacher-forced check is gated on its float32 model at full width
# cut to HYBRID_F32_LAYERS layers (one group of 6 and the 2 left over; the
# module's docstring, 5e).  Card vs CPU: SUBQ_SMALL's float32 models, a
# prefill of 2 x SUBQ_SMALL_S and SUBQ_SMALL_STEPS decode steps (past the
# hybrid's 64-slot ring), each output within CARD_CPU_TOL of the CPU's or,
# where more, within NOISE_FACTOR times what half a float32 ulp of noise at
# every block's input moves it on the CPU (``half_ulp_noise``): the
# hybrid at the reference's init amplifies any rounding difference (noise
# on its attention outputs alone moves a prefill's logits by 4e-4).
ZAMBA2, RWKV6 = "zamba2_7b", "rwkv6_3b"
# RWKV-6 is served at full width with its depth cut to SUBQ_LAYERS, 8 of
# 32 (at 32 it took 76.4 s of the phase); long_500k keeps its 524,288
# positions.  Zamba2 keeps its 81 layers: at 14 its prefill failed the
# float64 gate (kernel 0.816, plain 0.623 from float64; PERF.md §6).
SUBQ_LAYERS = {RWKV6: 8}
RWKV_WARMUP, RWKV_PROFILE = (PREFILL_B, 64), (1, 256)
LONG_PROMPT = 32
HYBRID_F32_LAYERS = 8
SUBQ_SMALL = {
    RWKV6: dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                vocab=512, ssm=dict(head_dim=64)),
    ZAMBA2: dict(n_layers=5, d_model=224, n_heads=2, n_kv_heads=2, d_ff=448,
                 vocab=512, shared_attn_period=2, sliding_window=64,
                 ssm=dict(d_state=64, head_dim=64, expand=2, chunk=128)),
}
SUBQ_SMALL_S, SUBQ_SMALL_STEPS = 256, 100
CARD_CPU_TOL, NOISE_FACTOR = (1e-4, 1e-3), 2.0
# Its teacher-forced check (``moe_teacher_forced``): the least share of
# decode's own routes that must be prefill's, far above a wrong router's
# 1 / 16.
MOE_ROUTE_AGREEMENT = 0.5
# Phase 5f: DeepSeek-V2 (MLA + MoE) at full width, its 60 layers cut to
# DSV2_LAYERS: 238.9B parameters do not fit one card; 4 layers are 16.4B
# (32.8 GB in bf16; the init's float32 draw of one (4, 160, 5120, 1536)
# expert stack is 20 GB, and 5 layers would near Scout's 58.8 GB peak).
# Its prefill attention takes q/k at 192 (nope 128 + rope 64) against v
# at 128: one launch of the kernel's (192, 128) instantiation a layer.
# Card vs CPU: MLA_SMALL, tests/test_torch_mla.py's float32 2-layer
# variant at those head dims (the float32 route at the pair), prefill of 2
# x MLA_SMALL_S tokens and MLA_SMALL_STEPS decode steps on a float32
# latent cache of MLA_SMALL_S positions, within CARD_CPU_TOL.
DSV2 = "deepseek_v2_236b"
DSV2_LAYERS = 4
# Its teacher-forced gate runs in float32 at full width on DSV2_F32_LAYERS
# layers (``mla_teacher_forced``; 34 GB beside the served bf16 model).
DSV2_F32_LAYERS = 2
MLA_SMALL = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, d_ff=512,
                 vocab=512,
                 mla=dict(kv_lora_rank=64, q_lora_rank=96, rope_head_dim=64,
                          nope_head_dim=128, v_head_dim=128),
                 moe=dict(n_experts=16, top_k=6, n_shared=2, d_ff_expert=64))
MLA_SMALL_S, MLA_SMALL_STEPS = 256, 32
# Phase 2b: the bf16 kernel at every attention shape of phase 5d's path,
# (B, Sq, Sk, H, KV, hd, causal): Whisper's encoder over the prefill
# cell's frames (a) and over its own 1,500 (b), its decoder's causal self
# attention and its cross attention (b), Scout's prefill (its GQA group
# of 5); and phase 5f's, DeepSeek-V2's MLA prefill, hd given as the (q/k,
# v) pair (192, 128).
MODEL_ATTN_SHAPES = {
    "whisper_base prefill": (PREFILL_B, PREFILL_S, PREFILL_S, 8, 8, 64,
                             False),
    "whisper_base encode": (WHISPER_B, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8,
                            64, False),
    "whisper_base decoder": (WHISPER_B, WHISPER_TOKENS, WHISPER_TOKENS, 8, 8,
                             64, True),
    "whisper_base cross": (WHISPER_B, WHISPER_TOKENS, WHISPER_FRAMES, 8, 8,
                           64, False),
    "llama4_scout_17b_a16e": (PREFILL_B, PREFILL_S, PREFILL_S, 40, 8, 128,
                              True),
    DSV2: (PREFILL_B, PREFILL_S, PREFILL_S, 128, 128, (192, 128), True),
}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_flash_attention.py
# The bf16 kernel rounds its float32 result once, and the plain version
# computes in float32 from the same upcast inputs, so on phase 2b's random
# (well-conditioned) inputs the bf16 kernel must also lie within half a
# bf16 ulp (2**-8 of the value) of the plain version run in float32.  The
# atol covers float32 summation order (kernel vs plain version in float32:
# 3.7e-7 at most, PERF.md).  On a model's ill-conditioned rows any two
# float32 summation orders differ by more; phase 5b holds those against
# float64 instead.
BF16_HALF_ULP, F32_ATOL = 2.0 ** -8, 1e-5
# Prefill logits, kernel vs plain attention, bf16, 22 layers: relative L2
# error and max error over max |logit|.  Measured on the H100 (PERF.md)
# over five seeds: 0.073-0.084 and 0.073-0.102.  Each layer's ill-
# conditioned rows flip bf16 roundings between any two float32 summation
# orders, and 22 layers of the reference init's peaked softmax amplify
# them: two plain-torch paths, prefill vs teacher-forced decode, differ by
# 0.06, and every implementation is ~0.075 from float64 attention.  The
# elementwise bound is the JAX package's 0.15.
PREFILL_TOL = (0.1, 0.15)
# Phase 5b: the bf16 kernel may be no further from the float64 function
# than the float32 plain version: per reading, no more elements beyond half
# a bf16 ulp, and prefill logits against float64 attention (mean relative
# L2 over the seeds) within this factor of the plain version's.  Measured
# on the H100 (PERF.md): 0.64x the count, 0.95x the logits error.
ACCURACY_LOGITS_RATIO = 1.25
ACCURACY_SEEDS = (0, 1, 2, 3, 4)


def result_digest(res) -> str:
    """Digest of a SimResult's decisions and series (both packages'
    SimResult have these fields)."""
    payload = repr((list(res.accepted_ids), res.intra_migrations,
                    res.inter_migrations,
                    [repr(v) for v in res.hourly_acceptance],
                    [repr(v) for v in res.hourly_active_hw]))
    return hashlib.sha256(payload.encode()).hexdigest()


def telemetry_digest(events, out) -> str:
    """Digest of a telemetry replay's output arrays (numpy), sliced to
    the trace's logical VMs, steps and GPUs: the per-VM codes, the code
    tally, the step rows and the free-mask snapshots, with their dtypes
    and shapes."""
    import numpy as np
    N, S, G = len(events.vm_ids), len(events.step_times), events.num_gpus
    h = hashlib.sha256()
    for a in (out["tele_vm_reason"][:N], out["tele_rej"],
              out["tele_steps"][:S], out["tele_masks"][:S, :G]):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def same_result(a, b) -> bool:
    return (a.accepted_ids == b.accepted_ids
            and a.per_profile_accepted == b.per_profile_accepted
            and a.hourly_acceptance == b.hourly_acceptance
            and a.hourly_active_hw == b.hourly_active_hw
            and a.intra_migrations == b.intra_migrations
            and a.inter_migrations == b.inter_migrations)


# ---------------------------------------------------------------------------
# Phase 2 helpers: bounds and timing
# ---------------------------------------------------------------------------

def bound_ms(name, n, model, hosts=0):
    """The bytes floor of one call over ``n`` masks (GPUs): each input
    byte read once and each output byte written once, over the card's
    memory rate.  A scorer reads a 4-byte mask and writes a 4-byte score
    per mask (ecc also reads its weights).  A pick reads per GPU its mask
    (4), host id (8) and capacity row (8), the used row (8) of each of
    the ``hosts`` hosts that hold a GPU, the (2,) need (8) and the
    weights (ecc), and writes one int64."""
    weights = 4 * model.num_profiles if name.startswith("ecc") else 0
    if name.endswith("_pick"):
        nbytes = 20 * n + 8 * hosts + 8 + weights + 8
    else:
        nbytes = 8 * n + weights
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def time_ms(torch, fn, iters=200):
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph, replayed between two CUDA events (no host launch cost)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def host_us(torch, fn, iters=200):
    """Microseconds per call launched eagerly from Python (what the replay
    loop pays), measured with CUDA events around the loop."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) * 1e3 / iters


def tiled_masks(torch, model, n, high_bits=False, seed=0):
    """Every mask of the model, tiled to ``n``; with ``high_bits``, random
    bits above the model's blocks (bit 31 on every fifth)."""
    import numpy as np
    base = np.arange(model.num_masks, dtype=np.int64)
    masks = np.resize(base, n)
    if high_bits:
        rng = np.random.default_rng(seed)
        masks = masks | (rng.integers(0, 1 << (31 - model.num_blocks), n)
                         << model.num_blocks)
        masks[::5] |= 1 << 31
    return torch.as_tensor(masks.astype(np.uint32).view(np.int32)).cuda()


def random_fleet(torch, model, G, seed, case="random", H=None):
    """One arrival's pick inputs on the card: ``tests/_torch_fleets.py``'s
    draws (ties, nothing fitting, every host full, bits above the blocks;
    headroom at, just under and just over the need)."""
    from _torch_fleets import fleet
    return [torch.as_tensor(a).cuda()
            for a in fleet(model, G, seed, case, H)]


def pick_weights(torch, model, seed):
    """(integer counts, real probabilities) as float32 on the card."""
    from _torch_fleets import weights
    return [torch.as_tensor(w).cuda() for w in weights(model, seed)]


def check_kernels(torch, np):
    """Phase 2: every kernel equals its plain version on the card,
    exactly: the scorers over every mask x profile of every preset (and
    with bits above the blocks), the picks on random fleets."""
    from _torch_fleets import CASES
    from repro_torch.core.mig import DEVICE_MODELS
    from repro_torch.kernels import mask_scores as K, ref

    rng = np.random.default_rng(0)
    err = {k: 0.0 for k in KERNELS}
    n_checked = 0

    def hold(name, got, want, where):
        nonlocal n_checked
        diff = (got.double() - want.double()).abs().max().item()
        err[name] = max(err[name], diff)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} kernel != plain version on "
                                 f"{where} (max abs diff {diff})")
        n_checked += 1

    for model in DEVICE_MODELS.values():
        big = tiled_masks(torch, model, N_BIG)
        rag = tiled_masks(torch, model, N_RAG, high_bits=True, seed=2)
        # rag[1:] starts 4 bytes past a 16-byte boundary: the kernels'
        # one-mask-at-a-time path; N_RAG (not a multiple of 4) its tail.
        cases = [big, big[:N_MAIN].clone(),
                 tiled_masks(torch, model, N_BIG, high_bits=True),
                 tiled_masks(torch, model, N_MAIN, high_bits=True, seed=1),
                 tiled_masks(torch, model, N_RAG), rag, rag[1:]]
        NP = model.num_profiles
        w_int = torch.as_tensor(rng.integers(0, 60, NP).astype(np.float32))
        w_prob = torch.as_tensor(rng.dirichlet(np.ones(NP)).astype(
            np.float32))
        for masks in cases:
            where = f"{model.name} N {masks.numel()}"
            hold("cc", K.cc(masks, model), ref.cc_ref(masks, model), where)
            hold("frag", K.frag(masks, model), ref.frag_ref(masks, model),
                 where)
            for p in range(NP):
                hold("mcc", K.mcc(masks, p, model),
                     ref.mcc_score_ref(masks, p, model), where)
                for w in (w_int, w_prob):
                    w = w.cuda()
                    hold("ecc", K.ecc(masks, p, w, model),
                         ref.ecc_score_ref(masks, p, w, model), where)
        # The plain version on the card equals the one on the CPU too.
        cpu = torch.arange(model.num_masks, dtype=torch.int32)
        gpu = cpu.cuda()
        for p in range(NP):
            if not torch.equal(K.mcc(gpu, p, model).cpu(),
                               ref.mcc_score_ref(cpu, p, model)):
                raise AssertionError(f"mcc card != CPU on {model.name}")
            if not torch.equal(K.ecc(gpu, p, w_prob.cuda(), model).cpu(),
                               ref.ecc_score_ref(cpu, p, w_prob, model)):
                raise AssertionError(f"ecc card != CPU on {model.name}")
        if not torch.equal(K.frag(gpu, model).cpu(), ref.frag_ref(cpu, model)):
            raise AssertionError(f"frag card != CPU on {model.name}")
        if not torch.equal(K.cc(gpu, model).cpu(), ref.cc_ref(cpu, model)):
            raise AssertionError(f"cc card != CPU on {model.name}")
        # The picks, on random fleets of both sizes.
        n_minus = 0
        for G in (N_MAIN, N_BIG):
            for c, case in enumerate(CASES):
                fleet = random_fleet(torch, model, G, seed=G + c, case=case,
                                     H=H_MAIN if G == N_MAIN else None)
                where = f"{model.name} G {G} {case}"
                for p in range(NP):
                    got = K.mcc_pick(*fleet, p, model)
                    hold("mcc_pick", got,
                         ref.mcc_pick_ref(*fleet, p, model), where)
                    n_minus += int(got.item() < 0)
                    for w in pick_weights(torch, model, p):
                        got = K.ecc_pick(*fleet, p, w, model)
                        hold("ecc_pick", got,
                             ref.ecc_pick_ref(*fleet, p, w, model), where)
                        n_minus += int(got.item() < 0)
        # The CPU's plain pick on one fleet equals the card's.
        fleet = random_fleet(torch, model, N_MAIN, seed=5, H=H_MAIN)
        for p in range(NP):
            if not torch.equal(K.mcc_pick(*fleet, p, model).cpu(),
                               ref.mcc_pick_ref(*[t.cpu() for t in fleet],
                                                p, model)):
                raise AssertionError(f"mcc_pick card != CPU on {model.name}")
        print(f"phase 2: {model.name}: picks == plain versions, "
              f"{n_minus} of them -1", flush=True)
    torch.cuda.synchronize()
    print(f"phase 2: {n_checked} kernel/plain comparisons exact; "
          f"max abs diff {err}", flush=True)
    return err


def timed_fleet(model, n):
    """The arrival the picks are timed on: ``n`` GPUs over the replay's
    1,213 hosts at N = 1,860 (a third of ``n`` otherwise), numbered host
    by host so that every host holds one or two (three at 1M).  Returns
    the numpy arrays and the number of host rows the pick reads."""
    import numpy as np
    from _torch_fleets import fleet
    arrays = fleet(model, n, seed=n, H=H_MAIN if n == N_MAIN else n // 3,
                   contiguous=True)
    return arrays, len(np.unique(arrays[1]))


def time_kernels(torch, np):
    """Phase 2 timing on the A100-40GB preset (the replay's model): the
    scorers over masks spread over the whole mask space with the 1g.5gb
    profile (the most slots), the picks on ``timed_fleet``; and a launch
    floor, one one-element ``zero_()`` in the same harness."""
    from repro_torch.core.mig import A100_40GB as model
    from repro_torch.kernels import mask_scores as K, ref
    w = torch.ones(model.num_profiles, dtype=torch.float32, device="cuda")
    z = torch.empty(1, dtype=torch.float32, device="cuda")
    floor_ms = time_ms(torch, z.zero_)
    out = {"launch_floor": dict(ms=floor_ms, host_us=host_us(torch, z.zero_))}
    print(f"phase 2: launch floor {floor_ms * 1e3:.3f} us (graph), "
          f"{out['launch_floor']['host_us']:.3f} us eager", flush=True)
    for n in (N_MAIN, N_BIG):
        masks = tiled_masks(torch, model, n)
        arrays, hosts = timed_fleet(model, n)
        arrival = [torch.as_tensor(a).cuda() for a in arrays]
        fns = {
            "mcc": (lambda: K.mcc(masks, 0, model),
                    lambda: ref.mcc_score_ref(masks, 0, model)),
            "ecc": (lambda: K.ecc(masks, 0, w, model),
                    lambda: ref.ecc_score_ref(masks, 0, w, model)),
            "cc": (lambda: K.cc(masks, model),
                   lambda: ref.cc_ref(masks, model)),
            "frag": (lambda: K.frag(masks, model),
                     lambda: ref.frag_ref(masks, model)),
            "mcc_pick": (lambda: K.mcc_pick(*arrival, 0, model),
                         lambda: ref.mcc_pick_ref(*arrival, 0, model)),
            "ecc_pick": (lambda: K.ecc_pick(*arrival, 0, w, model),
                         lambda: ref.ecc_pick_ref(*arrival, 0, w, model)),
        }
        for name, (kern, plain) in fns.items():
            b_ms, b_by = bound_ms(name, n, model, hosts)
            t = out[(name, n)] = dict(
                ms=time_ms(torch, kern),
                plain_ms=time_ms(torch, plain, iters=20),
                host_us=host_us(torch, kern),
                bound_ms=b_ms, bound_by=b_by)
            print(f"phase 2: {name} N {n}: {t['ms'] * 1e3:.3f} us "
                  f"(launch floor {floor_ms * 1e3:.3f}, bound "
                  f"{b_ms * 1e3:.4f} us {b_by}), plain "
                  f"{t['plain_ms'] * 1e3:.1f} us, eager "
                  f"{t['host_us']:.2f} us", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the replay
# ---------------------------------------------------------------------------

def replay_configs(B):
    return [("FF", B.FF, {}), ("BF", B.BF, {}),
            ("MCC", B.MCC, dict(score_backend="kernel")),
            ("MECC", B.MECC, dict(score_backend="kernel")),
            ("GRMU", B.GRMU, GRMU_FULL)]


def tables_configs(B):
    """(name, policy, knobs) of phase 4's five replays without their
    score backend: the placement service's ``ServeConfig`` knobs (phase
    6, which resolves the backend itself) and the sharded fleet's
    settings (phase 4d, tables only)."""
    return [(name, pol, {k: v for k, v in kw.items()
                         if k != "score_backend"})
            for name, pol, kw in replay_configs(B)]


def check_card_vs_cpu():
    """Phase 3: the card replays the 0.1-scale trace exactly as the CPU."""
    from repro_torch.core import batched as B
    from repro_torch.workload.alibaba import TraceConfig, generate
    cluster, vms = generate(TraceConfig(scale=0.1, seed=1))
    events = B.build_events(vms, cluster)
    configs = replay_configs(B) + [
        ("MCC-tables", B.MCC, dict(score_backend="tables")),
        ("MECC-tables", B.MECC, dict(score_backend="tables")),
        ("GRMU-6h", B.GRMU, dict(defrag=True, consolidation_interval=6.0)),
        ("GRMU-DB", B.GRMU, dict(defrag=False, consolidation_interval=None)),
    ]
    for name, pol, kw in configs:
        card = B.replay(events, pol, device="cuda", **kw)
        cpu = B.replay(events, pol, device="cpu", **kw)
        if not same_result(card, cpu):
            raise AssertionError(f"scale 0.1 {name}: card != CPU")
        print(f"phase 3: scale 0.1 {name}: card == CPU, accepted "
              f"{card.accepted}/{card.total_requests}, migrations "
              f"{card.intra_migrations}/{card.inter_migrations}",
              flush=True)
    if B.replay(events, B.GRMU, device="cuda", defrag=False,
                consolidation_interval=None).accepted != 516:
        raise AssertionError("GRMU DB anchor at scale 0.1 is not 516")
    from repro_torch.obs import inscan
    for name, pol, kw in replay_configs(B):
        card, card_tele = inscan.replay_with_telemetry(events, pol,
                                                       device="cuda", **kw)
        cpu, cpu_tele = inscan.replay_with_telemetry(events, pol,
                                                     device="cpu", **kw)
        if (not same_result(card, cpu)
                or card.rejection_reasons != cpu.rejection_reasons
                or card_tele.to_json_dict() != cpu_tele.to_json_dict()):
            raise AssertionError(f"scale 0.1 {name} telemetry: card != CPU")
        print(f"phase 3: scale 0.1 {name} telemetry: card == CPU, "
              f"rejections {card.rejection_reasons}", flush=True)


def run_main_path(torch):
    """Phase 4: full-scale replay of all five policies on the card."""
    from repro_torch.core import batched as B
    from repro_torch.kernels import mask_scores as K
    from repro_torch.workload.alibaba import TraceConfig, generate
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    n_events = len(events.kind)
    n_arrivals = int((events.kind == B.ARRIVAL).sum())
    configs = replay_configs(B)
    runs = {name: B.make_replay(events, pol, device="cuda", **kw)
            for name, pol, kw in configs}
    cap = B.default_heavy_capacity(events)
    for name, pol, _ in configs:                      # warm-up
        B.result_from_arrays(events, pol, {
            k: v.cpu().numpy() for k, v in runs[name](cap).items()})
    torch.cuda.synchronize()

    K.reset_launches()
    results, seconds = {}, {}
    for name, pol, _ in configs:
        t0 = time.perf_counter()
        out = runs[name](cap)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        results[name] = B.result_from_arrays(
            events, pol, {k: v.cpu().numpy() for k, v in out.items()})
    launches = dict(K.LAUNCHES)

    for name, _, _ in configs:
        res = results[name]
        if result_digest(res) != DIGESTS[name]:
            raise AssertionError(f"full-scale {name}: digest differs from "
                                 "the JAX reference")
        print(json.dumps({
            "policy": name, "accepted": res.accepted,
            "total": res.total_requests,
            "intra_migrations": res.intra_migrations,
            "inter_migrations": res.inter_migrations,
            "wall_s": seconds[name],
            "events_per_s": n_events / seconds[name],
            "digest_matches_jax": True}), flush=True)
    # One fused pick per MCC/MECC arrival; no score kernel on the replay.
    want = {k: n_arrivals if k in ("mcc_pick", "ecc_pick") else 0
            for k in launches}
    if launches != want:
        raise AssertionError(f"mask kernels launched {launches} on the "
                             f"main path, expected {want}")
    for name, pol in (("MCC", B.MCC), ("MECC", B.MECC)):
        t0 = time.perf_counter()
        tables = B.replay(events, pol, device="cuda", score_backend="tables")
        dt = time.perf_counter() - t0
        if not same_result(tables, results[name]):
            raise AssertionError(f"full-scale {name}: kernel path != "
                                 "tables path")
        print(f"phase 4: {name} tables path == kernel path "
              f"({n_events / dt:.1f} events/s through the tables)",
              flush=True)
    print(f"phase 4: {n_events} events, {n_arrivals} arrivals; launches on "
          f"the main path {launches}", flush=True)
    profiles = {}
    for name, pol, kw in configs:
        profiles[name] = profile_replay(torch, B, events, pol, kw, cap)
        print(json.dumps({"profile": dict(policy=name, **profiles[name])}),
              flush=True)
    return launches, profiles


def first_events(events, n):
    """The trace cut to its first ``n`` events; the VM, fleet and
    schedule arrays stay as they are."""
    import dataclasses
    return dataclasses.replace(events, **{
        k: getattr(events, k)[:n]
        for k in ("kind", "vm_index", "profile", "time", "idx")})


def profile_replay(torch, B, events, pol, kw, cap, n=1000):
    """Where a replay's time goes: ``torch.profiler`` over one replay of
    the trace's first ``n`` events through ``make_replay`` on the card,
    run once before the profile (so a graph runner's captures fall
    outside it).  Returns the device's busy share of the profiled wall
    time, device work per event, and the host operations that cost the
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = B.make_replay(first_events(events, n), pol, device="cuda", **kw)
    run(cap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(cap)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    top = sorted((a for a in prof.key_averages()
                  if a.key.startswith(("aten::", "cuda"))),
                 key=lambda a: a.self_cpu_time_total, reverse=True)[:6]
    per_kernel = {}
    for e in dev:
        per_kernel[e.name[:60]] = per_kernel.get(e.name[:60], 0) + 1
    return {"events": n, "profiled_wall_us_per_event": wall_us / n,
            # Each copy to the host is a point where the host waits.
            "device_to_host_copies": sum(
                v for k, v in per_kernel.items() if k.startswith(
                    "Memcpy DtoH")),
            "device_busy_share": (dev_us / wall_us) if dev else None,
            "device_us_per_event": dev_us / n if dev else None,
            "device_ops_per_event": len(dev) / n,
            "top_host_ops": [[a.key, a.count, a.self_cpu_time_total]
                             for a in top],
            "top_device_ops_by_count": sorted(
                per_kernel.items(), key=lambda kv: -kv[1])[:12]}


def _timed(torch, run, cap):
    """(output arrays, seconds) of one replay run to a synchronize."""
    t0 = time.perf_counter()
    out = run(cap)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {k: v.cpu().numpy() for k, v in out.items()}, dt


def _check_picks(launches, n_arrivals, what):
    want = {k: n_arrivals if k in ("mcc_pick", "ecc_pick") else 0
            for k in launches}
    if launches != want:
        raise AssertionError(f"mask kernels launched {launches} in {what}, "
                             f"expected {want}")


def run_streaming_and_telemetry(torch, off_profiles):
    """Phase 4b: telemetry at full scale, the padded scale-0.1 anchor, the
    chunked replay at full scale and the synthetic rung, on the card.
    ``off_profiles`` are phase 4's profiles, telemetry off: telemetry
    must add no copy to the host (no host synchronisation)."""
    import tempfile
    from repro_torch.core import batched as B
    from repro_torch.core import streaming as ST
    from repro_torch.core.bucketing import pad_events
    from repro_torch.kernels import mask_scores as K
    from repro_torch.obs import inscan, recorder, report
    from repro_torch.workload.alibaba import TraceConfig, generate
    from repro_torch.workload.synthetic import (SyntheticConfig,
                                                generate_events)
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    n_events = len(events.kind)
    n_arrivals = int((events.kind == B.ARRIVAL).sum())
    cap = B.default_heavy_capacity(events)
    configs = replay_configs(B)

    # (a) Telemetry at full scale.
    K.reset_launches()
    for name, pol, kw in configs:
        out, dt = _timed(torch, B.make_replay(events, pol, device="cuda",
                                              telemetry=True, **kw), cap)
        res = B.result_from_arrays(events, pol, out)
        if result_digest(res) != DIGESTS[name]:
            raise AssertionError(f"full-scale {name} with telemetry: digest "
                                 "differs from the JAX reference")
        if telemetry_digest(events, out) != TELE_DIGESTS[name]:
            raise AssertionError(f"full-scale {name}: telemetry digest "
                                 "differs from the JAX reference")
        print(json.dumps({
            "phase": "4b telemetry", "policy": name,
            "rejection_reasons": res.rejection_reasons, "wall_s": dt,
            "events_per_s": n_events / dt, "digests_match_jax": True}),
            flush=True)
    _check_picks(dict(K.LAUNCHES), n_arrivals, "the telemetry replays")
    for name, pol, kw in configs:
        if name not in ("MCC", "GRMU"):     # ~40 s a profile on the card
            continue
        prof = profile_replay(torch, B, events, pol,
                              dict(kw, telemetry=True), cap)
        print(json.dumps({"profile": dict(policy=name, telemetry=True,
                                          **prof)}), flush=True)
        off = off_profiles[name]["device_to_host_copies"]
        if prof["device_to_host_copies"] != off:
            raise AssertionError(
                f"{name}: {prof['device_to_host_copies']} copies to the "
                f"host in {prof['events']} events with telemetry, {off} "
                "without")

    # (b) The anchor: GRMU DB on the padded scale-0.1 trace.
    c01, v01 = generate(TraceConfig(scale=0.1, seed=1))
    res, _ = inscan.replay_with_telemetry(
        pad_events(B.build_events(v01, c01)), B.GRMU, device="cuda",
        **GRMU_DB)
    if res.accepted != 516 or res.rejection_reasons != ANCHOR_REASONS:
        raise AssertionError(f"padded scale-0.1 GRMU DB: accepted "
                             f"{res.accepted}, {res.rejection_reasons}")
    print(f"phase 4b: padded scale-0.1 GRMU DB accepted 516, rejections "
          f"{res.rejection_reasons}", flush=True)

    # (c) Chunked at full scale, then GRMU chunked with telemetry and a
    # recorder.
    K.reset_launches()
    for name, pol, kw in configs:
        run = ST.make_chunked_replay(events, pol, chunk_events=CHUNK_EVENTS,
                                     device="cuda", **kw)
        out, dt = _timed(torch, run, cap)
        if result_digest(B.result_from_arrays(run.events, pol, out)) \
                != DIGESTS[name]:
            raise AssertionError(f"full-scale {name} chunked: digest "
                                 "differs from the JAX reference")
        print(json.dumps({
            "phase": "4b chunked", "policy": name,
            "chunk_events": CHUNK_EVENTS, "num_chunks": run.num_chunks,
            "padded_shape": [len(run.events.kind),
                             len(run.events.gpu_model_id)],
            "wall_s": dt, "events_per_s": n_events / dt,
            "digest_matches_jax": True}), flush=True)
    _check_picks(dict(K.LAUNCHES), n_arrivals, "the chunked replays")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "grmu_chunked.jsonl"
        with recorder.record(path, run_id="chip-smoke-4b",
                             meta={"policy": "GRMU"}) as rec:
            run = ST.make_chunked_replay(events, B.GRMU,
                                         chunk_events=CHUNK_EVENTS,
                                         device="cuda", telemetry=True,
                                         **GRMU_FULL)
            out, dt = _timed(torch, run, cap)
            res = B.result_from_arrays(run.events, B.GRMU, out)
            rec.result(res)
        (summary,) = [report.summarize(r) for r in report.load([str(path)])]
    if (result_digest(res) != DIGESTS["GRMU"]
            or telemetry_digest(run.events, out) != TELE_DIGESTS["GRMU"]):
        raise AssertionError("full-scale GRMU chunked with telemetry: "
                             "digests differ from the unchunked replay's")
    spans = summary["spans"]
    if (spans["chunk.step"]["count"] != run.num_chunks
            or spans["chunk.prefetch"]["count"] != run.num_chunks
            or spans["finalize"]["count"] != 1 or not summary["cache"]
            or summary["rejection_reasons"] != res.rejection_reasons):
        raise AssertionError(f"recorded chunked replay: {summary}")
    print(json.dumps({
        "phase": "4b chunked telemetry recorded", "policy": "GRMU",
        "num_chunks": run.num_chunks, "wall_s": dt,
        "events_per_s": n_events / dt, "spans": spans,
        "digests_match_jax": True}), flush=True)

    # (d) The synthetic rung, as the JAX ladder pads and streams it.
    synth = generate_events(SyntheticConfig(**SYNTH_CFG))
    n_synth = len(synth.kind)
    synth_arrivals = int((synth.kind == B.ARRIVAL).sum())
    synth = pad_events(synth, event_multiple=SYNTH_CHUNK)
    scap = B.default_heavy_capacity(synth)
    for name, pol, kw in (("GRMU-DB", B.GRMU, GRMU_DB),
                          ("MECC", B.MECC, dict(score_backend="kernel"))):
        run = ST.make_chunked_replay(synth, pol, chunk_events=SYNTH_CHUNK,
                                     device="cuda", **kw)
        K.reset_launches()
        out, dt = _timed(torch, run, scap)
        launches = dict(K.LAUNCHES)
        want = {k: synth_arrivals if (k, name) == ("ecc_pick", "MECC")
                else 0 for k in launches}
        if launches != want:
            raise AssertionError(f"synth:20000x512 {name}: mask kernels "
                                 f"launched {launches}, expected {want}")
        res = B.result_from_arrays(run.events, pol, out)
        if result_digest(res) != SYNTH_DIGESTS[name]:
            raise AssertionError(f"synth:20000x512 {name}: digest differs "
                                 "from the JAX reference")
        if name == "GRMU-DB" and res.accepted != SYNTH_ACCEPTED_GRMU_DB:
            raise AssertionError(f"synth:20000x512 GRMU DB accepted "
                                 f"{res.accepted}")
        print(json.dumps({
            "phase": "4b synth:20000x512", "policy": name,
            "events": n_synth, "num_chunks": run.num_chunks,
            "accepted": res.accepted, "total": res.total_requests,
            "launches": launches, "wall_s": dt,
            "events_per_s": n_synth / dt, "digest_matches_jax": True}),
            flush=True)


def graph_replay(torch, run, cap):
    """Phase 4c: one replay through ``run``'s runner, which must hold
    captured graphs, after two warm-up calls.  Returns the outputs
    (numpy), the host synchronisations torch's sync debug mode reports
    during the call, the mask kernels' launches in it, and whether the
    device memory in use after it equals that after the call before."""
    import warnings
    from repro_torch.kernels import mask_scores as K
    runner = run.runner
    run(cap)
    out = run(cap)
    torch.cuda.synchronize()
    if not (runner.graphed and runner.graphs):
        raise AssertionError("the replay ran no captured graph")
    mem = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    del out
    K.reset_launches()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run(cap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # torch's warning at each synchronising call (its one-off notice that
    # the mode is a prototype does not count).
    syncs = [str(w.message) for w in seen
             if "called a synchronizing" in str(w.message)]
    flat = mem == (torch.cuda.memory_allocated(),
                   torch.cuda.memory_reserved())
    return ({k: v.cpu().numpy() for k, v in out.items()}, syncs,
            dict(K.LAUNCHES), flat)


def run_graph_path(torch):
    """Phase 4c: the replay's graph runners.  Through captured graphs,
    with the checks of ``graph_replay``: the full-scale replays of all
    five policies equal ``DIGESTS``, with telemetry ``DIGESTS`` and
    ``TELE_DIGESTS``, chunked at CHUNK_EVENTS ``DIGESTS``, and the
    synthetic rung ``SYNTH_DIGESTS``; MCC/MECC launch one pick per
    arrival; each replay's host synchronisations are at most its
    consolidating step-ends; device memory stays flat from one replay to
    the next.  Then each full-scale replay's events/s through the graphs
    and through the eager loop (``run_events``) in this process, which
    must give the same outputs over the trace's first EAGER_PREFIX events,
    with graphs per runner and capture seconds."""
    from repro_torch.core import batched as B
    from repro_torch.core import streaming as ST
    from repro_torch.core.bucketing import pad_events
    from repro_torch.workload.alibaba import TraceConfig, generate
    from repro_torch.workload.synthetic import (SyntheticConfig,
                                                generate_events)
    import numpy as np
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    n_events = len(events.kind)
    cap = B.default_heavy_capacity(events)
    synth = pad_events(generate_events(SyntheticConfig(**SYNTH_CFG)),
                       event_multiple=SYNTH_CHUNK)
    n_synth = int((synth.kind != B.PAD).sum())

    def chunked(evs, chunk):
        return lambda pol, **kw: ST.make_chunked_replay(
            evs, pol, chunk_events=chunk, device="cuda", **kw)

    plain = lambda pol, **kw: B.make_replay(events, pol, device="cuda",
                                            **kw)
    cases = [("plain", plain, name, pol, kw, n_events, DIGESTS[name])
             for name, pol, kw in replay_configs(B)]
    cases += [("telemetry", plain, name, pol, dict(kw, telemetry=True),
               n_events, DIGESTS[name]) for name, pol, kw in
              replay_configs(B)]
    cases += [("chunked", chunked(events, CHUNK_EVENTS), name, pol, kw,
               n_events, DIGESTS[name]) for name, pol, kw in
              replay_configs(B)]
    cases += [("synth", chunked(synth, SYNTH_CHUNK), name, pol, kw,
               n_synth, SYNTH_DIGESTS[name]) for name, pol, kw in
              (("GRMU-DB", B.GRMU, GRMU_DB),
               ("MECC", B.MECC, dict(score_backend="kernel")))]
    for what, make, name, pol, kw, n_ev, digest in cases:
        run = make(pol, **kw)
        evs = run.events if what in ("chunked", "synth") else events
        c = B.default_heavy_capacity(evs)
        out, syncs, launches, flat = graph_replay(torch, run, c)
        res = B.result_from_arrays(evs, pol, out)
        if result_digest(res) != digest:
            raise AssertionError(f"4c {what} {name}: digest differs from "
                                 "the JAX reference")
        if what == "telemetry" and (telemetry_digest(evs, out)
                                    != TELE_DIGESTS[name]):
            raise AssertionError(f"4c telemetry {name}: telemetry digest "
                                 "differs from the JAX reference")
        arrivals = int((evs.kind == B.ARRIVAL).sum())
        pick = {B.MCC: "mcc_pick", B.MECC: "ecc_pick"}.get(
            pol if kw.get("score_backend") == "kernel" else None)
        if launches != {k: arrivals if k == pick else 0 for k in launches}:
            raise AssertionError(f"4c {what} {name}: mask kernels "
                                 f"launched {launches}")
        n_cons = run.plan.keys.count((B.STEP_END, True))
        # Each consolidation reads its candidates on the host: the count
        # must see those, and nothing else.
        if len(syncs) > n_cons or (n_cons and not syncs):
            raise AssertionError(f"4c {what} {name}: {len(syncs)} host "
                                 f"synchronisations, {n_cons} "
                                 f"consolidating step-ends: {syncs[:3]}")
        if not flat:
            raise AssertionError(f"4c {what} {name}: device memory grew "
                                 "from one replay to the next")
        row = {"phase": "4c", "what": what, "policy": name, "events": n_ev,
               "graphs": len(run.runner.graphs),
               "capture_s": run.runner.capture_s, "host_syncs": len(syncs),
               "consolidating_step_ends": n_cons, "launches": launches,
               "memory_flat": flat, "digests_match_jax": True}
        if what == "plain":
            # Per replay: events/s, and the share of its wall time the
            # host spent before ``run`` returned (all launches queued).
            rates, queued = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                run(c)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                rates.append(n_ev / (time.perf_counter() - t0))
                queued.append((t1 - t0) * rates[-1] / n_ev)
            # The eager loop against the graphs on the trace's first
            # EAGER_PREFIX events (the whole trace, eagerly, took ~50 s of
            # the phase for five policies).
            pre = first_events(events, EAGER_PREFIX)
            pre_out = B.make_replay(pre, pol, device="cuda", **kw)(c)
            st = B.replay_statics(pre, pol, **kw)
            trace = B.trace_from_numpy(B.trace_arrays(pre), "cuda")
            state = B.init_state(pre, st, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            B.run_events(st, state, trace, c)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            eager = {k: v.cpu().numpy()
                     for k, v in B._finalize(st, state).items()}
            if any(not np.array_equal(eager[k], pre_out[k].cpu().numpy())
                   for k in pre_out):
                raise AssertionError(f"4c {name}: graph replay != eager "
                                     f"loop over the first {EAGER_PREFIX} "
                                     "events")
            row.update(events_per_s=rates, host_share_until_queued=queued,
                       eager_events=EAGER_PREFIX,
                       eager_events_per_s=EAGER_PREFIX / eager_s,
                       graphs_equal_eager=True)
        print(json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# Phase 4d: the sharded fleet
# ---------------------------------------------------------------------------

def fleet_replays(events, configs, cap, device):
    """Phase 4d (b), on each rank that ``spawn_fleet`` starts: the
    sharded replays of ``configs`` in a fleet of the group's world size."""
    import torch.distributed as dist
    from repro_torch.core import sharded as SH
    k = dist.get_world_size()
    return [SH.replay_sharded(events, pol, cap, num_shards=k, device=device,
                              **kw) for _, pol, kw in configs]


def run_sharded(torch):
    """Phase 4d: the sharded fleet.  (a) One rank over NCCL on the card,
    in this process (``sharded.fleet_group`` makes it a one-rank group):
    the full-scale trace padded with ``pad_events(shards=1)``, the five
    policies through the sharded runners' graphs, with the checks of
    ``graph_replay``: each digest equals ``DIGESTS``, no pick or score
    kernel launches, host synchronisations at most the consolidating
    step-ends, device memory flat; events/s sharded and unsharded on the
    same padded trace, in turns; then with telemetry (``DIGESTS`` and
    ``TELE_DIGESTS``) and chunked at ``CHUNK_EVENTS`` (``DIGESTS``).
    (b) GLOO_FLEETS ranks over gloo on the CPU (``spawn_fleet``) on the
    scale-0.1 trace padded with ``shards=K``, GRMU (defrag,
    consolidation) and MECC: each equals the card's unsharded replay
    (K = 4 runs in tests/test_torch_sharded.py).
    Returns the mask kernels' launches over (a)'s replays."""
    import torch.distributed as dist
    from repro_torch.core import batched as B
    from repro_torch.core import compile_cache
    from repro_torch.core import sharded as SH
    from repro_torch.core import streaming as ST
    from repro_torch.core.bucketing import pad_events
    from repro_torch.kernels import mask_scores as K
    from repro_torch.workload.alibaba import TraceConfig, generate
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    unpadded = B.build_events(vms, cluster)
    events = pad_events(unpadded, shards=1)
    n_events = len(unpadded.kind)
    cap = B.default_heavy_capacity(events)
    totals = {}

    def count(launches, what):
        for k, c in launches.items():
            totals[k] = totals.get(k, 0) + c
        if any(launches.values()):
            raise AssertionError(f"4d {what}: mask kernels launched "
                                 f"{launches} on the sharded path")

    # (a) One rank over NCCL: the plain replays, timed beside unsharded.
    for (name, pol, kw), (_, _, ukw) in zip(tables_configs(B),
                                             replay_configs(B)):
        run = SH.make_sharded_replay(events, pol, num_shards=1, **kw)
        if dist.get_backend() != "nccl" or run.runner.device.type != "cuda":
            raise AssertionError("4d: the one-rank fleet is not NCCL on "
                                 "the card")
        out, syncs, launches, flat = graph_replay(torch, run, cap)
        count(launches, f"plain {name}")
        if result_digest(B.result_from_arrays(events, pol, out)) \
                != DIGESTS[name]:
            raise AssertionError(f"4d sharded {name}: digest differs from "
                                 "the JAX reference")
        n_cons = run.plan.keys.count((B.STEP_END, True))
        if len(syncs) > n_cons or (n_cons and not syncs):
            raise AssertionError(f"4d sharded {name}: {len(syncs)} host "
                                 f"synchronisations, {n_cons} "
                                 f"consolidating step-ends: {syncs[:3]}")
        if not flat:
            raise AssertionError(f"4d sharded {name}: device memory grew "
                                 "from one replay to the next")
        unsharded = B.make_replay(events, pol, device="cuda", **ukw)
        unsharded(cap)
        rates = {"sharded": [], "unsharded": []}
        for which in ("unsharded", "sharded"):
            fn = run if which == "sharded" else unsharded
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(cap)
            torch.cuda.synchronize()
            rates[which].append(n_events / (time.perf_counter() - t0))
        print(json.dumps({
            "phase": "4d (a) sharded K=1 nccl", "policy": name,
            "events": n_events, "padded_gpus": len(events.gpu_model_id),
            "graphs": len(run.runner.graphs),
            "capture_s": run.runner.capture_s, "host_syncs": len(syncs),
            "consolidating_step_ends": n_cons, "launches": launches,
            "memory_flat": flat, "events_per_s": rates["sharded"],
            "unsharded_events_per_s": rates["unsharded"],
            "unsharded_score_backend": ukw.get("score_backend", "tables"),
            "digest_matches_jax": True}), flush=True)
    # Telemetry, then chunked at CHUNK_EVENTS.
    for name, pol, kw in tables_configs(B):
        run = SH.make_sharded_replay(events, pol, num_shards=1,
                                     telemetry=True, **kw)
        K.reset_launches()
        out, dt = _timed(torch, run, cap)
        count(dict(K.LAUNCHES), f"telemetry {name}")
        if (result_digest(B.result_from_arrays(events, pol, out))
                != DIGESTS[name]
                or telemetry_digest(events, out) != TELE_DIGESTS[name]):
            raise AssertionError(f"4d sharded {name} with telemetry: "
                                 "digests differ from the JAX reference")
        chunked = ST.make_chunked_replay(unpadded, pol,
                                         chunk_events=CHUNK_EVENTS,
                                         num_shards=1, **kw)
        K.reset_launches()
        cout, cdt = _timed(torch, chunked, cap)
        count(dict(K.LAUNCHES), f"chunked {name}")
        if result_digest(B.result_from_arrays(chunked.events, pol, cout)) \
                != DIGESTS[name]:
            raise AssertionError(f"4d sharded {name} chunked: digest "
                                 "differs from the JAX reference")
        print(json.dumps({
            "phase": "4d (a) sharded K=1 nccl, telemetry and chunked",
            "policy": name, "telemetry_events_per_s": n_events / dt,
            "telemetry_graphs": len(run.runner.graphs),
            "chunked_events_per_s": n_events / cdt,
            "num_chunks": chunked.num_chunks,
            "chunked_graphs": len(chunked.runner.graphs),
            "digests_match_jax": True}), flush=True)
    # The one-rank group ends with the runners that captured its
    # collectives.
    compile_cache.clear_cache()
    torch.cuda.synchronize()
    dist.destroy_process_group()

    # (b) GLOO_FLEETS ranks over gloo, against the card's unsharded replay
    # of the same padded trace.
    c01, v01 = generate(TraceConfig(scale=0.1, seed=1))
    ev01 = B.build_events(v01, c01)
    configs = [(name, pol, kw) for name, pol, kw in tables_configs(B)
               if name in ("GRMU", "MECC")]
    for k in GLOO_FLEETS:
        pv = pad_events(ev01, shards=k)
        kcap = B.default_heavy_capacity(pv)
        want = [B.replay(pv, pol, kcap, device="cuda", **kw)
                for _, pol, kw in configs]
        t0 = time.perf_counter()
        got = SH.spawn_fleet(fleet_replays, k, pv, configs, kcap,
                             device="cpu", timeout=300)
        wall = time.perf_counter() - t0
        for (name, _, _), w, g in zip(configs, want, got):
            if not same_result(w, g):
                raise AssertionError(f"4d (b) K={k} {name}: the gloo fleet "
                                     "!= the card's unsharded replay")
        print(json.dumps({
            "phase": "4d (b) sharded gloo", "ranks": k,
            "policies": [c[0] for c in configs],
            "accepted": [g.accepted for g in got],
            "migrations": [[g.intra_migrations, g.inter_migrations]
                           for g in got],
            "padded_gpus": len(pv.gpu_model_id), "spawn_and_run_s": wall,
            "equal_card_unsharded": True}), flush=True)
    return totals


# ---------------------------------------------------------------------------
# Phase 6: the placement service
# ---------------------------------------------------------------------------

def serve_stream(svc, reqs, horizon):
    """tests/test_serve.py's driving loop: submit in order, draining one
    micro-batch whenever the queue is full, then drain and flush."""
    for r in reqs:
        while not svc.submit(r):
            svc.drain(max_batches=1)
    svc.drain()
    svc.flush(horizon)
    return svc


def decisions_of(svc):
    return {v: (d.accepted, d.gpu, d.start, d.tier)
            for v, d in svc.decisions.items()}


def service_result(B, svc, events, policy):
    """The service's SimResult: its final snapshot read through the
    replay's ``_finalize`` and ``result_from_arrays``."""
    import torch
    st = svc._statics[svc.tier_name]
    snap = {k: torch.as_tensor(v) for k, v in svc._snapshot().items()}
    res = B.result_from_arrays(events, policy, {
        k: v.numpy() for k, v in B._finalize(st, snap).items()})
    if res.accepted_ids != svc.accepted_ids():
        raise AssertionError("the snapshot's accepted VMs differ from the "
                             "service's decisions")
    return res


def profile_service(torch, svc, reqs, n=640):
    """Where a service stream's time goes: ``torch.profiler`` over the
    first ``n`` requests submitted and drained through ``svc`` (its
    runner's graphs captured already).  Returns the device's busy share
    of the profiled wall time, device µs per request, device operations
    and copies per batch, and the share of device time in the copies
    between device buffers (the state and tables copied into the runner
    and the state back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs[:n]:
            while not svc.submit(r):
                svc.drain(max_batches=1)
        svc.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    kinds = {}
    for e in dev:
        k = e.name[:60]
        c, us = kinds.get(k, (0, 0.0))
        kinds[k] = (c + 1, us + e.time_range.elapsed_us())
    copies = {k: v for k, v in kinds.items() if k.startswith("Memcpy")}
    dtod_us = sum(us for k, (_, us) in copies.items() if "DtoD" in k)
    return {"requests": n, "batches": svc.batches,
            "profiled_wall_us_per_request": wall_us / n,
            "device_busy_share": dev_us / wall_us if dev else None,
            "device_us_per_request": dev_us / n if dev else None,
            "device_ops_per_batch": len(dev) / max(svc.batches, 1),
            "copies_per_batch": {k: c / max(svc.batches, 1)
                                 for k, (c, _) in copies.items()},
            "device_to_device_copy_share": dtod_us / dev_us if dev else None,
            "top_device_ops_by_time": sorted(
                ([k, c, us] for k, (c, us) in kinds.items()),
                key=lambda r: -r[2])[:8]}


def run_service(torch):
    """Phase 6: the placement service on the card.  (a) The full-scale
    request stream through ``PlacementService.for_trace`` at micro-batches
    of 64, all five policies, twice (the first captures the graphs): the
    second stream's results equal ``DIGESTS``, MCC/MECC launch their pick
    once per arrival and nothing else launches, the runners hold graphs,
    host synchronisations number at most one per batch plus GRMU's
    consolidating step-ends (a third stream, in torch's sync debug mode),
    and device memory is flat across the five streams.  (b) The flash
    crowd at BENCH_serve.json's size: online == offline, 373 accepted;
    the ("GRMU", "FF") ladder at slo_s=0 degrades once and ends on FF.
    (c) Checkpoint at half the full-scale GRMU stream, restore into a
    fresh service: the decisions equal the uninterrupted stream's.
    (d) The ("ILP", "GRMU", "FF") ladder on the small stream: card ==
    CPU.  (e) The sweep at full scale equals ``SWEEP_ACCEPTED``.  Returns
    the pick kernels' launches over the five timed streams."""
    import gc
    import tempfile
    import warnings
    from repro_torch.core import batched as B
    from repro_torch.core.bucketing import pad_events
    from repro_torch.kernels import mask_scores as K
    from repro_torch.serve import (PlacementService, ServeConfig,
                                   requests_from_trace)
    from repro_torch.workload.alibaba import TraceConfig, generate
    from repro_torch.workload.flashcrowd import (FlashCrowdConfig,
                                                 generate_flash_crowd)
    from repro_torch.workload.synthetic import (SyntheticConfig,
                                                generate_events)
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    reqs, horizon = requests_from_trace(events)
    n_arr = sum(type(r).__name__ == "Arrival" for r in reqs)
    if (len(reqs), n_arr) != (SERVE_REQUESTS, SERVE_ARRIVALS):
        raise AssertionError(f"{len(reqs)} requests, {n_arr} arrivals")
    configs = tables_configs(B)

    def service(name, kw):
        return PlacementService.for_trace(
            events, ServeConfig(policy=name, micro_batch=SERVE_BATCH, **kw),
            device="cuda")

    # (a) The first pass captures every graph the streams need.
    for name, _, kw in configs:
        serve_stream(service(name, kw), reqs, horizon)
    torch.cuda.synchronize()
    gc.collect()
    mem = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    rows, totals, ref = [], {}, None
    for name, pol, kw in configs:
        K.reset_launches()
        t0 = time.perf_counter()
        svc = serve_stream(service(name, kw), reqs, horizon)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        for k, c in launches.items():
            totals[k] = totals.get(k, 0) + c
        pick = {"MCC": "mcc_pick", "MECC": "ecc_pick"}.get(name)
        if launches != {k: n_arr if k == pick else 0 for k in launches}:
            raise AssertionError(f"service {name}: mask kernels launched "
                                 f"{launches}")
        if result_digest(service_result(B, svc, events, pol)) \
                != DIGESTS[name]:
            raise AssertionError(f"service {name}: digest differs from the "
                                 "JAX reference")
        runner = svc.runner
        if not (runner.graphed and runner.graphs):
            raise AssertionError(f"service {name}: the runner holds no "
                                 "graph")
        st = svc.stats()
        rows.append({
            "phase": "6 service", "policy": name,
            "micro_batch": SERVE_BATCH, "requests": len(reqs),
            "arrivals": st["decisions"], "accepted": st["accepted"],
            "wall_s": wall, "arrivals_per_s": st["decisions"] / wall,
            "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
            "queue_high_watermark": st["queue_high_watermark"],
            "batches": svc.batches, "graphs": len(runner.graphs),
            "expiry_width": runner.step.width,
            "capture_s": runner.capture_s, "launches": launches,
            "digest_matches_jax": True})
        if name == "GRMU":
            ref = (decisions_of(svc), svc.accepted_ids(), svc.migrations())
        del svc, runner
    gc.collect()
    flat = mem == (torch.cuda.memory_allocated(),
                   torch.cuda.memory_reserved())
    for row, (name, _, kw) in zip(rows, configs):
        row["profile"] = profile_service(torch, service(name, kw), reqs)
    if not flat:
        raise AssertionError("device memory moved across the five service "
                             "streams")
    # Host synchronisations, a third stream each in sync debug mode.
    trace = B.trace_from_numpy(B.trace_arrays(events), "cpu")
    for row, (name, pol, kw) in zip(rows, configs):
        st = B.replay_statics(events, pol, **kw)
        n_cons = B.plan_events(st, trace, last_cons=0.0).keys.count(
            (B.STEP_END, True))
        svc = service(name, kw)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                serve_stream(svc, reqs, horizon)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message)
                    for w in seen)
        if syncs > svc.batches + n_cons or not syncs:
            raise AssertionError(f"service {name}: {syncs} host "
                                 f"synchronisations in {svc.batches} "
                                 f"batches, {n_cons} consolidating "
                                 "step-ends")
        row.update(host_syncs=syncs, consolidating_step_ends=n_cons,
                   memory_flat=flat)
        print(json.dumps(row), flush=True)

    # (b) The flash crowd at BENCH_serve.json's size.
    fc = generate_flash_crowd(FlashCrowdConfig(**FLASH_CFG))
    freqs, fh = requests_from_trace(fc)
    svc = serve_stream(PlacementService.for_trace(
        fc, ServeConfig(policy="GRMU", micro_batch=SERVE_BATCH),
        device="cuda"), freqs, fh)
    off = B.replay(pad_events(fc), B.GRMU, device="cuda")
    ladder = serve_stream(PlacementService.for_trace(
        fc, ServeConfig(policy="GRMU", tiers=("GRMU", "FF"),
                        micro_batch=SERVE_BATCH, slo_s=0.0),
        device="cuda"), freqs, fh)
    switches = [e["event"] for e in ladder.switch_events]
    if (svc.accepted_ids() != off.accepted_ids
            or svc.stats()["accepted"] != FLASH_ACCEPTED
            or switches != ["degrade"] or ladder.tier_name != "FF"):
        raise AssertionError(f"flash crowd: online {svc.stats()['accepted']}"
                             f", offline {off.accepted}, ladder {switches} "
                             f"ending on {ladder.tier_name}")
    print(json.dumps({
        "phase": "6 flash crowd", **FLASH_CFG, "requests": len(freqs),
        "accepted_online": svc.stats()["accepted"],
        "accepted_offline": off.accepted, "decisions_match": True,
        "p50_ms": svc.stats()["p50_ms"], "p99_ms": svc.stats()["p99_ms"],
        "ladder_switches": switches, "ladder_final_tier": ladder.tier_name,
        "ladder_occupancy": ladder.tier_occupancy}), flush=True)

    # (c) Checkpoint at half the full-scale GRMU stream, restore.
    half = len(reqs) // 2
    with tempfile.TemporaryDirectory() as tmp:
        a = service("GRMU", GRMU_FULL)
        for r in reqs[:half]:
            while not a.submit(r):
                a.drain(max_batches=1)
        a.drain()
        a.checkpoint(tmp)
        b = service("GRMU", GRMU_FULL)
        if not b.restore(tmp):
            raise AssertionError("no checkpoint to restore")
        for r in reqs[half:]:
            while not b.submit(r):
                b.drain(max_batches=1)
        b.drain()
        b.flush(horizon)
    got, (want, want_ids, want_mig) = decisions_of(b), ref
    if (b.accepted_ids() != want_ids or b.migrations() != want_mig
            or got != {v: want[v] for v in got}):
        raise AssertionError("restored GRMU service differs from the "
                             "uninterrupted stream")
    print(f"phase 6: GRMU checkpointed at request {half} of {len(reqs)}, "
          f"restored: {len(got)} later decisions and migrations "
          f"{b.migrations()} equal the uninterrupted stream's", flush=True)

    # (d) The ILP -> GRMU -> FF ladder, card == CPU.
    small = generate_events(SyntheticConfig(**SERVE_SMALL))
    sreqs, sh = requests_from_trace(small)
    runs = {dev: serve_stream(PlacementService.for_trace(
        small, ServeConfig(**ILP_LADDER), device=dev), sreqs, sh)
        for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    if (decisions_of(card) != decisions_of(cpu)
            or card.migrations() != cpu.migrations()
            or [e["to"] for e in card.switch_events] != ["GRMU", "FF"]):
        raise AssertionError("ILP ladder: card != CPU")
    print(f"phase 6: ({', '.join(ILP_LADDER['tiers'])}) ladder at slo_s=0: "
          f"card == CPU, occupancy {card.tier_occupancy}", flush=True)

    # (e) The heavy-capacity sweep at full scale.
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        got = B.sweep_heavy_capacity(events, SWEEP_FRACS, device="cuda")
        seconds.append(time.perf_counter() - t0)
        if got.tolist() != SWEEP_ACCEPTED:
            raise AssertionError(f"sweep: {got.tolist()}")
    print(json.dumps({
        "phase": "6 sweep", "fracs": SWEEP_FRACS,
        "accepted_totals": got.sum(axis=1).tolist(),
        "first_s": seconds[0], "s_per_capacity": seconds[1] / len(
            SWEEP_FRACS), "equals_jax": True}), flush=True)
    return totals


# ---------------------------------------------------------------------------
# Phase 2b: the attention kernel
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, hd, causal, window)
ATTN_CASES = {
    "tinyllama": (2, 1024, 1024, 32, 4, 64, True, None),
    "hd128_gqa4": (1, 512, 512, 32, 8, 128, True, None),
    "mha": (1, 256, 256, 8, 8, 64, True, None),
    "mqa": (1, 256, 256, 8, 1, 64, True, None),
    "hd32": (2, 256, 256, 4, 4, 32, True, None),
    "noncausal": (1, 256, 768, 8, 2, 64, False, None),
    "noncausal_ragged": (1, 200, 333, 8, 2, 64, False, None),
    "window96": (1, 512, 512, 8, 2, 64, True, 96),
    "ragged1000": (2, 1000, 1000, 32, 4, 64, True, None),
    "request_prefill": (N_REQ, PROMPT, PROMPT, 32, 4, 64, True, None),
    # The zoo's other head dims: the smoke configs' heads (hd 16),
    # StableLM-3B's (hd 80, ragged), Zamba2-7B's shared attention (hd 112,
    # window over ragged tiles).
    "smoke_hd16": (2, 256, 256, 4, 2, 16, True, None),
    "stablelm_hd80": (1, 1000, 1000, 32, 32, 80, True, None),
    "zamba2_hd112_window300": (1, 1000, 1000, 32, 32, 112, True, 300),
}
# float32 only: one row's softmax over 256 key tiles, where a tensor-core
# sum carried across tiles would drift (the kernel merges per tile).
F32_ATTN_CASES = {
    "long_noncausal": (1, 1024, 16384, 8, 2, 64, False, None),
}
# Both dtypes at the (q/k, v) head-dim pairs (``HEAD_DIM_PAIRS``): MLA's
# heads over ragged tiles, causal, and non-causal with Sq != Sk and GQA.
PAIR_ATTN_CASES = {
    "mla_ragged1000": (1, 1000, 1000, 16, 16, (192, 128), True, None),
    "mla_noncausal_ragged": (1, 200, 333, 8, 2, (192, 128), False, None),
}


def attention_head_dims(cfg):
    """The head dim a model's prefill attention runs at: the config's, or
    MLA's (nope + rope, v) pair."""
    if cfg.mla is None:
        return cfg.resolved_head_dim
    m = cfg.mla
    return (m.nope_head_dim + m.rope_head_dim, m.v_head_dim)


def plain_chunk(n) -> int:
    """The plain version's chunk for a length n: the largest divisor of n
    up to its default 1024 (it needs Sq and Sk to be multiples of their
    chunks; Whisper's 1,500 frames take 750, 448 tokens 448)."""
    return max(c for c in range(1, min(n, 1024) + 1) if n % c == 0)


def plain_attention(q, k, v, causal=True, window=None):
    """``ref.flash_attention_ref`` with ``plain_chunk``s: the default
    chunks at every length that is at most 1024 or a multiple of it."""
    from repro_torch.kernels import ref
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_chunk=plain_chunk(q.shape[1]),
                                   k_chunk=plain_chunk(k.shape[1]))


def _qkv(torch, B, Sq, Sk, H, KV, hd, dtype, seed=0):
    """Random q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hd_v) on
    the card; ``hd`` an int or a (q/k, v) pair."""
    hd, hd_v = head_dims_of(hd)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd),
                          (B, Sk, KV, hd_v))]


def hold_attention(torch, name, got, q, k, v, causal, window, err):
    """Hold one kernel output against the plain version on the same inputs:
    within ATTN_TOL in q's dtype, and for bf16 also within half an ulp of
    the plain version in float32.  Folds the max abs differences (and, for
    bf16, the largest error in half-ulps) into ``err``."""
    want = plain_attention(q, k, v, causal=causal, window=window)
    tname = str(q.dtype).split(".")[-1]
    diff = (got.float() - want.float()).abs().max().item()
    err[tname] = max(err.get(tname, 0.0), diff)
    tol = ATTN_TOL[tname]
    if got.dtype != q.dtype or not torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"attention {name} {tname}: kernel != plain "
                             f"version (max abs diff {diff})")
    if q.dtype == torch.bfloat16:
        want32 = plain_attention(q.float(), k.float(), v.float(),
                                 causal=causal, window=window)
        ulps = ((got.float() - want32).abs()
                / (BF16_HALF_ULP * want32.abs() + F32_ATOL)).max().item()
        err["bf16_half_ulps"] = max(err.get("bf16_half_ulps", 0.0), ulps)
        if not ulps <= 1.0:
            raise AssertionError(
                f"attention {name} bf16: kernel is {ulps:.3f} half-ulps "
                f"from the plain version in float32 (limit 1)")


def launch_counts(FA, **counts):
    """Every ``FA.LAUNCHES`` key at 0 but ``counts``: the launches a path
    must make and no other (the backward's keys included)."""
    assert set(counts) <= set(FA.LAUNCHES), counts
    return {n: counts.get(n, 0) for n in FA.LAUNCHES}


def route_launches(FA, dtype):
    """The launches one wrapper call of ``dtype`` makes: its attention
    kernel once, and for float32 the split of q, k and v."""
    import torch
    key = FA.ROUTES[dtype][1]
    want = {n: int(n == key) for n in FA.LAUNCHES}
    if dtype == torch.float32:
        want[FA.SPLIT] = 3
    return want


def attention_on_its_route(torch, q, k, v, causal=True, window=None):
    """One wrapper call, checked to launch its dtype's kernels once
    (``route_launches``) and the other dtype's not at all."""
    from repro_torch.kernels import flash_attention as FA
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    moved = {n: FA.LAUNCHES[n] - before[n] for n in FA.LAUNCHES}
    if moved != route_launches(FA, q.dtype):
        raise AssertionError(f"{q.dtype} attention launched {moved}, "
                             f"expected {route_launches(FA, q.dtype)}")
    return got


def split_inputs(torch, n, seed):
    """float32 inputs of the split, length ``n``: normal values; tiny ones
    (1e-36 scale, mid and lo subnormal); zeros of both signs; values over
    float32's finite range (e^-87 to e^87)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda")
    zero = torch.zeros(n, device="cuda")
    zero[::3] = -0.0
    wide = torch.exp(torch.rand(n, generator=g, device="cuda") * 174 - 87)
    return {"normal": x, "tiny": x * 1e-36, "zero": zero,
            "wide": wide * x.sign()}


def check_split(torch):
    """Phase 2b: the split kernel equals ref.split_bf16x3 bit for bit on
    ``split_inputs`` at the prefill's k/v length, a ragged length and two
    elements, and on the view that drops the first element (unaligned,
    copied by the wrapper).  The six lengths leave every tail of 0 to 3
    elements past the kernel's four-element groups.  Returns the largest
    absolute difference seen (0 unless it raised)."""
    from repro_torch.kernels import flash_attention as FA, ref
    n_checked, diff = 0, 0.0
    for n in (PREFILL_B * PREFILL_S * 4 * 64, 1001, 2):
        for kind, x in split_inputs(torch, n, seed=n).items():
            for where, t in ((kind, x), (f"{kind} unaligned", x[1:])):
                got = FA.split_bf16x3(t)
                want = torch.stack(ref.split_bf16x3(t))
                diff = max(diff, (got.double() - want.double()).abs()
                           .nan_to_num(nan=math.inf).max().item())
                if not torch.equal(got.view(torch.int16),
                                   want.view(torch.int16)):
                    raise AssertionError(f"split_bf16x3 kernel != plain "
                                         f"version on {where} n {n}")
                n_checked += 1
    torch.cuda.synchronize()
    print(f"phase 2b: split kernel == plain version bit for bit in "
          f"{n_checked} comparisons", flush=True)
    return diff


def check_attention(torch):
    """Phase 2b: each kernel equals flash_attention_ref on the card at
    every case, bf16 through the tensor-core kernel and float32 through the
    split and its kernel (``hold_attention``); the split kernel equals its
    plain version bit for bit (``check_split``)."""
    err = {"split": check_split(torch)}
    cases = [(name, c, dtype)
             for name, c in (*ATTN_CASES.items(), *PAIR_ATTN_CASES.items())
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(name, c, torch.float32) for name, c in F32_ATTN_CASES.items()]
    for name, (B, Sq, Sk, H, KV, hd, causal, window), dtype in cases:
        q, k, v = _qkv(torch, B, Sq, Sk, H, KV, hd, dtype)
        got = attention_on_its_route(torch, q, k, v, causal, window)
        hold_attention(torch, name, got, q, k, v, causal, window, err)
    torch.cuda.synchronize()
    print(f"phase 2b: attention kernels == plain version at "
          f"{len(ATTN_CASES)} shapes and {len(PAIR_ATTN_CASES)} at head-dim "
          f"pairs x 2 dtypes and {len(F32_ATTN_CASES)} float32 one(s); max "
          f"abs diff {err}", flush=True)
    return err


def event_ms(torch, fn, iters):
    """Device milliseconds per call: ``iters`` eager calls between two CUDA
    events after a warm-up (for calls of a millisecond or more, where
    launch cost is noise)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def split_bound_ms(n):
    """The split's bytes floor: each float32 element read once (4 bytes)
    and its three bf16 planes written once (6)."""
    return 10 * n / PEAK_BYTES_PER_S * 1e3, "bytes"


def time_attention(torch, err):
    """Phase 2b at the slice's prefill shape, in bf16 (the tensor-core
    kernel) and in float32 (the split and the float32 kernel): each kernel
    held against its plain version (``hold_attention``, folded into
    ``err``), then timed beside the plain version and
    scaled_dot_product_attention (the yardstick; the port never calls it).
    In float32 the kernel and the plain version are also held against the
    float64 function, the kernel within ATTN_TOL, and the split of q is
    timed beside its plain version.  Returns {dtype name or "split":
    timings}."""
    from repro_torch.kernels import flash_attention as FA, ref
    cfg = _tinyllama()
    B, S, H, KV = PREFILL_B, PREFILL_S, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        q, k, v = _qkv(torch, B, S, S, H, KV, hd, dtype, seed=1)
        got = attention_on_its_route(torch, q, k, v)
        hold_attention(torch, "prefill", got, q, k, v, True, None, err)
        torch.cuda.synchronize()
        print(f"phase 2b: attention kernel == plain version at B {B} S {S} "
              f"{tname}; max abs diff {err}", flush=True)
        vs_f64 = None
        if dtype == torch.float32:
            vs_f64 = f32_vs_f64(torch, got, q, k, v, f"B {B} S {S}")
            s_ms, s_by = split_bound_ms(q.numel())
            out["split"] = dict(
                ms=event_ms(torch, lambda: FA.split_bf16x3(q), 20),
                plain_ms=event_ms(torch, lambda: torch.stack(
                    ref.split_bf16x3(q)), 5),
                bound_ms=s_ms, bound_by=s_by, library_ms=None,
                shape=dict(n=q.numel(), what="q at the prefill shape"))
            print(f"phase 2b: split of q ({q.numel()} float32): "
                  f"{out['split']['ms']:.4f} ms, plain "
                  f"{out['split']['plain_ms']:.4f} ms, bound {s_ms:.4f} ms "
                  f"({s_by})", flush=True)
        del got
        t = out[tname] = attention_timings(torch, q, k, v, plain_iters=3)
        t["max_abs_err_vs_f64"] = vs_f64
        print(f"phase 2b: attention at B {B} S {S} H {H} KV {KV} hd {hd} "
              f"{tname} causal: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
        del q, k, v
    return out


def f32_vs_f64(torch, got, q, k, v, where):
    """Causal float32 attention: the kernel's output ``got`` and the plain
    version, each held against the float64 function; the kernel must be
    within ATTN_TOL.  Returns {kernel, plain: max abs error}."""
    from repro_torch.kernels import ref
    truth = attention_f64(q, k, v)
    vs_f64 = {name: (x.double() - truth).abs().max().item()
              for name, x in (("kernel", got), (
                  "plain", ref.flash_attention_ref(q, k, v)))}
    del truth
    print(f"phase 2b: float32 at {where}, max abs error against float64: "
          f"kernel {vs_f64['kernel']:.3g}, plain version "
          f"{vs_f64['plain']:.3g}", flush=True)
    if not vs_f64["kernel"] <= ATTN_TOL["float32"]:
        raise AssertionError(f"float32 attention kernel at {where} is "
                             f"{vs_f64['kernel']} from float64 (limit "
                             f"{ATTN_TOL['float32']})")
    return vs_f64


def attention_timings(torch, q, k, v, plain_iters, causal=True,
                      window=None):
    """Attention on q, k, v: ms per call of the kernel's wrapper, of the
    plain version and of scaled_dot_product_attention (the yardstick; the
    port never calls it; with a window, which it has no argument for, over
    a boolean band mask, ``band_mask``; at unequal q/k and v widths
    without ``enable_gqa``, which only the backends that refuse them
    take), CUDA events after a warm-up, with the bound (the pairs the
    mask keeps: ``attention_pairs``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    B, S, H, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
    tname = str(q.dtype).split(".")[-1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b_ms, b_by = attention_bound_ms(B, S, Sk, H, KV, (hd, hd_v), causal,
                                    window, tname)
    shape = dict(B=B, S=S, H=H, KV=KV, hd=hd, dtype=tname, causal=causal)
    gqa = dict(enable_gqa=True)
    if hd_v != hd:
        shape["hd_v"] = hd_v
        gqa = {}
    if Sk != S:
        shape["Sk"] = Sk
    if window:
        shape["window"] = window
        mask = band_mask(torch, S, Sk, window, q.device)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, **gqa)
    else:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, **gqa)
    return dict(
        ms=event_ms(torch, lambda: FA.flash_attention(
            q, k, v, causal=causal, window=window), 10),
        plain_ms=event_ms(torch, lambda: plain_attention(q, k, v, causal,
                                                         window),
                          plain_iters),
        library_ms=event_ms(torch, library, 10),
        bound_ms=b_ms, bound_by=b_by, shape=shape)


def band_mask(torch, Sq, Sk, window, device):
    """The causal sliding window as a boolean (Sq, Sk) mask, True where a
    query sees a key: kpos <= qpos and kpos > qpos - window."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    return (kpos <= qpos) & (kpos > qpos - window)


def prefill_shape(cfg):
    """(B, S) of a model's prefill on the card: PREFILL_B x PREFILL_S; for
    a model with a sliding window, S twice the window at the same tokens
    per call (a window as long as S would mask nothing)."""
    if not cfg.sliding_window:
        return PREFILL_B, PREFILL_S
    S = 2 * cfg.sliding_window
    return PREFILL_B * PREFILL_S // S, S


def attention_calls(cfg):
    """Attention calls (kernel launches on the card) per forward pass: one
    per layer; the hybrid's shared block once per group; none for RWKV."""
    if cfg.family == "rwkv6":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_period
    return cfg.n_layers


def zoo_attention_shape(cfg):
    """(B, S, H, KV, hd) of a model's prefill attention at its prefill
    shape (``prefill_shape``); hd MLA's (q/k, v) pair for DeepSeek-V2
    (``attention_head_dims``)."""
    return (*prefill_shape(cfg), cfg.n_heads, cfg.n_kv_heads,
            attention_head_dims(cfg))


def time_zoo_attention(torch, err):
    """Phase 2b at each phase 5c model's prefill shape (B 4, S 4096, its
    heads), at phase 5d's attention shapes (``MODEL_ATTN_SHAPES``) and at
    Zamba2-7B's windowed prefill shape (B 2, S 8,192, H 32 / KV 32, hd 112,
    window 4,096), bf16: the kernel held against the plain version
    (``hold_attention``, folded into ``err``), then ``attention_timings``.
    Then the float32 prefill shape (F32_PREFILL_B x PREFILL_S) of ZOO_F32
    and of DeepSeek-V2 (H 128, q/k 192 against v 128: the float32 route at
    the pair): the float32 kernel held against the plain version within
    ATTN_TOL and against the float64 function (``f32_vs_f64``), and timed.
    Returns ({arch or MODEL_ATTN_SHAPES name: bf16 timings}, {ZOO_F32 or
    DSV2: float32 timings})."""
    from repro_torch.configs import get_config
    out = {}
    for arch in ZOO + (ZAMBA2,):
        cfg = get_config(arch)
        B, S, H, KV, hd = zoo_attention_shape(cfg)
        window = cfg.sliding_window
        q, k, v = _qkv(torch, B, S, S, H, KV, hd, torch.bfloat16, seed=2)
        got = attention_on_its_route(torch, q, k, v, window=window)
        hold_attention(torch, f"{arch} prefill", got, q, k, v, True, window,
                       err)
        del got
        t = out[arch] = attention_timings(torch, q, k, v, plain_iters=2,
                                          window=window)
        print(f"phase 2b: attention at {arch}'s prefill shape B {B} S {S} "
              f"H {H} KV {KV} hd {hd} window {window} bfloat16 causal: "
              f"kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); max abs diff {err}", flush=True)
        del q, k, v
    for name, (B, Sq, Sk, H, KV, hd, causal) in MODEL_ATTN_SHAPES.items():
        q, k, v = _qkv(torch, B, Sq, Sk, H, KV, hd, torch.bfloat16, seed=4)
        got = attention_on_its_route(torch, q, k, v, causal)
        hold_attention(torch, name, got, q, k, v, causal, None, err)
        del got
        t = out[name] = attention_timings(torch, q, k, v, plain_iters=2,
                                          causal=causal)
        print(f"phase 2b: attention at {name} B {B} Sq {Sq} Sk {Sk} H {H} "
              f"KV {KV} hd {hd} bfloat16 {'causal' if causal else 'non-causal'}"
              f": kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"SDPA {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); max abs diff {err}", flush=True)
        del q, k, v
    f32 = {}
    for arch in (ZOO_F32, DSV2):
        _, S, H, KV, hd = zoo_attention_shape(get_config(arch))
        B = F32_PREFILL_B
        q, k, v = _qkv(torch, B, S, S, H, KV, hd, torch.float32, seed=3)
        got = attention_on_its_route(torch, q, k, v)
        where = f"{arch}'s float32 prefill shape B {B} S {S} H {H} KV " \
                f"{KV} hd {hd}"
        hold_attention(torch, where, got, q, k, v, True, None, err)
        vs_f64 = f32_vs_f64(torch, got, q, k, v, where)
        del got
        t = f32[arch] = attention_timings(torch, q, k, v, plain_iters=2)
        t["max_abs_err_vs_f64"] = vs_f64
        print(f"phase 2b: attention at {where} float32 causal: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); max abs diff {err}", flush=True)
        del q, k, v
    return out, f32


# ---------------------------------------------------------------------------
# Phase 5: the serving path
# ---------------------------------------------------------------------------

def _tinyllama():
    from repro_torch.configs import get_config
    return get_config(ARCH)


def _rel_errors(torch, got, want):
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm()).item()
    elem = ((got - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()
    return rel, elem


class attention_as:
    """Within the block, the model's prefill attention calls ``fn`` (the
    plain version, to hold the kernel's prefill against it, or another
    function to compare with); restored on exit."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.models import layers as L
        self._saved = L.flash_attention
        L.flash_attention = self.fn
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.flash_attention = self._saved
        return False


def device_ops(torch, run, n_top=10):
    """torch.profiler over ``run()``: its device events' µs by kernel-name
    part (``us(part)``), the total device µs, and the ``n_top`` device
    operations that took the most time: [name, count, µs]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in dev)
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(([name[:120], n, t] for name, (n, t) in by_name.items()),
                 key=lambda r: r[2], reverse=True)[:n_top]

    def us(part):
        return sum(t for name, (_, t) in by_name.items() if part in name)
    return us, total, top


def prefill_attention_share(torch, step, model, batch, n_top=10):
    """The attention kernel's (``fa_fwd_wgmma``, either dtype) share of one
    prefill's device time, from torch.profiler (None when the trace holds
    no device events), the total device µs, and the ``n_top`` device
    operations that took the most time: [name, count, µs]."""
    us, total, top = device_ops(torch, lambda: step(model, batch), n_top)
    return (us("fa_fwd_wgmma") / total if total else None), total, top


def profile_decode(torch, fn, n=4):
    """torch.profiler over ``n`` decode steps: the device's busy share of
    the wall time, device ms per step, and the host operations that cost
    the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    top = sorted((a for a in prof.key_averages()
                  if a.key.startswith("aten::")),
                 key=lambda a: a.self_cpu_time_total, reverse=True)[:6]
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "device_busy_share": dev_us / wall_us if dev else None,
            "device_ms_per_step": dev_us / n / 1e3 if dev else None,
            "device_ops_per_step": len(dev) / n,
            "top_host_ops": [[a.key, a.count, a.self_cpu_time_total]
                             for a in top]}


def check_card_vs_cpu_prefill(torch):
    """A 2-layer float32 model at TinyLlama's head dim: prefill on the card
    (the kernel) equals prefill on the CPU (the plain version, which the
    CPU tests hold against the JAX package)."""
    from repro_torch.models import transformer as M
    from repro_torch.serve import llm_decode as D
    cfg = _tinyllama().scaled(n_layers=2, d_model=512, n_heads=8,
                              n_kv_heads=1, d_ff=1024, vocab=512)
    # A CPU generator draws the same weights for either device.
    cpu, card = (M.init_params(cfg, torch.Generator().manual_seed(3),
                               torch.float32, device=dev)
                 for dev in ("cpu", "cuda"))
    tokens = torch.randint(0, cfg.vocab, (2, 256),
                           generator=torch.Generator().manual_seed(4))
    got = D.prefill(card, tokens.cuda(), cfg, 256).cpu()
    want = D.prefill(cpu, tokens, cfg, 256)
    rel, elem = _rel_errors(torch, got, want)
    if not rel <= 1e-4 or not elem <= 1e-3:
        raise AssertionError(f"2-layer float32 prefill card != CPU "
                             f"(relative L2 {rel}, max {elem})")
    print(f"phase 5: 2-layer float32 prefill, card == CPU (relative L2 "
          f"{rel:.3g}, max {elem:.3g})", flush=True)


def run_f32_prefill(torch, cfg=None):
    """Phase 5, the float32 attention route's path: ``cfg`` (None:
    TinyLlama-1.1B; phase 5c: StableLM-3B) at full width in float32
    (random weights from a seeded generator), prefill of F32_PREFILL_B x
    PREFILL_S tokens through registry.make_step.  Launch counts are read
    over the timed calls alone: per call one float32 kernel launch and
    three splits per layer, no bf16 launch.  Reports wall time, the
    kernel's share of device time and the logits against the same prefill
    with the plain attention.  Returns (launches, result)."""
    from repro_torch.kernels import flash_attention as FA, ref
    from repro_torch.models import registry
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    cfg = cfg or _tinyllama()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = M.init_params(cfg, gen, torch.float32)
    prefill = registry.make_step(cfg, ShapeConfig(
        "prefill_4k_f32", PREFILL_S, F32_PREFILL_B, "prefill"))
    batch = {"tokens": torch.randint(0, cfg.vocab, (F32_PREFILL_B, PREFILL_S),
                                     generator=gen, device="cuda")}
    prefill(model, batch)                                # warm-up
    torch.cuda.synchronize()

    FA.reset_launches()
    n_calls = 2
    t0 = time.perf_counter()
    for _ in range(n_calls):
        logits = prefill(model, batch)
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t0) / n_calls
    launches = dict(FA.LAUNCHES)
    want = launch_counts(FA, flash_attention_f32=n_calls * cfg.n_layers,
                         split_bf16x3=3 * n_calls * cfg.n_layers)
    if launches != want:
        raise AssertionError(f"float32 prefill launched {launches}, "
                             f"expected {want}")
    shape = (F32_PREFILL_B, 1, cfg.vocab)
    if (logits.dtype != torch.float32 or tuple(logits.shape) != shape
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"float32 prefill logits: {logits.dtype} "
                             f"{tuple(logits.shape)}, want float32 {shape}, "
                             f"finite")
    with attention_as(ref.flash_attention_ref):
        plain = prefill(model, batch)
    if not torch.isfinite(plain).all():
        raise AssertionError("float32 prefill with plain attention: logits "
                             "not finite")
    rel, elem = _rel_errors(torch, logits, plain)
    result = {"model": cfg.name, "batch": F32_PREFILL_B, "seq": PREFILL_S,
              "dtype": "float32", "layers": cfg.n_layers, "wall_s": wall_s,
              "tokens_per_s": F32_PREFILL_B * PREFILL_S / wall_s,
              **device_profile(torch, f"{cfg.name}'s float32 prefill",
                               prefill, model, batch),
              "launches_per_call": {k: n // n_calls
                                    for k, n in launches.items()},
              "vs_plain_attention": {"relative_l2": rel,
                                     "max_over_scale": elem}}
    print(json.dumps({"f32_prefill": result}), flush=True)
    del model
    torch.cuda.empty_cache()
    return launches, result


def device_profile(torch, what, step, model, batch):
    """``prefill_attention_share`` of one ``step(model, batch)`` as a
    result's fields; fails where the profiler saw no device time."""
    share, dev_us, top = prefill_attention_share(torch, step, model, batch)
    if share is None:
        raise AssertionError(f"the profiler saw no device time in {what}")
    return {"device_ms": dev_us / 1e3,
            "attention_share_of_device_time": share, "top_device_ops": top}


def init_on_card(torch, cfg, what, dtype=None):
    """A model at full width in ``dtype`` (default bf16) for phases 5-5g:
    the allocator's cache emptied and its peak reset, then random weights
    drawn on the card from a generator seeded 0.  Returns (model, the
    generator, seconds)."""
    from repro_torch.models import registry
    from repro_torch.models import transformer as M
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    dtype = dtype or torch.bfloat16
    model = M.init_params(cfg, rng, dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"{what}: {cfg.name} ({registry.total_param_count(cfg)} "
          f"parameters, {str(dtype).split('.')[-1]}) initialized on the "
          f"card in {init_s:.2f} s", flush=True)
    return model, rng, init_s


def prefill_step(torch, cfg):
    """The prefill cell at ``prefill_shape(cfg)`` (B x S) through
    registry.make_step: (inputs(gen) -> a batch of tokens, or of bf16
    frames for an encoder-decoder; run(model, batch) -> the last position's
    logits)."""
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    B, S = prefill_shape(cfg)
    run = registry.make_step(cfg, ShapeConfig(f"prefill_{S}", S, B,
                                              "prefill"))

    def inputs(gen):
        if cfg.family == "encdec":
            return {"frames": torch.randn(
                (B, S, cfg.d_model), generator=gen,
                device="cuda").to(torch.bfloat16)}
        return {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                        device="cuda")}
    return inputs, run


def recording_attention(calls):
    """The kernel's wrapper, appending each call's (causal, Sq, Sk, window)
    to ``calls``."""
    from repro_torch.kernels import flash_attention as FA

    def attend(q, k, v, causal=True, window=None):
        calls.append((causal, q.shape[1], k.shape[1], window))
        return FA.flash_attention(q, k, v, causal=causal, window=window)
    return attend


class ServedPath:
    """A model's path on the card in named parts: ``path(name, fn)`` runs
    fn() with the model's attention recording each call
    (``recording_attention``) and keeps, under the part's name, the calls,
    the launches by kernel and the wall seconds."""

    def __init__(self, torch):
        self.torch = torch
        self.calls, self.launches, self.wall = {}, {}, {}

    def __call__(self, name, fn):
        from repro_torch.kernels import flash_attention as FA
        calls = self.calls[name] = []
        before = dict(FA.LAUNCHES)
        with attention_as(recording_attention(calls)):
            t0 = time.perf_counter()
            out = fn()
            self.torch.cuda.synchronize()
            self.wall[name] = time.perf_counter() - t0
        self.launches[name] = {n: FA.LAUNCHES[n] - before[n]
                               for n in FA.LAUNCHES}
        return out

    def expect(self, cfg, want):
        """Each part made exactly the attention calls ``want[part]``, each
        one launch of the bf16 kernel, and no launch on another route."""
        from repro_torch.kernels import flash_attention as FA
        for name, calls in want.items():
            bf16 = launch_counts(FA, flash_attention=len(calls))
            got = self.calls[name]
            if got != calls or self.launches[name] != bf16:
                raise AssertionError(
                    f"{cfg.name} {name}: attention calls {got[:4]}... "
                    f"({len(got)}), launches {self.launches[name]}; "
                    f"expected {calls[:2]}... ({len(calls)}), {bf16}")


def decoder(torch, decode, model, cache):
    """Decoding through make_step's ``decode`` on ``cache`` (filled in
    place, or its entries replaced): step(tokens (B, 1), t) -> the logits
    (B, 1, V) at position t; generate(logits, t, n) -> the last logits of n
    greedy steps from position t on, the first fed with ``logits``'
    argmax.  Every family's cache holds the batch at dim 1."""
    B = next(iter(cache.values())).shape[1]

    def step(tokens, t):
        return decode(model, {"cache": cache, "tokens": tokens, "pos":
                              torch.full((B,), t, dtype=torch.int32,
                                         device="cuda")})[0]

    def generate(logits, t, n):
        for i in range(n):
            logits = step(logits.argmax(-1), t + i)
        return logits
    return step, generate


def check_logits(torch, cfg, outputs):
    """Each (name, logits, shape) of ``outputs`` has that shape and is
    finite."""
    for name, x, shape in outputs:
        if tuple(x.shape) != shape or not torch.isfinite(x.float()).all():
            raise AssertionError(f"{cfg.name} {name} logits: shape "
                                 f"{tuple(x.shape)}, want {shape}, or not "
                                 f"finite")


def hold_teacher_forced(torch, cfg, what, got, want, gate=True):
    """Teacher-forced decode logits ``got`` within 0.15 (the JAX package's
    bound) of ``want``, the same positions' logits from one pass over the
    whole sequence; with ``gate`` False the figures are only reported.
    Returns the errors, whether they are within 0.15 and the argmax
    agreement."""
    rel, elem = _rel_errors(torch, got, want)
    within = torch.allclose(got.float(), want.float(), rtol=0.15, atol=0.15)
    if gate and not within:
        raise AssertionError(
            f"{cfg.name} {what}: teacher-forced decode logits differ beyond "
            f"0.15 from one pass's (relative L2 {rel}, max {elem})")
    return {"relative_l2": rel, "max_over_scale": elem, "within_0.15": within,
            "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float()
            .mean().item()}


def hold_vs_plain(torch, cfg, what, errors, step=None):
    """Logits, kernel vs the plain attention (``_rel_errors``), within
    PREFILL_TOL.  Where they are not and ``step`` is given (a model of 30
    or more layers, or Whisper's decoder: rounding amplified through the
    peaked layers, phase 5b), the kernel must instead be no further from
    float64 attention than the plain version on ACCURACY_SEEDS
    (``prefill_logits_vs_f64`` on ``step``, ``logits_ratio_gate``): call
    it with the served model freed, as that draws a model for each seed.
    Returns the comparison for the result."""
    rel, elem = errors
    out = {"relative_l2": rel, "max_over_scale": elem}
    if rel <= PREFILL_TOL[0] and elem <= PREFILL_TOL[1]:
        return out
    if step is None:
        raise AssertionError(f"{cfg.name} {what}: logits, kernel vs plain "
                             f"attention: relative L2 {rel} max {elem}, "
                             f"tolerance {PREFILL_TOL}")
    rows = out["logits_vs_f64"] = prefill_logits_vs_f64(
        torch, cfg, ACCURACY_SEEDS, step=step)
    kern, plain = logits_ratio_gate(rows, cfg.name)
    print(f"{what}: {cfg.name} kernel vs plain logits {rel:.4g} / "
          f"{elem:.4g} exceed {PREFILL_TOL}; against float64 attention over "
          f"seeds {ACCURACY_SEEDS}: kernel {kern:.4g}, plain version "
          f"{plain:.4g}", flush=True)
    return out


class moe_routes:
    """Routing imposed on an MoE model: within ``record()`` each
    ``moe_route`` call (one a layer, in order) keeps its experts, as
    (B, S, K) for a pass over B x S tokens; within ``replay(t)`` a decode
    step at position t routes layer i's tokens (one a sequence) to the
    experts call i recorded for position t, with the slots ``moe_slots``
    gives them, and ``agree`` / ``n`` count the choices the step would
    have made itself that were those."""

    def __init__(self, B, S):
        self.B, self.S = B, S
        self.experts, self.agree, self.n = [], 0, 0

    @contextlib.contextmanager
    def _routed(self, fn):
        from repro_torch.models import layers as L
        saved = L.moe_route
        L.moe_route = lambda *a, **kw: fn(saved, *a, **kw)
        try:
            yield
        finally:
            L.moe_route = saved

    def record(self):
        def fn(route, moe, xt, cfg, capacity_factor=None):
            out = route(moe, xt, cfg, capacity_factor)
            self.experts.append(out[2].reshape(self.B, self.S, -1))
            return out
        return self._routed(fn)

    def replay(self, t):
        from repro_torch.models import layers as L
        calls = iter(self.experts)

        def fn(route, moe, xt, cfg, capacity_factor=None):
            probs, _, own, _, _, C = route(moe, xt, cfg, capacity_factor)
            top_e = next(calls)[:, t]                           # (B, K)
            flat_e = top_e.reshape(-1)
            self.agree += int((own == flat_e).sum())
            self.n += own.numel()
            top_p = probs.gather(1, top_e)
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
            return (probs, top_p, flat_e,
                    *L.moe_slots(flat_e, cfg.moe.n_experts, C), C)
        return self._routed(fn)


def moe_teacher_forced(torch, model, cfg, prompts, gate=True,
                       max_seq=MAX_SEQ):
    """An MoE model's teacher-forced check, on the given (served) model:
    prefill over ``prompts`` (B, S), then decode_step over them on a fresh
    cache in the model's dtype, its last logits within 0.15 of prefill's
    (``hold_teacher_forced``).  At the served capacity the two are
    different functions of the reference: a decode step routes its B
    tokens (C = 1 per expert), the prefill B x S of them (C = 20 for
    Scout), and each drops what its capacity cannot hold.  So both run at
    a capacity where nothing drops (capacity_factor E / K, so C = T), and
    each decode step takes prefill's routes (``moe_routes``): a rounding
    difference between the two paths moves a bf16 router logit by an ulp,
    and a near tie then picks another expert.  The steps' own choices must
    agree with prefill's on at least MOE_ROUTE_AGREEMENT of the tokens (a
    wrong router agrees by chance, 1 / E).  With ``gate`` False the 0.15
    is reported, not enforced (``hold_teacher_forced``); the cache holds
    ``max_seq`` positions."""
    import dataclasses
    from repro_torch.serve import llm_decode as D
    m = cfg.moe
    nodrop = cfg.scaled(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    B, S = prompts.shape
    routes = moe_routes(B, S)
    with routes.record():
        first = D.prefill(model, prompts, nodrop, max_seq)
    cache = {k: v.to(model.embedding.dtype) for k, v in D.init_cache(
        nodrop, B, max_seq, device=prompts.device).items()}
    for t in range(S):
        with routes.replay(t):
            logits, cache = D.decode_step(
                model, cache, prompts[:, t:t + 1],
                torch.full((B,), t, dtype=torch.int32,
                           device=prompts.device), nodrop)
    agree = routes.agree / routes.n
    if not agree >= MOE_ROUTE_AGREEMENT:
        raise AssertionError(f"{cfg.name}: decode's own routes agree with "
                             f"prefill's on {agree} of the tokens (limit "
                             f"{MOE_ROUTE_AGREEMENT})")
    out = hold_teacher_forced(torch, cfg, "prefill's routes, nothing "
                              "dropped", logits, first, gate)
    return {"capacity_factor": nodrop.moe.capacity_factor,
            "own_route_agreement": agree, **out}


def serve_model(torch, cfg, *, n_prefill, prompt, gen, profile_steps, what,
                f64_gate=False, inspect=None, profile_batch=None,
                warmup_batch=None):
    """One model at full width in bf16 (``init_on_card``) through
    registry.make_step, its path counted from 0 in parts (``ServedPath``):
    ``n_prefill`` timed prefills at ``prefill_shape(cfg)``
    (``attention_calls(cfg)`` causal launches a call, with the config's
    window), then N_REQ requests of ``prompt``-token prompts (first token
    from prefill, as many launches; the cache filled by decode_step over
    the prompt, no launch) and ``gen`` greedy tokens.  Holds the
    teacher-forced decode's last logits within 0.15 of the request
    prefill's (an MoE model with prefill's routes at a capacity where
    nothing drops, ``moe_teacher_forced``, the served capacity's numbers
    reported; MLA through ``mla_teacher_forced``, the hybrid through
    ``hybrid_teacher_forced``) and, for a
    model with attention, prefill's logits against the same prefill with
    the plain attention (``hold_vs_plain``, with the float64 gate when
    ``f64_gate``).  Reports tokens/s, the attention kernel's share of
    prefill's device time and prefill's costliest device operations (over
    a prefill of ``profile_batch`` (B, S) tokens where given), a profile of
    ``profile_steps`` decode steps and the peak device memory, as one JSON
    line under ``what``; ``inspect(model, batch)`` adds to the result.  The
    warm-up prefill runs over ``warmup_batch`` (B, S) tokens where given,
    else over the cell's.  Returns (launches, result)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve import llm_decode as D
    model, rng, init_s = init_on_card(torch, cfg, what)
    inputs, prefill = prefill_step(torch, cfg)
    decode = registry.make_step(cfg, ShapeConfig("decode_4k", MAX_SEQ, N_REQ,
                                                 "decode"))
    batch = inputs(rng)
    prompts = torch.randint(0, cfg.vocab, (N_REQ, prompt), generator=rng,
                            device="cuda")
    prefill(model, batch if warmup_batch is None else {      # warm-up
        "tokens": torch.randint(0, cfg.vocab, warmup_batch, generator=rng,
                                device="cuda")})
    torch.cuda.synchronize()
    cache = D.init_cache(cfg, N_REQ, MAX_SEQ)
    step, generate = decoder(torch, decode, model, cache)
    path = ServedPath(torch)

    FA.reset_launches()
    # -- this model's path: prefill, then requests ---------------------------
    logits = path("prefill", lambda: [prefill(model, batch)
                                      for _ in range(n_prefill)][-1])
    first = path("request prefill", lambda: prefill(model,
                                                    {"tokens": prompts}))
    last = path("prompt", lambda: [step(prompts[:, t:t + 1], t)
                                   for t in range(prompt)][-1])
    out = path("decode", lambda: generate(first, prompt, gen))
    launches = dict(FA.LAUNCHES)
    # -- end of this model's path ---------------------------------------------
    L, V = cfg.n_layers, cfg.vocab
    (B_p, S_p), n_attn = prefill_shape(cfg), attention_calls(cfg)
    w = cfg.sliding_window
    path.expect(cfg, {
        "prefill": [(True, S_p, S_p, w)] * (n_prefill * n_attn),
        "request prefill": [(True, prompt, prompt, w)] * n_attn,
        "prompt": [], "decode": []})
    check_logits(torch, cfg, (("prefill", logits, (B_p, 1, V)),
                              ("request prefill", first, (N_REQ, 1, V)),
                              ("decode", out, (N_REQ, 1, V))))
    if cfg.moe is not None:
        teacher = (mla_teacher_forced(torch, cfg, model, prompts)
                   if cfg.family == "mla_moe" else
                   moe_teacher_forced(torch, model, cfg, prompts))
        teacher["served_capacity"] = dict(zip(
            ("relative_l2", "max_over_scale"),
            _rel_errors(torch, last, first)))
    elif cfg.family == "hybrid":
        teacher = hybrid_teacher_forced(torch, cfg, last, first, prompts)
    else:
        teacher = hold_teacher_forced(torch, cfg, "requests", last, first)
    vs_plain = None
    if n_attn:
        with attention_as(plain_attention):
            vs_plain = _rel_errors(torch, logits, prefill(model, batch))
    profiled = batch if profile_batch is None else {"tokens": torch.randint(
        0, V, profile_batch, generator=rng, device="cuda")}
    profile = device_profile(torch, f"{cfg.name}'s prefill", prefill, model,
                             profiled)
    if profile_batch is not None:
        profile["profiled_batch"] = list(profile_batch)
    nxt = out.argmax(-1)
    decode_profile = profile_decode(
        torch, lambda i: step(nxt, prompt + gen + i), n=profile_steps)
    peak = torch.cuda.max_memory_allocated()
    extra = inspect(model, batch) if inspect is not None else {}
    del model, cache, step, generate, logits, first, last, out
    torch.cuda.empty_cache()
    wall = path.wall
    result = {
        "model": cfg.name, "parameters": registry.total_param_count(cfg),
        "layers": L, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": attention_head_dims(cfg),
        "init_s": init_s, "peak_device_bytes": peak,
        "prefill": {"batch": B_p, "seq": S_p,
                    "wall_s": wall["prefill"] / n_prefill,
                    "tokens_per_s": n_prefill * B_p * S_p / wall["prefill"],
                    **profile, "launches_per_call": n_attn, "window": w,
                    "vs_plain_attention": vs_plain and hold_vs_plain(
                        torch, cfg, what, vs_plain,
                        (inputs, prefill) if f64_gate else None)},
        "requests": {"n": N_REQ, "prompt": prompt, "generated": gen,
                     "max_seq": MAX_SEQ, "prefill_s": wall["request prefill"],
                     "prompt_fill_decode_tokens_per_s":
                         N_REQ * prompt / wall["prompt"],
                     "decode_tokens_per_s": N_REQ * gen / wall["decode"],
                     "decode_profile": decode_profile,
                     "prefill_vs_teacher_forced": teacher},
        **extra,
    }
    print(json.dumps({what: result}), flush=True)
    return launches, result


def hybrid_teacher_forced(torch, cfg, last, first, prompts):
    """The hybrid's teacher-forced check.  In bf16 its two forms (the
    chunked scan in prefill, the recurrent step in decode) part by rounding
    that the reference's init amplifies: JAX's own bf16 forms part beyond
    0.15 on a 5-layer variant (tests/test_torch_subquadratic.py).  So the
    served bf16 model's figures (``last`` vs ``first``) are reported, and
    the gate is the float32 model at full width cut to HYBRID_F32_LAYERS
    layers (one group and the layers left over), on a float32 cache (the
    reference's bf16 rings round a float32 model's keys in decode, not in
    prefill): decode_step over ``prompts``, its last logits within 0.15 of
    prefill's (``hold_teacher_forced``).  Also reported: its layer 0's
    scan against its steps over the prompts, in float32."""
    from repro_torch.models import layers as L, ssm as S
    from repro_torch.models import transformer as M
    from repro_torch.serve import llm_decode as D
    rel, elem = _rel_errors(torch, last, first)
    bf16 = {"relative_l2": rel, "max_over_scale": elem,
            "within_0.15": torch.allclose(last.float(), first.float(),
                                          rtol=0.15, atol=0.15),
            "argmax_agreement": (last.argmax(-1) == first.argmax(-1))
            .float().mean().item()}
    small = cfg.scaled(n_layers=HYBRID_F32_LAYERS)
    model = M.init_params(small, torch.Generator(device="cuda").manual_seed(1),
                          torch.float32)
    B, T = prompts.shape
    with torch.inference_mode():
        want = D.prefill(model, prompts, small, MAX_SEQ)
        cache = {k: v.float() for k, v in D.init_cache(
            small, B, MAX_SEQ).items()}
        for t in range(T):
            got, cache = D.decode_step(
                model, cache, prompts[:, t:t + 1],
                torch.full((B,), t, dtype=torch.int32, device="cuda"), small)
        layer = model.layers[0]
        h = L.rmsnorm(layer.ln1.scale, model.embedding[prompts])
        scan = S.mamba2_scan(layer.mamba, h, small)
        st, steps = S.mamba2_init_state(small, B, h.device), []
        for t in range(T):
            y, st = S.mamba2_step(layer.mamba, h[:, t:t + 1], st, small)
            steps.append(y)
        layer0 = _rel_errors(torch, torch.cat(steps, dim=1), scan)
    f32 = hold_teacher_forced(torch, small, f"float32, {HYBRID_F32_LAYERS} "
                              f"layers", got, want)
    del model, cache
    torch.cuda.empty_cache()
    print(f"phase 5e: {cfg.name} teacher-forced decode vs prefill: bf16 "
          f"{rel:.4g} / {elem:.4g} (within 0.15: {bf16['within_0.15']}); "
          f"float32 at {HYBRID_F32_LAYERS} layers {f32['relative_l2']:.4g} / "
          f"{f32['max_over_scale']:.4g}; layer 0 scan vs steps "
          f"{layer0[0]:.3g}", flush=True)
    return {"bf16": bf16, "float32": {"layers": HYBRID_F32_LAYERS, **f32},
            "float32_layer0_scan_vs_steps": dict(zip(
                ("relative_l2", "max_over_scale"), layer0))}


def run_serving(torch):
    """Phase 5: TinyLlama-1.1B at full width on the card (``serve_model``:
    3 timed prefills, 8 requests of 128 + 32 tokens).  Returns the
    kernel's launches on this path and the result."""
    return serve_model(torch, _tinyllama(), n_prefill=3, prompt=PROMPT,
                       gen=GEN, profile_steps=4, what="serving")


# ---------------------------------------------------------------------------
# Phase 5b: the bf16 kernel's accuracy against the exact function
# ---------------------------------------------------------------------------

def attention_f64(q, k, v, causal=True, window=None, q_chunk=512):
    """The attention function in float64 on the (exactly upcast) inputs:
    the truth the float32 plain version and both kernels approximate.
    Same masks as the plain version; (B, Sq, H, hd_v) float64."""
    import torch
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    kd = k.double().repeat_interleave(G, dim=2)
    vd = v.double().repeat_interleave(G, dim=2)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qd = q[:, q0:q0 + q_chunk].double()
        qpos = q0 + torch.arange(qd.shape[1], device=q.device)
        s = torch.einsum("bqhd,bshd->bhqs", qd, kd) / math.sqrt(hd)
        keep = torch.ones(len(qpos), Sk, dtype=torch.bool, device=q.device)
        if causal:
            keep &= qpos[:, None] >= kpos[None, :]
        if window:
            keep &= kpos[None, :] > qpos[:, None] - window
        p = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1)
        outs.append(torch.einsum("bhqs,bshd->bqhd", p, vd))
    return torch.cat(outs, dim=1)


def error_vs_truth(torch, got, truth):
    """A bf16 output's error against the float64 function: ``rel_l2``;
    ``max_half_ulps`` and ``n_over_half_ulp`` in hold_attention's measure;
    the mean signed error toward larger magnitude in those units with its
    standard error (a truncating accumulation reads below the plain
    version); and the elements that differ from bf16(truth) ("flips") with
    the share of them above it in magnitude (0.5 without a bias)."""
    g = got.double()
    sign = truth.sign()
    e = (g - truth) * sign / (BF16_HALF_ULP * truth.abs() + F32_ATOL)
    rn = truth.to(got.dtype).double()
    flip = g != rn
    n_flip = int(flip.sum().item())
    up = int((((g - rn) * sign)[flip] > 0).sum().item())
    return {"rel_l2": ((g - truth).norm() / truth.norm()).item(),
            "max_half_ulps": e.abs().max().item(),
            "n_over_half_ulp": int((e.abs() > 1).sum().item()),
            "mean_half_ulps": e.mean().item(),
            "se_half_ulps": (e.std() / e.numel() ** 0.5).item(),
            "flips": n_flip, "flips_up_share": up / n_flip if n_flip else None}


def against_truth(torch, q, k, v, causal=True, window=None):
    """(kernel output, {kernel, plain: error_vs_truth}) on one bf16 input;
    plain is the float32 plain version rounded once."""
    from repro_torch.kernels import flash_attention as FA, ref
    truth = attention_f64(q, k, v, causal, window)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    outs = {"kernel": got,
            "plain": ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)}
    return got, {n: error_vs_truth(torch, x, truth) for n, x in outs.items()}


def prefill_logits_vs_f64(torch, cfg, seeds, first_seed=None, step=None):
    """Logits on each seed's model and inputs with the kernel, the plain
    version and float64 attention as the model's attention: per seed
    ``_rel_errors`` of kernel vs plain (PREFILL_TOL's measure) and of each
    against the float64-attention logits.  ``step`` is (inputs(gen),
    run(model, batch)), by default the prefill cell (``prefill_step``).
    ``first_seed(run, model, batch)`` runs on the first seed's model
    before it is freed."""
    from repro_torch.models import transformer as M
    inputs, run = step or prefill_step(torch, cfg)
    routes = {"plain": plain_attention,
              "f64": lambda q, k, v, causal=True, window=None: attention_f64(
                  q, k, v, causal, window).to(q.dtype)}
    rows = []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = M.init_params(cfg, gen)
        batch = inputs(gen)
        out = {"kernel": run(model, batch)}
        for name, fn in routes.items():
            with attention_as(fn):
                out[name] = run(model, batch)
        row = {"seed": seed, "kernel_vs_plain": _rel_errors(
            torch, out["kernel"], out["plain"])}
        for name in ("kernel", "plain"):
            row[f"{name}_vs_f64"] = _rel_errors(torch, out[name], out["f64"])
        rows.append(row)
        if first_seed is not None and seed == seeds[0]:
            first_seed(run, model, batch)
        del model, out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def logits_ratio_gate(rows, what):
    """The kernel's prefill logits may be no further from float64
    attention (mean relative L2 over the seeds) than ACCURACY_LOGITS_RATIO
    times the plain version's.  Returns (kernel, plain)."""
    kern, plain = (sum(r[f"{n}_vs_f64"][0] for r in rows) / len(rows)
                   for n in ("kernel", "plain"))
    if not kern <= ACCURACY_LOGITS_RATIO * plain:
        raise AssertionError(
            f"{what}: prefill logits vs float64 attention: kernel {kern}, "
            f"plain version {plain} (limit {ACCURACY_LOGITS_RATIO}x)")
    return kern, plain


def attention_accuracy(torch, seeds=ACCURACY_SEEDS):
    """Phase 5b, after the main path: the bf16 kernel and the plain
    version, each against the float64 function, at the prefill shape on
    random inputs and layer by layer in a full-width prefill (seed 0: the
    main path's model and tokens); then
    prefill logits on several seeds with each of them, and with float64
    attention, as the model's attention (``prefill_logits_vs_f64``)."""
    cfg = _tinyllama()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(torch, PREFILL_B, PREFILL_S, PREFILL_S, H, KV, hd,
                   torch.bfloat16, seed=1)
    _, at_shape = against_truth(torch, q, k, v)
    del q, k, v
    layers = []

    def by_layer(prefill, model, batch):
        def watch(q, k, v, causal=True, window=None):
            got, errs = against_truth(torch, q, k, v, causal, window)
            layers.append(errs)
            return got
        with attention_as(watch):
            prefill(model, batch)

    logits = prefill_logits_vs_f64(torch, cfg, seeds, by_layer)
    result = {"at_prefill_shape": at_shape, "by_layer": layers,
              "prefill_logits": logits}
    print(json.dumps({"attention_accuracy": result}), flush=True)
    for where, errs in [("prefill shape", at_shape)] + [
            (f"layer {i}", e) for i, e in enumerate(layers)]:
        if errs["kernel"]["n_over_half_ulp"] > errs["plain"]["n_over_half_ulp"]:
            raise AssertionError(
                f"attention at the {where}: the kernel has more elements "
                f"beyond half a bf16 ulp of float64 than the plain version "
                f"({errs['kernel']['n_over_half_ulp']} > "
                f"{errs['plain']['n_over_half_ulp']})")
    logits_ratio_gate(logits, cfg.name)
    return result


# ---------------------------------------------------------------------------
# Phase 5c: the dense zoo at full width
# ---------------------------------------------------------------------------

def run_zoo(torch):
    """Phase 5c: each ZOO model at full width in bf16 (``serve_model``),
    one at a time, each freed before the next; ZOO_F32 also runs the
    float32 prefill (``run_f32_prefill``).  Returns ({path: launches},
    {path: result}), the float32 path keyed "<arch> float32"."""
    from repro_torch.configs import get_config
    launches, results = {}, {}
    for arch in ZOO:
        t = time.perf_counter()
        cfg = get_config(arch)
        launches[arch], results[arch] = serve_model(
            torch, cfg, n_prefill=2, prompt=ZOO_PROMPT, gen=ZOO_GEN,
            profile_steps=2, what="zoo_serving", f64_gate=True)
        if arch == ZOO_F32:
            key = f"{arch} float32"
            launches[key], results[key] = run_f32_prefill(torch, cfg)
        print(f"phase 5c: {arch} took {time.perf_counter() - t:.1f} s",
              flush=True)
    return launches, results


# ---------------------------------------------------------------------------
# Phase 5d: Whisper-base and Llama-4 Scout at full width
# ---------------------------------------------------------------------------

def fill_cross_cache(model, cache, enc, cfg):
    """Each decoder layer's cross-attention K / V of the encoder states
    ``enc`` into ``xk`` / ``xv`` (neither package's prefill fills them)."""
    B, S = enc.shape[:2]
    shape = (B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    for i, layer in enumerate(model.dec_layers):
        cache["xk"][i] = (enc @ layer.xattn.wk).reshape(shape)
        cache["xv"][i] = (enc @ layer.xattn.wv).reshape(shape)


def whisper_step(torch, cfg):
    """Phase 5d (b) as a step: (inputs(gen) -> WHISPER_B x WHISPER_FRAMES
    bf16 frames and WHISPER_B x WHISPER_TOKENS tokens; run(model, batch)
    -> ``lm_forward``'s logits over the tokens with ``encode``'s states of
    the frames as ``encoder_out``)."""
    from repro_torch.models import transformer as M

    def inputs(gen):
        frames = torch.randn((WHISPER_B, WHISPER_FRAMES, cfg.d_model),
                             generator=gen, device="cuda").to(torch.bfloat16)
        return {"frames": frames, "tokens": torch.randint(
            0, cfg.vocab, (WHISPER_B, WHISPER_TOKENS), generator=gen,
            device="cuda")}

    @torch.inference_mode()
    def run(model, batch):
        enc = M.encode(model, batch["frames"], cfg)
        return M.lm_forward(model, batch["tokens"], cfg, encoder_out=enc)[0]
    return inputs, run


def serve_whisper(torch, n_prefill=2):
    """Phase 5d: Whisper-base at full width in bf16 (``init_on_card``).
    Its path, counted from 0 in parts (``ServedPath``): (a) ``n_prefill``
    prefills through registry.make_step over PREFILL_B x PREFILL_S frames
    (``n_enc_layers`` non-causal launches a call); (b) ``encode`` over
    WHISPER_B x WHISPER_FRAMES frames (non-causal, Sq = Sk) and
    ``lm_forward`` over WHISPER_TOKENS tokens with that ``encoder_out``
    (per layer one causal launch and one cross, Sq != Sk); (c) a decode
    cache of exactly the WHISPER_FRAMES encoder positions, ``xk`` / ``xv``
    filled from (b)'s states, WHISPER_PROMPT of (b)'s tokens teacher-
    forced through make_step's decode and WHISPER_GEN greedy tokens (no
    launch: decode attention is plain torch, as in JAX).  Holds (a)'s
    logits against the same prefill with the plain attention within
    PREFILL_TOL, (b)'s within PREFILL_TOL or else phase 5b's float64 gate
    (``hold_vs_plain``), and the teacher-forced logits within 0.15 of
    (b)'s at the same positions; reports tokens/s, the kernel's share of
    (a)'s and (b)'s device time, a decode profile and the peak memory.
    Returns ({path: launches}, result)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import registry
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve import llm_decode as D
    cfg = get_config(WHISPER)
    model, rng, init_s = init_on_card(torch, cfg, "phase 5d")
    inputs_a, prefill = prefill_step(torch, cfg)
    inputs_b, forward = whisper_step(torch, cfg)
    decode = registry.make_step(cfg, ShapeConfig(
        "decode_1500", WHISPER_FRAMES, WHISPER_B, "decode"))
    batch_a, batch_b = inputs_a(rng), inputs_b(rng)
    frames, tokens = batch_b["frames"], batch_b["tokens"]
    with torch.inference_mode():
        prefill(model, batch_a)                          # warm-up
        forward(model, batch_b)
    torch.cuda.synchronize()
    cache = D.init_cache(cfg, WHISPER_B, WHISPER_FRAMES)
    step, generate = decoder(torch, decode, model, cache)
    path = ServedPath(torch)

    FA.reset_launches()
    # -- this model's path: (a) prefill, (b) encode + forward, (c) decode ----
    with torch.inference_mode():
        logits_a = path("prefill", lambda: [prefill(model, batch_a)
                                            for _ in range(n_prefill)][-1])
        enc = path("encode", lambda: M.encode(model, frames, cfg))
        logits_b = path("forward", lambda: M.lm_forward(
            model, tokens, cfg, encoder_out=enc)[0])
        fill_cross_cache(model, cache, enc, cfg)
        steps = path("prompt", lambda: [step(tokens[:, t:t + 1], t)
                                        for t in range(WHISPER_PROMPT)])
        out = path("decode", lambda: generate(steps[-1], WHISPER_PROMPT,
                                              WHISPER_GEN))
    # -- end of this model's path ---------------------------------------------
    L_enc, L_dec, V = cfg.n_enc_layers, cfg.n_layers, cfg.vocab
    path.expect(cfg, {
        "prefill": [(False, PREFILL_S, PREFILL_S, None)] * (n_prefill
                                                            * L_enc),
        "encode": [(False, WHISPER_FRAMES, WHISPER_FRAMES, None)] * L_enc,
        "forward": [(True, WHISPER_TOKENS, WHISPER_TOKENS, None),
                    (False, WHISPER_TOKENS, WHISPER_FRAMES, None)] * L_dec,
        "prompt": [], "decode": []})
    check_logits(torch, cfg, (
        ("prefill", logits_a, (PREFILL_B, 1, V)),
        ("forward", logits_b, (WHISPER_B, WHISPER_TOKENS, V)),
        ("decode", out, (WHISPER_B, 1, V))))
    teacher = hold_teacher_forced(torch, cfg, "(c)", torch.cat(steps, dim=1),
                                  logits_b[:, :WHISPER_PROMPT])
    with torch.inference_mode(), attention_as(plain_attention):
        vs_plain_a = _rel_errors(torch, logits_a, prefill(model, batch_a))
        vs_plain_b = _rel_errors(torch, logits_b, forward(model, batch_b))
    profile_a = device_profile(torch, f"{cfg.name}'s prefill", prefill,
                               model, batch_a)
    profile_b = device_profile(torch, f"{cfg.name}'s forward", forward,
                               model, batch_b)
    nxt = out.argmax(-1)
    decode_profile = profile_decode(torch, lambda i: step(
        nxt, WHISPER_PROMPT + WHISPER_GEN + i), n=2)
    peak = torch.cuda.max_memory_allocated()
    del model, cache, step, generate, logits_a, logits_b, enc, steps, out
    torch.cuda.empty_cache()
    wall = path.wall
    result = {
        "model": cfg.name, "parameters": registry.total_param_count(cfg),
        "layers": [L_enc, L_dec], "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
        "init_s": init_s, "peak_device_bytes": peak,
        "prefill": {"batch": PREFILL_B, "frames": PREFILL_S,
                    "wall_s": wall["prefill"] / n_prefill,
                    "frames_per_s": n_prefill * PREFILL_B * PREFILL_S
                    / wall["prefill"],
                    **profile_a, "launches_per_call": L_enc,
                    "vs_plain_attention": hold_vs_plain(
                        torch, cfg, "phase 5d (a)", vs_plain_a)},
        "encode_forward": {
            "batch": WHISPER_B, "frames": WHISPER_FRAMES,
            "tokens": WHISPER_TOKENS, "encode_s": wall["encode"],
            "encode_frames_per_s": WHISPER_B * WHISPER_FRAMES
            / wall["encode"],
            "forward_s": wall["forward"],
            "forward_tokens_per_s": WHISPER_B * WHISPER_TOKENS
            / wall["forward"],
            **profile_b, "launches": {"encode": L_enc, "forward": 2 * L_dec},
            "vs_plain_attention": hold_vs_plain(
                torch, cfg, "phase 5d (b)", vs_plain_b, (inputs_b, forward))},
        "decode": {"n": WHISPER_B, "cross_positions": WHISPER_FRAMES,
                   "prompt": WHISPER_PROMPT, "generated": WHISPER_GEN,
                   "prompt_fill_decode_tokens_per_s":
                       WHISPER_B * WHISPER_PROMPT / wall["prompt"],
                   "decode_tokens_per_s": WHISPER_B * WHISPER_GEN
                   / wall["decode"],
                   "decode_profile": decode_profile,
                   "teacher_forced_vs_forward": teacher},
    }
    print(json.dumps({"whisper_serving": result}), flush=True)
    return {f"{WHISPER} {p}": path.launches[p]
            for p in ("prefill", "encode", "forward")}, result


def first_layer_routing(torch, cfg, model, batch):
    """Layer 0's routing of the prefill batch, from its router logits (the
    path's own ``moe_route`` on the layer's FFN input): tokens per expert,
    the capacity and the share of tokens dropped."""
    from repro_torch.models import layers as L
    tokens = batch["tokens"]
    B, S = tokens.shape
    layer = model.layers[0]
    attend = L.mla_apply if cfg.family == "mla_moe" else L.attention_apply
    with torch.inference_mode():
        x = model.embedding[tokens]
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        x = x + attend(layer.attn, L.rmsnorm(layer.ln1.scale, x), cfg, pos)
        h_in = L.rmsnorm(layer.ln2.scale, x).reshape(B * S, -1)
        _, _, flat_e, _, keep, C = L.moe_route(layer.ffn, h_in, cfg)
    share = 1.0 - keep.float().mean().item()
    per_expert = torch.bincount(flat_e, minlength=cfg.moe.n_experts)
    print(f"{cfg.name} layer 0 at prefill: {share:.4%} of "
          f"{B * S} tokens dropped at capacity {C} per expert (tokens per "
          f"expert {per_expert.tolist()})", flush=True)
    return {"first_layer_routing": {"tokens": B * S, "capacity": C,
                                    "dropped_share": share,
                                    "per_expert": per_expert.tolist()}}


def run_5d(torch):
    """Phase 5d: Whisper-base (``serve_whisper``), then Llama-4 Scout at
    full width cut to SCOUT_LAYERS layers, as phase 5c serves its models
    (``serve_model``, with the float64 gate, and layer 0's routing of the
    prefill batch).  Returns ({path: launches}, {model: result})."""
    from repro_torch.configs import get_config
    t = time.perf_counter()
    launches, whisper = serve_whisper(torch)
    print(f"phase 5d: {WHISPER} took {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    full = get_config(SCOUT)
    cfg = full.scaled(n_layers=SCOUT_LAYERS)
    launches[SCOUT], scout = serve_model(
        torch, cfg, n_prefill=2, prompt=ZOO_PROMPT, gen=ZOO_GEN,
        profile_steps=2, what="moe_serving", f64_gate=True,
        inspect=lambda model, batch: {
            "reduced": {"n_layers": [full.n_layers, SCOUT_LAYERS]},
            **first_layer_routing(torch, cfg, model, batch)})
    print(f"phase 5d: {SCOUT} took {time.perf_counter() - t:.1f} s",
          flush=True)
    return launches, {WHISPER: whisper, SCOUT: scout}


# ---------------------------------------------------------------------------
# Phase 5e: RWKV-6-3B and Zamba2-7B at full width, long_500k uncut
# ---------------------------------------------------------------------------

def cache_bytes(cache):
    return sum(v.numel() * v.element_size() for v in cache.values())


def decode_long(torch, cfg, model, n=LONG_PROMPT):
    """long_500k uncut through make_step's decode: ``init_cache(cfg, 1,
    524288)``, ``n`` prompt tokens decoded at the cell's last positions
    (524,288 - n to 524,287; the slots never written stay zero, as in
    JAX's init).  The cache's bytes must equal a 4,096-position cache's
    (the state does not grow with the context), before and after.  Returns
    {"long_500k": ms per step, bytes, positions}."""
    from repro_torch.models import registry
    from repro_torch.models.config import SHAPES
    from repro_torch.serve import llm_decode as D
    shape = SHAPES["long_500k"]
    B, S = shape.global_batch, shape.seq_len
    cache = D.init_cache(cfg, B, S)
    small = cache_bytes(D.init_cache(cfg, B, 4096, device="meta"))
    at_init = cache_bytes(cache)
    step, _ = decoder(torch, registry.make_step(cfg, shape), model, cache)
    tokens = torch.randint(0, cfg.vocab, (B, n), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    pos0 = S - n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        logits = step(tokens[:, i:i + 1], pos0 + i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    check_logits(torch, cfg, (("long_500k decode", logits,
                               (B, 1, cfg.vocab)),))
    after = cache_bytes(cache)
    if not at_init == after == small:
        raise AssertionError(f"{cfg.name} long_500k cache: {at_init} bytes "
                             f"at init, {after} after {n} steps; a 4,096-"
                             f"position cache holds {small}")
    print(f"phase 5e: {cfg.name} long_500k: {n} steps at positions {pos0}-"
          f"{S - 1}, {ms:.3f} ms per step, cache {after} bytes (== at 4,096 "
          f"positions)", flush=True)
    return {"long_500k": {"seq_len": S, "batch": B, "steps": n,
                          "positions": [pos0, S - 1], "ms_per_step": ms,
                          "cache_bytes": after,
                          "cache_bytes_at_4096": small,
                          "cache_shapes": {k: list(v.shape)
                                           for k, v in cache.items()}}}


def subq_small_config(arch):
    """``arch``'s config cut to SUBQ_SMALL[arch] (tests/
    test_torch_subquadratic.py's variants at the models' head dims)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import SSMConfig
    kw = dict(SUBQ_SMALL[arch])
    return get_config(arch).scaled(ssm=SSMConfig(**kw.pop("ssm")), **kw)


@contextlib.contextmanager
def half_ulp_noise(torch, seed=0):
    """Within the block every RMSNorm output (each block's input, and the
    final norm's) is multiplied by 1 + 2^-24 n, n standard normal from a
    CPU generator seeded ``seed``: half a float32 ulp of noise, less than
    any two float32 summation orders differ by."""
    from repro_torch.models import layers as L
    saved = L.rmsnorm
    gen = torch.Generator().manual_seed(seed)

    def noisy(scale, x, eps=1e-6):
        out = saved(scale, x, eps)
        n = torch.randn(out.shape, generator=gen).to(out.device)
        return out * (1 + 2.0 ** -24 * n)
    L.rmsnorm = noisy
    try:
        yield
    finally:
        L.rmsnorm = saved


def subq_card_vs_cpu(torch, arch):
    """SUBQ_SMALL[arch]'s float32 model on the card and on the CPU (the
    same weights, from a CPU generator): prefill of 2 x SUBQ_SMALL_S
    tokens, then SUBQ_SMALL_STEPS decode steps on a float32 cache (the
    hybrid's 64-slot rings wrap), and the cache after.  Each output must
    lie within CARD_CPU_TOL (relative L2, max over scale) of the CPU's or,
    where larger, NOISE_FACTOR times the distance the CPU run moves under
    ``half_ulp_noise``.  Returns {output: {card, noise, bound}}."""
    from repro_torch.models import transformer as M
    from repro_torch.serve import llm_decode as D
    cfg = subq_small_config(arch)
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (2, SUBQ_SMALL_S), generator=gen)
    nxt = torch.randint(0, cfg.vocab, (2, SUBQ_SMALL_STEPS), generator=gen)

    def run(dev):
        model = M.init_params(cfg, torch.Generator().manual_seed(3),
                              torch.float32, device=dev)
        cache = {k: v.float() for k, v in D.init_cache(
            cfg, 2, SUBQ_SMALL_S, device=dev).items()}
        steps = []
        for t in range(SUBQ_SMALL_STEPS):
            logits, cache = D.decode_step(
                model, cache, nxt[:, t:t + 1].to(dev),
                torch.full((2,), t, dtype=torch.int32, device=dev), cfg)
            steps.append(logits)
        return {"prefill": D.prefill(model, tokens.to(dev), cfg,
                                     SUBQ_SMALL_S),
                "decode": torch.cat(steps, dim=1),
                **{f"cache {k}": v.cpu() for k, v in cache.items()}}
    cpu, card = run("cpu"), run("cuda")
    with half_ulp_noise(torch):
        noise = run("cpu")
    out = {}
    for name, want in cpu.items():
        got = _rel_errors(torch, card[name].cpu(), want)
        yard = _rel_errors(torch, noise[name], want)
        bound = tuple(max(t, NOISE_FACTOR * y)
                      for t, y in zip(CARD_CPU_TOL, yard))
        out[name] = {"card": got, "noise": yard, "bound": bound}
        if not (got[0] <= bound[0] and got[1] <= bound[1]):
            raise AssertionError(f"{cfg.name} float32 {name}: card != CPU "
                                 f"(relative L2, max {got}; bound {bound}, "
                                 f"half an ulp of noise {yard})")
    return out


def check_subq_card_vs_cpu(torch):
    """Phase 5e: ``subq_card_vs_cpu`` for RWKV-6 (2 layers, hd 64) and the
    hybrid (5 layers of period 2, window 64, attention hd 112).  Returns
    {arch: its result}."""
    out = {}
    for arch in (RWKV6, ZAMBA2):
        res = out[arch] = subq_card_vs_cpu(torch, arch)
        worst = max(r["card"] for r in res.values())
        noise = max(r["noise"] for r in res.values())
        print(f"phase 5e: {arch} float32 narrow variant, prefill, "
              f"{SUBQ_SMALL_STEPS} decode steps and cache: card == CPU "
              f"(worst relative L2 / max {worst[0]:.3g} / {worst[1]:.3g}; "
              f"half an ulp of noise moves the CPU's {noise[0]:.3g} / "
              f"{noise[1]:.3g})", flush=True)
    return out


def prefill_calls_vs_plain(torch, cfg, model, batch):
    """Each attention call of one served prefill, the kernel held against
    the plain version on the same q, k, v within ATTN_TOL
    (``hold_attention``'s first test; a model's near-tied rows are not
    within half an ulp, phase 5b); there must be ``attention_calls(cfg)``.
    Returns {"n": calls, "max_abs_diff", "head_dims": the calls' distinct
    (q/k, v) head dims}."""
    from repro_torch.kernels import flash_attention as FA
    diffs, dims = [], set()

    def watch(q, k, v, causal=True, window=None):
        got = FA.flash_attention(q, k, v, causal=causal, window=window)
        want = plain_attention(q, k, v, causal, window)
        diffs.append((got.float() - want.float()).abs().max().item())
        dims.add((q.shape[-1], v.shape[-1]))
        tol = ATTN_TOL["bfloat16"]
        if not torch.allclose(got.float(), want.float(), rtol=tol,
                              atol=tol):
            raise AssertionError(f"{cfg.name}: attention call {len(diffs)}, "
                                 f"kernel != plain (max {diffs[-1]})")
        return got
    with torch.inference_mode(), attention_as(watch):
        prefill_step(torch, cfg)[1](model, batch)
    if len(diffs) != attention_calls(cfg):
        raise AssertionError(f"{cfg.name}: {len(diffs)} attention calls")
    return {"n": len(diffs), "max_abs_diff": max(diffs),
            "head_dims": sorted(dims)}


def windowed_calls_vs_plain(torch, cfg, model, batch):
    """``prefill_calls_vs_plain`` for a model with a window (Zamba2: 13
    windowed calls) as {"windowed_calls": ...}; {} for one without."""
    if not cfg.sliding_window:
        return {}
    out = prefill_calls_vs_plain(torch, cfg, model, batch)
    print(f"phase 5e: {cfg.name} prefill's {out['n']} windowed calls: "
          f"kernel == plain (max abs diff {out['max_abs_diff']:.4g})",
          flush=True)
    return {"windowed_calls": out}


def run_5e(torch):
    """Phase 5e: Zamba2-7B, then RWKV-6-3B (depth cut to SUBQ_LAYERS), each
    at full width in bf16 through ``serve_model`` (Zamba2 with the float64
    gate; RWKV's prefill one warm-up and one timed call, profiled over
    RWKV_PROFILE), each with
    long_500k uncut (``decode_long``); then ``check_subq_card_vs_cpu``.
    Returns ({model: launches}, {model: result})."""
    from repro_torch.configs import get_config
    launches, results = {}, {}
    for arch in (ZAMBA2, RWKV6):
        t = time.perf_counter()
        cfg = get_config(arch)
        cfg = cfg.scaled(n_layers=SUBQ_LAYERS.get(arch, cfg.n_layers))
        rwkv = cfg.family == "rwkv6"
        launches[arch], results[arch] = serve_model(
            torch, cfg, n_prefill=1 if rwkv else 2, prompt=ZOO_PROMPT,
            gen=ZOO_GEN, profile_steps=2, what="subquadratic_serving",
            f64_gate=not rwkv, profile_batch=RWKV_PROFILE if rwkv else None,
            warmup_batch=RWKV_WARMUP if rwkv else None,
            inspect=lambda model, batch, cfg=cfg: {
                **decode_long(torch, cfg, model),
                **windowed_calls_vs_plain(torch, cfg, model, batch)})
        print(f"phase 5e: {arch} took {time.perf_counter() - t:.1f} s",
              flush=True)
    t = time.perf_counter()
    results["card_vs_cpu"] = check_subq_card_vs_cpu(torch)
    print(f"phase 5e: float32 card vs CPU took "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return launches, results


# ---------------------------------------------------------------------------
# Phase 5f: DeepSeek-V2 (MLA + MoE) at full width
# ---------------------------------------------------------------------------

def pair_calls_vs_plain(torch, cfg, model, batch):
    """``prefill_calls_vs_plain`` for an MLA model, each of its calls at the
    (q/k, v) pair ``attention_head_dims(cfg)``, as {"pair_calls": ...}."""
    out = prefill_calls_vs_plain(torch, cfg, model, batch)
    if out["head_dims"] != [attention_head_dims(cfg)]:
        raise AssertionError(f"{cfg.name}: prefill attention at head dims "
                             f"{out['head_dims']}")
    print(f"phase 5f: {cfg.name} prefill's {out['n']} attention calls at "
          f"q/k {out['head_dims'][0][0]} against v {out['head_dims'][0][1]}: "
          f"kernel == plain (max abs diff {out['max_abs_diff']:.4g})",
          flush=True)
    return {"pair_calls": out}


def mla_teacher_forced(torch, cfg, model, prompts):
    """DeepSeek-V2's teacher-forced check, ``moe_teacher_forced`` (prefill's
    routes, nothing dropped) on two models.  The served bf16 model's
    figures are reported, with the kernel and with the plain attention in
    prefill, and its route agreement gated, not its 0.15: in bf16 the
    model's prefill and its decode part by rounding that the reference's
    init amplifies, as much with the plain attention as with the kernel
    (beyond 0.15 on some inputs; PERF.md §6, PR 24).  The gate is the
    float32 model at full width cut to DSV2_F32_LAYERS layers (weights
    from a generator seeded 1 on ``prompts``' device) on a float32 latent
    cache of the prompts' length, where the two are one function."""
    from repro_torch.models import transformer as M
    bf16 = moe_teacher_forced(torch, model, cfg, prompts, gate=False)
    with attention_as(plain_attention):
        plain = moe_teacher_forced(torch, model, cfg, prompts, gate=False)
    small = cfg.scaled(n_layers=DSV2_F32_LAYERS)
    dev = prompts.device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(1)
    f32_model = M.init_params(small, gen, torch.float32, device=dev)
    f32 = moe_teacher_forced(torch, f32_model, small, prompts,
                             max_seq=prompts.shape[1])
    del f32_model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"phase 5f: {cfg.name} teacher-forced decode vs prefill, prefill's "
          f"routes: bf16 {bf16['relative_l2']:.4g} / "
          f"{bf16['max_over_scale']:.4g} (within 0.15: "
          f"{bf16['within_0.15']}, own routes "
          f"{bf16['own_route_agreement']:.3f}); with plain attention "
          f"{plain['relative_l2']:.4g} / "
          f"{plain['max_over_scale']:.4g}; float32 at {DSV2_F32_LAYERS} "
          f"layers {f32['relative_l2']:.4g} / {f32['max_over_scale']:.4g}",
          flush=True)
    return {"bf16": bf16, "bf16_plain_attention": plain,
            "float32": {"layers": DSV2_F32_LAYERS, **f32}}


def latent_cache(cfg):
    """The served requests' latent cache (N_REQ x MAX_SEQ): its shapes and
    bytes, beside the bytes of the K/V it expands to (q/k and v widths
    over every head), which an MHA cache of this model would hold."""
    from repro_torch.serve import llm_decode as D
    cache = D.init_cache(cfg, N_REQ, MAX_SEQ, device="meta")
    hd, hd_v = attention_head_dims(cfg)
    expanded = 2 * cfg.n_layers * N_REQ * MAX_SEQ * cfg.n_heads * (hd + hd_v)
    print(f"phase 5f: {cfg.name} latent cache {cache_bytes(cache)} bytes "
          f"for {N_REQ} x {MAX_SEQ} positions (expanded K/V {expanded})",
          flush=True)
    return {"latent_cache": {"bytes": cache_bytes(cache),
                             "expanded_kv_bytes": expanded,
                             "shapes": {k: list(v.shape)
                                        for k, v in cache.items()}}}


def mla_small_config():
    """DeepSeek-V2's smoke config scaled to MLA_SMALL (tests/
    test_torch_mla.py's variant at the real head dims)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import MLAConfig, MoEConfig
    kw = dict(MLA_SMALL)
    return get_smoke_config(DSV2).scaled(mla=MLAConfig(**kw.pop("mla")),
                                         moe=MoEConfig(**kw.pop("moe")), **kw)


def mla_card_vs_cpu(torch):
    """MLA_SMALL's float32 model on the card and on the CPU (the same
    weights, from a CPU generator): prefill of 2 x MLA_SMALL_S tokens (one
    float32 kernel launch at the (192, 128) pair and three splits a layer
    on the card, counted from 0 over the card's run), then
    MLA_SMALL_STEPS decode steps on a float32 latent cache, and the cache
    after.  Each output within CARD_CPU_TOL (relative L2, max over scale)
    of the CPU's.  Returns (the card's launches, {output: errors})."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as M
    from repro_torch.serve import llm_decode as D
    cfg = mla_small_config()
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (2, MLA_SMALL_S), generator=gen)
    nxt = torch.randint(0, cfg.vocab, (2, MLA_SMALL_STEPS), generator=gen)

    def run(dev):
        model = M.init_params(cfg, torch.Generator().manual_seed(3),
                              torch.float32, device=dev)
        first = D.prefill(model, tokens.to(dev), cfg, MLA_SMALL_S)
        cache = {k: v.float() for k, v in D.init_cache(
            cfg, 2, MLA_SMALL_S, device=dev).items()}
        steps = []
        for t in range(MLA_SMALL_STEPS):
            logits, cache = D.decode_step(
                model, cache, nxt[:, t:t + 1].to(dev),
                torch.full((2,), t, dtype=torch.int32, device=dev), cfg)
            steps.append(logits)
        return {"prefill": first.cpu(), "decode": torch.cat(steps, 1).cpu(),
                **{f"cache {k}": v.cpu() for k, v in cache.items()}}
    cpu = run("cpu")
    FA.reset_launches()
    card = run("cuda")
    launches = dict(FA.LAUNCHES)
    want = launch_counts(FA, flash_attention_f32=cfg.n_layers,
                         split_bf16x3=3 * cfg.n_layers)
    if launches != want:
        raise AssertionError(f"{cfg.name} float32 narrow variant launched "
                             f"{launches}, expected {want}")
    out = {}
    for name, w in cpu.items():
        got = out[name] = _rel_errors(torch, card[name], w)
        if not (got[0] <= CARD_CPU_TOL[0] and got[1] <= CARD_CPU_TOL[1]):
            raise AssertionError(f"{cfg.name} float32 {name}: card != CPU "
                                 f"(relative L2, max {got}; tolerance "
                                 f"{CARD_CPU_TOL})")
    worst = max(out.values())
    print(f"phase 5f: {cfg.name} float32 narrow variant (q/k 192, v 128), "
          f"prefill, {MLA_SMALL_STEPS} decode steps and latent cache: card "
          f"== CPU (worst relative L2 / max {worst[0]:.3g} / "
          f"{worst[1]:.3g}; tolerance {CARD_CPU_TOL})", flush=True)
    return launches, out


def run_5f(torch):
    """Phase 5f: DeepSeek-V2 at full width cut to DSV2_LAYERS layers
    through ``serve_model`` (with the float64 gate; each prefill attention
    call at the (192, 128) pair held against the plain version,
    ``pair_calls_vs_plain``; layer 0's routing of the prefill batch; the
    latent cache's bytes), then its float32 narrow variant card == CPU
    (``mla_card_vs_cpu``).  Returns ({path: launches}, {path: result})."""
    from repro_torch.configs import get_config
    t = time.perf_counter()
    full = get_config(DSV2)
    cfg = full.scaled(n_layers=DSV2_LAYERS)
    launches, results = {}, {}
    launches[DSV2], results[DSV2] = serve_model(
        torch, cfg, n_prefill=2, prompt=ZOO_PROMPT, gen=ZOO_GEN,
        profile_steps=2, what="mla_serving", f64_gate=True,
        inspect=lambda model, batch: {
            "reduced": {"n_layers": [full.n_layers, DSV2_LAYERS]},
            **latent_cache(cfg),
            **pair_calls_vs_plain(torch, cfg, model, batch),
            **first_layer_routing(torch, cfg, model, batch)})
    print(f"phase 5f: {DSV2} took {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    key = f"{DSV2} float32 narrow"
    launches[key], results[key] = mla_card_vs_cpu(torch)
    print(f"phase 5f: float32 card vs CPU took "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return launches, results


# ---------------------------------------------------------------------------
# Phase 2c: the attention backward kernel; phase 5g: training
# ---------------------------------------------------------------------------

FA_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu"
# The gradient the backward kernel computes has no Pallas kernel: the JAX
# package differentiates its jnp chunked attention (jax.value_and_grad in
# src/repro/train/step.py:131).
FA_BWD_REPLACES = "src/repro/models/layers.py:128"
# Phase 2c: (B, Sq, Sk, H, KV, hd, causal, window), each in bf16 and
# float32: every head dim of HEAD_DIMS and the (192, 128) pair, GQA groups
# 1, 4, 5 and 8, causal, non-causal with Sq != Sk, windows, ragged S.
BWD_CASES = {
    "tinyllama_g8": (2, 512, 512, 32, 4, 64, True, None),
    "hd16_g1": (2, 256, 256, 4, 4, 16, True, None),
    "hd32_noncausal_g4": (1, 200, 333, 8, 2, 32, False, None),
    "hd64_noncausal_g4": (1, 256, 768, 8, 2, 64, False, None),
    "hd64_window96": (1, 512, 512, 8, 2, 64, True, 96),
    "hd80_ragged1000": (1, 1000, 1000, 8, 8, 80, True, None),
    "hd112_window300_ragged": (1, 1000, 1000, 8, 8, 112, True, 300),
    "hd128_g5": (1, 512, 512, 40, 8, 128, True, None),
    "mla_ragged1000": (1, 1000, 1000, 16, 16, (192, 128), True, None),
    "mla_noncausal_g4": (1, 200, 333, 8, 2, (192, 128), False, None),
}
# The bf16 gradients lie within half a bf16 ulp of the plain backward run
# in float32 on the same (bf16) inputs, output and lse, plus BWD_F32_ATOL
# of the gradient's max |want| for float32 summation order (measured
# 1.25e-6 in float32); the float32 ones within BWD_F32_TOL of the float64
# gradient's max |want| (torch autograd of ``attention_f64``) and of the
# plain version's.  The lse within 1e-5 of torch.logsumexp of float64
# scores.
BWD_F32_ATOL, BWD_F32_TOL, LSE_TOL = 1e-5, 2e-5, 1e-5
# TinyLlama's training attention: a micro-batch of 4 x 4096, H 32 / KV 4,
# hd 64, causal (phase 5g (a)).
TRAIN_ATTN_SHAPE = (4, 4096, 4096, 32, 4, 64, True, None)
# Phase 5g (a): TinyLlama-1.1B at full width, train_4k's seq 4096 with its
# global batch cut from 256 to TRAIN_B, TRAIN_MICRO micro-batches, remat
# "full", dense CE, AdamW's defaults; one warm-up step, TRAIN_STEPS timed
# and one profiled.  (b) card vs CPU: TinyLlama's width cut to
# TRAIN_SMALL_LAYERS layers, float32, B x S = TRAIN_SMALL_SHAPE, three
# steps on each, within CARD_CPU_TOL or TRAIN_NOISE_FACTOR times what half
# a float32 ulp of noise moves the CPU run (``train_card_vs_cpu``: loss and
# grad norm relative CARD_CPU_TOL[0]; the first step's gradient and the
# final moments relative L2 and max over max |want|; parameters within
# PARAM_ATOL_LR * lr where |m| exceeds PARAM_KEEP of its max, since the
# first AdamW steps move a parameter by about lr * sign(g)).
TRAIN_B, TRAIN_MICRO, TRAIN_STEPS = 8, 2, 3
TRAIN_SMALL_LAYERS, TRAIN_SMALL_SHAPE, TRAIN_SMALL_STEPS = 2, (2, 256), 3
PARAM_KEEP, PARAM_ATOL_LR = 1e-2, 0.05
TRAIN_NOISE_FACTOR = 4.0


def plain_attention_bwd(q, k, v, o, lse, do, causal=True, window=None):
    """``ref.flash_attention_bwd_ref`` in float32 with ``plain_chunk``s."""
    from repro_torch.kernels import ref
    f = [x.float() for x in (q, k, v, o, do)]
    return ref.flash_attention_bwd_ref(
        *f[:4], lse, f[4], causal=causal, window=window,
        q_chunk=plain_chunk(q.shape[1]), k_chunk=plain_chunk(k.shape[1]))


def lse_f64(torch, q, k, causal, window):
    """torch.logsumexp of the float64 scaled, masked scores: (B, H, Sq)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    kd = k.double().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.double(), kd) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        keep &= qpos >= kpos
    if window:
        keep &= kpos > qpos - window
    return torch.logsumexp(s.masked_fill(~keep, -math.inf), dim=-1)


def _bwd_inputs(torch, case, dtype, seed=0):
    B, Sq, Sk, H, KV, hd, causal, window = case
    q, k, v = _qkv(torch, B, Sq, Sk, H, KV, hd, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    do = torch.randn((B, Sq, H, head_dims_of(hd)[1]), generator=g,
                     device="cuda").to(dtype)
    return q, k, v, do, causal, window


def bwd_launches(FA, f32, calls=1):
    """The launches of ``calls`` backward wrapper calls, float32 if
    ``f32`` else bf16: one backward entry each (its two kernels), float32
    after the four splits of q, k, v and do."""
    if f32:
        return launch_counts(FA, flash_attention_bwd_f32=calls,
                             split_bf16x3=4 * calls)
    return launch_counts(FA, flash_attention_bwd=calls)


def hold_attention_bwd(torch, name, q, k, v, do, causal, window, err,
                       vs_f64=True):
    """One case of phase 2c: the forward with its lse (whose o must equal
    the serving forward's bit for bit), the backward twice (bitwise
    equal, ``bwd_launches``), the lse against float64, the gradients
    against the plain backward (bf16: half an ulp + BWD_F32_ATOL; float32:
    BWD_F32_TOL) and, in float32 with ``vs_f64``, against float64
    autograd.  Folds the largest errors into ``err``: per dtype the max
    abs difference from the plain version, bf16's in half-ulps, float32's
    from float64 over max |grad| and from the plain version over it, the
    lse's."""
    from repro_torch.kernels import flash_attention as FA
    tname = str(q.dtype).split(".")[-1]
    o, lse, _ = FA._forward(q, k, v, causal, window, want_lse=True)
    if not torch.equal(o, FA.flash_attention(q, k, v, causal=causal,
                                             window=window)):
        raise AssertionError(f"attention backward {name} {tname}: the "
                             f"forward's output moved with its lse")
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    moved = {n: FA.LAUNCHES[n] - before[n] for n in FA.LAUNCHES}
    want_launch = bwd_launches(FA, q.dtype == torch.float32, calls=2)
    if moved != want_launch:
        raise AssertionError(f"attention backward {name} {tname} launched "
                             f"{moved}, expected {want_launch}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"attention backward {name} {tname}: two "
                             f"launches differ (not deterministic)")
    lse_err = (lse.double() - lse_f64(torch, q, k, causal, window)).abs()
    lse_err = lse_err.max().item()
    err["lse"] = max(err.get("lse", 0.0), lse_err)
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"attention backward {name} {tname}: lse is "
                             f"{lse_err} from float64 logsumexp")
    want = plain_attention_bwd(q, k, v, o, lse, do, causal, window)
    for part, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = max(1.0, w.abs().max().item())
        diff = (g.float() - w).abs()
        err[tname] = max(err.get(tname, 0.0), diff.max().item())
        if g.dtype != q.dtype or g.shape != w.shape:
            raise AssertionError(f"{name} {part}: {g.dtype} {g.shape}")
        if q.dtype == torch.bfloat16:
            ulps = (diff / (BF16_HALF_ULP * w.abs() + BWD_F32_ATOL * scale)
                    ).max().item()
            err["bf16_half_ulps"] = max(err.get("bf16_half_ulps", 0.0), ulps)
            ok = ulps <= 1.0
        else:
            rel = diff.max().item() / scale
            err["float32_vs_plain"] = max(err.get("float32_vs_plain", 0.0),
                                          rel)
            ok = rel <= BWD_F32_TOL
        if not ok:
            raise AssertionError(f"attention backward {name} {tname} {part}: "
                                 f"kernel != plain version (max abs diff "
                                 f"{diff.max().item()}, scale {scale})")
    if q.dtype == torch.float32 and vs_f64:
        leaves = [x.double().requires_grad_() for x in (q, k, v)]
        truth = torch.autograd.grad(
            attention_f64(*leaves, causal=causal, window=window), leaves,
            do.double())
        for part, g, t in zip(("dq", "dk", "dv"), got, truth):
            scale = max(1.0, t.abs().max().item())
            e = (g.double() - t).abs().max().item() / scale
            err["float32_vs_f64"] = max(err.get("float32_vs_f64", 0.0), e)
            if not e <= BWD_F32_TOL:
                raise AssertionError(f"attention backward {name} {part}: "
                                     f"float32 kernel {e} (of max |grad|) "
                                     f"from float64")


def check_attention_bwd(torch):
    """Phase 2c: the backward kernel (both dtypes) against its plain version
    at every BWD_CASES case (``hold_attention_bwd``); then at TinyLlama's
    training attention shape, held the same way, and timed in both dtypes
    beside the plain backward and SDPA's backward
    (``time_attention_bwd``).  Returns (err, {dtype: timings})."""
    err = {}
    for name, case in BWD_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, causal, window = _bwd_inputs(torch, case, dtype)
            hold_attention_bwd(torch, name, q, k, v, do, causal, window, err)
    torch.cuda.synchronize()
    print(f"phase 2c: attention backward == plain version at "
          f"{len(BWD_CASES)} shapes x 2 dtypes, deterministic; max errors "
          f"{err}", flush=True)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        times[str(dtype).split(".")[-1]] = time_attention_bwd(torch, dtype,
                                                               err)
    return err, times


def time_attention_bwd(torch, dtype, err):
    """At TRAIN_ATTN_SHAPE: the kernel held against the plain version
    (``hold_attention_bwd``; float32 without its float64 autograd, which
    would not fit here: it is held against float64 at the cases), then ms
    per call of the backward kernel's wrapper, of the plain backward and
    of scaled_dot_product_attention's backward (is_causal, enable_gqa;
    the yardstick, which the port never calls), CUDA events, beside the
    bound, and each of the call's kernels' device ms (``bwd_kernel_ms``).
    """
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    B, Sq, Sk, H, KV, hd, causal, window = TRAIN_ATTN_SHAPE
    tname = str(dtype).split(".")[-1]
    q, k, v, do, _, _ = _bwd_inputs(torch, TRAIN_ATTN_SHAPE, dtype, seed=1)
    o, lse, _ = FA._forward(q, k, v, causal, window, want_lse=True)
    hold_attention_bwd(torch, "training shape", q, k, v, do, causal, window,
                       err, vs_f64=False)
    b_ms, b_by = attention_bwd_bound_ms(*TRAIN_ATTN_SHAPE, tname)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    t = dict(
        ms=event_ms(torch, lambda: FA.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, window=window), 10),
        plain_ms=event_ms(torch, lambda: plain_attention_bwd(
            q, k, v, o, lse, do, causal, window), 2),
        library_ms=event_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 10),
        bound_ms=b_ms, bound_by=b_by,
        shape=dict(B=B, S=Sq, H=H, KV=KV, hd=hd, dtype=tname,
                   causal=causal))
    t["kernel_ms"] = bwd_kernel_ms(torch, lambda: FA.flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal, window=window), tname)
    split = " (" + ", ".join(f"{n} {ms:.4f}" for n, ms in
                             t["kernel_ms"].items()) + " ms)"
    print(f"phase 2c: attention backward at B {B} S {Sq} H {H} KV {KV} hd "
          f"{hd} {tname} causal: kernel {t['ms']:.3f} ms{split}, plain "
          f"{t['plain_ms']:.3f} ms, SDPA backward {t['library_ms']:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return t


# The backward's kernels by the name the profiler gives them (a part of
# it: each wgmma kernel is one template for both dtypes), with their
# launches per wrapper call: the dQ kernel and the dK / dV one; float32
# after the splits of q, k, v and do.
BWD_KERNELS = {"bfloat16": {"fa_bwd_dq_wgmma": 1, "fa_bwd_dkdv_wgmma": 1},
               "float32": {"split_bf16x3_kernel": 4, "fa_bwd_dq_wgmma": 1,
                           "fa_bwd_dkdv_wgmma": 1}}


def bwd_kernel_ms(torch, call, tname, n=5, tries=3):
    """Device ms per wrapper call of each backward kernel of dtype
    ``tname`` (``BWD_KERNELS``: the splits' together), from the profiler
    over ``n`` calls; fails unless each ran its launches a call.

    The profiler's trace can lose a kernel's record now and then (a
    float32 trace once held 19 of the 20 splits the wrapper launched), so
    a trace whose counts are off is taken again, up to ``tries`` traces in
    all, and printed; a wrapper that launches the wrong kernels is off in
    every trace and fails."""
    for attempt in range(1, tries + 1):
        us, _, top = device_ops(torch, lambda: [call() for _ in range(n)],
                                n_top=20)
        counts = {name: c for name, c, _ in top}
        ran = {kernel: sum(c for name, c in counts.items() if kernel in name)
               for kernel in BWD_KERNELS[tname]}
        off = {kernel: r for kernel, r in ran.items()
               if r != BWD_KERNELS[tname][kernel] * n}
        if not off:
            return {kernel: us(kernel) / 1e3 / n
                    for kernel in BWD_KERNELS[tname]}
        print(f"phase 2c: trace {attempt} of {n} {tname} backward calls "
              f"counts {off} against {BWD_KERNELS[tname]} a call: {top}",
              flush=True)
    raise AssertionError(f"phase 2c: {tname} backward kernel counts off in "
                         f"all {tries} traces of {n} calls: {off}")


# ---------------------------------------------------------------------------
# Phase 2d: the p_bf16 attention routes (JAX's flags.ATTN_P_BF16)
# ---------------------------------------------------------------------------

# JAX's p_bf16 function has no Pallas kernel: ``layers._attend_block``
# rounds p and v to bf16 in jnp (its backward, jax.vjp of it).
PB_REPLACES = "src/repro/models/layers.py:109"
# sha256 of the float32-p routes' results with the flag off, at
# TinyLlama's shape: phase 2b's prefill inputs (``_qkv``, seed 1; the
# forward's output and lse in bf16 and float32) and phase 2c's training
# inputs (``_bwd_inputs``, seed 1; dq, dk, dv), from a run of the parent
# commit (the routes before the p_bf16 ones were added) on an NVIDIA H100
# 80GB HBM3 at 700 W, ``default_route_digests`` against that commit's
# package: adding the p_bf16 routes must not move the default path's bits.
DEFAULT_ROUTE_DIGESTS = {
    "fwd bfloat16":
        "fe5bfd2f9e27281875151509d0c4bfe8dcf98b78716753a663d86af9716be216",
    "bwd bfloat16":
        "85109a3ad59c83459d8494e321564e929f6de9b49edf29849c029467f764c646",
    "fwd float32":
        "8d908f864cdfdd449b703ed85e7a2f20333ad55c3ba91b1abef2baaeff4f5c08",
    "bwd float32":
        "2be1030f6ff5a18d947d52429d416cd9b7dac57ed003a4b7bc3c6a1b8fbe807c",
}
# (B, Sq, Sk, H, KV, hd, causal, window) of the forward gate in both
# dtypes: TinyLlama's prefill (phase 2b's shape), the zoo's hd 128 and hd
# 80 heads and MLA's (192, 128) pair over two key chunks, and Zamba2-7B's
# shared attention (hd 112) over twice its 4,096-key window.
PB_FWD_CASES = {
    "tinyllama_prefill": (PREFILL_B, PREFILL_S, PREFILL_S, 32, 4, 64, True,
                          None),
    "hd128_g4": (1, 2048, 2048, 32, 8, 128, True, None),
    "hd80": (1, 2048, 2048, 32, 32, 80, True, None),
    "mla": (1, 2048, 2048, 16, 16, (192, 128), True, None),
    "zamba2_window": (1, 8192, 8192, 32, 32, 112, True, 4096),
}
# The tie cases (a name starting "ties", ``_pb_inputs``): q and k drawn
# from {-1, 0, 1}, so that every score is exact on the tensor cores and in
# the plain version alike and many rows' chunk maxima are tied between
# keys whose rows differ, over two key chunks; at TinyLlama's head dim and
# at MLA's (192, 128) pair, whose dQ tiles are narrower (bf16 32 keys,
# float32 16).
PB_TIE_CASES = {"ties_two_chunks": (2, 2048, 2048, 16, 4, 64, True, None),
                "ties_mla": (1, 2048, 2048, 4, 4, (192, 128), True, None)}
PB_FWD_CASES.update(PB_TIE_CASES)
# The backward gate's shapes: phase 2c's (one key chunk each), the tie
# cases and TinyLlama's training attention (four).
PB_BWD_CASES = dict(BWD_CASES, **PB_TIE_CASES, training=TRAIN_ATTN_SHAPE)
# The gate, fixed before the first run on the card: the kernel's distance
# from its plain version (relative L2 over the whole output or gradient)
# at most PB_SHARE of the flag's own effect (the plain version with the
# flag against without it), in both dtypes.  The bf16 forward's distance
# from the p_bf16 function run in float64 (``attention_pbf16_f64``) is
# reported in half-ulps beside the plain version's, and not gated: the
# function rounds p to bf16, so any float32 evaluation rounds a few p to
# the other side of a bf16 boundary than float64 does, and a p near 1 in
# a short causal row moves the output by up to 2^-8 |v|.  On the H100 the
# plain version itself sat 39 / 14 / 12 half-ulps from float64 at the
# TinyLlama / hd 80 / MLA cases (3,061 of 33.5M elements past half an
# ulp at TinyLlama's, the kernel 3,074; PERF.md), where phase 2b's
# float32-p gate asks for 1.
PB_SHARE = 0.25


@contextlib.contextmanager
def p_bf16_flag(on=True):
    """``models.flags.ATTN_P_BF16`` set for the block, restored after."""
    from repro_torch.models import flags
    old = flags.ATTN_P_BF16
    flags.ATTN_P_BF16 = on
    try:
        yield
    finally:
        flags.ATTN_P_BF16 = old


def _digest(torch, *tensors) -> str:
    """sha256 of the tensors' bytes (bf16 read as int16)."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def default_route_digests(torch):
    """sha256 of the flag-off routes' results at TinyLlama's shape
    (``DEFAULT_ROUTE_DIGESTS``' note): {"fwd <dtype>": out and lse, "bwd
    <dtype>": dq, dk, dv}."""
    from repro_torch.kernels import flash_attention as FA
    cfg = _tinyllama()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        q, k, v = _qkv(torch, PREFILL_B, PREFILL_S, PREFILL_S, cfg.n_heads,
                       cfg.n_kv_heads, cfg.resolved_head_dim, dtype, seed=1)
        res = FA._forward(q, k, v, True, None, want_lse=True)
        out[f"fwd {tname}"] = _digest(torch, res[0], res[1])
        del q, k, v, res
        q, k, v, do, causal, window = _bwd_inputs(torch, TRAIN_ATTN_SHAPE,
                                                  dtype, seed=1)
        res = FA._forward(q, k, v, causal, window, want_lse=True)
        grads = FA.flash_attention_bwd(q, k, v, res[0], res[1], do,
                                       causal=causal, window=window)
        out[f"bwd {tname}"] = _digest(torch, *grads)
        del q, k, v, do, res, grads
    torch.cuda.synchronize()
    return out


def pb_plain(q, k, v, causal, window, p_bf16=True, return_lse=False):
    """The plain version (``ref.flash_attention_ref``) with or without the
    flag's function, over JAX's chunks (``plain_chunk``: min(1024, S))."""
    from repro_torch.kernels import ref
    return ref.flash_attention_ref(
        q, k, v, causal=causal, window=window, p_bf16=p_bf16,
        return_lse=return_lse, q_chunk=plain_chunk(q.shape[1]),
        k_chunk=plain_chunk(k.shape[1]))


def pb_plain_bwd(q, k, v, o, lse, do, causal, window, p_bf16=True):
    from repro_torch.kernels import ref
    return ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=causal, window=window, p_bf16=p_bf16,
        q_chunk=plain_chunk(q.shape[1]), k_chunk=plain_chunk(k.shape[1]))


def attention_pbf16_f64(q, k, v, causal=True, window=None):
    """The p_bf16 function run in float64 on the (exactly upcast) inputs:
    JAX's chunks, each chunk's p = exp(s - m_b) in float64 rounded to
    bf16 against the chunk's row max, times bf16(v), the chunks merged in
    float64 -> (B, Sq, H, hd_v) float64."""
    import torch
    from repro_torch.kernels import ref
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    qc, kc = plain_chunk(Sq), plain_chunk(Sk)
    kd = k.double().repeat_interleave(G, dim=2)
    vb = v.to(torch.bfloat16).double().repeat_interleave(G, dim=2)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi, q0, kis in ref._chunks(Sq, Sk, qc, kc, causal, window):
        qd = q[:, qi * qc:(qi + 1) * qc].double()
        qpos = q0 + torch.arange(qc, device=q.device)
        acc = torch.zeros((B, H, qc, v.shape[3]), dtype=torch.float64,
                          device=q.device)
        m = torch.full((B, H, qc), -1e30, dtype=torch.float64,
                       device=q.device)
        l = torch.zeros_like(m)
        for ki in kis:
            ks = slice(ki * kc, (ki + 1) * kc)
            kpos = ki * kc + torch.arange(kc, device=q.device)
            keep = ref._mask(qpos, kpos, causal, window)
            s = torch.einsum("bqhd,bshd->bhqs", qd, kd[:, ks]) * scale
            s = torch.where(keep, s, -1e30)
            m_b = s.amax(dim=-1)
            p = torch.exp(s - m_b[..., None])
            o_b = torch.einsum("bhqs,bshd->bhqd",
                               p.to(torch.bfloat16).double(), vb[:, ks])
            m_new = torch.maximum(m, m_b)
            alpha, beta = torch.exp(m - m_new), torch.exp(m_b - m_new)
            acc = acc * alpha[..., None] + o_b * beta[..., None]
            l = l * alpha + p.sum(-1) * beta
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None]).transpose(1, 2))
    return torch.cat(outs, dim=1)


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def pb_launches(FA, f32, calls=1, bwd=False):
    """The launches of ``calls`` p_bf16 wrapper calls (forward, or the
    backward alone with ``bwd``): the route's entry each, float32 after
    three (forward) or four (backward) splits."""
    key = ("flash_attention_bwd" if bwd else "flash_attention") + (
        "_f32_pbf16" if f32 else "_pbf16")
    counts = {key: calls}
    if f32:
        counts["split_bf16x3"] = (4 if bwd else 3) * calls
    return launch_counts(FA, **counts)


def _tie_qk(torch, q, k, seed):
    """q and k of the same shapes and dtype drawn from {-1, 0, 1}."""
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    return [torch.randint(-1, 2, x.shape, generator=g, device="cuda").to(
        x.dtype) for x in (q, k)]


def _pb_inputs(torch, name, case, dtype, seed=0):
    """(q, k, v, do, causal, window) of a phase 2d case: ``_bwd_inputs``'s,
    with q and k from ``_tie_qk`` for a tie case (a name starting
    "ties")."""
    q, k, v, do, causal, window = _bwd_inputs(torch, case, dtype, seed)
    if name.startswith("ties"):
        q, k = _tie_qk(torch, q, k, seed)
    return q, k, v, do, causal, window


def tied_rows(torch, q, k, causal, window):
    """(rows, keys) a tie touches: boolean (B, Sq, H) of the query rows
    with a tied maximal score in some key chunk and (B, Sk, KV) of the
    keys holding such a tie (``ref.chunk_max_stats`` over JAX's chunks,
    whose scores these are)."""
    from repro_torch.kernels import ref
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kc = plain_chunk(Sk)
    st = ref.chunk_max_stats(q, k, causal=causal, window=window, k_chunk=kc)
    tied = st[..., 3] > 1                                 # (B, H, Sq, NC)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()
                     .repeat_interleave(H // KV, 2)) * (1.0 / math.sqrt(hd))
    keep = ref._mask(torch.arange(Sq, device=q.device),
                     torch.arange(Sk, device=q.device), causal, window)
    keys = torch.zeros((B, H, Sk), dtype=torch.bool, device=q.device)
    for c in range(st.shape[3]):
        ks = slice(c * kc, (c + 1) * kc)
        hit = (s[..., ks] == st[..., c, :1]) & tied[..., c:c + 1] & keep[:, ks]
        keys[..., ks] |= hit.any(2)
    del s
    keys = keys.transpose(1, 2).reshape(B, Sk, KV, H // KV).any(-1)
    return tied.any(-1).transpose(1, 2), keys


def hold_pbf16_ties(torch, name, q, k, v, o, lse, do, got, plain, off,
                    causal, window, err):
    """The tie case's own gate, on the rows a tie touches (``tied_rows``):
    dQ's and dK's rel-L2 from the plain p_bf16 backward there within
    PB_SHARE of the flag's effect there, and nearer to it than the plain
    backward that gives T whole to the first maximal key (``split_ties=
    False``, not JAX's rule).  dV does not depend on T.  Folds (kernel,
    first-key rule) shares into ``err``."""
    from repro_torch.kernels import ref
    tname = str(q.dtype).split(".")[-1]
    rows, keys = tied_rows(torch, q, k, causal, window)
    if not (rows.any() and keys.any()):
        raise AssertionError(f"phase 2d {name}: the tie case has no tie")
    first = ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=causal, window=window, p_bf16=True,
        split_ties=False, q_chunk=plain_chunk(q.shape[1]),
        k_chunk=plain_chunk(k.shape[1]))
    out = {"tied dq rows": int(rows.sum()), "tied dk rows": int(keys.sum())}
    for part, r, g, w, w0, f in (("dq", rows, got[0], plain[0], off[0],
                                  first[0]),
                                 ("dk", keys, got[1], plain[1], off[1],
                                  first[1])):
        effect = _rel_l2(w[r], w0[r])
        share, share_first = _rel_l2(g[r], w[r]) / effect, _rel_l2(
            f[r], w[r]) / effect
        out[part] = [share, share_first]
        if not (share <= PB_SHARE and share < share_first):
            err.setdefault(f"ties {tname}", {})[name] = out
            raise AssertionError(
                f"phase 2d {name} {tname} {part} on its {int(r.sum())} tied "
                f"rows: kernel {share:.4f} of the flag's effect from the "
                f"plain version, the first-key rule {share_first:.4f} "
                f"(limit {PB_SHARE}, and below the first-key rule)")
    err.setdefault(f"ties {tname}", {})[name] = out


def hold_pbf16_mstat(torch, name, q, k, ms, causal, window):
    """The tie case's chunk statistics: on its exact scores the forward's
    mstat equals ``ref.chunk_max_stats`` (chunk max, first and last
    maximal key, their count) bit for bit."""
    from repro_torch.kernels import ref
    want = ref.chunk_max_stats(q, k, causal=causal, window=window)
    if not torch.equal(ms, want):
        bad = (ms != want).any(-1)
        raise AssertionError(f"phase 2d {name}: mstat differs from "
                             f"ref.chunk_max_stats at {int(bad.sum())} "
                             f"(row, chunk)s")


def hold_pbf16_fwd(torch, name, case, dtype, err):
    """One forward gate: two wrapper calls under the flag (launches, bits
    equal); rel-L2 from the plain p_bf16 version within PB_SHARE of the
    flag's effect; bf16 also reports the kernel's and the plain version's
    largest distance from the float64 run (``attention_pbf16_f64``) in
    half a bf16 ulp plus F32_ATOL, and how many elements lie past it.
    Folds errors into ``err``."""
    from repro_torch.kernels import flash_attention as FA
    B, Sq, Sk, H, KV, hd, causal, window = case
    tname = str(dtype).split(".")[-1]
    q, k, v = _qkv(torch, B, Sq, Sk, H, KV, hd, dtype, seed=2)
    if name.startswith("ties"):
        q, k = _tie_qk(torch, q, k, 2)
    before = dict(FA.LAUNCHES)
    with p_bf16_flag():
        got = FA.flash_attention(q, k, v, causal=causal, window=window)
        again = FA.flash_attention(q, k, v, causal=causal, window=window)
    moved = {n: FA.LAUNCHES[n] - before[n] for n in FA.LAUNCHES}
    want = pb_launches(FA, dtype == torch.float32, calls=2)
    if moved != want:
        raise AssertionError(f"phase 2d {name} {tname}: launched {moved}, "
                             f"expected {want}")
    if not torch.equal(got, again):
        raise AssertionError(f"phase 2d {name} {tname}: two launches "
                             f"differ")
    plain = pb_plain(q, k, v, causal, window)
    effect = _rel_l2(plain, pb_plain(q, k, v, causal, window, False))
    share = _rel_l2(got, plain) / effect
    key = f"fwd {tname}"
    err.setdefault(key, {})[name] = share
    diff = (got.float() - plain.float()).abs().max().item()
    err[f"max_abs {key}"] = max(err.get(f"max_abs {key}", 0.0), diff)
    if not share <= PB_SHARE:
        raise AssertionError(f"phase 2d {name} {tname}: kernel is "
                             f"{share:.4f} of the flag's effect from the "
                             f"plain version (limit {PB_SHARE})")
    if dtype == torch.float32:
        return
    truth = attention_pbf16_f64(q, k, v, causal, window)
    for who, x in (("kernel", got), ("plain", plain)):
        ulps = ((x.double() - truth).abs()
                / (BF16_HALF_ULP * truth.abs() + F32_ATOL))
        err.setdefault(f"fwd bfloat16 vs float64 {who}", {})[name] = [
            ulps.max().item(), (ulps > 1).sum().item(), ulps.numel()]


def hold_pbf16_bwd(torch, name, case, dtype, err):
    """One backward gate: the p_bf16 forward with its lse and chunk
    statistics, the backward twice (launches, bits equal), each gradient's
    rel-L2 from the plain p_bf16 backward (on the kernel's o and lse, in
    the dtype) within PB_SHARE of the flag's effect on it (the plain
    backward of each function from its own plain forward); a tie case
    also ``hold_pbf16_ties`` and ``hold_pbf16_mstat``."""
    from repro_torch.kernels import flash_attention as FA
    tname = str(dtype).split(".")[-1]
    q, k, v, do, causal, window = _pb_inputs(torch, name, case, dtype)
    with p_bf16_flag():
        o, lse, ms = FA._forward(q, k, v, causal, window, want_lse=True,
                                 p_bf16=True)
        if not torch.equal(o, FA.flash_attention(q, k, v, causal=causal,
                                                 window=window)):
            raise AssertionError(f"phase 2d {name} {tname}: the p_bf16 "
                                 f"forward's output moved with its lse")
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window, p_bf16=True, mstat=ms)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window, p_bf16=True, mstat=ms)
    moved = {n: FA.LAUNCHES[n] - before[n] for n in FA.LAUNCHES}
    want = pb_launches(FA, dtype == torch.float32, calls=2, bwd=True)
    if moved != want:
        raise AssertionError(f"phase 2d {name} {tname} backward: launched "
                             f"{moved}, expected {want}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"phase 2d {name} {tname} backward: two "
                             f"launches differ")
    plain = pb_plain_bwd(q, k, v, o, lse, do, causal, window)
    o0, lse0 = pb_plain(q, k, v, causal, window, False, return_lse=True)
    off = pb_plain_bwd(q, k, v, o0, lse0, do, causal, window, False)
    for part, g, w, w0 in zip(("dq", "dk", "dv"), got, plain, off):
        if not torch.isfinite(g).all():
            raise AssertionError(f"phase 2d {name} {tname} {part}: not "
                                 f"finite")
        share = _rel_l2(g, w) / _rel_l2(w, w0)
        err.setdefault(f"bwd {tname}", {})[f"{name} {part}"] = share
        diff = (g.float() - w.float()).abs().max().item()
        err[f"max_abs bwd {tname}"] = max(
            err.get(f"max_abs bwd {tname}", 0.0), diff)
        if not share <= PB_SHARE:
            raise AssertionError(f"phase 2d {name} {tname} {part}: kernel "
                                 f"is {share:.4f} of the flag's effect from "
                                 f"the plain version (limit {PB_SHARE})")
    if name.startswith("ties"):
        hold_pbf16_ties(torch, name, q, k, v, o, lse, do, got, plain, off,
                        causal, window, err)
        hold_pbf16_mstat(torch, name, q, k, ms, causal, window)


def time_pbf16(torch):
    """At TinyLlama's prefill shape (forward) and training shape
    (backward), each dtype: the p_bf16 route beside the float32-p route,
    the plain p_bf16 version and SDPA (forward and backward; timed only,
    the port never calls it), CUDA events, with the bound of
    ``launch/dryrun.py``, and each backward kernel's device ms
    (``bwd_kernel_ms``).  Returns {"fwd <dtype>" / "bwd <dtype>":
    timings}."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    B, S, _, H, KV, hd, causal, window = PB_FWD_CASES["tinyllama_prefill"]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        q, k, v = _qkv(torch, B, S, S, H, KV, hd, dtype, seed=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        b_ms, b_by = attention_bound_ms(B, S, S, H, KV, (hd, hd), True,
                                        None, tname)
        with p_bf16_flag():
            ms = event_ms(torch, lambda: FA.flash_attention(q, k, v), 10)
        t = out[f"fwd {tname}"] = dict(
            ms=ms,
            float32_p_ms=event_ms(torch, lambda: FA.flash_attention(
                q, k, v), 10),
            plain_ms=event_ms(torch, lambda: pb_plain(q, k, v, True, None),
                              2),
            library_ms=event_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10),
            bound_ms=b_ms, bound_by=b_by,
            shape=dict(B=B, S=S, H=H, KV=KV, hd=hd, dtype=tname,
                       causal=True))
        print(f"phase 2d: p_bf16 attention at B {B} S {S} H {H} KV {KV} hd "
              f"{hd} {tname} causal: kernel {t['ms']:.4f} ms, float32-p "
              f"route {t['float32_p_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        del q, k, v, qt, kt, vt
        Bt, Sq, Sk, Ht, KVt, hdt, causal, window = TRAIN_ATTN_SHAPE
        q, k, v, do, _, _ = _bwd_inputs(torch, TRAIN_ATTN_SHAPE, dtype,
                                        seed=1)
        with p_bf16_flag():
            o, lse, mst = FA._forward(q, k, v, causal, window,
                                      want_lse=True, p_bf16=True)
        o0, lse0, _ = FA._forward(q, k, v, causal, window, want_lse=True)
        b_ms, b_by = attention_bwd_bound_ms(*TRAIN_ATTN_SHAPE, tname)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        dot = do.transpose(1, 2)
        call = lambda: FA.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, causal=causal, window=window, p_bf16=True,
            mstat=mst)
        t = out[f"bwd {tname}"] = dict(
            ms=event_ms(torch, call, 10),
            float32_p_ms=event_ms(torch, lambda: FA.flash_attention_bwd(
                q, k, v, o0, lse0, do, causal=causal, window=window), 10),
            plain_ms=event_ms(torch, lambda: pb_plain_bwd(
                q, k, v, o, lse, do, causal, window), 1),
            library_ms=event_ms(torch, lambda: torch.autograd.grad(
                sd, (qt, kt, vt), dot, retain_graph=True), 10),
            bound_ms=b_ms, bound_by=b_by,
            kernel_ms=bwd_kernel_ms(torch, call, tname),
            shape=dict(B=Bt, S=Sq, H=Ht, KV=KVt, hd=hdt, dtype=tname,
                       causal=causal))
        split = ", ".join(f"{n} {x:.4f}" for n, x in t["kernel_ms"].items())
        print(f"phase 2d: p_bf16 attention backward at B {Bt} S {Sq} H {Ht} "
              f"KV {KVt} hd {hdt} {tname} causal: kernel {t['ms']:.3f} ms "
              f"({split} ms), float32-p route {t['float32_p_ms']:.3f} ms, "
              f"plain {t['plain_ms']:.3f} ms, SDPA backward "
              f"{t['library_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        del q, k, v, do, o, lse, mst, o0, lse0, qt, kt, vt, sd
    return out


def check_attention_pbf16(torch):
    """Phase 2d: the flag-off routes' results at TinyLlama's shape equal
    the parent commit's (``DEFAULT_ROUTE_DIGESTS``); the p_bf16 forward at
    every PB_FWD_CASES case and the backward at every PB_BWD_CASES case,
    both dtypes, against their plain versions (``hold_pbf16_fwd`` /
    ``hold_pbf16_bwd``); then ``time_pbf16``.  Returns (err, times)."""
    digests = default_route_digests(torch)
    if digests != DEFAULT_ROUTE_DIGESTS:
        raise AssertionError(f"phase 2d: the float32-p routes' results at "
                             f"TinyLlama's shape moved: {digests}, parent "
                             f"{DEFAULT_ROUTE_DIGESTS}")
    print(f"phase 2d: flag off, the float32-p routes' results at "
          f"TinyLlama's shape equal the parent commit's bit for bit "
          f"({len(digests)} sha256)", flush=True)
    err = {}
    for name, case in PB_FWD_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            hold_pbf16_fwd(torch, name, case, dtype, err)
            torch.cuda.empty_cache()
    for name, case in PB_BWD_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            hold_pbf16_bwd(torch, name, case, dtype, err)
    torch.cuda.synchronize()
    print(f"phase 2d: p_bf16 routes == plain version (share of the flag's "
          f"effect <= {PB_SHARE}) at {len(PB_FWD_CASES)} forward and "
          f"{len(PB_BWD_CASES)} backward shapes x 2 dtypes, deterministic; "
          f"the bf16 forward's and the plain version's half-ulps from "
          f"float64 reported: {json.dumps(err)}", flush=True)
    return err, time_pbf16(torch)


def train_profile(torch, run):
    """``device_ops`` over ``run()`` (one train step): device ms, the
    attention kernels' share (forward ``fa_fwd_wgmma``, backward
    ``fa_bwd_``) and the backward's alone, each's ms, the backward's by
    kernel, the splits' ms (float32: the forward's and the backward's
    together), and the ten costliest device operations."""
    us, total, top = device_ops(torch, run)
    if not total:
        raise AssertionError("the profiler saw no device time in a train "
                             "step")
    fwd, bwd = us("fa_fwd_wgmma"), us("fa_bwd_")
    return {"device_ms": total / 1e3,
            "attention_share_of_device_time": (fwd + bwd) / total,
            "attention_bwd_share_of_device_time": bwd / total,
            "attention_fwd_ms": fwd / 1e3, "attention_bwd_ms": bwd / 1e3,
            "attention_bwd_ms_by_kernel": {k: us(k) / 1e3
                                           for k in BWD_KERNELS["bfloat16"]},
            "split_ms": us("split_bf16x3_kernel") / 1e3,
            "top_device_ops": top}


def train_step_launches(FA, f32, n_attn):
    """A train step's attention launches with ``n_attn`` attention calls
    (layers times micro-batches): 2 forward launches a call, the forward
    and its remat recompute, and one backward; float32 with the splits,
    three a forward and four a backward."""
    if f32:
        return launch_counts(FA, flash_attention_f32=2 * n_attn,
                             split_bf16x3=10 * n_attn,
                             flash_attention_bwd_f32=n_attn)
    return launch_counts(FA, flash_attention=2 * n_attn,
                         flash_attention_bwd=n_attn)


def train_full_width(torch, dtype=None):
    """Phase 5g (a) in bf16 (the default) and (c) in float32:
    TinyLlama-1.1B at full width in ``dtype`` trained through
    ``launch.train.train_loop`` with the registry's train step: seq 4096,
    TRAIN_B sequences in TRAIN_MICRO micro-batches, remat "full", dense
    CE, AdamW's defaults; one warm-up step, TRAIN_STEPS timed steps (the
    launches counted per step, ``train_step_launches``), one profiled.
    Returns (launches of the timed steps, result)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as LT
    from repro_torch.models import flags, registry
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import adamw_init
    assert flags.REMAT_MODE == "full" and flags.CE_MODE == "dense"
    dtype = dtype or torch.bfloat16
    tname = str(dtype).split(".")[-1]
    cfg = _tinyllama()
    shape = ShapeConfig("train_4k cut", PREFILL_S, TRAIN_B, "train")
    model, _, init_s = init_on_card(torch, cfg, "phase 5g", dtype)
    M.make_trainable(model)
    opt = adamw_init(M.stacked_params(model))
    step_fn = registry.make_step(cfg, shape, n_micro=TRAIN_MICRO)
    log = []
    loop = dict(data_cfg=DataConfig(0), device="cuda", log_every=1,
                log=log.append)
    t0 = time.perf_counter()
    opt, rc = LT.train_loop(cfg, shape, model, opt, step_fn, start_step=0,
                            steps=1, **loop)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    per_step, metrics = [], []

    def on_step(step, m):
        torch.cuda.synchronize()
        per_step.append(dict(FA.LAUNCHES))
        metrics.append({k: float(v) for k, v in m.items()})
        FA.reset_launches()

    FA.reset_launches()
    t0 = time.perf_counter()
    opt, rc2 = LT.train_loop(cfg, shape, model, opt, step_fn, start_step=1,
                             steps=1 + TRAIN_STEPS, on_step=on_step, **loop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: sum(p[n] for p in per_step) for n in FA.LAUNCHES}
    want = train_step_launches(FA, dtype == torch.float32,
                               cfg.n_layers * TRAIN_MICRO)
    if rc or rc2 or any(p != want for p in per_step):
        raise AssertionError(f"phase 5g: rc {rc} {rc2}, launches per step "
                             f"{per_step}, expected {want}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics):
        raise AssertionError(f"phase 5g: non-finite step {metrics}")
    profile = train_profile(torch, lambda: LT.train_loop(
        cfg, shape, model, opt, step_fn, start_step=1 + TRAIN_STEPS,
        steps=2 + TRAIN_STEPS, **loop))
    tokens = TRAIN_B * PREFILL_S
    res = {"model": cfg.name, "layers": cfg.n_layers, "dtype": tname,
           "seq": PREFILL_S, "global_batch": TRAIN_B, "n_micro": TRAIN_MICRO,
           "reduced": {"global_batch": [256, TRAIN_B]}, "remat": "full",
           "ce": "dense", "init_s": init_s, "warmup_step_s": warm_s,
           "step_s": wall / TRAIN_STEPS, "tokens_per_s":
               TRAIN_STEPS * tokens / wall,
           "steps": metrics, "launches_per_step": want,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **profile,
           "log": log}
    share = profile["attention_share_of_device_time"]
    by_kernel = ", ".join(f"{k} {ms:.1f}" for k, ms in
                          profile["attention_bwd_ms_by_kernel"].items())
    print(f"phase 5g: {cfg.name} at full width in {tname}, {TRAIN_B} x "
          f"{PREFILL_S} in {TRAIN_MICRO} micro-batches: "
          f"{res['tokens_per_s']:.0f} tokens/s ({res['step_s']:.3f} s a "
          f"step), device {profile['device_ms']:.1f} ms a step, attention "
          f"{share:.3f} of it (forward {profile['attention_fwd_ms']:.1f} ms, "
          f"backward {profile['attention_bwd_ms']:.1f} ms, "
          f"{profile['attention_bwd_share_of_device_time']:.3f} of the step:"
          f" {by_kernel}; splits {profile['split_ms']:.1f} ms), peak "
          f"{res['peak_gb']:.1f} GB; steps {metrics}; launches per step "
          f"{want}", flush=True)
    print("phase 5g: top device ops " + json.dumps(profile["top_device_ops"]),
          flush=True)
    for line in log:
        print(f"phase 5g: {line}", flush=True)
    del model, opt
    torch.cuda.empty_cache()
    return launches, res


def _tree_distance(got, want):
    """Worst relative L2 and worst max |got - want| over max |want| of
    two lists of tensors."""
    rel = elem = 0.0
    for a, b in zip(got, want):
        rel = max(rel, ((a - b).norm() / b.norm()).item())
        elem = max(elem, ((a - b).abs().max() / b.abs().max()).item())
    return rel, elem


def _params_over_lr(got, want, m, lr):
    """Worst |got - want| over lr of parameter leaves where |m| exceeds
    PARAM_KEEP of its max (the first AdamW steps move a parameter by about
    lr * sign(g), so only a clear gradient fixes the update)."""
    worst = 0.0
    for a, b, mm in zip(got, want, m):
        keep = mm.abs() > PARAM_KEEP * mm.abs().max()
        if keep.any():
            worst = max(worst, (a - b).abs()[keep].max().item() / lr)
    return worst


def _train_distances(torch, got, want, lr):
    """How far one train run lies from another.  A run is (per-step
    metrics, the final [params, m, v] leaves, [params, m] after the first
    step).  The first step: its grad norm's relative difference, its
    gradient (m after it: (1 - b1) g times the clip scale) as relative L2
    and max over max |want|, the parameters over lr (``_params_over_lr``).
    Every step's loss, relatively.  The trajectory: every step's grad
    norm, the final moments and parameters."""
    (gm, gs, g1), (wm, ws, w1) = got, want

    def rel(key, a, b):
        return abs(a[key] - b[key]) / abs(b[key])
    d = {"loss": max(rel("loss", a, b) for a, b in zip(gm, wm)),
         "first_grad_norm": rel("grad_norm", gm[0], wm[0])}
    d["first_grad_rel_l2"], d["first_grad_max"] = _tree_distance(g1[1],
                                                                 w1[1])
    d["first_params_over_lr"] = _params_over_lr(g1[0], w1[0], w1[1], lr)
    d["grad_norm"] = max(rel("grad_norm", a, b) for a, b in zip(gm, wm))
    d["moments_rel_l2"], d["moments_max"] = _tree_distance(
        gs[1] + gs[2], ws[1] + ws[2])
    d["params_over_lr"] = _params_over_lr(gs[0], ws[0], ws[1], lr)
    return d


# The trajectory distances of ``_train_distances``: held only where half
# a float32 ulp of noise moves the final moments by at most TRAIN_CHAOS
# (relative L2); beyond it the run is chaotic after its first step.
TRAJECTORY = ("grad_norm", "moments_rel_l2", "moments_max", "params_over_lr")
TRAIN_CHAOS = 1e-2


def train_card_vs_cpu(torch, cfg=None, shape=TRAIN_SMALL_SHAPE,
                      steps=TRAIN_SMALL_STEPS):
    """Phase 5g (b): a float32 model (default TinyLlama's width cut to
    TRAIN_SMALL_LAYERS layers; the same weights on both, drawn on the CPU)
    trained ``steps`` steps of ``shape`` (B, S) on the card and on the CPU
    on the same batches.  Each distance of ``_train_distances`` must lie
    within its tolerance (CARD_CPU_TOL[0] for losses, grad norms and
    relative L2s, CARD_CPU_TOL[1] for the maxima, PARAM_ATOL_LR for the
    parameters) or, where larger, TRAIN_NOISE_FACTOR times the distance
    the CPU run moves under ``half_ulp_noise``.  The card differs from
    the CPU at every operation (cuBLAS's summation order, the attention's
    six-pass products within 2^-23 of each float32 product), not only at
    the blocks' inputs, hence a factor of 4.  The first step and every
    loss are always held; the trajectory (``TRAJECTORY``) only where the
    noise moves the final moments by at most TRAIN_CHAOS.  At the
    reference's init (std 1 / sqrt(n_layers) over the stacked layers) a
    2-layer model at full width has scores in the thousands: the first
    AdamW step moves every parameter by about lr * sign(g), so half an ulp
    of noise, which flips the sign of small gradients, moves the next
    steps' gradients by tens of percents (their distances are reported;
    on the smoke config they are held).  The card's path launches the
    float32 forward twice a layer and step and the float32 backward once.
    Returns (launches, result)."""
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             tree_leaves)
    from repro_torch.train.step import make_train_step
    cfg = cfg or _tinyllama().scaled(n_layers=TRAIN_SMALL_LAYERS)
    B, S = shape
    cut = ShapeConfig("train small", S, B, "train")
    opt_cfg = AdamWConfig(warmup_steps=2)

    def copies(tree):
        # copies: on the CPU .cpu() would alias the tensors updated later
        return [x.detach().to("cpu", copy=True) for x in tree_leaves(tree)]

    def run(device):
        model = M.make_trainable(M.init_params(
            cfg, torch.Generator().manual_seed(0), torch.float32, device))
        opt = adamw_init(M.stacked_params(model))
        step = make_train_step(cfg, opt_cfg)
        out = []
        for s in range(steps):
            opt, m = step(model, opt, batch_for_step(cfg, cut, s,
                                                     device=device))
            out.append({k: float(v) for k, v in m.items()})
            if s == 0:
                first = [copies(M.stacked_params(model)), copies(opt.m)]
        return out, [copies(t) for t in (M.stacked_params(model), opt.m,
                                         opt.v)], first

    cpu = run("cpu")
    with half_ulp_noise(torch):
        noisy = run("cpu")
    FA.reset_launches()
    card = run("cuda")
    launches = dict(FA.LAUNCHES)
    n = steps * cfg.n_layers
    want = train_step_launches(FA, True, n)
    if launches != want:
        raise AssertionError(f"{cfg.name} training launched {launches}, "
                             f"expected {want}")
    l2, elem = CARD_CPU_TOL
    tol = {"loss": l2, "first_grad_norm": l2, "first_grad_rel_l2": l2,
           "first_grad_max": elem, "first_params_over_lr": PARAM_ATOL_LR,
           "grad_norm": l2, "moments_rel_l2": l2, "moments_max": elem,
           "params_over_lr": PARAM_ATOL_LR}
    got = _train_distances(torch, card, cpu, opt_cfg.lr)
    noise = _train_distances(torch, noisy, cpu, opt_cfg.lr)
    chaotic = noise["moments_rel_l2"] > TRAIN_CHAOS
    bound = {k: max(t, TRAIN_NOISE_FACTOR * noise[k])
             for k, t in tol.items() if not (chaotic and k in TRAJECTORY)}
    bad = {k: got[k] for k in bound if not got[k] <= bound[k]}
    if bad:
        raise AssertionError(f"{cfg.name} float32 training: card != CPU "
                             f"{bad} (bounds {bound}, half an ulp of noise "
                             f"{noise})")
    held = ("chaotic after its first step: the trajectory reported, not "
            "held" if chaotic else "the trajectory held")
    print(f"phase 5g: {cfg.name}, {cfg.n_layers} layers, float32, {steps} "
          f"steps of {B} x {S}: card == CPU ({held}), distances {got}; "
          f"bounds {bound}; half an ulp of noise on the CPU: {noise}; card "
          f"steps {card[0]}, CPU steps {cpu[0]}; launches {launches}",
          flush=True)
    return launches, {"card": card[0], "cpu": cpu[0], "distances": got,
                      "noise": noise, "bounds": bound, "chaotic": chaotic}


def run_training(torch):
    """Phase 5g: (a) ``train_full_width`` in bf16, (b)
    ``train_card_vs_cpu``, (c) ``train_full_width`` in float32, each
    path's launches counted from 0.  Returns ({path: launches}, {path:
    result})."""
    launches, results = {}, {}
    t = time.perf_counter()
    launches[ARCH], results[ARCH] = train_full_width(torch)
    print(f"phase 5g (a): full width took {time.perf_counter() - t:.1f} s",
          flush=True)
    key = f"{ARCH} float32 {TRAIN_SMALL_LAYERS} layers"
    launches[key], results[key] = train_card_vs_cpu(torch)
    t = time.perf_counter()
    key = f"{ARCH} float32"
    launches[key], results[key] = train_full_width(torch, torch.float32)
    print(f"phase 5g (c): float32 full width took "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return launches, results


# ---------------------------------------------------------------------------
# Phase 7: the pod tools on the card (launch/dryrun, roofline, hillclimb,
# train/grad_compress, launch/sharding, launch/elastic)
# ---------------------------------------------------------------------------

# Phase 7 (b): 5g (a)'s cell under every remat mode and two micro-batch
# counts; HILLCLIMB_STEPS timed steps after a warm-up each.
HILLCLIMB_REMAT = ("full", "dots", "none")
HILLCLIMB_MICRO = (2, 4)
HILLCLIMB_STEPS = 2


def train_shape():
    """Phase 5g (a)'s cell: ``train_4k``'s seq, global batch cut to
    TRAIN_B."""
    from repro_torch.models.config import ShapeConfig
    return ShapeConfig("train_4k cut", PREFILL_S, TRAIN_B, "train")


def roofline_vs_card(what, fit, device_ms, peak_bytes):
    """Phase 7 (a): one cell's meta roofline (``dryrun.lower_cell``) beside
    the device ms and peak bytes the card measured for it."""
    bound_ms = 1e3 * max(fit["compute_s"], fit["memory_s"],
                         fit["collective_s"])
    fit_peak = fit["per_device_bytes"]["peak"]
    row = {"cell": what, "compute_ms": fit["compute_s"] * 1e3,
           "memory_ms": fit["memory_s"] * 1e3, "dominant": fit["dominant"],
           "bound_ms": bound_ms, "counted_flops": fit["hlo_flops"],
           "flops_by_peak": fit["flops_by_peak"],
           "counted_bytes": fit["hlo_bytes"],
           "attention_calls": fit["attention_calls"],
           "measured_device_ms": device_ms,
           "bound_over_measured": bound_ms / device_ms,
           "fit_bytes": fit["per_device_bytes"],
           "measured_peak_bytes": peak_bytes,
           "fit_over_peak": fit_peak / peak_bytes}
    print("phase 7 (a): " + json.dumps(row), flush=True)
    return row


def prefill_peak(torch, cfg):
    """Peak allocated bytes of one bf16 prefill of phase 5's cell alone:
    the model on the card, the peak reset after its init, one prefill."""
    model, rng, _ = init_on_card(torch, cfg, "phase 7 (a)")
    inputs, prefill = prefill_step(torch, cfg)
    batch = inputs(rng)
    torch.cuda.reset_peak_memory_stats()
    prefill(model, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del model, batch
    torch.cuda.empty_cache()
    return peak


def roofline_on_card(torch, served, trained):
    """Phase 7 (a): the meta roofline and fit of TinyLlama's bf16 prefill
    (phase 5: its profiled device ms; its peak from ``prefill_peak``) and
    of phase 5g (a) / (c)'s train steps (bf16 / float32, 8 x 4096 in 2
    micro-batches, remat "full": their profiled device ms and peak)."""
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.models.config import ShapeConfig
    cfg = _tinyllama()
    rows = {}
    fit = dryrun.lower_cell(ARCH, ShapeConfig(
        "prefill_32k cut", PREFILL_S, PREFILL_B, "prefill"))
    rows["prefill bf16"] = roofline_vs_card(
        f"{ARCH} prefill {PREFILL_B} x {PREFILL_S} bf16", fit,
        served["prefill"]["device_ms"], prefill_peak(torch, cfg))
    for key, dtype in ((ARCH, torch.bfloat16),
                       (f"{ARCH} float32", torch.float32)):
        res = trained[key]
        fit = hillclimb.fit_variant(cfg, train_shape(), n_micro=TRAIN_MICRO,
                                    dtype=dtype)
        rows[f"train {res['dtype']}"] = roofline_vs_card(
            f"{key} train {TRAIN_B} x {PREFILL_S} in {TRAIN_MICRO} "
            f"micro-batches, remat full", fit, res["device_ms"],
            res["peak_gb"] * 1e9)
    return rows


def hillclimb_on_card(torch):
    """Phase 7 (b): ``hillclimb.measure`` of 5g (a)'s cell (TinyLlama at
    full width, bf16, 8 x 4096) under remat "full" / "dots" / "none" x
    n_micro 2 / 4: a variant the meta fit puts over the card's memory is
    reported and not run; each that runs must launch 2 (full, dots: the
    recompute) or 1 (none) forward and 1 backward attention call a layer
    and micro-batch in every timed step, peak under 80 GB, and its first
    step's loss must equal every other remat mode's at its n_micro bit for
    bit.  Returns ({variant: its timed steps' launches}, {variant:
    result})."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import hillclimb
    cfg = _tinyllama()
    launches, rows = {}, {}
    for micro in HILLCLIMB_MICRO:
        first = {}
        for remat in HILLCLIMB_REMAT:
            key = f"remat {remat}, n_micro {micro}"
            t = time.perf_counter()
            r = hillclimb.measure(cfg, train_shape(), remat=remat,
                                  n_micro=micro, steps=HILLCLIMB_STEPS)
            r["s"] = time.perf_counter() - t
            rows[key] = r
            fit_peak = r["fit_bytes"]["peak"]
            if not r["fits"]:
                print(f"phase 7 (b): {key}: does not fit (meta fit "
                      f"{fit_peak} bytes), not run", flush=True)
                continue
            calls = cfg.n_layers * micro
            want = {"flash_attention": (1 if remat == "none" else 2) * calls,
                    "flash_attention_bwd": calls}
            if any(p != want for p in r["launches_per_step"]):
                raise AssertionError(f"phase 7 (b): {key}: launches per "
                                     f"step {r['launches_per_step']}, "
                                     f"expected {want}")
            if not r["peak_bytes"] < 80e9 or not all(
                    math.isfinite(x) for x in r["losses"]):
                raise AssertionError(f"phase 7 (b): {key}: {r}")
            launches[key] = {n: sum(p.get(n, 0) for p in
                                    r["launches_per_step"])
                             for n in FA.LAUNCHES}
            first[remat] = r["losses"][0]
            r["fit_over_peak"] = fit_peak / (r["peak_bytes"]
                                             - r["start_bytes"])
            print(f"phase 7 (b): {key}: {r['tokens_per_s']:.0f} tokens/s "
                  f"({r['step_s']:.3f} s a step), device "
                  f"{r['device_ms']:.1f} ms a step, peak {r['peak_bytes']} "
                  f"bytes (fit {fit_peak}, {r['fit_over_peak']:.4f} of the "
                  f"peak above the {r['start_bytes']} held before), counted "
                  f"{r['counted_flops']:.6g} flops, compute "
                  f"{r['compute_s'] * 1e3:.1f} / memory "
                  f"{r['memory_s'] * 1e3:.1f} ms, attention launches a "
                  f"step {want}, losses {r['losses']}, {r['s']:.1f} s",
                  flush=True)
        if len(set(first.values())) > 1:
            raise AssertionError(f"phase 7 (b): n_micro {micro}: first "
                                 f"losses differ across remat modes {first}")
    hillclimb_pbf16_on_card(torch, launches, rows)
    return launches, rows


# Phase 7 (b)'s p_bf16 runs: JAX's two one-card p_bf16 hillclimb variants
# at 5g (a)'s cut (bf16, TRAIN_B x 4096 in TRAIN_MICRO micro-batches,
# remat "full"), and the float32 p_bf16 route's training path: TinyLlama
# cut to PB_F32_LAYERS layers, PB_F32_SHAPE (B, S), float32, p_bf16.
PB_VARIANTS = ("p_bf16", "ce+pbf16")
PB_F32_LAYERS, PB_F32_SHAPE = 2, (2, 4096)


def hillclimb_pbf16_on_card(torch, launches, rows):
    """Phase 7 (b), the p_bf16 variants (``PB_VARIANTS``) through
    ``hillclimb.measure`` beside the baseline row (remat "full", n_micro
    TRAIN_MICRO): each timed step must launch the p_bf16 forward twice and
    its backward once a layer and micro-batch (88 / 44 at 22 x 2) and no
    float32-p route, losses finite, peak under 80 GB; then the float32 run
    (``PB_F32_LAYERS`` / ``PB_F32_SHAPE``) with the float32 p_bf16 routes
    and their splits.  Adds each run's launches and result to
    ``launches`` / ``rows``."""
    import dataclasses
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import hillclimb
    from repro_torch.models.config import ShapeConfig
    cfg = _tinyllama()
    base = rows.get(f"remat full, n_micro {TRAIN_MICRO}", {})
    f32_cfg = dataclasses.replace(cfg, n_layers=PB_F32_LAYERS)
    runs = [(v, cfg, train_shape(), TRAIN_MICRO, torch.bfloat16)
            for v in PB_VARIANTS]
    runs.append(("p_bf16 float32", f32_cfg, ShapeConfig(
        "train_4k f32 cut", PB_F32_SHAPE[1], PB_F32_SHAPE[0], "train"), 1,
        torch.float32))
    for name, c, shape, micro, dtype in runs:
        remat, ce, _, p_bf16 = hillclimb._knobs(name.split()[0])
        key = f"{name}, n_micro {micro}"
        t = time.perf_counter()
        r = hillclimb.measure(c, shape, remat=remat, ce=ce, n_micro=micro,
                              p_bf16=p_bf16, steps=HILLCLIMB_STEPS,
                              dtype=dtype)
        r["s"] = time.perf_counter() - t
        rows[key] = r
        if not r["fits"]:
            raise AssertionError(f"phase 7 (b): {key} does not fit")
        calls = c.n_layers * micro
        f32 = dtype == torch.float32
        want = {("flash_attention_f32_pbf16" if f32
                 else "flash_attention_pbf16"): 2 * calls,
                ("flash_attention_bwd_f32_pbf16" if f32
                 else "flash_attention_bwd_pbf16"): calls}
        if f32:
            want["split_bf16x3"] = 10 * calls
        if any(p != want for p in r["launches_per_step"]):
            raise AssertionError(f"phase 7 (b): {key}: launches per step "
                                 f"{r['launches_per_step']}, expected "
                                 f"{want}")
        if not r["peak_bytes"] < 80e9 or not all(
                math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"phase 7 (b): {key}: {r}")
        launches[key] = {n: sum(p.get(n, 0) for p in r["launches_per_step"])
                         for n in FA.LAUNCHES}
        beside = ("" if f32 else f" (baseline remat full, n_micro "
                  f"{TRAIN_MICRO}: {base.get('tokens_per_s', 0):.0f} "
                  f"tokens/s, {base.get('device_ms', 0):.1f} device ms)")
        print(f"phase 7 (b): {key} ({'float32' if f32 else 'bf16'}, "
              f"{c.n_layers} layers, {shape.global_batch} x "
              f"{shape.seq_len}): {r['tokens_per_s']:.0f} tokens/s "
              f"({r['step_s']:.3f} s a step), device {r['device_ms']:.1f} "
              f"ms a step{beside}, peak {r['peak_bytes']} bytes, attention "
              f"launches a step {want}, losses {r['losses']}, "
              f"{r['s']:.1f} s", flush=True)


def grad_compress_on_card(torch):
    """Phase 7 (c): ``compress`` / ``decompress`` of a float32 tree of 5g's
    gradient shapes (TinyLlama's stacked parameters; values drawn on the
    card, seeded) equal the CPU's bit for bit, and ``cross_pod_int8`` over
    a one-rank NCCL group equals the no-group path.  Leaves the group for
    ``rescale_on_card``."""
    from repro_torch.core.sharded import fleet_group
    from repro_torch.models.registry import abstract_params
    from repro_torch.train import grad_compress as GC
    from repro_torch.train.optimizer import tree_leaves, tree_map
    gen = torch.Generator(device="cuda").manual_seed(7)
    grads = tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device="cuda") * 1e-3,
        abstract_params(_tinyllama(), torch.float32))
    n = 0
    for g in tree_leaves(grads):
        q, s = GC.compress(g)
        qc, sc = GC.compress(g.cpu())
        d, dc = GC.decompress(q, s), GC.decompress(qc, sc)
        same = (torch.equal(q.cpu(), qc), torch.equal(s.cpu(), sc),
                torch.equal(d.cpu(), dc))
        if not all(same):
            raise AssertionError(f"phase 7 (c): compress on the card != CPU "
                                 f"(values, scale, decompressed equal: "
                                 f"{same}; scales {s.item()!r} "
                                 f"{sc.item()!r})")
        n += g.numel()
    group, _ = fleet_group(1, "cuda")
    got = GC.cross_pod_int8(grads, group)
    want = GC.cross_pod_int8(grads)
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want))):
        raise AssertionError("phase 7 (c): cross_pod_int8 over one NCCL "
                             "rank != the no-group path")
    print(f"phase 7 (c): compress / decompress of {n} gradient elements "
          f"(TinyLlama's shapes) on the card == CPU bit for bit; "
          f"cross_pod_int8 over a one-rank NCCL group == no group",
          flush=True)
    return n


def rescale_on_card(torch):
    """Phase 7 (d): ``elastic.apply_rescale`` of TinyLlama's full-width
    params (drawn on the card) onto a one-device ``DeviceMesh`` on cuda:0
    with ``plan_rescale``'s specs: each DTensor's local tensor equals the
    parameter bit for bit and carries the placements ``sharding``'s specs
    give.  Destroys the process group."""
    from repro_torch.launch import elastic
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as M
    from repro_torch.train.optimizer import tree_leaves
    cfg = _tinyllama()
    model, _, _ = init_on_card(torch, cfg, "phase 7 (d)")
    tree = M.stacked_params(model)
    shape, specs = elastic.plan_rescale(cfg, tree, n_devices=1)
    dm = MS.device_mesh(shape)
    moved = elastic.apply_rescale(tree, specs, dm)
    rows = SH.explain_sharding(M.param_axes(cfg), tree, shape)
    spec_of = {path: spec for path, _, _, spec in rows}

    def walk(a, b, prefix=""):
        if not isinstance(a, dict):
            yield prefix, a, b
            return
        for k in a:
            yield from walk(a[k], b[k], f"{prefix}/{k}")

    sharded = 0
    for path, a, b in walk(tree, moved):
        want = tuple(SH.placements(spec_of[path], dm.mesh_dim_names))
        if not (torch.equal(b.to_local(), a) and b.placements == want
                and b.device_mesh is dm):
            raise AssertionError(f"phase 7 (d): {path}: {b.placements} "
                                 f"!= {want} or values differ")
        sharded += any(p.is_shard() for p in want)
    torch.distributed.destroy_process_group()
    n = sum(a.numel() for a in tree_leaves(tree))
    print(f"phase 7 (d): {len(rows)} parameters ({n} elements) committed "
          f"to a {shape.shape} DeviceMesh on cuda:0, "
          f"{sharded} with a Shard placement: values equal bit for bit",
          flush=True)
    del model, tree, moved
    torch.cuda.empty_cache()
    return len(rows)


def run_pod_tools(torch, served, trained):
    """Phase 7: (a) ``roofline_on_card``, (b) ``hillclimb_on_card``, (c)
    ``grad_compress_on_card``, (d) ``rescale_on_card``.  Returns (phase 7
    (b)'s launches by variant, the results)."""
    out = {}
    for part, fn, args in (("a", roofline_on_card, (served, trained)),
                           ("b", hillclimb_on_card, ()),
                           ("c", grad_compress_on_card, ()),
                           ("d", rescale_on_card, ())):
        t = time.perf_counter()
        out[part] = fn(torch, *args)
        print(f"phase 7 ({part}) took {time.perf_counter() - t:.1f} s",
              flush=True)
    return out["b"][0], out


# Phase 7 (e): the sharded step.  (i) 5g (a)'s cell (TinyLlama-1.1B at
# full width, bf16, TRAIN_B x 4096 in TRAIN_MICRO micro-batches, remat
# "full") on a 1 x 1 ("data", "model") NCCL DeviceMesh on cuda:0, every
# parameter and moment a DTensor under DEFAULT_RULES, held bit for bit
# against the plain step on the first step (loss, the accumulated float32
# gradients, the updated parameters and moments), then SHARDED_STEPS
# timed steps.  (ii) The production-mesh dry-run of DRYRUN_SHAPES on both
# meshes, one subprocess a cell (a fake group of 256 / 512 ranks each,
# ``roofline``'s depth variants), all six at once after (i).
SHARDED_STEPS = 2
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def start_mesh_dryruns(out):
    """Phase 7 (e) (ii): one ``repro_torch.launch.roofline`` process per
    (shape, mesh) cell of TinyLlama, each writing its JSON into the
    directory ``out``.  Returns [(cell, process, json path)]."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for shape in DRYRUN_SHAPES:
        for flag in ("--pod", "--multi-pod"):
            path = out / f"dryrun_{ARCH}_{shape}{flag.replace('-', '_')}.json"
            cmd = [sys.executable, "-m", "repro_torch.launch.roofline",
                   "--arch", ARCH, "--shape", shape, flag, "--json",
                   str(path)]
            procs.append(((shape, flag), subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), path))
    return procs


def finish_mesh_dryruns(procs, timeout=600):
    """Phase 7 (e) (ii): wait for ``start_mesh_dryruns``' processes and
    check each cell: chips 256 / 512, non-zero collective bytes under
    JAX's kinds, finite terms.  Returns {cell: the row}."""
    from repro_torch.launch.dryrun import COLLECTIVES
    rows = {}
    for (shape, flag), proc, path in procs:
        try:
            log, _ = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0 or not path.exists():
            raise AssertionError(f"phase 7 (e): dry-run {shape} {flag} "
                                 f"exited {proc.returncode}: {log[-2000:]}")
        (r,) = json.loads(path.read_text())
        if "error" in r:
            raise AssertionError(f"phase 7 (e): dry-run {shape} {flag}: "
                                 f"{r['error']}")
        chips = 512 if flag == "--multi-pod" else 256
        if (r["chips"] != chips or not r["collective_bytes"] > 0
                or not set(r["collectives"]) <= set(COLLECTIVES.values())
                or not all(math.isfinite(r[k]) for k in
                           ("compute_s", "memory_s", "collective_s"))):
            raise AssertionError(f"phase 7 (e): dry-run {shape} {flag}: {r}")
        rows[f"{shape} {r['mesh']}"] = {
            k: r[k] for k in ("mesh", "chips", "hlo_flops", "hlo_bytes",
                              "collective_bytes", "collectives",
                              "per_device_bytes", "compute_s", "memory_s",
                              "collective_s", "dominant", "counted_at",
                              "measure_s")}
        pd = r["per_device_bytes"]
        print(f"phase 7 (e): {ARCH} {shape} on {r['mesh']} ({chips} "
              f"ranks, {r['counted_at']}, {r['measure_s']} s): per-device "
              f"peak {pd['peak'] / 2**30:.2f} GiB, flops "
              f"{r['hlo_flops']:.4g}, collective bytes "
              f"{json.dumps(r['collectives'])}, dominant {r['dominant']} "
              f"(compute {r['compute_s']:.4g} s, memory "
              f"{r['memory_s']:.4g} s, collective {r['collective_s']:.4g} s)",
              flush=True)
    return rows


def sharded_step_on_card(torch):
    """Phase 7 (e) (i): the plain step, then the sharded step on a fresh
    copy of the same weights (the same draw) over a one-rank NCCL
    DeviceMesh, each recording the accumulated gradients it hands AdamW.
    Loss, gradients, parameters and moments after the step must be equal
    bit for bit; the sharded step launches the attention kernels as the
    plain one does (``train_step_launches``: 88 forward and 44 backward).
    Then SHARDED_STEPS timed sharded steps.  Destroys the process group.
    Returns (launches of the compared sharded step, result)."""
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import mesh as MS
    from repro_torch.models import registry
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import step as TS
    from repro_torch.train.optimizer import adamw_init, tree_leaves
    cfg = _tinyllama()
    shape = ShapeConfig("train_4k cut", PREFILL_S, TRAIN_B, "train")
    data = DataConfig(0)

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def one_step(mesh):
        model, _, _ = init_on_card(torch, cfg, "phase 7 (e)")
        opt = adamw_init(M.stacked_params(model))
        if mesh is not None:
            model = registry.shard_model(model, cfg, mesh)
            opt = registry.shard_opt_state(opt, cfg, mesh)
        M.make_trainable(model)
        step = registry.make_step(cfg, shape, n_micro=TRAIN_MICRO,
                                  mesh=mesh)
        grads = []
        update = TS.adamw_update

        def recording(opt_cfg, g, opt_state, params):
            grads.extend(local(x).clone() for x in tree_leaves(g))
            return update(opt_cfg, g, opt_state, params)
        FA.reset_launches()
        TS.adamw_update = recording
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt, metrics = step(model, opt, batch_for_step(
                cfg, shape, 0, data, "cuda"))
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        finally:
            TS.adamw_update = update
        out = {"loss": local(metrics["loss"]).clone(), "grads": grads,
               "params": [local(p) for p in
                          tree_leaves(M.stacked_params(model))],
               "m": [local(x) for x in tree_leaves(opt.m)],
               "v": [local(x) for x in tree_leaves(opt.v)],
               "launches": dict(FA.LAUNCHES), "first_step_s": first_s}
        return model, opt, step, out

    model, opt, _, plain = one_step(None)
    plain_first_s = plain["first_step_s"]
    del model, opt
    torch.cuda.empty_cache()
    dm = MS.device_mesh(MS.MeshShape((1, 1), ("data", "model")))
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError("phase 7 (e): the mesh's group is not NCCL")
    model, opt, step, sharded = one_step(dm)
    if not all(type(p).__name__ == "DTensor" for p in model.parameters()):
        raise AssertionError("phase 7 (e): a parameter is not a DTensor")
    want = train_step_launches(FA, False, cfg.n_layers * TRAIN_MICRO)
    if sharded["launches"] != want or plain["launches"] != want:
        raise AssertionError(f"phase 7 (e): launches sharded "
                             f"{sharded['launches']}, plain "
                             f"{plain['launches']}, expected {want}")
    parted = {}
    for key in ("loss", "grads", "params", "m", "v"):
        a, b = plain[key], sharded[key]
        pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
        bad = [i for i, (x, y) in enumerate(pairs) if not torch.equal(x, y)]
        if bad:
            parted[key] = bad
    if parted:
        raise AssertionError(f"phase 7 (e): the sharded step parts from the "
                             f"plain one (leaf indices {parted})")
    del plain
    times = []
    for i in range(SHARDED_STEPS):
        batch = batch_for_step(cfg, shape, 1 + i, data, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, metrics = step(model, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tokens = TRAIN_B * PREFILL_S
    res = {"model": cfg.name, "mesh": {"data": 1, "model": 1},
           "backend": "nccl", "seq": PREFILL_S, "global_batch": TRAIN_B,
           "n_micro": TRAIN_MICRO, "remat": "full",
           "bit_for_bit": ["loss", "gradients", "parameters", "moments"],
           "launches_per_step": sharded["launches"],
           "first_step_s": sharded["first_step_s"],
           "plain_first_step_s": plain_first_s,
           "step_s": times, "tokens_per_s": SHARDED_STEPS * tokens
           / sum(times), "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"phase 7 (e): {cfg.name} at full width in bfloat16 on a 1 x 1 "
          f"NCCL DeviceMesh, every parameter a DTensor: the first step "
          f"equals the plain step bit for bit (loss, gradients, parameters, "
          f"moments); {res['tokens_per_s']:.0f} tokens/s over "
          f"{SHARDED_STEPS} steps ({times}), launches a step "
          f"{sharded['launches']}", flush=True)
    del model, opt, step
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return sharded["launches"], res


def run_sharded_step(torch, trained):
    """Phase 7 (e): ``sharded_step_on_card``, then the dry-runs (started
    after it: their DTensor dispatch would share the host's cores with the
    timed steps).  Returns (launches, result)."""
    t = time.perf_counter()
    launches, res = sharded_step_on_card(torch)
    res["plain_tokens_per_s_5g"] = trained.get(ARCH, {}).get("tokens_per_s")
    print(f"phase 7 (e) (i) took {time.perf_counter() - t:.1f} s; phase 5g "
          f"(a) ran {res['plain_tokens_per_s_5g']} tokens/s", flush=True)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_dryrun_") as tmp:
        procs = start_mesh_dryruns(Path(tmp))
        try:
            res["dryrun"] = finish_mesh_dryruns(procs)
        finally:
            for _, proc, _ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    print(f"phase 7 (e) (ii) took {time.perf_counter() - t:.1f} s",
          flush=True)
    print(json.dumps({"sharded_step": res}), flush=True)
    return launches, res


def run_lint_gate(torch):
    """Phase 8: ``graph_gate.run_gate("cuda")`` on every policy x variant
    entry (docstring, phase 8); prints one line per captured key (kernel,
    memcpy and memset nodes, pick launches) and a JSON summary of the
    kernel nodes per key by entry; raises on any hard violation.  Returns
    {entry: {key: kernel nodes}}."""
    from repro_torch.lint import graph_gate as G
    errors, notes, results = G.run_gate("cuda")
    for line in G.node_lines(results):
        print(f"phase 8: {line}", flush=True)
    for note in notes:
        print(f"phase 8: note: {note}", flush=True)
    if errors:
        raise AssertionError(f"phase 8: {len(errors)} graph-gate "
                             "violation(s): " + "; ".join(errors[:20]))
    kernels = {e: {k: fp["nodes"]["kernel"] for k, fp in keys.items()
                   if "nodes" in fp} for e, keys in results.items()}
    print(json.dumps({"lint_gate": {
        "entries": len(results),
        "keys": sum(len(k) for k in results.values()),
        "kernel_nodes": kernels}}), flush=True)
    return kernels


# ---------------------------------------------------------------------------
# Phase 9: the examples/ scripts' ports on the card
# ---------------------------------------------------------------------------

# The JAX scripts' output at their defaults, taken on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python examples/paper_eval.py
#   PYTHONPATH=src JAX_PLATFORMS=cpu python examples/quickstart.py
# (the sequential engine; the port's scripts replay on the card, and the
# decisions are exact, so the lines must be equal).
PAPER_EVAL_JAX = """\
FF    acc=0.482 hw=0.808 auc=583 mig=0 (0.0% of accepted) | per-profile: 1g.5gb=0.59 1g.10gb=0.54 2g.10gb=0.53 3g.20gb=0.47 4g.20gb=0.46 7g.40gb=0.41
BF    acc=0.476 hw=0.808 auc=583 mig=0 (0.0% of accepted) | per-profile: 1g.5gb=0.57 1g.10gb=0.53 2g.10gb=0.52 3g.20gb=0.46 4g.20gb=0.46 7g.40gb=0.41
MCC   acc=0.626 hw=0.887 auc=640 mig=0 (0.0% of accepted) | per-profile: 1g.5gb=1.00 1g.10gb=1.00 2g.10gb=1.00 3g.20gb=0.67 4g.20gb=0.67 7g.40gb=0.24
MECC  acc=0.626 hw=0.887 auc=640 mig=0 (0.0% of accepted) | per-profile: 1g.5gb=1.00 1g.10gb=1.00 2g.10gb=1.00 3g.20gb=0.67 4g.20gb=0.67 7g.40gb=0.24
GRMU  acc=0.657 hw=0.651 auc=469 mig=39 (0.7% of accepted) | per-profile: 1g.5gb=1.00 1g.10gb=0.99 2g.10gb=0.99 3g.20gb=0.99 4g.20gb=0.99 7g.40gb=0.19

--- headline vs paper ---
GRMU/MCC acceptance: 1.05x   (paper: 1.22x)
GRMU/FF  acceptance: 1.36x   (paper: 1.39x)
GRMU normalized hw AUC: 0.734 (paper Table 6: 0.815)
GRMU migration fraction: 0.74% (paper: ~1%)"""
QUICKSTART_JAX = """\
empty GPU CC: 18
first 1g.5gb placed at block: 6
second 1g.5gb placed at block: 4
CC now: 11

free blocks: [1, 3] -> 1g.10gb fits? False

replaying a 5%-scale Alibaba-shaped trace...
  FF    acceptance=0.506 active_hw=0.816 migrations=0
  MCC   acceptance=0.643 active_hw=0.887 migrations=0
  GRMU  acceptance=0.653 active_hw=0.651 migrations=78

GRMU should accept the most while keeping the least hardware active (paper §8)."""


def run_examples(torch):
    """Phase 9: the five ``repro_torch.examples`` scripts on the card at
    the JAX scripts' defaults: ``paper_eval`` (all five policies on the
    full-scale trace) and ``quickstart`` must print the JAX scripts' lines
    (``PAPER_EVAL_JAX`` / ``QUICKSTART_JAX``); ``sweep_on_device``'s
    device sweep must equal its sequential-engine cross-check;
    ``serve_with_grmu``'s online decisions must equal the offline replay's
    where no tier switch happened; ``train_lm`` (200 steps of StableLM-3B's
    smoke config, checkpoints under a temporary directory) must end with
    0.  Returns {script: result}, paper_eval's headline lines included."""
    import contextlib as cl
    import io
    from repro_torch.examples import (paper_eval, quickstart,
                                      serve_with_grmu, sweep_on_device,
                                      train_lm)
    out = {}

    def timed(name, fn, *args, **kw):
        buf = io.StringIO()
        t = time.perf_counter()
        with cl.redirect_stdout(buf):
            res = fn(*args, **kw)
        out[name] = {"s": time.perf_counter() - t}
        text = buf.getvalue()
        print(text, end="", flush=True)
        print(f"phase 9: {name} took {out[name]['s']:.1f} s", flush=True)
        return res, text.rstrip("\n")

    lines, text = timed("paper_eval", paper_eval.run)
    if text != PAPER_EVAL_JAX:
        raise AssertionError(f"phase 9: paper_eval on the card printed\n"
                             f"{text}\nthe JAX script\n{PAPER_EVAL_JAX}")
    out["paper_eval"]["headline"] = lines[-4:]
    _, text = timed("quickstart", quickstart.run)
    if text != QUICKSTART_JAX:
        raise AssertionError(f"phase 9: quickstart on the card printed\n"
                             f"{text}\nthe JAX script\n{QUICKSTART_JAX}")
    res, _ = timed("sweep_on_device", sweep_on_device.run)
    if res["sequential"] != res["device"]:
        raise AssertionError(f"phase 9: sweep_on_device: {res}")
    out["sweep_on_device"].update(res)
    res, _ = timed("serve_with_grmu", serve_with_grmu.run)
    if res.get("online_equals_offline") is False:
        raise AssertionError("phase 9: serve_with_grmu: online != offline")
    out["serve_with_grmu"].update(
        {k: res[k] for k in ("decisions", "accepted", "p50_ms", "p99_ms",
                             "switches", "tier")},
        online_equals_offline=res.get("online_equals_offline"))
    with tempfile.TemporaryDirectory(prefix="train_lm_") as tmp:
        rc, _ = timed("train_lm", train_lm.run, ckpt_dir=tmp)
    if rc != 0:
        raise AssertionError(f"phase 9: train_lm returned {rc}")
    print(f"phase 9: paper_eval on {card_line()}: "
          + " | ".join(out["paper_eval"]["headline"]), flush=True)
    print(json.dumps({"examples": out}), flush=True)
    return out


def attention_paths(fa_launches, f32_launches, zoo_launches, launches_5d,
                    launches_5e, launches_5f):
    """The serving paths that reach the attention kernels, each path's
    launches counted from 0: ({bf16 path: launches}, {float32 path:
    launches}).  bf16: phase 5 TinyLlama, phase 5c the zoo, phase 5d
    Whisper's prefill / encode / forward and Scout, phase 5e Zamba2 and
    RWKV-6 (which launches none), phase 5f DeepSeek-V2; float32: TinyLlama,
    ZOO_F32 and DeepSeek-V2's narrow variant (phase 5f)."""
    bf16_paths = {ARCH: fa_launches}
    bf16_paths.update({a: zoo_launches[a] for a in ZOO})
    bf16_paths.update(launches_5d)
    bf16_paths.update(launches_5e)
    bf16_paths[DSV2] = launches_5f[DSV2]
    narrow = f"{DSV2} float32 narrow"
    f32_paths = {ARCH: f32_launches,
                 ZOO_F32: zoo_launches[f"{ZOO_F32} float32"],
                 narrow: launches_5f[narrow]}
    return bf16_paths, f32_paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import numpy as np
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in f32
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: built {sorted(libs)} from {SOURCE}, {FA_SOURCE} and "
          f"{FA_BWD_SOURCE} in {time.perf_counter() - t0:.2f} s", flush=True)

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"{name} took {time.perf_counter() - t:.1f} s", flush=True)
        return out

    err = timed_phase("phase 2 checks", check_kernels, torch, np)
    timing = timed_phase("phase 2 timing", time_kernels, torch, np)
    fa_err = timed_phase("phase 2b checks", check_attention, torch)
    fa_time = timed_phase("phase 2b timing", time_attention, torch, fa_err)
    zoo_time, zoo_f32_time = timed_phase("phase 2b zoo timing",
                                         time_zoo_attention, torch, fa_err)
    bwd_err, bwd_time = timed_phase("phase 2c", check_attention_bwd, torch)
    pb_err, pb_time = timed_phase("phase 2d", check_attention_pbf16, torch)
    timed_phase("phase 3", check_card_vs_cpu)
    launches, profiles = timed_phase("phase 4", run_main_path, torch)
    timed_phase("phase 4b", run_streaming_and_telemetry, torch, profiles)
    timed_phase("phase 4c", run_graph_path, torch)
    sharded_launches = timed_phase("phase 4d", run_sharded, torch)
    service_launches = timed_phase("phase 6", run_service, torch)
    timed_phase("phase 5 card vs CPU", check_card_vs_cpu_prefill, torch)
    fa_launches, served = timed_phase("phase 5 bf16", run_serving, torch)
    f32_launches, _ = timed_phase("phase 5 float32", run_f32_prefill, torch)
    timed_phase("phase 5b", attention_accuracy, torch)
    zoo_launches, _ = timed_phase("phase 5c", run_zoo, torch)
    launches_5d, _ = timed_phase("phase 5d", run_5d, torch)
    launches_5e, _ = timed_phase("phase 5e", run_5e, torch)
    launches_5f, _ = timed_phase("phase 5f", run_5f, torch)
    launches_5g, trained = timed_phase("phase 5g", run_training, torch)
    launches_7, _ = timed_phase("phase 7", run_pod_tools, torch, served,
                                trained)
    launches_7e, _ = timed_phase("phase 7 (e)", run_sharded_step, torch,
                                 trained)
    timed_phase("phase 8", run_lint_gate, torch)
    timed_phase("phase 9", run_examples, torch)

    rows = []
    floor = timing["launch_floor"]
    for name, replaces in KERNELS.items():
        main_t, big_t = timing[(name, N_MAIN)], timing[(name, N_BIG)]
        rows.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[name], on_main_path=launches[name] > 0,
            max_abs_err=err[name], max_abs_diff=err[name],
            ms=main_t["ms"], plain_ms=main_t["plain_ms"],
            bound_ms=main_t["bound_ms"], bound_by=main_t["bound_by"],
            library_ms=None, host_us_per_call=main_t["host_us"],
            launch_floor_us=floor["ms"] * 1e3,
            launch_floor_host_us=floor["host_us"],
            us_at_1860=main_t["ms"] * 1e3, us_at_1M=big_t["ms"] * 1e3,
            plain_us_at_1M=big_t["plain_ms"] * 1e3,
            bound_us_at_1M=big_t["bound_ms"] * 1e3,
            bound_by_at_1M=big_t["bound_by"],
            host_us_at_1M=big_t["host_us"]))
        if name in ("mcc_pick", "ecc_pick"):
            # The placement service's five full-scale streams (phase 6).
            rows[-1]["service_launches"] = service_launches.get(name, 0)
        # The sharded fleet's replays (phase 4d (a)) score through the
        # tables: 0 for every mask kernel.
        rows[-1]["sharded_launches"] = sharded_launches.get(name, 0)
    # Attention: each kernel's launches on the serving paths that reach it
    # (``attention_paths``), with the head dim (MLA: the q/k, v pair) it
    # runs there; the head dims and pairs phase 2b held against the plain
    # version; times at TinyLlama's prefill shape, and at each phase 5c /
    # 5d / 5e / 5f model's that runs the kernel
    # (``at_model_prefill_shapes``).
    from repro_torch.configs import get_config
    bf16_paths, f32_paths = attention_paths(
        fa_launches, f32_launches, zoo_launches, launches_5d, launches_5e,
        launches_5f)
    checked = sorted({c[5] for c in ATTN_CASES.values()})
    pairs_checked = sorted({head_dims_of(c[5])
                            for c in PAIR_ATTN_CASES.values()})
    for name, tname, paths in (
            ("flash_attention", "bfloat16", bf16_paths),
            ("flash_attention_f32", "float32", f32_paths),
            ("split_bf16x3", "split", f32_paths)):
        t = fa_time[tname]
        by_path = {a: runs[name] for a, runs in paths.items()}
        rows.append(dict(
            name=name, route="cuda", source=FA_SOURCE, replaces=FA_REPLACES,
            launches=sum(by_path.values()), on_main_path=tname == "bfloat16",
            path=("bf16 serving" if tname == "bfloat16"
                  else "float32 prefill"),
            launches_by_path=by_path,
            head_dims={a: attention_head_dims(get_config(a.split()[0]))
                       for a in paths},
            head_dims_checked=checked, head_dim_pairs_checked=pairs_checked,
            max_abs_err=fa_err[tname], max_abs_err_by_dtype=fa_err,
            max_abs_err_vs_f64=t.get("max_abs_err_vs_f64"),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            shape=t["shape"],
            at_model_prefill_shapes={"bfloat16": zoo_time,
                                     "float32": zoo_f32_time}.get(tname),
            train_launches={a: runs[name] for a, runs in
                            launches_5g.items()},
            sharded_step_launches=launches_7e[name],
            hillclimb_launches={v: runs[name] for v, runs in
                                launches_7.items()}))
    # The attention backward: its launches on the training paths (phase 5g
    # (a), bf16; (b) and (c), float32), per full-width step, and its times
    # at TinyLlama's training attention shape beside SDPA's backward, by
    # kernel (phase 2c).
    for name, tname, full in (("flash_attention_bwd", "bfloat16", ARCH),
                              ("flash_attention_bwd_f32", "float32",
                               f"{ARCH} float32")):
        t = bwd_time[tname]
        by_path = {a: runs[name] for a, runs in launches_5g.items()}
        rows.append(dict(
            name=name, route="cuda", source=FA_BWD_SOURCE,
            replaces=FA_BWD_REPLACES,
            replaces_note=("no Pallas kernel: the gradient of "
                           "flash_attention_pallas's function, which JAX "
                           "takes by jax.value_and_grad of the jnp "
                           "attention (src/repro/train/step.py:131)"),
            launches=sum(by_path.values()),
            on_main_path=by_path[full] > 0,
            path=("bf16 training" if tname == "bfloat16"
                  else "float32 training (full width; card vs CPU)"),
            launches_by_path=by_path,
            launches_per_train_step=by_path[full] // TRAIN_STEPS,
            head_dims_checked=sorted({head_dims_of(c[5])
                                      for c in BWD_CASES.values()}),
            max_abs_err=bwd_err.get(tname), max_abs_err_by_dtype=bwd_err,
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            ms_by_kernel=t.get("kernel_ms"), shape=t["shape"],
            sharded_step_launches=launches_7e[name],
            hillclimb_launches={v: runs[name] for v, runs in
                                launches_7.items()}))
    # The p_bf16 routes (phase 2d; JAX's ATTN_P_BF16): their launches on
    # phase 7 (b)'s p_bf16 training runs, which reset the counts before
    # each step and read them after it; times at TinyLlama's prefill
    # (forward) and training (backward) shapes.
    pb_runs = {v: runs for v, runs in launches_7.items() if "bf16" in v}
    for name, kind, tname, replaces in (
            ("flash_attention_pbf16", "fwd", "bfloat16", PB_REPLACES),
            ("flash_attention_f32_pbf16", "fwd", "float32", PB_REPLACES),
            ("flash_attention_bwd_pbf16", "bwd", "bfloat16",
             FA_BWD_REPLACES),
            ("flash_attention_bwd_f32_pbf16", "bwd", "float32",
             FA_BWD_REPLACES)):
        t = pb_time[f"{kind} {tname}"]
        by_path = {v: runs[name] for v, runs in pb_runs.items()}
        rows.append(dict(
            name=name, route="cuda",
            source=FA_SOURCE if kind == "fwd" else FA_BWD_SOURCE,
            replaces=replaces,
            replaces_note=("no Pallas kernel: JAX's flags.ATTN_P_BF16 "
                           "function of layers._attend_block (p and v "
                           "rounded to bf16), and its jax.vjp"),
            launches=sum(by_path.values()),
            on_main_path=sum(by_path.values()) > 0,
            path=("p_bf16 training (phase 7 (b): " + ", ".join(pb_runs)
                  + ")"),
            launches_by_path=by_path,
            max_abs_err=pb_err[f"max_abs {kind} {tname}"],
            share_of_flag_effect=pb_err[f"{kind} {tname}"],
            ms=t["ms"], float32_p_route_ms=t["float32_p_ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            ms_by_kernel=t.get("kernel_ms"), shape=t["shape"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
