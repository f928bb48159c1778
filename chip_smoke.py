#!/usr/bin/env python3
"""Drive the PyTorch port (matryoshka_mm_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero, and no phase's exception is caught:

1. device: require CUDA; print the card (nvidia-smi name and power limit),
   torch.version.cuda, nvcc and Triton versions; turn TF32 off;
2. build: compile csrc/*.cu with nvcc for sm_90a (one nvcc per source, all
   at once), print ptxas usage (and any wgmma note of ptxas) and the build
   time, and the prefill kernel's block, ring depth and shared memory at
   the prefill rows;
3. kernels against their plain PyTorch versions at the main path's shapes
   in bf16, with max errors and the median time of kernel and plain version
   over CUDA events: prefill flash attention B=1 H=32 Dh=128 Sq=640 against
   a 672-slot cache, GQA and window cases (the float32 FMA kernel timed at
   the same shape), the training shapes S=1024 and S=1599 and an anyres
   prefill at S=3008 (kernel, plain version and library timed, TFLOP/s),
   chunked_prefill's last chunk (512 queries at q_index_offset 2,560
   against 3,136 slots, left-padded; timed the same), and the edges of a
   64 x 64 tile
   walk in bf16 and float32 (S of 63/64/65/129, paddings of 70 and 150,
   windows of 16 and 150, q_index_offset with Sq != Sk, GQA 4 and 8, Dh=64,
   non-causal; zeros and lse = -1e30 on keyless rows, the same bits from two
   launches); decode attention with its n_split printed: B in {1, 4}, S=672,
   GQA, window, a ragged S, S=40, S=65, a row whose last split is wholly
   masked, B=1 at S=4096, B=1 at 3040 (an anyres request, timed with b1
   and b4), B=5 and B=20 at 672 (ver=v2 steps, timed) (each against the
   plain and the split plain
   version, two launches bit-identical), then its int8-KV branch at B in
   {1, 4}, S in {672, 673}, GQA and window; int4_matmul / int8_matmul at the
   7B projections (qkv 12288x4096, o 4096x4096, gateup 22016x4096, down
   4096x11008, lm_head 32000x4096) for M in {1, 2, 4, 8} (the decode
   kernel) and {9, 20, 192, 640, 768, 1024} (the prefill kernel; 9 a
   speculative verify, 20 a ver=v2 step of 5 scales x 4 rows), and at
   M=3008 (an anyres prefill) for qkv, gateup and down, two launches
   bit-identical at M = 1, 8, 9, 20 and 640, timed at M = 1, 4, 8, 9, 20
   (GB/s, share of the byte bound; 9 and 20 also beside dequantize +
   F.linear) and 192, 640, 1024, 3008 (TFLOP/s, share of the operations
   bound), each beside bf16 F.linear on the dequantized weight; quant_mlp
   at 7B widths for M in {1, 4, 8, 20, 32}, int4 and int8;
4. the bf16 slice at full width: load_pretrained_model("debug://7b")
   (random weights from a seed), five one-image requests with 32 greedy
   tokens at ver=v0_numtoks in {1, 9, 36, 144, 576} and a left-padded B=4
   batch at 144, each decode a captured CUDA graph (generate's default on
   the card); the launch counters must show 32 flash launches per prefill
   and 32 decode launches per decode step, replays included, and each
   request one capture and a replay for every decode step but its warm-up;
   one prefill's last-position logits are held against
   attn_impl="reference" (cosine >= 0.99); the captured decode's tokens and
   last logits are bit-identical to decode_chunk's from the same cache
   (capture ms printed); TTFT per scale, decode tok/s at B=1 and B=4, peak
   memory; then at B=1 and B=4 (scale 144) decode tok/s of the eager loop
   and the graph in turns E G G E, and each mode's profile: device ms,
   kernels and Python launch calls a step (runtime launch events of a
   32-token run less a 1-token run, 8 tokens for the eager loop, which
   launches the same every step), the device's idle share, and the
   graph's wall ms a replayed step (a run less its warm-up and capture);
5. the quantized slice at full width: debug://7b under load_4bit (scales
   144 and 576 at B=1, 144 at a left-padded B=4), load_8bit (144, B=1) and
   load_4bit with kv_cache_dtype="int8" (144, B=4); the launch counters
   must equal the counts of 32 layers (per prefill qkv, o, gateup, down
   and lm_head through the matmul kernel, per decode step qkv, o and
   lm_head through it, one quant_mlp and one decode attention per
   step-layer), replays of the captured decode included; one prefill's
   last-position logits are held against the same weights under
   disable_fused_proj() (cosine >= 0.99, same argmax); per load the
   captured decode bit-identical to decode_chunk on one request; TTFT,
   decode tok/s and peak memory per configuration, and per request a
   profile of its prefill (device ms, the quantized prefill kernel's ms,
   launches and share) and of its decode steps; and, under load_4bit,
   phase 4's eager / graph turns and profiles at B=1 and B=4;
6. paged attention against its plain version at the 7B shapes (H=Hkv=32,
   Dh=128, page 64, 25 pages a row; bf16 and int8 pools; the stacked form
   at layers 0 and 31 with the split paged_splits picks; B=1 and B=8;
   ragged row lengths 0, 63, 64, 65 and a full row, and one GQA case, both
   also at n_split 1, 2, 4 and 8 with two launches bit-identical;
   scattered page tables), timed with the rule's split and at one split in
   turns (A B B A) at B=8 with ~700-token rows, at B=8 with one live row of
   700 tokens and at B=1; the bandwidth probes against their plain versions
   on a small array, hbm_copy over 256 MiB against dst.copy_(src) as a
   ratio, then the calibration run: hbm_read_gb_s over 512 MiB and
   hbm_copy_gb_s over 256 MiB at 1, 4 and 16 passes a launch (median and
   least-greatest of 7 runs);
7. the serving slice at full width, debug://7b in bf16 and under load_4bit
   with kv_cache_dtype="int8": ContinuousBatcher(backend="paged",
   max_batch=8, prefill_len=1024, max_new_tokens=128, page_size=64,
   chunk=8) answers 12 requests (8 as a burst, 4 joining late) at scales
   9 / 144 / 576 with 32-64 new tokens each, every decode round a replay
   of the round captured during warmup().  Every stream must end with
   its budget and no BatchError; the launch counts of every kernel on the
   path must be exact (paged attention: decode steps x 32); admissions must
   have been grouped; every page must be back on the free list.  The same
   traffic then goes through eager rounds (cuda_graph=False) with the same
   gates, for the comparison.  Then 8
   long requests are stopped in mid-decode and one decode step on that live
   pool is taken with use_kernel=True and use_kernel=False: in float32
   (weights and pool cast up) the logits' cosine is >= 0.999 and the argmax
   the same in every row; in the model's dtype the cosine is >= 0.995 (>=
   0.999 in the rows of 200 tokens or more), the
   kernel lies at most twice as far from the float32 step as the gather path
   does, and the argmax is the same wherever the top two logits lie farther
   apart than the two paths' logits; three layers' attention over the live
   pool is held against float32 attention.  One decode round is profiled
   (device ms per step, idle share, top kernels).  One round is replayed on
   the live pool and run eagerly from the same state on a copy of it: the
   tokens, the state and the pool bytes must be equal; a replayed round is
   profiled too (the profiler must see its kernels).
   On the bf16 model one short run each with prefix_cache=True (a repeated
   prompt hits its three cached pages), speculative_k=4 (the verify steps
   add up) and a constraint_regex (the output full-matches); phase 8 holds
   the tokens of the first two equal to the plain run's in float32.
   Printed, with the card's name and power limit: tok/s over the batch,
   TTFT p50 / max, ms a decode step, mean occupancy, pool size, peak memory;
8. a small model (Dh=128, float32) on the card against the same weights on
   the CPU (plain versions): same greedy tokens from generate and from the
   batcher with the paged and with the dense backend, the paged one also
   with prefix_cache=True (hit == miss) and speculative_k=4; on the card
   generate and both batchers must have replayed captured graphs.

9. the flash-attention backward kernels (dQ, dK/dV; tensor cores in bf16,
   f32 FMAs in float32) against their plain versions: the training shapes
   (B=1, H=32, Dh=128, S 1024 and 1599, causal, a left-padded row whose
   first queries see no key; B=3 at 1059), GQA groups 4 and 8, windows
   narrower than a 64-wide tile and across three, q_index_offset with
   Sq != Sk, Dh=64, S in {63, 64, 65, 129}, a padding longer than two tiles;
   NaN scan, zero gradients on masked rows and slots, the same bits from
   two launches, times of kernels, plain versions and the library's
   backward, and the float32 kernels' times;
10. the training slice at full width: debug://7b, bf16 base frozen, LoRA
   r=128 alpha=256 on every LM projection, remat, frozen_vision, K=5 scales,
   T=1024, B=1, through create_train_state + make_train_step: one warm and
   three timed steps on one seeded batch.  Gates: losses and grad norms
   finite, loss lower at step 4 than at step 1, every lora_b non-zero after
   step 1, every frozen leaf bit-identical at the end, exact launches a
   step (dQ and dK/dV 32 x 3 forwards, flash forward twice that under full
   recompute and once under remat_policy="names:flash_out,flash_lse"), the
   loss within 1e-2 of the same loss through attn_impl="reference".
   Printed: step time, tokens/s, peak memory, adapter count, a profile of
   one step;
11. small-model train steps (float32, Dh=128), the card (kernels) against
   the CPU (plain versions): an M3-MoE config with full fine-tuning and
   QLoRA over an int8 base; step-1 gradients, two steps' losses and grad
   norms within 1e-3;
12. checkpoints on disk at full width: debug://7b with a dense router
   (debug://tiny-moe's router kind at 7B widths) written in the liuhaotian
   layout, bf16 safetensors shards of at most 5 GB and a config.json with
   the M3 `config` dict and the `mm_*` keys, to a temporary directory (bytes
   and seconds printed), then read back by load_pretrained_model with the
   page cache dropped first: in bf16 every leaf bit-identical and the
   config equal, 32 greedy tokens at scale 144 and the prefill's last
   logits bit-identical to the in-memory model's, the launch counters
   exact; gating_probs on the card against the CPU within 1e-3 in float32
   (the bf16 difference printed) and gateprobargmax decoding as the fixed
   scale it picks; under load_4bit every decoder leaf bit-identical to
   debug://7b + load_4bit, the tokens equal and the counters at phase 5's
   counts; a seeded bf16 LoRA adapter (r=128, alpha=256, every LM
   projection) over the directory, the merged leaves bit-identical to a
   float32 merge done here; train._build_params from the directory
   bit-identical to debug://7b + add_lora.  Printed with the card's name
   and power limit: load seconds and GB/s, device memory added at the peak
   and held, the host's RSS before and at its peak, TTFT and decode tok/s
   of the loaded models.  The directory is removed at the end.

13. anyres and multi-image prompts at the full width of
   llava-next-vicuna-7b-m3: LlavaConfig.llava_v15_7b_m3 with anyres,
   spatial_unpad and LLaVA-1.6's published pinpoints, random bf16 weights
   made on the card by init_params (image_newline included), a 672x672
   and a 1000x400 image from a seed through process_images (5 and 4
   tiles).  generate at every scale of both images and two multi-image
   prompts (3 images at 144, 2 at 576), 32 greedy tokens each, a captured
   decode: 32 flash launches a prefill and 32 decode launches a step,
   replays included, one capture a request; the host's spliced length
   equal to the prefill's device length at every scale; the 576 prefill's
   logits against attn_impl="reference" (cosine >= 0.99); the captured
   decode bit-identical to decode_chunk.  Printed per request: TTFT,
   decode tok/s, peak memory; the CLIP tower's ms over each tile stack; a
   profile of the 576 prefill (device ms, idle share, flash, quantized
   products, CLIP).  A paged ContinuousBatcher(max_batch=8,
   prefill_len=3072, page_size=64, chunk=8) answers 4 anyres and 4
   single-tile requests as one burst: every budget met, the anyres rows
   admitted solo and the single tiles as a group, exact paged-attention
   launches, every page returned; tok/s, TTFT p50 / max, pool GiB; a
   repeated anyres request with prefix_cache=True hits its pages.  The same
   weights quantized to int4 in place: anyres requests at 576 and 144 with
   exact launches (4 x 32 + 1 products a prefill through the quantized
   kernels, 3,008 rows at 576), logits against disable_fused_proj()
   (cosine >= 0.99, same argmax) and TTFT beside that route's, a profile
   of each prefill.  Then phase 8's small float32 model with anyres fields, the
   card against the CPU: the same greedy tokens from anyres and
   multi-image generate, the paged and the dense batcher's anyres
   admission, and an anyres prefix-cache hit equal to its miss.

14. generate's other modes at the full width of llava-v1.5-7b-m3
   (debug://7b, random bf16 weights, nothing cut; B=1 prompts of ~40
   tokens and phase 4's left-padded B=4 batch).  ver=v2 combine-logits:
   ver=v2_numtoks=[36,576]_betas=[0.5,1]_gamma=0.1 and
   ver=v2_numtoks=[1,9,36,144,576]_pickby=entropy at B=1, the betas spec
   at B=4 (K*B = 8), the entropy spec under load_4bit at B=4 (K*B = 20), 32
   greedy tokens each: K * 32 flash launches, 32 decode launches a step,
   replays included, and under int4 the quantized products of K prefills
   and of the K*B-row steps (through the prefill kernel and quant_mlp),
   one capture and 30 replays a request; ver=v2_numtoks=[144]_betas=[1]
   gives ver=v0_numtoks=144's tokens bit for bit; the captured v2 step
   bit-identical to decode_chunk; TTFT and tok/s at K = 2 and 5 beside v0
   at 576.  stream_generate at 144 in chunks of 8: one yield a chunk plus
   one, the last equal to generate's; the time to the first yield.
   beam_generate with 3 beams at 144: one beam equals greedy generate, the
   hypothesis's summed log-prob at least greedy's (less 0.5, both rescored
   by one forward), exact launches; tok/s and the cache reorder's ms.
   speculative_generate, k = 8, on a prompt whose text repeats, in bf16 and
   under load_4bit: exact launches (under int4 every verify step's
   products at 9 rows, the profile's count of the prefill kernel equal to
   the prefill's 128 and 65 a verify step); the acceptance rate, tok/s
   beside generate's, the first index where the tokens differ.
   chunked_prefill of a 3,072-token prompt in chunks of 512 against the
   one-shot prefill: cosine >= 0.99, the same argmax, 32 x 6 flash
   launches; ms and peak memory of both.  Then phase 8's small float32
   model, card against CPU: the same tokens from v2 generate (a captured
   decode), stream_generate, beam_generate, speculative_generate and
   chunked_prefill's argmax.

15. the Mistral and MPT decoder families at full width, one model at a
   time: LlavaConfig.llava_v15_7b_m3 with llama=LlamaConfig.mistral_7b()
   (32 layers, 32 heads over 8 KV heads, I 14,336, window 4,096, theta 1e6)
   and then LlamaConfig.mpt_7b() (vocab 50,432, alibi, fused Wqkv, GELU MLP,
   tied head), random bf16 weights made on the card by init_params, nothing
   cut.  Mistral: one-image requests at 36 and 576, 32 greedy tokens, a
   captured decode (32 flash launches a prefill, 32 decode launches a step,
   replays included, no paged launch), the 576 prefill against
   attn_impl="reference", the captured decode bit-identical to decode_chunk;
   a one-shot 4,608-token text prefill and a decode step past the window
   against attn_impl="reference" (cosine >= 0.99) and against
   sliding_window=0 (the window must move the logits farther), then a
   counted 32-token request of that prompt; the paged batcher (phase 7's
   options, 8 requests at 576: rows of ~700 slots) on the gather path with
   0 paged-kernel launches; load_4bit in place, one request at 576 (65
   int4_matmul and 32 quant_mlp launches a decode step), logits against
   disable_fused_proj().  MPT: bf16 requests at 144 with 0 flash, decode and
   paged launches (alibi attends through the plain path), the captured
   decode bit-identical to decode_chunk, an int8-KV request's tokens beside
   bf16 KV's, the paged batcher at 4 requests with 0 paged launches,
   load_4bit in place (128 int4_matmul and 0 quant_mlp launches a decode
   step; the tied head stays bf16), logits against disable_fused_proj().
   Printed with the card's name and power limit: TTFT, tok/s at B=1 and
   B=4, peak memory, a decode step's device ms by kernel; serving tok/s and
   ms a step.  Then a small float32 model of each family (Dh=128, Mistral
   with a window of 64 under prompts past it), card against CPU: the same
   greedy tokens from generate, the dense and paged batcher, and
   chunked_prefill's argmax.  Phase 3 also runs the kernels at these
   families' shapes: flash at S=4,608 with GQA 4 and the window, decode at
   Hkv=8 with the window at 672 and 4,640 slots (n_split printed), the
   quantized products at N 6,144 / 16,384 / 28,672 and K 14,336 / 16,384
   for M in {1, 8, 640, 3008} and quant_mlp at I=14,336, each held against
   its plain version, two launches bit-identical, timed beside the library
   or dequantize + F.linear.

16. multi-LoRA serving at the full width of llava-v1.5-7b-m3 (debug://7b,
   random bf16 weights, nothing cut) with two adapters, alpha and beta,
   r=128 alpha=256 on every LM projection (add_lora, lora_b seeded
   non-zero).  First s2_multiscale_forward at ViT-L/14-336 over (336, 672,
   1008), 14 tiles: bf16 against float32 (cosine >= 0.99), 336 alone bit
   for bit equal to clip_vision_forward, its ms.  The paged batcher of
   phase 7 (prefix_cache=True) with adapters= answers phase 7's 12
   requests under the adapters None / alpha / beta in turn, two requests
   each (the burst groups per adapter and scale): exact launches
   (paged attention L a step, quant_mlp 0), one replay a round, every
   budget, pages returned; one prompt under each adapter (each adapter
   changes the tokens) and alpha's repeat (its own salted chain hits, no
   other); 8 rows of the three adapters stopped in mid-decode: a replayed
   round bit-identical to paged_pool_decode with the pack, device ms a step
   of the eager round with and without the pack (the delta) and of the
   replay; each adapter's first-token logits from the batcher's prefill
   against generate's prefill on its load_lora params with
   attn_impl="reference" (cosine >= 0.99).  The same traffic with no
   adapter, then again under adapters over the base quantized to int4 in
   place with fuse=False (int4_matmul 7L + 1 = 225 a decode step and a
   prefill).  Printed with the card's name and power limit: tok/s, TTFT,
   ms a step, the pack's GiB, peak memory.  Then a small float32 model
   (Dh=128) with two rank-8 adapters, card against CPU: the batcher's
   tokens under each adapter equal its solo generate on both; bert_forward
   at bge-small widths for 8 prompts of 42 tokens, timed; a small train
   step with the textcls router (a tiny BERT), card against CPU within
   1e-3.  Phase 10 also gives one warm and two timed steps under
   remat=True, remat_policy="dots" and "names:attn" (step ms, peak memory,
   the flash forward launched twice a step but under names:attn).

17. the serving front end at the full width of llava-v1.5-7b-m3: the
   port's ModelWorker on debug://7b (random bf16 weights, seed 0, nothing
   cut) with continuous_batching=True, kv_backend="paged", max_batch=8,
   prefix_cache=True, warmup=True, limit_model_concurrency=10 and
   kv_cache_dtype="auto" (which must pick bf16), registered with a port
   Controller; both served by aiohttp on localhost in one event loop of
   this process (the SGLang app as the worker's), or, where aiohttp or
   requests does not import, driven in process through
   Controller.worker_api_generate_stream (the line printed says which).
   Importing the front end's modules sends sys.stdout into their logger:
   the phase keeps the script's own.  Through the controller: phase 7's 12
   greedy requests (8 as one burst, 4 late; scales 9 / 144 / 576; 32-64
   new tokens; one seeded PNG each) with 2 sampled requests (temperature
   0.7, top_p 0.9, 32 tokens) on the solo stream, each capturing its
   decode while the batcher's rounds replay; then on the SGLang route a
   json_schema request (the output full-matches the schema's regex) and
   one with a stop list (no stop word in the answer); then one sampled
   request alone.  Gates: error_code 0 on every chunk, paged-attention
   launches during the traffic, the lone request's flash launches one a
   layer and decode launches one a layer a step, the worker healthy at
   the end.  Printed with the card's name and power limit: TTFT p50 / max
   and tok/s of the 12, each sampled request's TTFT and tok/s beside the
   batch, the host ms a 64-token request spends re-decoding its answer at
   every chunk.  Then phase 8's small float32 model (Dh=128, a tiny CLIP
   tower at 336 pixels) saved as a checkpoint of the port, behind a
   batching worker and a solo worker on the card: a greedy request through
   each, and one cli.py turn (stdin patched), give the text of the port's
   generate.  The port's C++ image preprocessing builds with g++ and gives
   the PIL path's bits.

18. the eval layer at the full width of llava-v1.5-7b-m3 (debug://7b,
   random bf16 weights, nothing cut), run as a user runs it: each
   generator through its build_parser().parse_args and eval_model.  16
   POPE-style questions ("Is there a {object} in the image?\nAnswer the
   question using a single word or phrase.", conv mode llava_v1) over 8
   seeded JPEGs at COCO sizes through model_vqa_loader at
   ver=v0_numtoks=144 with 32 new tokens, at --batch-size 1 and 8, then at
   --batch-size 8 at scales 1 and 576 (a two-point scale sweep); each
   answers file scored by eval_pope against seeded yes/no labels.  Gates:
   every question answered once, every line with the JAX layout's keys,
   exact flash (32 a generate call) and decode launches (32 a decode
   step, replays included), one capture a generate call.  Printed with
   the card's name and power limit: questions/s and generated tok/s over
   the generate calls, TTFT p50 / max, the decode graphs' warm-up and
   capture ms and their share of the wall clock, POPE F1 and accuracy
   (meaningless on random weights).  Then phase 8's small float32 model
   (Dh=128, a CLIP tower at 336 pixels): the loader's answers at
   --batch-size 1 equal those at 8, --num-chunks 2 merged equal the
   whole run, and model_vqa, model_vqa_science (an image row and a
   text-only row) and model_vqa_qbench answer 2 questions each.
   model_vqa_mmbench and model_qa are left to the CPU tests;
19. the lmms-eval harness and the IG-VLM pipeline at the full width of
   llava-v1.5-7b-m3 (debug://7b, random bf16 weights, nothing cut), after a
   line saying that yaml, pandas and cv2 import.  The shipped pope task
   (its prompt and scoring hooks) over phase 18's 16 questions and 8 JPEGs
   as a local JSON with 32 new tokens: simple_evaluate(model="llava",
   batch_size=8, ver=v0_numtoks=144), gates exact flash (32 a generate
   call) and decode launches (31 x 32 a call, replays included), one
   capture a call, 16 samples, POPE metrics in [0, 1]; the adapter's
   loglikelihood on 8 image requests at scales 144 and 576, gates 32 flash
   launches a request and no decode launch, finite logprobs, one request's
   scored logits against attn_impl="reference" (cosine >= 0.99); the
   llava_sglang adapter's in-process worker (paged batcher, prefix cache,
   parallel=8, max_batch=8) over the 16 questions, gates paged-attention
   launches > 0, every response a string, and after close() no new thread
   alive and the device memory back within 256 MiB; IG-VLM's
   eval_llava_multiplechoice run over 2 seeded 640 x 480 mp4s of 8 frames
   (8 new tokens), gates a prediction a video and exact flash and decode
   launches.  Printed with the card's name and power limit: questions/s
   and generated tok/s, loglikelihood requests/s and ms a request per
   scale, llava_sglang questions/s, s a video.  Then phase 8's small
   float32 model: generate_until at batch 8 equals batch 1, a second
   llava_sglang run in the process answers as the llava adapter, and
   loglikelihood on the card equals the CPU's within 1e-4.
20. tensor-parallel inference (parallel/tp_decode.py), two ranks over gloo
   with both on this card (NCCL refuses two ranks on one device).  First
   the kernels at a 7B rank's shapes at tp = 2 and 4: int4_matmul /
   int8_matmul at fused qkv 6,144 / 3,072, o K 2,048 / 1,024, gate/up
   11,008 / 5,504, down K 5,504 / 2,752 and lm_head 16,000 / 8,000 rows for
   M in {1, 8, 640}, quant_mlp at I = 5,504 and 2,752 for M in {1, 8, 32},
   flash (640 queries, 672 slots) and decode attention (672 slots) at 16
   and 8 heads, each against its plain version, two launches
   bit-identical, M = 1 and the attention timed.  Then phase 8's small
   float32 model on a TPEngine: greedy tokens (one image a row, left-padded
   B=2, and text only) equal one card's and the CPU's, prefill logits
   within 1e-5 of one card's, sampled tokens under a seed equal one card's
   eager decode.  Then debug://7b through load_pretrained_model(tp_size=2,
   tp_devices=[cuda:0, cuda:0], tp_backend="gloo") in bf16 at scales 144
   and 576 with 32 greedy tokens: each rank launches what one card does
   (32 flash launches a prefill, 32 decode launches a step), prefill
   logits cosine >= 0.99 against one card's generate on the same weights;
   the same weights under load_4bit (144, 576) and load_8bit (144) with
   fuse=False: per rank 2L + 1 = 65 quantized products and 32 quant_mlp
   launches a decode step, 4L + 1 a prefill, logits against one card, and
   every rank's o and down K-shards dequantized equal the whole weight's
   columns bit for bit.  Printed with the card's name and power limit:
   each rank's peak memory, TTFT and ms a decode step at tp = 2 in bf16
   and int4 with the collectives' share of a step (torch.profiler's tp.*
   ranges on rank 0) beside one card's, as facts about two ranks sharing
   one card over gloo;
21. training across ranks (parallel/sharding.py), ranks that share this
   card over gloo, each a fresh process.  First the flash forward and
   both backward kernels at a 7B rank's shapes under tp = 2 (16 heads,
   Dh 128, 1,059 and 1,599 tokens, bf16) against their plain versions,
   timed beside the plain versions, the bound and the library.  Then a
   probe of DTensor's redistribution on CUDA tensors over gloo (a gather,
   its backward reduce-scatter, full_tensor) in two processes of its own:
   each step it takes, and their exit codes.  Then a world of two ranks:
   gloo's all-reduce, all-gather and reduce-scatter on CUDA tensors (taken
   or refused, ms); phase 11's small float32 MoE model at meshes (data,
   model) = (2, 1) and (1, 2), then phase 10's 7B LoRA recipe (its lora_b
   drawn from a seed, so that every lora_a has a gradient to compare) at
   (1, 2) with B=1 (all 32 layers, 16 heads a rank) and at (2, 1) with
   B=2 (one row a rank, the first SHARD_DP_LAYERS layers at full width);
   then a world of four ranks: the small model at (2, 2).
   Each case is held against the one-card step on the same batch (on rank
   0, before the ranks place their weights): the small model's loss and
   grad_norm within SHARD_SMALL_TOL relative and its updated trainable
   leaves within SHARD_SMALL_TOL as one vector (each leaf within
   SMALL_TRAIN_TOL of its max); the 7B loss within TRAIN_LOSS_TOL,
   grad_norm within SHARD_GN_TOL and the cosine of the flattened trainable
   gradients >= SHARD_COS; every rank launches #1 and #3 exactly as one
   card does (2*3*L and 3*L a 7B step) and leaves its frozen leaves
   bit-identical.  Printed with the card's name and power limit: seconds
   of the step, the collectives' seconds and share (rank 0's host time
   inside parallel/collectives.py's sp.* collectives, the ranges
   torch.profiler shows), each rank's peak memory.

22. the pipeline, ring attention and the placed-weight repairs, two ranks
   that share this card over gloo.  First #1 and #3 at a pipeline
   microbatch's shapes against their plain versions, and #1 at a ring
   step's blocks (4,096 queries and keys, 32 heads, Dh 128: full, diagonal
   and keyless) against its plain version and float32 attention (RING_TOL
   of the largest value); then a probe of the ring shift's routes in two
   processes of its own (gloo's send of a CUDA tensor, and the host-staged
   shift); one card's llama_forward of debug://7b's 32-layer decoder (B=4
   x 1,024 tokens, bf16, remat) forward and backward to the embeddings.
   Then one world of two ranks: the same decoder as a 2-stage pipeline of
   4 microbatches (each rank builds its 16 layers only), its hidden states
   and every rank's embeddings gradient against one card's (bit-identical)
   and its exact launches (#1 twice and #3 once for each of a stage's 16
   layers and 4 microbatches); ring attention at B=1, 32 heads, Dh 128,
   8,192 tokens (4,096 a rank) on the flash kernel, causal, non-causal and
   with a padded tail, against one card's kernel and float32 attention
   over the whole sequence (RING_TOL of the largest value), #1 launched 1
   and 2 times (causal) or 2 and 2 by rank, and the differentiable path in
   float32 at 2,048 tokens against attention_reference's gradients; MPT-7B
   widths (MPT_LAYERS layers) at (data, model) = (1, 2) against one card's
   logits (bit-identical); debug://7b widths (QUANT_LAYERS layers) under
   int4 and int8 (fuse=False) at (1, 2), the quantized kernels at a rank's
   shard shapes, logits (cosine >= QUANT_COS) and launches against one
   card; beam search on the small float32 model placed at (1, 2), tokens
   equal to one card's; the small MoE model's --bits 4 LoRA step at (2, 1)
   and (1, 2) against one card's, as phase 21 holds its small cases.
   Printed with the card's name and power limit: seconds of the pipeline
   step by rank, the shift's share, peak memory by rank, the ring's ms and
   shift share by rank.
23. orbax: the JAX package's checkpoint format on a host with no JAX, orbax,
   tensorstore or zstandard.  The port's zstd decoder (native/zstd.cpp) is
   built with g++ and decodes every committed zstandard frame of
   tests/data/torch_orbax/frames to its recorded SHA-256 (MB/s printed on
   the largest and on the level-1 float16 one); the committed JAX-written tiny checkpoint loads in float32
   through load_pretrained_model and gives the JAX greedy tokens recorded
   beside it, with #1 and #2 launched; debug://7b (SMOKE_DEPTH layers,
   bf16) is written by save_checkpoint and read back through
   load_pretrained_model in bf16 and under load_4bit, every leaf and 32
   greedy tokens bit-identical to the model in memory (quantized in place
   for load_4bit), exact launches of #1, #2, #4 and #6; write and read
   seconds and GB/s, the host's peak RSS, device memory at the peak, and
   phase 12's safetensors load GB/s of the same call beside them.

With arguments (`python3 chip_smoke.py kernels quant slice qslice paged hbm
serve smallinfer bwd train small ckpt anyres genmodes families famkernels
lora frontend eval harness tp shard pipe orbax`) only the build and the named phases run
(famkernels: phase 3's cases at the families' shapes), and no result line is
printed.

Depth: phases 4, 10, 12, 16, the quantized TP engines of 20, the 7B LoRA case
of 21 at tp = 2, the pipeline of 22, and 23 cut debug://7b's decoder to
SMOKE_DEPTH = 16 layers, widths unchanged (load_7b, cut_cfg), so that the
script ends within its limit on a card host whose CPU it shares; there, where
the text above says 32 layers (or 32 launches a step), read SMOKE_DEPTH.
Phases whose gates ask the kernel path and a reference for the same argmax
on random weights (5, 7, 13, 14, 15) keep 32 layers, as do the bf16 TP load
of 20, the HTTP worker of 17 and the eval and harness CLIs of 18-19.

Each kernel's record carries its bound: the larger of its bytes (inputs once,
outputs once) over 3.35 TB/s and its operations over 989 TFLOP/s, the H100
data sheet's rates, computed from this run's inputs; and, where one PyTorch
call computes the same function, that call's time (library_ms, timed in
the function of that name and used nowhere else).

The line before the last is the kernels' JSON record, the last line the
device JSON.  Needs no network and no package beyond torch and numpy.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

FLASH_TOL = 2e-2      # bf16 outputs, P rounded to bf16 before PV
LSE_TOL = 1e-3
MM_TOL = 1e-2         # of max|plain|: bf16 outputs, f32 sums in another order
MLP_TOL = 2e-2        # of max|plain|: the bf16 h may round the other way
LOGIT_COS = 0.99
L2_SWEEP = 150_000_000   # bytes: three times the H100's 50 MB L2 cache
SLEEP_CYCLES = 50_000_000  # ~30 ms: the host queues the timed calls meanwhile
# the 7B weight shapes (N, K) of the quantized projections
QUANT_SHAPES = {"qkv": (12288, 4096), "o": (4096, 4096),
                "gateup": (22016, 4096), "down": (4096, 11008),
                "lm_head": (32000, 4096)}
# rows held against the plain versions
QUANT_ROWS = (1, 2, 4, 8, 9, 20, 192, 640, 768, 1024)
# rows timed against the byte bound: decode rows (8: the serving step), a
# speculative verify of k + 1 = 9 rows and a ver=v2 step of 5 scales x 4
# rows, the last two through the prefill kernel
QUANT_TIMED_ROWS = (1, 4, 8, 9, 20)
QUANT_STEP_ROWS = (9, 20)         # also timed beside dequant_linear_ms
# prefill rows timed: a B=1 prefill at scales 144 and 576 (generate.py rounds
# T - 1 + numtoks up to 64) and a 1024-row serving admission; 768, the B=4
# batch at 144, is held only
QUANT_PREFILL_ROWS = (192, 640, 1024)
QUANT_SAME_BITS_ROWS = (1, 8, 9, 20, 640)   # two launches bit-identical
# long prefills, held and timed at the projections of a decoder layer: an
# anyres request at scale 576 (3,008 slots) and a serving group of 8 rows
# of 1,024.  Beside the kernel, the model's other route for a quantized
# projection, dequantize + bf16 F.linear (dequant_linear_ms), which it takes
# past MAX_FUSED_ROWS rows
QUANT_LONG_ROWS = (3008, 8192)
QUANT_LONG_SHAPES = ("qkv", "gateup", "down")
MLP_ROWS = (1, 4, 8, 20, 32)      # quant_mlp rows held (32: its limit)
# the quantized products' kernels, by the names a profile gives them: the
# prefill kernel was quant_mma_kernel before its wgmma design, a name kept so
# that ab_torch_phases.py --same-script also reads an older package's
QUANT_PREFILL_KERNELS = ("quant_wgmma_kernel", "quant_mma_kernel")
QUANT_KERNELS = ("quant_gemv_kernel",) + QUANT_PREFILL_KERNELS
# (label, load_pretrained_model options, requests as (batch, numtoks))
QUANT_RUNS = (
    ("int4", {"load_4bit": True}, ((1, 144), (1, 576), (4, 144))),
    ("int8", {"load_8bit": True}, ((1, 144),)),
    ("int4+kv8", {"load_4bit": True, "kv_cache_dtype": "int8"},
     ((4, 144),)),
)
PROFILE_MARGIN_S = 0.02   # a profiler window's margin on either side
# the runtime calls that launch work from the host, as the profiler names
# them: cudaLaunchKernel and its Ex / ExC forms, the lower-level
# cuLaunchKernel, and a captured graph's launch
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch")
SCALES = (1, 9, 36, 144, 576)
BATCH_SCALE = 144     # the scale of the left-padded B=4 batch
NEW_TOKENS = 32
EAGER_PROFILE_TOKENS = 8   # the eager loop's decode profile: 7 steps
PROMPT_LEN = 40
HBM_BYTES_S = 3.35e12    # H100 SXM data sheet: device memory rate
PEAK_FLOPS = 989e12      # and the dense bf16 rate of the tensor cores
# one decode step through the paged kernel against the gather path, logits
# cosine per row.  In float32 the two compute one function (readings on the
# live 7B pool: cosine 1.0 to seven digits, logits 3.5e-5 apart over a bf16
# pool cast up and 2.7e-4 over an int8 pool):
PAGED_COS_F32 = 0.999
# In bf16 one layer's attention comes out of either path half a bf16 unit of
# its output from the float32 attention (7.9e-3 at |out| = 3) and one unit
# from the other's (``live_attention_check`` prints them), and 32 layers of
# random weights amplify that: each path's logits read cosine 0.9986-0.9996
# against the float32 step's, and the same against each other's, the rows of
# under 100 tokens lowest.  So the kernel is held to the gather path's own
# distance from the float32 step, PAGED_EXCESS times it at most, and to a
# coarse floor against the gather path
PAGED_COS = 0.995
PAGED_EXCESS = 2.0
# rows of PAGED_LONG tokens or more are held to the float32 step's limit in
# bf16 too (they read 0.99944-0.99955)
PAGED_LONG = 200
# the serving slice: (numtoks, new tokens) of the 8 burst and 4 late requests
SERVE_BURST = ((9, 32), (9, 48), (144, 64), (144, 40), (144, 56), (576, 32),
               (576, 64), (576, 48))
SERVE_LATE = ((9, 64), (144, 32), (576, 40), (144, 48))
SERVE_RUNS = (("serve bf16", {}),
              ("serve int4+kv8", {"load_4bit": True,
                                  "kv_cache_dtype": "int8"}))
SERVE_KW = dict(backend="paged", max_batch=8, prefill_len=1024,
                max_new_tokens=128, page_size=64, chunk=8)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


@functools.cache
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them; printed
    beside every measurement."""
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])


def time_ms(fn, operands, reps: int = 20, warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn(*operands[i % len(operands)])``.

    The stream first sleeps on the card while the host queues the calls, so
    they run back to back and the host's launch cost (Python, ctypes) stays
    out of the interval between the two CUDA events.  ``operands`` holds
    copies of the inputs (``rotations``) that together exceed the L2 cache,
    so each call reads its operands from device memory, as the model's
    per-layer calls do."""
    for i in range(warmup):
        fn(*operands[i % len(operands)])
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*operands[i % len(operands)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: float, flops: float) -> dict:
    """The least time the card could take for this work: its bytes over the
    memory rate or its operations over the peak rate, whichever is
    larger."""
    t_bytes = moved_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_ms(kind: str, operands: list, **kw) -> float:
    """Yardsticks: the time of the ONE PyTorch call that computes the same
    function as a kernel on the same operands.  Timed here and used nowhere
    in the port (its package may not call these operators at all).
    ``flash``: (q, k, v) with ``kv_valid`` and index causality folded into
    one boolean mask; ``decode``: the decode wrapper's operands, the mask
    from ``valid``; ``copy``: (src, dst)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kind == "flash":
        Sq, Sk = operands[0][0].shape[2], operands[0][1].shape[2]
        dev = operands[0][0].device
        rel = torch.arange(Sq, device=dev)[:, None] + kw.get("offset", 0) \
            - torch.arange(Sk, device=dev)[None]
        causal = rel >= 0
        if kw.get("window"):
            causal = causal & (rel < kw["window"])
        mask = (kw["kv_valid"][:, None, None, :] & causal[None, None])
        return time_ms(lambda q, k, v: sdpa(
            q, k, v, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1]),
            operands)
    if kind == "flash_bwd":
        # forward + backward less the forward: (q, k, v, do) with the same
        # mask; the one call gives dq, dk and dv together
        Sq, Sk = operands[0][0].shape[2], operands[0][1].shape[2]
        dev = operands[0][0].device
        causal = torch.arange(Sk, device=dev)[None] <= \
            torch.arange(Sq, device=dev)[:, None]
        mask = (kw["kv_valid"][:, None, None, :] & causal[None, None])
        # a row with no key would give NaN in the library's softmax: let it
        # see itself, which changes no other row
        mask = mask | torch.eye(Sq, Sk, dtype=torch.bool, device=dev)

        def fwd(q, k, v, do):
            return sdpa(q, k, v, attn_mask=mask)

        def fwd_bwd(q, k, v, do):
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            return torch.autograd.grad(sdpa(q, k, v, attn_mask=mask),
                                       (q, k, v), do)

        return time_ms(fwd_bwd, operands, reps=10) \
            - time_ms(fwd, operands, reps=10)
    if kind == "decode":
        def call(q, k, v, valid, kv_pos, q_pos):
            return sdpa(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=valid[:, None, None, :],
                        enable_gqa=q.shape[1] != k.shape[2])
        return time_ms(call, operands)
    if kind == "copy":
        return time_ms(lambda src, dst: dst.copy_(src), operands)
    raise ValueError(kind)


def dev_us(e) -> float:
    """A profiler event's own device time in microseconds (the attribute's
    name depends on the version)."""
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0)


def profile_events(fn) -> tuple:
    """``(kernel events, launch calls)`` of one call of ``fn`` under
    ``torch.profiler``: device-side events only, since the operators that
    launched them would count the same device time twice; and the runtime
    calls that launched work from the host (``LAUNCH_CALLS``: a kernel each,
    or a whole captured graph)."""
    from torch.profiler import ProfilerActivity, profile

    # the profiler places the card's timestamps on the host's clock with an
    # offset that moves by a few ms and drops kernels that land outside the
    # window: keep it open a margin on each side
    # (scripts/diag_profiler_window.py)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = sum(e.count for e in events
                if e.device_type != torch.autograd.DeviceType.CUDA
                and e.key.startswith(LAUNCH_CALLS))
    return kernels, calls


def profile_kernels(fn) -> list:
    """The kernel events of one call of ``fn`` under ``torch.profiler``."""
    return profile_events(fn)[0]


def rotations(*tensors) -> list:
    """``tensors`` and copies of them, together at least ``L2_SWEEP``
    bytes."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, -(-L2_SWEEP // nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device() -> str:
    card = card_line()
    print(card)
    from matryoshka_mm_torch import _kernels

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")
    print(sh([_kernels._nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton not installed")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    """Build every source; print one line per compiled kernel (registers,
    shared memory, spills) instead of ptxas' five."""
    import contextlib
    import io

    from matryoshka_mm_torch import _kernels

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _kernels.build(verbose=True)
    _kernels.library()
    entry = None
    for line in log.getvalue().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            spill = ""
        elif "spill" in line and entry:
            spill = line.strip()
        elif "Used" in line and entry:
            # _ZN[<namespace>]..._cu_<hash><len><name>I<template args>E...
            short = re.sub(r"^_ZN\w*?_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+",
                           "", entry)
            short = short.split("EEv")[0][:60]
            print(f"[ptxas] {short}: {line.split(':', 1)[1].strip()}; "
                  f"{spill}")
            entry = None
        elif line.startswith("nvcc build"):
            print(line)
        elif "wgmma.mma_async" in line:   # ptxas serialized the products
            print(f"[ptxas] {line.strip()}")
    print(f"[build] {time.perf_counter() - t0:.2f} s")
    from matryoshka_mm_torch.ops import int4_matmul as mm

    if hasattr(mm, "mma_tile"):   # an older package (ab_torch_phases) has not
        for bits in (4, 8):
            tiles = []
            for M in QUANT_PREFILL_ROWS:
                for N in (4096, 12288):
                    (bm, tn, stages), smem = mm.mma_tile(bits, M, N)
                    tiles.append(f"M={M} N={N}: {bm} x {tn} a block, "
                                 f"{stages} stages, {smem} B")
            print(f"[build] prefill kernel int{bits} (shared memory a "
                  f"block): " + "; ".join(tiles))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)


# flash forward cases where a walk over 64 x 64 tiles goes wrong, run in
# bf16 (tensor cores) and float32 (FMA kernel): (label, B, H, Hkv, Sq, Sk,
# causal, window, q_offset, left padding of row 0, Dh)
FLASH_EDGES = (
    ("s63", 1, 4, 4, 63, 63, True, None, 0, 5, 128),
    ("s64 dh64", 1, 4, 4, 64, 64, True, None, 0, 0, 64),
    ("s65", 2, 4, 4, 65, 65, True, None, 0, 3, 128),
    ("s129", 1, 4, 4, 129, 129, True, None, 0, 64, 128),
    ("pad 70 dh64", 2, 4, 2, 129, 129, True, None, 0, 70, 64),
    ("pad 150", 2, 4, 4, 257, 257, True, None, 0, 150, 128),
    ("window 16", 2, 4, 4, 300, 300, True, 16, 0, 7, 128),
    ("window 150 dh64", 1, 4, 2, 300, 300, True, 150, 0, 70, 64),
    ("offset", 2, 4, 4, 70, 131, True, None, 40, 3, 128),
    ("offset window dh64", 1, 4, 4, 100, 260, True, 48, 160, 0, 64),
    ("gqa 4", 2, 8, 2, 200, 200, True, None, 0, 66, 128),
    ("gqa 8 dh64", 1, 8, 1, 131, 131, True, None, 0, 9, 64),
    ("non-causal", 2, 4, 4, 65, 130, False, None, 0, 4, 128),
)
# long shapes of the flash forward (B=1, H=32, Dh=128, causal): (label, S,
# left padding); bf16 kernel, plain version and library timed.  The training
# shapes, and an anyres prefill at scale 576 (a 5-tile image, 2,928 visual
# tokens in 3,008 slots)
FLASH_TRAIN = (("train", 1024, 37), ("train", 1599, 61), ("anyres", 3008, 41))
# chunked_prefill's last chunk of a 3,072-token prompt in chunks of 512:
# (Sq, cache slots, q_index_offset, left padding)
FLASH_CHUNK = (512, 3136, 2560, 41)
# decode cases: (label, B, H, Hkv, S, window); every row valid up to S - 20
# except that the last row's first 31 slots are not, the query at S - 21
DECODE_CASES = (
    ("b1", 1, 32, 32, 672, None), ("b4", 4, 32, 32, 672, None),
    ("gqa", 4, 32, 8, 672, None), ("window", 4, 32, 32, 672, 128),
    ("ragged", 2, 32, 32, 673, None), ("s40", 1, 32, 32, 40, None),
    ("s65", 1, 32, 32, 65, None),
    # slots 0-30 invalid and the last split (504-671 of 4) wholly masked
    ("masked split", 1, 32, 32, 672, None),
    ("long b1", 1, 32, 32, 4096, None),
    # an anyres request at scale 576: 3,008 prefill slots + 32 decode slots
    ("anyres b1", 1, 32, 32, 3040, None),
    # ver=v2 steps: 5 scales of one row, 5 scales of 4 rows
    ("b5", 5, 32, 32, 672, None), ("b20", 20, 32, 32, 672, None))
DECODE_INT8 = (
    ("int8 b1", 1, 32, 32, 672, None), ("int8 b4", 4, 32, 32, 673, None),
    ("int8 gqa", 4, 32, 8, 672, None), ("int8 window", 4, 32, 32, 673, 128))


def _pairs(valid, Sq, Sk, offset=0) -> int:
    """(query, valid slot) pairs under index causality, over the batch."""
    dev = valid.device
    sees = torch.arange(Sk, device=dev)[None] \
        <= torch.arange(Sq, device=dev)[:, None] + offset
    return int((valid[:, None, :] & sees[None]).sum())


def _flash_operands(gen, dev, dtype, B, H, Hkv, Sq, Sk, Dh, pad):
    """q, and K/V as the strided (B, Hkv, S, Dh) view of a (B, S, Hkv, Dh)
    cache layer, as the cached prefill passes them; row 0 left-padded."""
    def operand(heads, S):
        return torch.randn((B, S, heads, Dh), generator=gen, device=dev,
                           dtype=torch.float32).to(dtype).transpose(1, 2)

    q = torch.randn((B, H, Sq, Dh), generator=gen, device=dev,
                    dtype=torch.float32).to(dtype)
    k, v = operand(Hkv, Sk), operand(Hkv, Sk)
    valid = torch.ones((B, Sk), dtype=torch.bool, device=dev)
    valid[0, :pad] = False
    return q, k, v, valid


def flash_edge_cases(dev, gen) -> float:
    """The forward kernels against flash_attention_plain at the edges of a
    64 x 64 walk, both dtypes: tolerances, no NaN, zeros and lse = -1e30 on
    rows that see no key, the same bits from two launches.  Returns the
    largest error."""
    from matryoshka_mm_torch.ops import flash_attention as fl

    worst = 0.0
    for (label, B, H, Hkv, Sq, Sk, causal, window, offset, pad,
         Dh) in FLASH_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, valid = _flash_operands(gen, dev, dtype, B, H, Hkv, Sq,
                                             Sk, Dh, pad)
            kw = dict(causal=causal, kv_valid=valid, sliding_window=window,
                      q_index_offset=offset)
            out, lse = fl.flash_attention_lse(q, k, v, **kw)
            out2, lse2 = fl.flash_attention_lse(q, k, v, **kw)
            ref_o, ref_l = fl.flash_attention_plain(q, k, v, **kw)
            keyless = ~fl._mask(B, Sq, Sk, valid, causal, window, offset,
                                dev).any(-1)                 # (B, 1, Sq)
            keyless = keyless.expand(B, H, Sq)
            torch.cuda.synchronize()
            err = (out.float() - ref_o.float()).abs().max().item()
            lerr = (lse - ref_l).abs().max().item()
            name = f"flash {label} {str(dtype)[6:]}"
            print(f"[{name}] max|out-plain|={err:.3e} "
                  f"max|lse-plain|={lerr:.3e} keyless rows "
                  f"{int(keyless.sum())}")
            if not (bool(torch.isfinite(out).all())
                    and torch.allclose(out.float(), ref_o.float(),
                                       atol=FLASH_TOL, rtol=FLASH_TOL)
                    and lerr <= LSE_TOL):
                fail(f"{name} disagrees with its plain version")
            if not (bool((out[keyless] == 0).all())
                    and bool((lse[keyless] == fl.LSE_MASKED).all())):
                fail(f"{name}: a row without a key is not 0 / -1e30")
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                fail(f"{name}: two launches gave other bits")
            worst = max(worst, err)
    return worst


def flash_chunk_case(dev, gen, Dh) -> float:
    """The last chunk of ``chunked_prefill``'s 3,072-token prompt in chunks
    of 512 (FLASH_CHUNK): 512 queries at ``q_index_offset`` 2,560 against
    a 3,136-slot cache, left-padded, the slots past the prompt not yet
    written; against the plain version, two launches bit-identical, and
    timed beside the plain version and the library.  Returns the error."""
    from matryoshka_mm_torch.ops import flash_attention as fl

    Sq, Sk, offset, pad = FLASH_CHUNK
    q, k, v, valid = _flash_operands(gen, dev, torch.bfloat16, 1, 32, 32, Sq,
                                     Sk, Dh, pad)
    valid[:, offset + Sq:] = False
    kw = dict(kv_valid=valid, q_index_offset=offset)
    out, lse = fl.flash_attention_lse(q, k, v, **kw)
    out2, lse2 = fl.flash_attention_lse(q, k, v, **kw)
    ref_o, ref_l = fl.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref_o.float()).abs().max().item()
    lerr = (lse - ref_l).abs().max().item()
    if not (torch.allclose(out.float(), ref_o.float(), atol=FLASH_TOL,
                           rtol=FLASH_TOL) and lerr <= LSE_TOL):
        fail("flash chunk disagrees with its plain version")
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        fail("flash chunk: two launches gave other bits")
    ops = rotations(q, k, v)
    ms = time_ms(lambda *a: fl.flash_attention_lse(*a, **kw), ops)
    pms = time_ms(lambda *a: fl.flash_attention_plain(*a, **kw), ops, reps=3,
                  warmup=1)
    chunk_library_ms = library_ms("flash", ops, kv_valid=valid,
                                  offset=offset)
    flops = 4 * 32 * Dh * _pairs(valid, Sq, Sk, offset)
    b = bound(nbytes(q, k, v) + nbytes(out, lse), flops)
    print(f"[flash chunk] {card_line()}: Sq={Sq} q_index_offset={offset} "
          f"against {Sk} slots, {pad} padded: max|out-plain|={err:.3e} "
          f"max|lse-plain|={lerr:.3e}, two launches bit-identical; kernel "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)  plain {pms:.4f} ms"
          f"  bound {b['bound_ms']:.4f} ms by {b['bound_by']}  library "
          f"{chunk_library_ms:.4f} ms")
    return err


def phase_kernels(dev) -> dict:
    from matryoshka_mm_torch.ops import decode_attention as dec
    from matryoshka_mm_torch.ops import flash_attention as fl
    from matryoshka_mm_torch.ops.quant import _quantize_kv_slots

    gen = torch.Generator(device=dev).manual_seed(0)
    Dh, Sq, Sk, pad = 128, 640, 672, 23
    rec = {"flash_attention": {"err": 0.0}, "decode_attention": {"err": 0.0}}

    for name, H, Hkv, window in (("mha", 32, 32, None), ("gqa", 32, 8, None),
                                 ("window", 32, 32, 256)):
        q = _rand((1, H, Sq, Dh), gen, dev)
        # K/V as the strided (B, Hkv, S, Dh) view of a cache layer, as the
        # cached prefill passes them
        k = _rand((1, Sk, Hkv, Dh), gen, dev).transpose(1, 2)
        v = _rand((1, Sk, Hkv, Dh), gen, dev).transpose(1, 2)
        valid = torch.zeros((1, Sk), dtype=torch.bool, device=dev)
        valid[0, pad:Sq] = True                       # left-padded prompt
        kw = dict(kv_valid=valid, sliding_window=window)
        out, lse = fl.flash_attention_lse(q, k, v, **kw)
        ref_o, ref_l = fl.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref_o.float()).abs().max().item()
        lerr = (lse - ref_l).abs().max().item()
        ok = torch.allclose(out.float(), ref_o.float(), atol=FLASH_TOL,
                            rtol=FLASH_TOL) and lerr <= LSE_TOL
        print(f"[flash {name}] max|out-plain|={err:.3e} "
              f"max|lse-plain|={lerr:.3e}")
        if not ok:
            fail(f"flash {name} disagrees with its plain version")
        rec["flash_attention"]["err"] = max(rec["flash_attention"]["err"],
                                            err)
        if name == "mha":
            ops = rotations(q, k, v)
            r = rec["flash_attention"]
            r["ms"] = time_ms(lambda *a: fl.flash_attention_lse(*a, **kw), ops)
            r["plain_ms"] = time_ms(
                lambda *a: fl.flash_attention_plain(*a, **kw), ops, reps=5)
            r["library_ms"] = library_ms("flash", ops, kv_valid=valid)
            # pairs (query i, valid slot j <= i): 2 products of Dh each
            flops = 4 * H * Dh * _pairs(valid, Sq, Sk)
            r.update(bound(nbytes(q, k, v) + nbytes(out, lse), flops))
            _show("flash mha", r)
            print(f"[flash mha] {card_line()}: {flops / 1e9:.2f} GFLOP, "
                  f"kernel {flops / r['ms'] / 1e9:.1f} TFLOP/s, library "
                  f"{flops / r['library_ms'] / 1e9:.1f} TFLOP/s")
            ops32 = rotations(*(t.float() for t in (q, k, v)))
            ms32 = time_ms(lambda *a: fl.flash_attention_lse(*a, **kw), ops32)
            print(f"[flash mha f32] {card_line()}: the float32 FMA kernel "
                  f"{ms32:.4f} ms ({flops / ms32 / 1e9:.1f} TFLOP/s)")
            del ops, ops32

    # ---- the training shapes and the anyres prefill ----
    for label, S, tpad in FLASH_TRAIN:
        q, k, v, valid = _flash_operands(gen, dev, torch.bfloat16, 1, 32, 32,
                                         S, S, Dh, tpad)
        out, lse = fl.flash_attention_lse(q, k, v, kv_valid=valid)
        ref_o, ref_l = fl.flash_attention_plain(q, k, v, kv_valid=valid)
        torch.cuda.synchronize()
        err = (out.float() - ref_o.float()).abs().max().item()
        lerr = (lse - ref_l).abs().max().item()
        if not (torch.allclose(out.float(), ref_o.float(), atol=FLASH_TOL,
                               rtol=FLASH_TOL) and lerr <= LSE_TOL):
            fail(f"flash {label} {S} disagrees with its plain version")
        ops = rotations(q, k, v)
        ms = time_ms(lambda *a: fl.flash_attention_lse(*a, kv_valid=valid),
                     ops)
        pms = time_ms(lambda *a: fl.flash_attention_plain(*a, kv_valid=valid),
                      ops, reps=3, warmup=1)
        train_library_ms = library_ms("flash", ops, kv_valid=valid)
        flops = 4 * 32 * Dh * _pairs(valid, S, S)
        b = bound(nbytes(q, k, v) + nbytes(out, lse), flops)
        print(f"[flash {label} {S}] {card_line()}: max|out-plain|={err:.3e} "
              f"max|lse-plain|={lerr:.3e}; kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {pms:.4f} ms  bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']}  library "
              f"{train_library_ms:.4f} ms "
              f"({flops / train_library_ms / 1e9:.1f} TFLOP/s)")
        rec["flash_attention"]["err"] = max(rec["flash_attention"]["err"],
                                            err)
        del ops
    rec["flash_attention"]["err"] = max(
        rec["flash_attention"]["err"], flash_chunk_case(dev, gen, Dh),
        flash_edge_cases(dev, gen))

    sms = dec._sm_count(dev.index or 0)
    for name, B, H, Hkv, S, window in DECODE_CASES:
        q = _rand((B, H, Dh), gen, dev)
        k_all = _rand((2, B, S, Hkv, Dh), gen, dev)
        v_all = _rand((2, B, S, Hkv, Dh), gen, dev)
        valid = torch.zeros((B, S), dtype=torch.bool, device=dev)
        valid[:, :S - 20] = True
        valid[-1, :31] = False                        # a left-padded row
        n_split = dec.decode_splits(B, Hkv, S, sms)
        if name == "masked split":
            last = dec.split_ranges(S, n_split)[-1]
            valid[:, last[0]:] = False
        kv_pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
        q_pos = torch.full((B,), S - 21, device=dev, dtype=torch.int32)
        args = (q, k_all[1], v_all[1], valid, kv_pos, q_pos)
        got = dec.flash_decode_attention(*args, sliding_window=window)
        again = dec.flash_decode_attention(*args, sliding_window=window)
        want = dec.decode_attention_plain(*args, sliding_window=window)
        split = dec.decode_attention_split_plain(*args,
                                                 sliding_window=window,
                                                 n_split=n_split)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        serr = (got.float() - split.float()).abs().max().item()
        print(f"[decode {name}] B={B} S={S} n_split={n_split} "
              f"({B * Hkv * n_split} blocks) max|out-plain|={err:.3e} "
              f"max|out-split plain|={serr:.3e}")
        if not (torch.allclose(got.float(), want.float(), atol=FLASH_TOL,
                               rtol=FLASH_TOL)
                and torch.allclose(got.float(), split.float(),
                                   atol=FLASH_TOL, rtol=FLASH_TOL)):
            fail(f"decode {name} disagrees with its plain version")
        if not torch.equal(got, again):
            fail(f"decode {name}: two launches gave other bits")
        if name == "b1" and n_split < 2:
            fail(f"decode b1: the slots were not split (n_split {n_split})")
        rec["decode_attention"]["err"] = max(rec["decode_attention"]["err"],
                                             err)
        if name in ("b1", "b4", "anyres b1", "b5", "b20"):
            ops = rotations(*args)
            ms = time_ms(dec.flash_decode_attention, ops)
            plain = time_ms(dec.decode_attention_plain, ops, reps=5)
            case_library_ms = library_ms("decode", ops)
            slots = int(valid.sum())      # K and V of the valid slots
            b = bound(2 * slots * Hkv * Dh * 2 + nbytes(q, got, valid),
                      4 * H * Dh * slots)
            rec["decode_attention"][f"ms_{name}"] = ms
            rec["decode_attention"][f"plain_ms_{name}"] = plain
            print(f"[decode {name}] {card_line()}: kernel {ms:.4f} ms  "
                  f"plain {plain:.4f} ms  bound {b['bound_ms']:.4f} ms by "
                  f"{b['bound_by']}  library {case_library_ms:.4f} ms")
            if name == "b1":
                rec["decode_attention"].update(b, library_ms=case_library_ms)
    for name, B, H, Hkv, S, window in DECODE_INT8:
        q = _rand((B, H, Dh), gen, dev)
        kq, ks = _quantize_kv_slots(_rand((2, B, S, Hkv, Dh), gen, dev))
        vq, vs = _quantize_kv_slots(_rand((2, B, S, Hkv, Dh), gen, dev))
        valid = torch.zeros((B, S), dtype=torch.bool, device=dev)
        valid[:, :S - 20] = True
        valid[-1, :31] = False
        kv_pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
        q_pos = torch.full((B,), S - 21, device=dev, dtype=torch.int32)
        args = (q, kq[1], vq[1], valid, kv_pos, q_pos)
        kw = dict(sliding_window=window, k_scale=ks[1], v_scale=vs[1])
        n_split = dec.decode_splits(B, Hkv, S, sms)
        got = dec.flash_decode_attention(*args, **kw)
        again = dec.flash_decode_attention(*args, **kw)
        want = dec.decode_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"[decode {name}] B={B} S={S} n_split={n_split} "
              f"max|out-plain|={err:.3e}")
        if not torch.allclose(got.float(), want.float(), atol=FLASH_TOL,
                              rtol=FLASH_TOL):
            fail(f"decode {name} disagrees with its plain version")
        if not torch.equal(got, again):
            fail(f"decode {name}: two launches gave other bits")
        rec["decode_attention"]["err"] = max(rec["decode_attention"]["err"],
                                             err)
        if name == "int8 b1":
            ops = rotations(*args, ks[1], vs[1])

            def kernel(*a):
                return dec.flash_decode_attention(
                    *a[:6], sliding_window=window, k_scale=a[6],
                    v_scale=a[7])

            def plain_fn(*a):
                return dec.decode_attention_plain(
                    *a[:6], sliding_window=window, k_scale=a[6],
                    v_scale=a[7])

            ms = time_ms(kernel, ops)
            plain = time_ms(plain_fn, ops, reps=5)
            slots = int(valid.sum())      # int8 K and V, their f32 scales
            b = bound(2 * slots * Hkv * (Dh + 4) + nbytes(q, got, valid),
                      4 * H * Dh * slots)
            print(f"[decode {name}] {card_line()}: kernel {ms:.4f} ms  "
                  f"plain {plain:.4f} ms  bound {b['bound_ms']:.4f} ms by "
                  f"{b['bound_by']}  library none")
    rec["decode_attention"]["ms"] = rec["decode_attention"]["ms_b1"]
    rec["decode_attention"]["plain_ms"] = \
        rec["decode_attention"]["plain_ms_b1"]
    _show("decode b1", rec["decode_attention"])
    for name, err in family_attention_cases(dev).items():
        rec[name]["err"] = max(rec[name]["err"], err)
    return rec


def _show(label: str, r: dict) -> None:
    lib = r.get("library_ms")
    print(f"[{label}] {card_line()}: kernel {r['ms']:.4f} ms  plain "
          f"{r['plain_ms']:.4f} ms  "
          f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}  library "
          + ("none" if lib is None else f"{lib:.4f} ms"))


def _rel_err(got, want) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-9)


def phase_quant_kernels(dev) -> dict:
    """int4_matmul / int8_matmul at the 7B projections and quant_mlp at 7B
    widths against their plain versions, at every row count of
    QUANT_ROWS / MLP_ROWS; two launches bit-identical at the rows of
    QUANT_SAME_BITS_ROWS (M = 1 and 8 for quant_mlp); the decode rows of
    QUANT_TIMED_ROWS timed with their GB/s and their share of the byte
    bound, the prefill rows of QUANT_PREFILL_ROWS with their TFLOP/s and
    their share of the operations bound, each beside ``bf16_linear_ms``,
    the time of bf16 ``F.linear`` (cuBLAS) on the dequantized weight of the
    same shape: a yardstick of what the quantized bytes buy, not the same
    function (no library call computes it, so ``library_ms`` stays None).
    Each record's ``ms`` / ``plain_ms`` is the B=1 decode time of the qkv
    projection (matmuls) or of one layer's MLP (quant_mlp)."""
    from matryoshka_mm_torch.ops import fused_mlp as mlp
    from matryoshka_mm_torch.ops import int4_matmul as mm
    from matryoshka_mm_torch.ops import quant

    linear = torch.nn.functional.linear
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = {}

    def timed(line, r, tag, fn, plain, ops, lin_fn, lin_ops, moved=None,
              flops=None):
        """Times of the kernel, its plain version and the bf16 yardstick,
        kept in ``r`` under ``tag`` and appended to ``line`` with the rate
        against the byte bound (``moved``) or the operations bound
        (``flops``)."""
        ms = time_ms(fn, ops)
        pms = time_ms(plain, ops, reps=3, warmup=1)
        lin = time_ms(lin_fn, lin_ops)
        r[f"ms_{tag}"], r[f"plain_ms_{tag}"] = ms, pms
        r[f"bf16_linear_ms_{tag}"] = lin
        if flops is None:
            t = moved / HBM_BYTES_S * 1e3
            rate = (f"{moved / ms / 1e6:.1f} GB/s, {100 * t / ms:.0f}% of "
                    f"the byte bound {t:.4f} ms")
        else:
            t = flops / PEAK_FLOPS * 1e3
            rate = (f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * t / ms:.0f}% "
                    f"of the operations bound {t:.4f} ms")
        return (line + f"  kernel {ms:.4f} ms  plain {pms:.4f} ms  {rate}  "
                f"bf16_linear_ms {lin:.4f} ({lin / ms:.2f}x the kernel's "
                f"time)")

    for bits, name in ((4, "int4_matmul"), (8, "int8_matmul")):
        fn = getattr(mm, name)
        plain = getattr(mm, f"{name}_plain")
        quantize = quant.quantize_array_int4 if bits == 4 \
            else quant.quantize_array
        key = quant.Q4KEY if bits == 4 else quant.QKEY
        r = rec[name] = {"err": 0.0}
        for shape, (N, K) in QUANT_SHAPES.items():
            leaf = quantize(_rand((N, K), gen, dev).mul_(0.02))
            w, sc = leaf[key], leaf["scale"]
            wdq = quant.dequantize_array(leaf)   # the yardstick's weight
            del leaf
            rows = QUANT_ROWS + (QUANT_LONG_ROWS
                                 if shape in QUANT_LONG_SHAPES else ())
            for M in rows:
                x = _rand((M, K), gen, dev)
                got = fn(x, w, sc)
                err, rel = _rel_err(got, plain(x, w, sc))
                torch.cuda.synchronize()
                line = (f"[{name} {shape} {N}x{K} M={M}] max|out-plain|="
                        f"{err:.3e} rel {rel:.2e}")
                if rel > MM_TOL:
                    fail(f"{name} {shape} M={M} disagrees with its plain "
                         f"version")
                if M in QUANT_SAME_BITS_ROWS:
                    if not torch.equal(got, fn(x, w, sc)):
                        fail(f"{name} {shape} M={M}: two launches differ")
                    line += "  two launches bit-identical"
                r["err"] = max(r["err"], err)
                if M in QUANT_TIMED_ROWS:
                    moved = nbytes(x, w, sc) + M * N * 2
                    line = timed(line, r, f"{shape}_{M}", fn, plain,
                                 rotations(x, w, sc), linear,
                                 rotations(x, wdq), moved=moved)
                    if (shape, M) == ("qkv", 1):
                        r.update(bound(moved, 2 * M * N * K),
                                 library_ms=None)
                elif M in QUANT_PREFILL_ROWS + QUANT_LONG_ROWS:
                    line = timed(line, r, f"{shape}_{M}", fn, plain,
                                 rotations(x, w, sc), linear,
                                 rotations(x, wdq), flops=2 * M * N * K)
                if M in QUANT_LONG_ROWS + QUANT_STEP_ROWS:
                    dq = time_ms(lambda x, w, sc: linear(
                        x, quant.dequantize_array({key: w, "scale": sc})),
                        rotations(x, w, sc), reps=5)
                    r[f"dequant_linear_ms_{shape}_{M}"] = dq
                    line += (f"  dequant_linear_ms {dq:.4f} "
                             f"({dq / r[f'ms_{shape}_{M}']:.2f}x the "
                             f"kernel's time)")
                print(line)
            del w, sc, wdq
        r["ms"], r["plain_ms"] = r["ms_qkv_1"], r["plain_ms_qkv_1"]
        _show(f"{name} qkv M=1", r)

    r = rec["quant_mlp"] = {"err": 0.0}
    D, I = 4096, 11008
    for bits in (4, 8):
        quantize = quant.quantize_array_int4 if bits == 4 \
            else quant.quantize_array
        key = quant.Q4KEY if bits == 4 else quant.QKEY
        gate = quantize(_rand((I, D), gen, dev).mul_(0.02))
        up = quantize(_rand((I, D), gen, dev).mul_(0.02))
        gateup = {key: torch.cat([gate[key], up[key]]),
                  "scale": torch.cat([gate["scale"], up["scale"]])}
        del gate, up
        down = quantize(_rand((D, I), gen, dev).mul_(0.02))
        gu_dq, dn_dq = (quant.dequantize_array(l) for l in (gateup, down))

        def call(f):
            return lambda x, gq, gs, dq, ds: f(
                x, {key: gq, "scale": gs}, {key: dq, "scale": ds}, bits, I)

        def bf16_mlp(x, gu, dn):   # the yardstick: three cuBLAS products
            g, u = linear(x, gu).chunk(2, dim=-1)
            return linear(torch.nn.functional.silu(g) * u, dn)

        for M in MLP_ROWS:
            x = _rand((M, D), gen, dev)
            got = mlp.quant_mlp(x, gateup, down, bits, I)
            err, rel = _rel_err(got, mlp.quant_mlp_plain(x, gateup, down,
                                                         bits, I))
            torch.cuda.synchronize()
            line = (f"[quant_mlp int{bits} M={M}] max|out-plain|={err:.3e} "
                    f"rel {rel:.2e}")
            if rel > MLP_TOL:
                fail(f"quant_mlp int{bits} M={M} disagrees with its plain "
                     f"version")
            if M in (1, 8, 20):
                if not torch.equal(got, mlp.quant_mlp(x, gateup, down, bits,
                                                      I)):
                    fail(f"quant_mlp int{bits} M={M}: two launches differ")
                line += "  two launches bit-identical"
            r["err"] = max(r["err"], err)
            if M in QUANT_TIMED_ROWS:
                ops = rotations(x, gateup[key], gateup["scale"], down[key],
                                down["scale"])
                moved = nbytes(*ops[0]) + M * D * 2
                line = timed(line, r, f"int{bits}_{M}", call(mlp.quant_mlp),
                             call(mlp.quant_mlp_plain), ops, bf16_mlp,
                             rotations(x, gu_dq, dn_dq), moved=moved)
                if (bits, M) == (4, 1):
                    r.update(bound(moved, 2 * M * 3 * I * D),
                             library_ms=None)
                del ops
            print(line)
        del gateup, down, gu_dq, dn_dq
    r["ms"], r["plain_ms"] = r["ms_int4_1"], r["plain_ms_int4_1"]
    _show("quant_mlp int4 M=1", r)
    for name, err in family_quant_cases(dev).items():
        rec[name]["err"] = max(rec[name]["err"], err)
    return rec


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------

def make_prompt(rng, length, vocab):
    ids = rng.integers(100, vocab, (length,)).astype(np.int32)
    ids[0] = 1                                        # BOS
    ids[5] = -200                                     # the image sentinel
    return ids


# The decoder depth of the phases that make llava-v1.5-7b-m3 (or another
# 7B family) themselves: the whole script has to end within its 1,200 s on
# a card host whose CPU it shares, and took 1,321.5 s at 32 layers on one
# such host (NVIDIA H100 80GB HBM3, 700 W).  Widths stay the published ones;
# the entry points that make debug://7b inside the port (the TP engine's
# bf16 load, the HTTP worker, the eval and harness CLIs) keep 32 layers.
SMOKE_DEPTH = 16


def cut_cfg(cfg, layers: int = SMOKE_DEPTH):
    """``cfg`` with its decoder cut to ``layers`` layers."""
    import dataclasses

    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_hidden_layers=layers))


def load_7b(dev, load_4bit=False, load_8bit=False, kv_cache_dtype=""):
    """load_pretrained_model("debug://7b") with the decoder cut to
    SMOKE_DEPTH layers before it is quantized, as the loader quantizes
    (load_4bit wins; fused projections)."""
    from matryoshka_mm_torch.models.builder import (LlavaModel, _quantize,
                                                    load_pretrained_model)

    tok, model, proc, ctx = load_pretrained_model("debug://7b",
                                                  device=str(dev))
    params, cfg = model.params, cut_cfg(model.cfg)
    params["llama"]["layers"] = params["llama"]["layers"][:SMOKE_DEPTH]
    del model
    _quantize(params, load_8bit, load_4bit, True)
    if kv_cache_dtype:
        cfg = cfg.with_kv_cache_dtype(kv_cache_dtype)
    return tok, LlavaModel(params, cfg), proc, ctx


def make_inputs(cfg) -> dict:
    """batch -> (ids, pixels, mask): one B=1 prompt and a left-padded B=4
    batch, from a seed."""
    rng = np.random.default_rng(0)
    vocab, size = cfg.llama.vocab_size, cfg.vision.image_size
    px1 = rng.standard_normal((1, 3, size, size)).astype(np.float32)
    ids1 = make_prompt(rng, PROMPT_LEN, vocab)[None]
    lens4 = (PROMPT_LEN, 33, 28, 37)
    ids4 = np.zeros((4, PROMPT_LEN), np.int32)
    mask4 = np.zeros((4, PROMPT_LEN), bool)
    for b, n in enumerate(lens4):
        ids4[b, PROMPT_LEN - n:] = make_prompt(rng, n, vocab)
        mask4[b, PROMPT_LEN - n:] = True
    px4 = rng.standard_normal((4, 3, size, size)).astype(np.float32)
    return {1: (ids1, px1, None), 4: (ids4, px4, mask4)}


def run(model, inputs, numtoks, new_tokens, cuda_graph=True,
        image_sizes=None, spec=None, **kw):
    """One ``generate`` request at ``ver=v0_numtoks=<numtoks>``, or at the
    scale spec ``spec``; its decode replays a captured step unless
    ``cuda_graph=False`` asks for the eager loop.  ``kw`` goes to
    ``LlavaModel.generate`` (``num_beams``, ``speculative``)."""
    ids, px, mask = inputs
    spec = spec or f"ver=v0_numtoks={numtoks}"
    out = model.generate(ids, images=px, attention_mask=mask,
                         image_sizes=image_sizes,
                         matryoshka_vis_token_scale=spec,
                         max_new_tokens=new_tokens, eos_token_id=-1,
                         cuda_graph=cuda_graph, **kw)
    torch.cuda.synchronize()
    if out.shape != (ids.shape[0], new_tokens) or out.min() < 0 \
            or out.max() >= model.cfg.llama.vocab_size:
        fail(f"{spec}: output {out.shape} ids [{out.min()}, {out.max()}]")
    return out


def prefill_logits(model, cfg, inputs, numtoks):
    """Last-position logits of row 0 after one prefill, in f32."""
    from matryoshka_mm_torch.generate import _round_up, prefill_image

    dev = model.params["llama"]["embed_tokens"].device
    ids, px, mask = inputs
    L = _round_up(ids.shape[1] - 1 + numtoks, 64)
    mask_t = None if mask is None else torch.as_tensor(mask, device=dev)
    return prefill_image(model.params, cfg,
                         torch.as_tensor(ids, dtype=torch.int64, device=dev),
                         torch.as_tensor(px, device=dev), mask_t, numtoks, L,
                         L + NEW_TOKENS)[0][0].float()


def compare_logits(a, b, what, need_same_top: bool) -> None:
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
    same_top = int(a.argmax()) == int(b.argmax())
    print(f"[{what}] prefill logits: cosine {cos:.6f} finite {finite} "
          f"same argmax {same_top}")
    if not (finite and cos >= LOGIT_COS) or (need_same_top and not same_top):
        fail(f"{what}: kernel-path logits disagree with the reference")


def time_requests(model, inputs, numtoks, label, reps=(3, 2)) -> tuple:
    """Median TTFT (1 token) and decode tok/s (NEW_TOKENS tokens) on the
    host clock, each request ending in a synchronize."""
    ttft = statistics.median(
        _wall(lambda: run(model, inputs, numtoks, 1)) for _ in range(reps[0]))
    full = statistics.median(
        _wall(lambda: run(model, inputs, numtoks, NEW_TOKENS))
        for _ in range(reps[1]))
    batch = inputs[0].shape[0]
    rate = batch * (NEW_TOKENS - 1) / (full - ttft)
    print(f"[{label}] B={batch} numtoks={numtoks:4d} TTFT {ttft * 1e3:.2f} ms"
          f"  decode {rate:.2f} tok/s  (prefill slots "
          f"{-(-(PROMPT_LEN - 1 + numtoks) // 64) * 64})")
    return ttft, rate


def decode_profile(model, inputs, numtoks, label, cuda_graph=True,
                   prefill=True, top=0, decode=True, base=None) -> tuple:
    """Device ms a decode step of ``generate``, and the quantized products'
    ms and launches a step: the kernels of a NEW_TOKENS run less those of a
    1-token run (the same prefill), under ``torch.profiler``; kernels and
    Python launch calls (``LAUNCH_CALLS``) a step the same way; a check
    that the profiler sees the kernels of the decode.  The eager loop is
    profiled over EAGER_PROFILE_TOKENS instead: it launches the same
    kernels every step, and its profile of ~1,700 launches a step is slow
    to process.  With ``prefill``, the 1-token run's prefill (vision tower
    included): its device ms and the quantized prefill kernel's ms,
    launches and share of it.  With ``top``, the ``top`` kernels of a
    decode step by device time.  Without ``decode``, the prefill alone.
    ``base`` is the 1-token run's profile of an earlier call on the same
    request, which both modes share (each profile takes seconds to
    process).  Returns ``(device ms a decode step or None, the 1-token
    run's profile)``."""
    sums, calls, counts, by_name = [], [], [], []
    if base is not None:
        for acc, x in zip((sums, calls, counts, by_name), base):
            acc.append(x)
    last = NEW_TOKENS if cuda_graph else EAGER_PROFILE_TOKENS
    for n in (1, last)[:1 + decode]:
        if n == 1 and base is not None:
            continue
        kernels, n_calls = profile_events(
            lambda: run(model, inputs, numtoks, n, cuda_graph))
        quant = [e for e in kernels if any(k in e.key for k in QUANT_KERNELS)]
        sums.append((sum(dev_us(e) for e in kernels),
                     sum(dev_us(e) for e in quant),
                     sum(e.count for e in quant)))
        calls.append(n_calls)
        counts.append(sum(e.count for e in kernels))
        by_name.append({e.key: (dev_us(e), e.count) for e in kernels})
        if n == 1 and prefill:
            tile = [e for e in kernels
                    if any(k in e.key for k in QUANT_PREFILL_KERNELS)]
            tile_us = sum(dev_us(e) for e in tile)
            print(f"[{label}] {card_line()}: B={inputs[0].shape[0]} numtoks="
                  f"{numtoks} prefill profile: device {sums[0][0] / 1e3:.3f}"
                  f" ms, quantized prefill kernel {tile_us / 1e3:.3f} ms over "
                  f"{sum(e.count for e in tile)} launches "
                  f"({100 * tile_us / sums[0][0]:.1f}% of the device time)")
    base = (sums[0], calls[0], counts[0], by_name[0])
    if not decode:
        return None, base
    steps = last - 1
    (dev1, q1, n1), (dev_n, q_n, n_n) = sums[0], sums[-1]
    mode = "graph" if cuda_graph else "eager"
    print(f"[{label}] {card_line()}: B={inputs[0].shape[0]} numtoks="
          f"{numtoks} decode profile ({mode}, a {last}-token run less a "
          f"1-token run): device "
          f"{(dev_n - dev1) / 1e3 / steps:.3f} ms/step, quantized products "
          f"{(q_n - q1) / 1e3 / steps:.4f} ms/step over {(n_n - n1) // steps} "
          f"launches a step; {(counts[-1] - counts[0]) / steps:.1f} kernels "
          f"and {(calls[-1] - calls[0]) / steps:.2f} Python launch calls a "
          f"step")
    if counts[-1] - counts[0] <= 0:
        fail(f"{label}: the profiler shows no kernel of the decode "
             f"({mode})")
    step = {k: (us - by_name[0].get(k, (0, 0))[0],
                n - by_name[0].get(k, (0, 0))[1])
            for k, (us, n) in by_name[-1].items()}
    for k, (us, n) in sorted(step.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{label}]   {us / 1e3 / steps:8.4f} ms/step  "
              f"x{n / steps:6.1f}  {k[:90]}")
    return (dev_n - dev1) / 1e3 / steps, base


def decode_bits(model, inputs, numtoks, label, image_sizes=None,
                spec=None) -> None:
    """The captured decode against ``decode_chunk`` on the card, from one
    prefill's cache and a copy of it: the NEW_TOKENS - 1 steps' tokens and
    the last step's logits must be bit-identical (the same kernels in the
    same order).  With a ``ver=v2`` ``spec`` the prefill is
    ``prefill_scales``' and both decodes combine its scales' logits.
    Prints the capture's ms and the warm-up step's."""
    from matryoshka_mm_torch.generate import (DecodeGraph, GenerationConfig,
                                              LogitCombiner, _prefill_dispatch,
                                              _round_up, _select_token,
                                              decode_chunk, prefill_scales)
    from matryoshka_mm_torch.kvconfig import parse_kv_from_string

    ids, px, mask = inputs
    dev = model.params["llama"]["norm"].device
    steps = NEW_TOKENS - 1
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, decode_chunk=steps,
                           eos_token_id=-1)
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    px_t = torch.as_tensor(px, device=dev)
    combine = None
    with torch.inference_mode():
        if spec is None:
            logits, cache_a, lengths = _prefill_dispatch(
                model.params, model.cfg, ids_t, px_t, mask, numtoks, gen,
                image_sizes)
        else:
            combine = LogitCombiner(parse_kv_from_string(spec), dev)
            L = _round_up(ids.shape[1] - 1 + max(combine.scales), 64)
            logits_k, cache_a, lengths = prefill_scales(
                model.params, model.cfg, ids_t, px_t,
                None if mask is None else torch.as_tensor(mask, device=dev),
                combine.scales, L, L + NEW_TOKENS)
            logits = combine(logits_k)
        first = _select_token(logits, gen, None)
        cache_b = _copy_cache(cache_a)
        finished = torch.zeros_like(first, dtype=torch.bool)
        _, _, _, toks, last = decode_chunk(
            model.params, model.cfg, gen, cache_a, first, lengths, finished,
            steps, return_logits=True, combine=combine)
        graph = DecodeGraph(model.params, model.cfg, gen, cache_b, first,
                            lengths, finished, combine=combine)
        got = graph.run(steps)
        torch.cuda.synchronize()
    same = bool(torch.equal(got, toks) and torch.equal(graph.logits, last))
    what = spec or f"numtoks={numtoks}"
    print(f"[{label}] {card_line()}: B={ids.shape[0]} {what} "
          f"captured decode vs decode_chunk over {steps} steps: tokens and "
          f"last logits bit-identical {same}; capture "
          f"{graph.graph.capture_ms:.1f} ms, warm-up step "
          f"{graph.graph.warmup_ms:.1f} ms")
    if not same:
        fail(f"{label}: the captured decode's tokens or logits differ from "
             f"decode_chunk's")


def decode_ab(model, inputs, label, numtoks=BATCH_SCALE) -> None:
    """Decode tok/s of the eager loop (E) and the captured graph (G) in turns
    E G G E at B=1 and B=4, each run a ``generate`` of NEW_TOKENS tokens
    less the median 1-token run (so a graph run pays its warm-up step and
    capture); the wall ms a step, and for the graph also the replays alone
    (a run less its warm-up step and capture, over the steps replayed); the
    capture's and the warm-up step's ms; then at B=1 each mode's decode
    profile (the graph's top kernels) and device idle
    share (1 - device ms / wall ms a step)."""
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    steps = NEW_TOKENS - 1
    for batch in (1, 4):
        x = inputs[batch]
        ttft = statistics.median(_wall(lambda: run(model, x, numtoks, 1))
                                 for _ in range(2))
        walls = {False: [], True: []}
        capture, warmup = [], []
        for graph in (False, True, True, False):
            cap0, warm0 = CapturedStep.capture_s, CapturedStep.warmup_s
            walls[graph].append(_wall(lambda: run(model, x, numtoks,
                                                  NEW_TOKENS, graph)) - ttft)
            if graph:
                capture.append(CapturedStep.capture_s - cap0)
                warmup.append(CapturedStep.warmup_s - warm0)
        replay_ms = statistics.median(
            w - c - u for w, c, u in zip(walls[True], capture, warmup)) \
            * 1e3 / (steps - 1)
        rates = {g: [batch * steps / w for w in ws] for g, ws in walls.items()}
        wall_ms = {g: statistics.median(ws) * 1e3 / steps
                   for g, ws in walls.items()}
        print(f"[{label}] {card_line()}: B={batch} numtoks={numtoks} decode "
              f"tok/s in turns E G G E: eager {rates[False][0]:.2f}, graph "
              f"{rates[True][0]:.2f}, graph {rates[True][1]:.2f}, eager "
              f"{rates[False][1]:.2f}; wall ms a step eager "
              f"{wall_ms[False]:.3f}, graph {wall_ms[True]:.3f} (replays "
              f"alone {replay_ms:.3f}); capture "
              f"{statistics.median(capture) * 1e3:.1f} ms, warm-up step "
              f"{statistics.median(warmup) * 1e3:.1f} ms a request")
        if batch != 1:
            continue
        base = None
        for graph in (False, True):
            dev_ms, base = decode_profile(
                model, x, numtoks, label, graph, prefill=False,
                top=8 if graph else 0, base=base)
            alone = (f"; replays alone: device idle "
                     f"{max(0.0, 1 - dev_ms / replay_ms):.3f}" if graph
                     else "")
            print(f"[{label}] {card_line()}: B={batch} numtoks={numtoks} "
                  f"{'graph' if graph else 'eager'}: wall "
                  f"{wall_ms[graph]:.3f} ms/step, device {dev_ms:.3f} "
                  f"ms/step, device idle "
                  f"{max(0.0, 1 - dev_ms / wall_ms[graph]):.3f}{alone}")


def graph_tally() -> tuple:
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    return CapturedStep.captures, CapturedStep.replays


def check_graphs(label, before, captures, replays) -> None:
    """The run since ``before = graph_tally()`` captured and replayed as
    many graphs as its decode steps need."""
    got = tuple(a - b for a, b in zip(graph_tally(), before))
    print(f"[{label}] CUDA graphs captured {got[0]}, replayed {got[1]}; "
          f"expected {captures}, {replays}")
    if got != (captures, replays):
        fail(f"{label}: the decode did not replay its captured graphs as "
             f"expected")


def phase_slice(dev) -> dict:
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, model, _, _ = load_7b(dev)
    torch.cuda.synchronize()
    print(f"[slice] debug://7b ({SMOKE_DEPTH} layers) made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = model.cfg
    n_layers = cfg.llama.num_hidden_layers
    inputs = make_inputs(cfg)

    # ---- the counted main-path run ----
    requests = [(1, n) for n in SCALES] + [(4, BATCH_SCALE)]
    flash_attention_lse.launches = 0
    flash_decode_attention.launches = 0
    tally = graph_tally()
    outs = [run(model, inputs[b], n, NEW_TOKENS) for b, n in requests]
    launches = {"flash_attention": flash_attention_lse.launches,
                "decode_attention": flash_decode_attention.launches}
    want = {"flash_attention": len(requests) * n_layers,
            "decode_attention": len(requests) * (NEW_TOKENS - 1) * n_layers}
    print(f"[slice] launches {launches} expected {want}")
    if launches != want:
        fail("the main path did not go through the kernels as expected")
    # each request: a warm-up step, a capture, a replay for every other step
    check_graphs("slice", tally, len(requests),
                 len(requests) * (NEW_TOKENS - 2))
    print(f"[slice] B=1 tokens at {BATCH_SCALE}: "
          f"{outs[SCALES.index(BATCH_SCALE)][0, :12].tolist()}")

    # ---- kernel path against attn_impl="reference" on one prefill ----
    compare_logits(
        prefill_logits(model, cfg, inputs[1], BATCH_SCALE),
        prefill_logits(model, cfg.with_attn_impl("reference"), inputs[1],
                       BATCH_SCALE), "slice", need_same_top=False)

    decode_bits(model, inputs[1], BATCH_SCALE, "slice")

    # ---- timings (after the counted run, which warmed everything up) ----
    for n in SCALES:
        time_requests(model, inputs[1], n, "slice", reps=(2, 1))
    time_requests(model, inputs[4], BATCH_SCALE, "slice", reps=(2, 1))
    decode_ab(model, inputs, "slice")
    print(f"[slice] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"launches": launches}


def phase_quant_slice(dev) -> dict:
    """The quantized configurations at full width; returns the launch counts
    summed over their counted runs."""
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.ops import fused_mlp, int4_matmul
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.ops.quant import disable_fused_proj

    counters = {"int4_matmul": int4_matmul.int4_matmul,
                "int8_matmul": int4_matmul.int8_matmul,
                "quant_mlp": fused_mlp.quant_mlp,
                "decode_attention": flash_decode_attention,
                "flash_attention": flash_attention_lse}
    total = dict.fromkeys(counters, 0)
    for label, options, requests in QUANT_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, model, _, _ = load_pretrained_model("debug://7b", device=str(dev),
                                               **options)
        torch.cuda.synchronize()
        print(f"[{label}] debug://7b {options} made and quantized on the "
              f"card in {time.perf_counter() - t0:.1f} s: decoder weights "
              f"{_nbytes(model.params['llama']) / 2**30:.2f} GiB, peak while "
              f"quantizing {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB")
        torch.cuda.reset_peak_memory_stats()
        cfg = model.cfg
        L = cfg.llama.num_hidden_layers
        inputs = make_inputs(cfg)

        # ---- the counted main-path run ----
        for fn in counters.values():
            fn.launches = 0
        tally = graph_tally()
        for b, n in requests:
            run(model, inputs[b], n, NEW_TOKENS)
        launches = {k: fn.launches for k, fn in counters.items()}
        prefills = len(requests)
        steps = prefills * (NEW_TOKENS - 1)
        matmul = "int4_matmul" if options.get("load_4bit") else "int8_matmul"
        want = dict.fromkeys(counters, 0)
        want.update({matmul: prefills * (4 * L + 1) + steps * (2 * L + 1),
                     "quant_mlp": steps * L, "decode_attention": steps * L,
                     "flash_attention": prefills * L})
        print(f"[{label}] launches {launches} expected {want}")
        if launches != want:
            fail(f"{label}: the main path did not go through the kernels as "
                 f"expected")
        for k in total:
            total[k] += launches[k]
        check_graphs(label, tally, len(requests),
                     len(requests) * (NEW_TOKENS - 2))
        decode_bits(model, inputs[requests[0][0]], requests[0][1], label)

        # ---- the kernels against dequantize-and-multiply, one prefill ----
        b, n = requests[0]
        got = prefill_logits(model, cfg, inputs[b], n)
        with disable_fused_proj():
            want_logits = prefill_logits(model, cfg, inputs[b], n)
        compare_logits(got, want_logits, label, need_same_top=True)

        # the eager / graph turns under the first load only: the other
        # loads replay the same captured step (PR 11 measured them all)
        turns = label == QUANT_RUNS[0][0]
        for b, n in requests:
            time_requests(model, inputs[b], n, label)
            # decode_ab profiles the decode at B=1 and BATCH_SCALE
            decode_profile(model, inputs[b], n, label,
                           decode=not turns or (b, n) != (1, BATCH_SCALE))
        if turns:
            decode_ab(model, inputs, label)
        print(f"[{label}] max_memory_allocated while serving "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model
    return total


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0



# ---------------------------------------------------------------------------
# phase 6: paged attention and the bandwidth probes
# ---------------------------------------------------------------------------

def _paged_pools(gen, dev, L, n_pages, page, Hkv, Dh, int8):
    """Stacked pools ``(L, n_pages, page, Hkv, Dh)``; the int8 ones hold
    random codes with random positive scales."""
    shape = (L, n_pages, page, Hkv, Dh)
    if not int8:
        return _rand(shape, gen, dev), _rand(shape, gen, dev), None, None

    def codes():
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales():
        return torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.005

    return codes(), codes(), scales(), scales()


def _paged_work(lens, H, Hkv, Dh, kv_bytes, int8, q) -> dict:
    """Bound of one paged-attention call: K and V of the ``row_len + 1``
    slots each row attends (and their scales), q, out, the page ids used."""
    slots = int((lens + 1).sum())
    moved = 2 * slots * Hkv * Dh * kv_bytes + 2 * nbytes(q) \
        + (2 * slots * Hkv * 4 if int8 else 0) \
        + 4 * (int(((lens + 64) // 64).sum()) + lens.numel())
    return bound(moved, 4 * H * Dh * slots)


PAGED_CASES = (("b1 700", 1, 32, [700]),
               ("b8 ragged", 8, 32, [0, 63, 64, 65, 1599, 700, 5, 128]),
               ("b8 gqa", 8, 8, [0, 63, 64, 65, 1599, 700, 5, 128]),
               ("b8 700", 8, 32, [700, 663, 712, 689, 731, 702, 695, 708]),
               ("b8 one live", 8, 32, [700, 0, 0, 0, 0, 0, 0, 0]))
PAGED_EVERY_SPLIT = ("b8 ragged", "b8 gqa")   # held at n_split 1, 2, 4, 8
PAGED_TIMED = ("b8 700", "b8 one live", "b1 700")


def phase_paged_kernels(dev) -> dict:
    from matryoshka_mm_torch.ops import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(2)
    L, page, P, Dh, H = 32, 64, 25, 128, 32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = {"err": 0.0, "library_ms": None}
    for int8 in (False, True):
        for name, B, Hkv, row_len in PAGED_CASES:
            n_pages = 8 * P + 1
            k, v, ks, vs = _paged_pools(gen, dev, L, n_pages, page, Hkv, Dh,
                                        int8)
            q = _rand((B, H, Dh), gen, dev)
            # scattered, non-monotone page ids; page 0 stays the trash page
            perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
            tables = perm[:B * P].reshape(B, P).to(torch.int32)
            lens = torch.tensor(row_len, device=dev, dtype=torch.int32)
            label = f"paged {'int8' if int8 else 'bf16'} {name}"
            rule = pa.paged_splits(B, Hkv, P, page, sms)

            def args(l):
                return (q, k[l], v[l], tables, lens,
                        None if ks is None else ks[l],
                        None if vs is None else vs[l])

            for layer in (0, L - 1):
                got = pa.paged_decode_attention_stacked(
                    q, k, v, layer, tables, lens, ks, vs)
                want = pa.paged_attention_plain(*args(layer))
                outs = {f"rule n={rule}": got}
                if name in PAGED_EVERY_SPLIT:
                    for n in (1, 2, 4, 8):
                        outs[f"n={n}"] = pa._launch(*args(layer), n_split=n)
                        again = pa._launch(*args(layer), n_split=n)
                        torch.cuda.synchronize()
                        if not torch.equal(outs[f"n={n}"], again):
                            fail(f"{label} layer {layer} n_split {n}: two "
                                 f"launches gave other bits")
                torch.cuda.synchronize()
                errs = {key: (o.float() - want.float()).abs().max().item()
                        for key, o in outs.items()}
                print(f"[{label} layer {layer}] max|out-plain| "
                      + "  ".join(f"{key} {e:.3e}" for key, e in errs.items()))
                for key, o in outs.items():
                    if not torch.allclose(o.float(), want.float(),
                                          atol=FLASH_TOL, rtol=FLASH_TOL):
                        fail(f"{label} ({key}) disagrees with its plain "
                             f"version")
                rec["err"] = max(rec["err"], *errs.values())
            if name in PAGED_TIMED:
                # each call reads another layer's pool (92 MB of K and V a
                # call at B = 8), so none finds its pages in the 50 MB L2;
                # the rule's split and one split in turns (A B B A)
                ops = [args(i) for i in range(L)]
                ms = one = 0.0
                for fn in ("rule", "one", "one", "rule"):
                    if fn == "rule":
                        ms += time_ms(pa.paged_decode_attention, ops) / 2
                    else:
                        one += time_ms(lambda *a: pa._launch(*a, n_split=1),
                                       ops) / 2
                work = _paged_work(lens, H, Hkv, Dh, k.element_size(), int8,
                                   q)
                print(f"[{label}] {card_line()}: n_split={rule} kernel "
                      f"{ms:.4f} ms  at 1 split {one:.4f} ms  bound "
                      f"{work['bound_ms']:.4f} ms by {work['bound_by']} "
                      f"({work['bound_ms'] / ms:.0%} of it)")
                if name == "b8 700":
                    pms = time_ms(pa.paged_attention_plain, ops, reps=5)
                    if not int8:        # the record's times: the bf16 pools
                        rec.update(work, ms=ms, plain_ms=pms)
                    _show(label, dict(work, ms=ms, plain_ms=pms))
            del k, v, ks, vs
    return {"paged_attention": rec}


def phase_hbm(dev) -> tuple:
    """The probes against their plain versions, then the calibration run
    through ``hbm_read_gb_s`` / ``hbm_copy_gb_s`` with the launch counts
    read around it.  Returns ``(records, launches, measured read GB/s)``."""
    from matryoshka_mm_torch.ops import hbm_probe as hbm

    gen = torch.Generator(device=dev).manual_seed(3)
    for n, reps in ((16 * 1000, 1), (16 * 300_001, 3)):
        x = torch.randint(-127, 128, (n,), generator=gen, device=dev,
                          dtype=torch.int8)
        got, want = hbm.hbm_read(x, reps), hbm.hbm_read_plain(x, reps)
        y = hbm.hbm_copy(x, reps)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"[hbm n={n} reps={reps}] read max|out-plain|={err:.1f} "
              f"copy equal {torch.equal(y, hbm.hbm_copy_plain(x))}")
        if err != 0 or not torch.equal(y, hbm.hbm_copy_plain(x)):
            fail("an hbm probe disagrees with its plain version")

    # ---- one pass at the calibration sizes: kernel, plain, library ----
    rec = {}
    x = hbm._probe_array(512, dev)
    ms = time_ms(lambda a: hbm.hbm_read(a, 1), [(x,)], reps=10)
    pms = time_ms(lambda a: hbm.hbm_read_plain(a, 1), [(x,)], reps=2,
                  warmup=1)
    rec["hbm_read"] = dict(bound(x.numel() + 4 * hbm.BLOCKS * 8, 0),
                           err=0.0, ms=ms, plain_ms=pms, library_ms=None)
    _show("hbm_read 512 MiB, 1 pass", rec["hbm_read"])
    x = x[:x.numel() // 2].contiguous()
    dst = torch.empty_like(x)
    ms = time_ms(lambda a: hbm.hbm_copy(a, 1), [(x,)], reps=10)
    pms = time_ms(hbm.hbm_copy_plain, [(x,)], reps=10)
    rec["hbm_copy"] = dict(bound(2 * x.numel(), 0), err=0.0, ms=ms,
                           plain_ms=pms)
    rec["hbm_copy"]["library_ms"] = library_ms("copy", [(x, dst)])
    _show("hbm_copy 256 MiB, 1 pass", rec["hbm_copy"])
    print(f"[hbm_copy 256 MiB, 1 pass] {card_line()}: kernel over library "
          f"{ms / rec['hbm_copy']['library_ms']:.3f}")
    del x, dst

    # ---- the calibration run (a main path of its own) ----
    hbm.hbm_read.launches = hbm.hbm_copy.launches = 0
    rates = {}
    for passes in (1, 4, 16):
        r = hbm.hbm_read_gb_s(512, reps=passes, runs=7)
        c = hbm.hbm_copy_gb_s(256, reps=passes, runs=7)
        rates[passes] = r, c
        print(f"[hbm] {card_line()}: {passes:2d} passes a launch: "
              f"hbm_read_gb_s median {r.median:.1f} ({r.lo:.1f}-{r.hi:.1f})  "
              f"hbm_copy_gb_s median {c.median:.1f} ({c.lo:.1f}-{c.hi:.1f})")
    launches = {"hbm_read": hbm.hbm_read.launches,
                "hbm_copy": hbm.hbm_copy.launches}
    want = {"hbm_read": 3 * 8, "hbm_copy": 3 * 8}   # 1 first touch + 7 runs
    print(f"[hbm] launches {launches} expected {want}")
    if launches != want:
        fail("the calibration run did not go through the probe kernels")
    read, copy = rates[16]
    for bw in (read, copy):
        if not 0 < bw.lo <= bw.median <= bw.hi < 2 * HBM_BYTES_S / 1e9:
            fail(f"an hbm probe's rate is out of range: {bw}")
    return rec, launches, read.median


# ---------------------------------------------------------------------------
# phase 7: the serving slice at full width
# ---------------------------------------------------------------------------

def serve_prompt(rng, cfg, length=PROMPT_LEN):
    size = cfg.vision.image_size
    return (make_prompt(rng, length, cfg.llama.vocab_size)[None],
            rng.standard_normal((1, 3, size, size)).astype(np.float32))


class Reader(threading.Thread):
    """Drains one request's stream; keeps the tokens, the time of the first
    chunk and the error, if the stream raised one."""

    def __init__(self, batcher, req, t_submit):
        super().__init__(daemon=True)
        self.batcher, self.req, self.t_submit = batcher, req, t_submit
        self.tokens, self.t_first, self.error = [], None, None
        self.start()

    def run(self):
        try:
            for chunk in self.batcher.stream(self.req):
                if self.t_first is None:
                    self.t_first = time.perf_counter()
                self.tokens.extend(chunk.tolist())
        except Exception as e:      # noqa: BLE001: kept for the main thread
            self.error = e

    def result(self, timeout=600.0):
        self.join(timeout)
        if self.is_alive():
            fail("a request's stream did not end")
        if self.error is not None:
            raise self.error
        return self.tokens


def _serve(batcher, prompt, numtoks, new_tokens, **kw) -> Reader:
    t = time.perf_counter()
    req = batcher.submit(*prompt, numtoks=numtoks, max_new_tokens=new_tokens,
                         **kw)
    return Reader(batcher, req, t)


def quant_products(batcher) -> tuple:
    """``(int4_matmul launches a decode step, a prefill; quant_mlp a decode
    step)`` of the batcher's weights: q, k, v, o (or the fused qkv, o), the
    MLP's gate, up, down unless ``quant_mlp`` takes it (the fused layout;
    an adapter pack needs the unfused one), and the head.  An unquantized
    model: 0."""
    from matryoshka_mm_torch.ops.quant import is_quantized

    layer = batcher.params["llama"]["layers"][0]
    attn = layer.get("self_attn", layer.get("attn"))
    if not any(is_quantized(leaf) for leaf in attn.values()):
        return 0, 0, 0
    L = batcher.cfg.llama.num_hidden_layers
    n_attn = 2 if "qkv_proj" in attn else 4
    fused_mlp = "gateup_proj" in layer["mlp"]
    return (L * (n_attn + (0 if fused_mlp else 3)) + 1,
            L * (n_attn + (2 if fused_mlp else 3)) + 1,
            L if fused_mlp else 0)


def serve_traffic(batcher, cfg, burst, late, label, lora_ids=None) -> dict:
    """The counted main-path run of the serving slice: ``burst`` requests
    at once, ``late`` ones joining while those decode; then the checks.
    ``lora_ids``: the adapter of each request, burst first.  Returns the
    launches of every kernel on the serving path."""
    from matryoshka_mm_torch.ops import fused_mlp, int4_matmul
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention

    counters = {"paged_attention": paged_decode_attention,
                "flash_attention": flash_attention_lse,
                "decode_attention": flash_decode_attention,
                "int4_matmul": int4_matmul.int4_matmul,
                "quant_mlp": fused_mlp.quant_mlp}

    rng = np.random.default_rng(7)
    n_layers = cfg.llama.num_hidden_layers
    # the warm-up's last round was dispatched before its stream ended: wait
    # until every dispatched round has been processed
    while batcher.decode_steps != batcher.occupancy["rounds"] * batcher.chunk:
        time.sleep(0.005)
    for fn in counters.values():
        fn.launches = 0
    batcher.decode_steps = 0
    batcher.occupancy = {"rounds": 0, "active_rows": 0}
    batcher.admit_stats = {"solo": 0, "grouped": 0}
    batcher.events = []
    tally = graph_tally()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lora = [{"lora_id": n} for n in lora_ids] if lora_ids \
        else [{}] * (len(burst) + len(late))
    batcher._hold_admission = True          # the burst lands as one batch
    readers = [_serve(batcher, serve_prompt(rng, cfg), n, new, **lora[i])
               for i, (n, new) in enumerate(burst)]
    batcher._hold_admission = False
    while batcher.occupancy["rounds"] < 2 and batcher.error is None:
        time.sleep(0.002)                   # the burst is decoding now
    for i, (n, new) in enumerate(late):
        readers.append(_serve(batcher, serve_prompt(rng, cfg), n, new,
                              **lora[len(burst) + i]))
        time.sleep(0.05)
    outs = [r.result() for r in readers]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = batcher.decode_steps
    for (n, new), out in zip(burst + late, outs):
        if len(out) != new or min(out) < 0 \
                or max(out) >= cfg.llama.vocab_size:
            fail(f"{label}: a request at scale {n} gave {len(out)} of {new} "
                 f"tokens in [{min(out)}, {max(out)}]")
    solo = sum(kind == "admit_solo" for _, kind, _ in batcher.events)
    sizes = [len(d["rids"]) for _, kind, d in batcher.events
             if kind == "admit_group"]
    groups = len(sizes)
    step_mm, prefill_mm, step_mlp = quant_products(batcher)
    # every decode step: one paged attention a layer and, with int4 weights,
    # the products of quant_products (fused: one quant_mlp a layer and qkv,
    # o and lm_head through the GEMV; under an adapter pack, unfused: q, k,
    # v, o, gate, up, down and lm_head); every prefill: one flash attention
    # a layer and, with int4 weights, each projection and lm_head through
    # the matmul kernel.  A prefill of more than MAX_FUSED_ROWS rows (a group
    # of G rows of L) dequantizes its weights instead, all but the lm_head
    # over its last positions
    prefill_matmuls = sum(
        prefill_mm if g * batcher.L <= int4_matmul.MAX_FUSED_ROWS
        else 1 for g in [1] * solo + sizes)
    quantized = step_mm > 0
    # a window config or MPT attends through the gather path: no paged
    # kernel at all
    want = {"paged_attention": steps * n_layers if batcher.use_kernel else 0,
            "flash_attention": (solo + groups) * n_layers
            if cfg.llama.arch != "mpt" else 0,
            "decode_attention": 0,
            "quant_mlp": steps * step_mlp,
            "int4_matmul": (steps * step_mm + prefill_matmuls)
            if quantized else 0}
    print(f"[{label}] launches {launches} over {steps} decode steps, {solo} "
          f"solo and {groups} group prefills (sizes {sizes}); expected "
          f"{want}")
    if steps <= 0 or launches != want:
        fail(f"{label}: the serving path did not go through the kernels as "
             f"expected")
    # the warm-up captured the round: every counted round is a replay
    check_graphs(label, tally, 0,
                 steps // batcher.chunk if batcher.cuda_graph else 0)
    print(f"[{label}] admissions {batcher.admit_stats}")
    # under adapters the burst groups per adapter, and a lone row admits solo
    if lora_ids is None and batcher.admit_stats["grouped"] < len(burst):
        fail(f"{label}: the burst was not admitted in groups")
    # with the prefix cache, pages of finished rows that the index holds
    # are kept aside (ref 0, "cached") and count as returned
    free, total = len(batcher.alloc.free), batcher.alloc.n_allocatable
    cached = len(getattr(batcher.alloc, "cached", ()))
    print(f"[{label}] pages free {free} (+ {cached} cached) of {total}")
    if free + cached != total:
        fail(f"{label}: pages were not returned to the free list")
    ttft = sorted(r.t_first - r.t_submit for r in readers)
    # a round's own ``ms`` spans two rounds under the pipelined loop, so the
    # step time is taken between the ends of consecutive rounds
    ends = [t for t, kind, _ in batcher.events if kind == "decode_round"]
    step_ms = statistics.median(
        b - a for a, b in zip(ends, ends[1:])) * 1e3 / batcher.chunk
    occ = batcher.occupancy
    pool = nbytes(*(t for t in (batcher.paged.k, batcher.paged.v,
                                batcher.paged.k_scale, batcher.paged.v_scale)
                    if t is not None))
    total_toks = sum(len(o) for o in outs)
    mode = "graph" if batcher.cuda_graph else "eager"
    print(f"[{label}] {card_line()}: {mode} rounds: {len(outs)} requests, "
          f"{total_toks} tokens in {wall:.3f} s: {total_toks / wall:.2f} "
          f"tok/s over the "
          f"batch (prefills included); median {step_ms:.2f} ms a decode step "
          f"between the ends of consecutive rounds; TTFT p50 "
          f"{statistics.median(ttft) * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} "
          f"ms; mean occupancy "
          f"{occ['active_rows'] / (occ['rounds'] * batcher.max_batch):.3f} "
          f"over {occ['rounds']} rounds; pool {pool / 2**30:.2f} GiB; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _to_f32(tree):
    """The float tensors of a parameter tree in float32; quantized leaves
    (packed integers with their f32 scales) as they are."""
    from matryoshka_mm_torch.ops.quant import is_quantized

    if is_quantized(tree):
        return tree
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def live_attention_check(batcher, lcfg, label) -> None:
    """One layer's attention over the live pool, with seeded queries: the
    paged kernel and the gather path's attention (pages gathered, an int8
    pool dequantized to the model's dtype, ``attention_reference``) against
    the same attention in float32 throughout.  Shows what one layer's two
    paths differ by before 32 layers of random weights amplify it."""
    from matryoshka_mm_torch.ops.attention import attention_reference
    from matryoshka_mm_torch.ops.paged_attention import (
        paged_attention_plain, paged_decode_attention)

    paged, tables = batcher.paged, batcher.tables.long()
    active = batcher.active
    lens = torch.where(active, batcher.lengths,
                       torch.zeros_like(batcher.lengths)).to(torch.int32)
    B, P = tables.shape
    H, Hkv, Dh = (lcfg.num_attention_heads, lcfg.num_key_value_heads,
                  lcfg.head_dim)
    S = P * paged.page_size
    dtype = batcher.params["llama"]["norm"].dtype
    int8 = paged.k_scale is not None
    g = torch.Generator(device=tables.device).manual_seed(11)
    kv_pos = torch.arange(S, device=tables.device)[None]
    for layer in (0, lcfg.num_hidden_layers // 2, lcfg.num_hidden_layers - 1):
        q = torch.randn((B, H, Dh), generator=g, device=tables.device,
                        dtype=torch.float32).to(dtype)
        ks = paged.k_scale[layer] if int8 else None
        vs = paged.v_scale[layer] if int8 else None
        before = paged_decode_attention.launches
        kernel = paged_decode_attention(q, paged.k[layer], paged.v[layer],
                                        batcher.tables, lens, ks, vs)
        if paged_decode_attention.launches != before + 1:
            fail(f"{label}: the live attention check launched no kernel")

        def rows(pool, scale):
            r = pool[tables].reshape(B, S, Hkv, Dh)
            if int8:
                r = (r.float() * scale[tables].reshape(B, S, Hkv, 1)).to(dtype)
            return r.transpose(1, 2)

        gather = attention_reference(
            q[:, :, None], rows(paged.k[layer], ks), rows(paged.v[layer], vs),
            causal=True, q_positions=lens.long()[:, None],
            kv_positions=kv_pos, kv_valid=kv_pos <= lens.long()[:, None]
        )[:, :, 0]
        if int8:
            truth = paged_attention_plain(q.float(), paged.k[layer],
                                          paged.v[layer], tables, lens, ks, vs)
        else:
            truth = paged_attention_plain(q.float(), paged.k[layer].float(),
                                          paged.v[layer].float(), tables, lens)
        torch.cuda.synchronize()
        e_k = (kernel.float() - truth)[active].abs().max().item()
        e_g = (gather.float() - truth)[active].abs().max().item()
        e_kg = (kernel.float() - gather.float())[active].abs().max().item()
        print(f"[{label}] live pool, layer {layer}: attention max|kernel-f32| "
              f"{e_k:.3e} max|gather-f32| {e_g:.3e} max|kernel-gather| "
              f"{e_kg:.3e} of max|f32| {truth[active].abs().max():.3f} "
              f"(tolerance {FLASH_TOL})")
        if not max(e_k, e_kg) <= FLASH_TOL:
            fail(f"{label}: layer {layer}: the paged kernel's attention "
                 f"leaves the float32 attention or the gather path's")


def serve_live_checks(batcher, cfg, label) -> None:
    """Stop the scheduler with 8 rows in mid-decode and, on that live pool:
    one decode step through the paged kernel against the gather path, then
    one decode round under the profiler."""
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention
    from matryoshka_mm_torch.serve.paged_cache import (PagedKVCache,
                                                       paged_decode_step,
                                                       paged_pool_decode)

    rng = np.random.default_rng(8)
    readers = [_serve(batcher, serve_prompt(rng, cfg), n, 128)
               for n, _ in SERVE_BURST]
    while min(len(r.tokens) for r in readers) < 24 and batcher.error is None:
        time.sleep(0.005)
    batcher._stop = True
    batcher._thread.join(60)
    if batcher._thread.is_alive() or batcher.error is not None:
        fail(f"{label}: the scheduler did not stop cleanly")
    torch.cuda.synchronize()
    llama, lcfg = batcher.params["llama"], cfg.llama
    active = batcher.active
    rows = int(active.sum())
    lens = batcher.lengths[active].tolist()
    if rows < 6:
        fail(f"{label}: only {rows} rows were live when the scheduler "
             f"stopped")
    args = (batcher.tables, batcher.lengths, batcher.tokens, active,
            batcher.page_size)
    with torch.inference_mode():
        # both branches write the same K/V of the same token into the same
        # slot, so the second starts from the pool the first left
        _, gather = paged_decode_step(llama, lcfg, batcher.paged, *args,
                                      use_kernel=False)
        _, kernel = paged_decode_step(llama, lcfg, batcher.paged, *args,
                                      use_kernel=True)
        # the same step in float32 (weights and float pool cast up, an int8
        # pool as it is): here the two branches compute one function to f32
        # rounding, and are held to the cosine and the argmax
        llama32 = _to_f32(llama)
        gather32 = kernel32 = None
        for use_kernel in (False, True):
            pool32 = PagedKVCache(*(
                None if t is None else
                t.float() if t.is_floating_point() else t.clone()
                for t in (batcher.paged.k, batcher.paged.v,
                          batcher.paged.k_scale, batcher.paged.v_scale)))
            before = paged_decode_attention.launches
            _, out = paged_decode_step(llama32, lcfg, pool32, *args,
                                       use_kernel=use_kernel)
            if (paged_decode_attention.launches - before
                    != use_kernel * lcfg.num_hidden_layers):
                fail(f"{label}: the float32 step's launches are wrong")
            if use_kernel:
                kernel32 = out[active]
            else:
                gather32 = out[active]
            del pool32, out
        del llama32
    torch.cuda.empty_cache()
    gather, kernel = gather[active].float(), kernel[active].float()

    def cosines(a, b):
        return torch.nn.functional.cosine_similarity(a, b, dim=1)

    def fmt(t, nd=6):
        return [round(x, nd) for x in t.tolist()]

    cos32 = cosines(kernel32, gather32)
    same32 = int((kernel32.argmax(-1) == gather32.argmax(-1)).sum())
    print(f"[{label}] live pool, {rows} rows of {lens} tokens, float32 step: "
          f"kernel vs gather logits cosine {fmt(cos32, 8)} "
          f"max|kernel-gather| {(kernel32 - gather32).abs().max():.6f} of "
          f"max|logit| {gather32.abs().max():.4f}, same argmax in {same32} "
          f"rows of {rows}")
    if not (bool(torch.isfinite(kernel32).all())
            and cos32.min() >= PAGED_COS_F32 and same32 == rows):
        fail(f"{label}: in float32 the paged kernel's logits leave the "
             f"gather path's")
    # the model's own dtype: each branch against the float32 step, and
    # against the other
    cos = cosines(kernel, gather)
    cos_kt, cos_gt = cosines(kernel, gather32), cosines(gather, gather32)
    gap = (kernel - gather).abs().amax(dim=1)
    top2 = gather.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = kernel.argmax(-1) == gather.argmax(-1)
    finite = bool(torch.isfinite(kernel).all())
    print(f"[{label}] the model's dtype: kernel vs gather logits cosine "
          f"{fmt(cos)}; against the float32 step: kernel {fmt(cos_kt)} "
          f"gather {fmt(cos_gt)}; max|kernel-gather| a row {fmt(gap, 4)} of "
          f"max|logit| {gather.abs().max():.4f}; the gather path's top two "
          f"logits lie {fmt(margin, 4)} apart; finite {finite}; same argmax "
          f"in {int(agree.sum())} rows of {rows}")
    long_rows = torch.tensor(lens, device=cos.device) >= PAGED_LONG
    if not (finite and cos.min() >= PAGED_COS
            and bool((cos[long_rows] >= PAGED_COS_F32).all())):
        fail(f"{label}: the paged kernel's logits leave the gather path's")
    # as near to the float32 result as the gather path is
    if bool(((1 - cos_kt) > PAGED_EXCESS * (1 - cos_gt) + 1e-4).any()):
        fail(f"{label}: the paged kernel's logits lie farther from the "
             f"float32 step than the gather path's")
    if not bool(agree[margin > gap].all()):
        fail(f"{label}: the argmax differs in a row whose top two logits "
             f"lie farther apart than the two paths' logits")
    live_attention_check(batcher, lcfg, label)

    # ---- one decode round under the profiler ----
    def one_round():
        with torch.inference_mode():
            paged_pool_decode(llama, lcfg, batcher.gen_cfg, batcher.chunk,
                              batcher.paged, batcher.tables, batcher._state(),
                              use_kernel=True, generator=batcher._generator)
        torch.cuda.synchronize()

    kernels = round_profile(one_round, batcher, rows, label, "eager")
    chunk = batcher.chunk
    for e in sorted(kernels, key=lambda e: -dev_us(e))[:6]:
        print(f"[{label}]   {dev_us(e) / 1e3 / chunk:8.4f} "
              f"ms/step  x{e.count // chunk:4d}  {e.key[:90]}")
    for what, names in (("paged_kernel", ("paged_kernel",)),
                        ("quantized products", QUANT_KERNELS)):
        mine = [e for e in kernels if any(n in e.key for n in names)]
        print(f"[{label}] {card_line()}: {what} "
              f"{sum(dev_us(e) for e in mine) / 1e3 / chunk:.4f} ms/step "
              f"over {sum(e.count for e in mine) // chunk} launches a step")
    captured_round_check(batcher, label)

    def graph_round():
        with torch.inference_mode():
            batcher._round_graph(batcher._state())
        torch.cuda.synchronize()

    kernels = round_profile(graph_round, batcher, rows, label, "graph")
    if not kernels:
        fail(f"{label}: the profiler shows no kernel of a replayed round")
    batcher.shutdown()


def round_profile(fn, batcher, rows, label, mode) -> list:
    """One decode round (``fn``) under the profiler: device ms a step,
    wall ms a step (host clock, outside the profiler), the device's idle
    share, kernels and Python launch calls a step.  Returns the kernel
    events."""
    fn()
    kernels, calls = profile_events(fn)
    # (the wall time inside the profiler is longer than outside it)
    wall = statistics.median(_wall(fn) for _ in range(3)) * 1e3
    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    chunk = batcher.chunk
    print(f"[{label}] {card_line()}: profile of one {mode} round ({chunk} "
          f"steps, {rows} live rows of 8): device {dev_ms / chunk:.3f} "
          f"ms/step, wall {wall / chunk:.3f} ms/step, device idle "
          f"{max(0.0, 1 - dev_ms / wall):.3f}, {n_launch / chunk:.1f} kernels "
          f"and {calls / chunk:.2f} Python launch calls a step")
    if dev_ms <= 0:
        print(f"[{label}] the profiler showed no device time")
    return kernels


def captured_round_check(batcher, label) -> None:
    """One round on the live pool through the batcher's captured graph (a
    replay), and the same round run eagerly by ``paged_pool_decode`` from
    the same state on a copy of the pool: the tokens, the new state and the
    pool bytes must be equal."""
    from matryoshka_mm_torch.serve.paged_cache import (CapturedRound,
                                                       PagedKVCache,
                                                       paged_pool_decode)
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    graph = batcher._round_graph
    if graph is None:
        fail(f"{label}: the batcher never captured its round")
    paged = batcher.paged
    with torch.inference_mode():
        state = batcher._state()
        copy = PagedKVCache(*(None if t is None else t.clone() for t in (
            paged.k, paged.v, paged.k_scale, paged.v_scale)))
        replays = CapturedStep.replays
        got_state, got = graph(state)
        want_state, want = paged_pool_decode(
            batcher.params["llama"], batcher.cfg.llama, batcher.gen_cfg,
            batcher.chunk, copy, batcher.tables, state,
            use_kernel=batcher.use_kernel, generator=batcher._generator,
            lora_pack=batcher.lora_pack, lora_idx=batcher.lora_idx)
        torch.cuda.synchronize()
    same_toks = bool(torch.equal(got, want)) and all(
        torch.equal(a, b) for a, b in zip(CapturedRound._fields(got_state),
                                          CapturedRound._fields(want_state)))
    same_pool = all(
        (a is None and b is None) or bool(torch.equal(a, b))
        for a, b in ((paged.k, copy.k), (paged.v, copy.v),
                     (paged.k_scale, copy.k_scale),
                     (paged.v_scale, copy.v_scale)))
    live = int(state.active.sum())
    print(f"[{label}] {card_line()}: a replayed round on the live pool "
          f"({live} live rows) against paged_pool_decode from the same "
          f"state: tokens and state equal {same_toks}, pool bytes equal "
          f"{same_pool}; tokens {got[state.active][:2].tolist()}")
    if CapturedStep.replays != replays + 1 or not (same_toks and same_pool):
        fail(f"{label}: the captured round differs from the eager round")
    del copy
    torch.cuda.empty_cache()


def _short_run(model, label, requests, gen=None, **kw):
    """Serve ``requests`` one after another on a small pool; returns their
    tokens and the batcher (shut down)."""
    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    gen = dict(dict(max_new_tokens=16, decode_chunk=8, eos_token_id=-1),
               **(gen or {}))
    b = ContinuousBatcher(model.params, model.cfg,
                          gen_cfg=GenerationConfig(**gen),
                          **dict(SERVE_KW, max_batch=2, **kw))
    try:
        outs = [_serve(b, prompt, n, new, **opts).result()
                for prompt, n, new, opts in requests]
    finally:
        b.shutdown()
    print(f"[{label}] {outs}")
    return outs, b


def serve_options(model, cfg) -> None:
    """One short run each at full width: prefix cache, speculative
    decoding, a regex constraint.  Their greedy tokens are not held against
    a run without the option here: the random 7B weights leave the top two
    logits of a row closer to each other than two such runs' logits are
    (``serve_live_checks`` prints both distances), so roundings of bf16
    size (a suffix prefill against a full one, a 5-token verify block
    against single steps) may pick the other token and every later one
    with it.  ``phase_small`` holds those tokens equal in float32."""
    rng = np.random.default_rng(9)
    # the repeated prompt: 59 + 144 = 203 tokens, so that three full pages
    # are cached: a hit must cover the image span, which ends at token 149
    prompt = serve_prompt(rng, cfg, 60)
    outs, b = _short_run(model, "serve prefix_cache",
                         [(prompt, 144, 16, {})] * 2, prefix_cache=True)
    print(f"[serve prefix_cache] {b.stats}")
    same = sum(a == b for a, b in zip(*outs))
    print(f"[serve prefix_cache] the hit gave {same} of 16 tokens of the miss")
    if b.stats["prefix_hits"] != 1 or b.stats["prefix_pages_reused"] != 3:
        fail("prefix cache: the repeated prompt did not hit its three pages")
    spec, b = _short_run(model, "serve speculative_k=4",
                         [(prompt, 144, 24, {})], speculative_k=4)
    print(f"[serve speculative_k=4] {b.spec_stats}")
    if not 0 < b.spec_stats["verify_steps"] <= 23 \
            or b.spec_stats["tokens_emitted"] != 23:
        fail("speculative decoding: the verify steps do not add up")
    V = cfg.llama.vocab_size
    for out, n in ((outs[0], 16), (outs[1], 16), (spec[0], 24)):
        if len(out) != n or min(out) < 0 or max(out) >= V:
            fail("a short serving run gave a wrong number of tokens, or "
                 "tokens outside the vocabulary")
    pieces = ["A", "B", "C", "D", "yes", "no", " really", "0", "1", "2", "3",
              ".", " ", "x"]
    vocab = ["<pad>", "<s>", "</s>"] + [
        pieces[i % len(pieces)] for i in range(cfg.llama.vocab_size - 3)]
    pattern = r"(yes|no)( really)?"
    outs, _ = _short_run(
        model, "serve constraint_regex",
        [(prompt, 144, 16, {"constraint_regex": pattern})],
        gen=dict(eos_token_id=2, pad_token_id=0), fsm_vocab=vocab)
    text = "".join(vocab[t] for t in outs[0][:-1])
    print(f"[serve constraint_regex] {pattern!r} -> {text!r}")
    if outs[0][-1] != 2 or not re.fullmatch(pattern, text):
        fail("constrained decoding: the output does not match the regex")


def phase_serving(dev) -> dict:
    """Returns the launches of the counted runs, by kernel."""
    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    launches = {}
    for label, options in SERVE_RUNS:
        torch.cuda.empty_cache()
        _, model, _, _ = load_pretrained_model("debug://7b", device=str(dev),
                                               **options)
        cfg = model.cfg
        gen_cfg = GenerationConfig(max_new_tokens=128, decode_chunk=8,
                                   eos_token_id=-1)
        batcher = ContinuousBatcher(model.params, cfg, gen_cfg=gen_cfg,
                                    **SERVE_KW)
        print(f"[{label}] {card_line()}: ContinuousBatcher {SERVE_KW} "
              f"warm-up {batcher.warmup(numtoks=144):.2f} s")
        if not batcher.use_kernel:
            fail(f"{label}: the batcher did not pick the paged kernel")
        counted = serve_traffic(batcher, cfg, SERVE_BURST, SERVE_LATE, label)
        if bool(options) != (counted["int4_matmul"] > 0):
            fail(f"{label}: int4 weights and the int4 kernels' launches do "
                 f"not go together")
        for k, n in counted.items():
            launches[k] = launches.get(k, 0) + n
        serve_live_checks(batcher, cfg, label)
        del batcher
        torch.cuda.empty_cache()
        # the same traffic through eager rounds, for the comparison
        eager = ContinuousBatcher(model.params, cfg, gen_cfg=gen_cfg,
                                  cuda_graph=False, **SERVE_KW)
        try:
            eager.warmup(numtoks=144)
            serve_traffic(eager, cfg, SERVE_BURST, SERVE_LATE, label)
        finally:
            eager.shutdown()
        if not options:
            serve_options(model, cfg)
        del model, eager
    return launches

# ---------------------------------------------------------------------------
# phase 9: the flash-attention backward kernels against their plain versions
# ---------------------------------------------------------------------------

BWD_TOL = {torch.bfloat16: 2e-2,   # of max|plain|: bf16 gradients, p and ds
                                   # rounded to bf16 on slightly other f32
           torch.float32: 2e-4}    # f32 sums in another order, exp2f
# (label, dtype, B, H, Hkv, Sq, Sk, window, q_offset, left padding, timed);
# timed: 1 = kernels, plain versions and the library, 2 = the kernels only
BWD_CASES = (
    ("train 1024 bf16", torch.bfloat16, 1, 32, 32, 1024, 1024, None, 0, 37, 1),
    ("train 1599 bf16", torch.bfloat16, 1, 32, 32, 1599, 1599, None, 0, 61, 1),
    ("train 1599 f32", torch.float32, 1, 32, 32, 1599, 1599, None, 0, 61, 2),
    ("batch 3x1059 bf16", torch.bfloat16, 3, 32, 32, 1059, 1059, None, 0,
     35, 0),
    ("gqa bf16", torch.bfloat16, 2, 8, 2, 200, 200, None, 0, 9, 0),
    ("window f32", torch.float32, 2, 4, 4, 203, 203, 48, 0, 5, 0),
    ("offset f32 dh64", torch.float32, 1, 4, 2, 70, 131, None, 40, 3, 0),
    ("ragged bf16 dh64", torch.bfloat16, 2, 4, 4, 65, 65, None, 0, 0, 0),
    # where a walk over 64 x 64 tiles goes wrong: kv tiles without a valid
    # slot and q tiles without a valid key,
    ("pad 150 bf16", torch.bfloat16, 2, 4, 4, 257, 257, None, 0, 150, 0),
    ("pad 70 bf16 dh64", torch.bfloat16, 2, 4, 2, 129, 129, None, 0, 70, 0),
    # lengths around one and two tiles,
    ("s63 bf16", torch.bfloat16, 1, 4, 4, 63, 63, None, 0, 5, 0),
    ("s64 bf16 dh64", torch.bfloat16, 1, 4, 4, 64, 64, None, 0, 0, 0),
    ("s65 bf16", torch.bfloat16, 2, 4, 4, 65, 65, None, 0, 3, 0),
    ("s129 bf16", torch.bfloat16, 1, 4, 4, 129, 129, None, 0, 64, 0),
    # a window inside one tile and one across three,
    ("window 16 bf16", torch.bfloat16, 2, 4, 4, 300, 300, 16, 0, 7, 0),
    ("window 150 bf16 dh64", torch.bfloat16, 1, 4, 2, 300, 300, 150, 0, 70,
     0),
    # an offset between the two axes, with and without a window,
    ("offset bf16", torch.bfloat16, 2, 4, 4, 70, 131, None, 40, 3, 0),
    ("offset window bf16 dh64", torch.bfloat16, 1, 4, 4, 100, 260, 48, 160,
     0, 0),
    # and query groups of 4 and 8
    ("gqa 4 bf16", torch.bfloat16, 2, 8, 2, 200, 200, None, 0, 66, 0),
    ("gqa 8 bf16 dh64", torch.bfloat16, 1, 8, 1, 131, 131, None, 0, 9, 0),
)


def phase_bwd_kernels(dev) -> dict:
    """dQ and dK/dV kernels against their plain versions; the two records
    carry the times at S=1599 in bf16, the longest sequence of a 7B train
    step."""
    from matryoshka_mm_torch.ops import flash_attention as fl

    gen = torch.Generator(device=dev).manual_seed(4)
    rec = {"flash_attention_bwd_dq": {"err": 0.0},
           "flash_attention_bwd_dkv": {"err": 0.0}}
    for (label, dtype, B, H, Hkv, Sq, Sk, window, offset, pad,
         timed) in BWD_CASES:
        Dh = 64 if "dh64" in label else 128

        def operand(heads, S):
            # the (B, heads, S, Dh) view of a (B, S, heads, Dh) tensor, as
            # the model's projections and autograd hand them over
            return torch.randn((B, S, heads, Dh), generator=gen, device=dev,
                               dtype=torch.float32).to(dtype).transpose(1, 2)

        q, k, v = operand(H, Sq), operand(Hkv, Sk), operand(Hkv, Sk)
        do = operand(H, Sq)
        valid = torch.ones((B, Sk), dtype=torch.bool, device=dev)
        valid[0, :pad] = False          # a left-padded row: its first `pad`
        kw = dict(causal=True, sliding_window=window,   # queries see no key
                  q_index_offset=offset)
        out, lse = fl.flash_attention_lse(q, k, v, kv_valid=valid, **kw)
        args = (q, k, v, valid, out, lse, do)
        dq = fl.flash_attention_bwd_dq(*args, **kw)
        dk, dv = fl.flash_attention_bwd_dkv(*args, **kw)
        again = (fl.flash_attention_bwd_dq(*args, **kw),
                 *fl.flash_attention_bwd_dkv(*args, **kw))
        want_q = fl.flash_attention_bwd_dq_plain(*args, **kw)
        want_k, want_v = fl.flash_attention_bwd_dkv_plain(*args, **kw)
        torch.cuda.synchronize()
        errs = {}
        for name, got, want in (("dq", dq, want_q), ("dk", dk, want_k),
                                ("dv", dv, want_v)):
            if not bool(torch.isfinite(got).all()):
                fail(f"backward {label}: {name} is not finite")
            err, rel = _rel_err(got, want)
            errs[name] = (err, rel)
            if rel > BWD_TOL[dtype]:
                fail(f"backward {label}: {name} disagrees with its plain "
                     f"version: {err:.3e}, {rel:.2e} of max|plain|")
        if offset == 0 and pad and not (
                bool((dq[0, :, :pad] == 0).all())
                and bool((dk[0, :, :pad] == 0).all())
                and bool((dv[0, :, :pad] == 0).all())):
            fail(f"backward {label}: a masked row or slot got a gradient")
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
            fail(f"backward {label}: two launches on the same operands gave "
                 f"other bits")
        print(f"[bwd {label}] " + "  ".join(
            f"max|{n}-plain|={e:.3e} ({r:.1e} of max)"
            for n, (e, r) in errs.items()) + f"  tolerance {BWD_TOL[dtype]}")
        rq, rkv = rec["flash_attention_bwd_dq"], rec["flash_attention_bwd_dkv"]
        rq["err"] = max(rq["err"], errs["dq"][0])
        rkv["err"] = max(rkv["err"], errs["dk"][0], errs["dv"][0])
        if not timed:
            continue
        ops = rotations(q, k, v, valid, out, lse, do)
        # each wrapper checks its operands and computes delta = rowsum(out *
        # do) before its launch (`prep`); the autograd path does that once
        # for both kernels (`one call`)
        t = {"dq": time_ms(lambda *a: fl.flash_attention_bwd_dq(*a, **kw),
                           ops, reps=10),
             "dkv": time_ms(lambda *a: fl.flash_attention_bwd_dkv(*a, **kw),
                            ops, reps=10),
             "prep": time_ms(fl._bwd_operands, ops, reps=10),
             "one_call": time_ms(lambda *a: fl.flash_attention_bwd(*a, **kw),
                                 ops, reps=10)}
        # the launches alone, on operands prepared beforehand
        ready = []
        for q_, k_, v_, valid_, out_, lse_, do_ in ops:
            valid_, lse_, delta_, do_ = fl._bwd_operands(q_, k_, v_, valid_,
                                                         out_, lse_, do_)
            ready.append((q_, k_, v_, valid_, do_, lse_, delta_,
                          kw["causal"], window or 0, offset))
        t["dq_alone"] = time_ms(fl._launch_dq, ready, reps=10)
        t["dkv_alone"] = time_ms(fl._launch_dkv, ready, reps=10)
        print(f"[bwd {label}] {card_line()}: dq {t['dq']:.4f} ms  dk/dv "
              f"{t['dkv']:.4f} ms, each with its own operand checks and "
              f"delta ({t['prep']:.4f} ms); the launches alone "
              f"{t['dq_alone']:.4f} and {t['dkv_alone']:.4f} ms; both "
              f"kernels behind one such pass, as autograd calls them, "
              f"{t['one_call']:.4f} ms")
        if timed == 2:
            continue
        t.update({
            "dq_plain": time_ms(
                lambda *a: fl.flash_attention_bwd_dq_plain(*a, **kw), ops,
                reps=3, warmup=1),
            "dkv_plain": time_ms(
                lambda *a: fl.flash_attention_bwd_dkv_plain(*a, **kw), ops,
                reps=3, warmup=1)})
        lib_ops = rotations(q, k, v, do)
        t["library_ms"] = library_ms("flash_bwd", lib_ops, kv_valid=valid)
        # pairs (query i, valid slot j <= i): dQ needs 3 products of Dh each
        # over them (s, dp, dq), dK/dV 4 (s, dp, dv, dk); a backward that
        # shared s and dp would need 5
        pairs = int((valid[:, None, :] & (
            torch.arange(Sk, device=dev)[None]
            <= torch.arange(Sq, device=dev)[:, None] + offset)[None]).sum())
        stats = nbytes(lse) * 2                      # lse and delta
        bq = bound(nbytes(q, k, v, out, do) + stats + nbytes(dq),
                   6 * H * Dh * pairs)
        bkv = bound(nbytes(q, k, v, do) + stats + nbytes(dk, dv),
                    8 * H * Dh * pairs)
        whole = bound(nbytes(q, k, v, out, do, lse) + nbytes(dq, dk, dv),
                      10 * H * Dh * pairs)
        print(f"[bwd {label}] {card_line()}: dq {t['dq']:.4f} ms (plain "
              f"{t['dq_plain']:.4f})  dk/dv {t['dkv']:.4f} ms (plain "
              f"{t['dkv_plain']:.4f})  both {t['dq'] + t['dkv']:.4f} ms; "
              f"bound of the whole backward (5 products) "
              f"{whole['bound_ms']:.4f} ms by {whole['bound_by']}; library "
              f"backward (forward + backward less forward) "
              f"{t['library_ms']:.4f} ms")
        if Sq == 1599:
            rq.update(bq, ms=t["dq"], plain_ms=t["dq_plain"])
            rkv.update(bkv, ms=t["dkv"], plain_ms=t["dkv_plain"])
            # the one library call computes dq, dk and dv together
            rq["library_ms"] = rkv["library_ms"] = t["library_ms"]
            _show("bwd dq 1599", rq)
            _show("bwd dk/dv 1599", rkv)
    return rec


# ---------------------------------------------------------------------------
# phase 10: the training slice at full width
# ---------------------------------------------------------------------------

TRAIN_T = 1024            # text tokens of the train batch
TRAIN_LR = 2e-4           # the reference's LoRA recipe
TRAIN_LOSS_TOL = 1e-2     # kernel path against attn_impl="reference"
# kernel names of a profiled step, by kind (first match wins)
TRAIN_KERNEL_GROUPS = (
    ("flash forward", ("flash_fwd_",)),      # ..._mma_kernel or ..._kernel
    ("flash dK/dV", ("flash_bwd_dkv_",)),    # ..._mma_kernel or ..._kernel
    ("flash dQ", ("flash_bwd_dq_",)),
    ("matrix products (cuBLAS)", ("nvjet", "gemm", "cutlass", "cublas")),
    ("elementwise", ("elementwise", "CatArrayBatchedCopy", "copy")),
    ("reductions and softmax", ("reduce", "softmax", "Softmax")),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
)


def _frozen_checksums(params, labels) -> dict:
    """path -> the int64 sum of a frozen leaf's bits."""
    from matryoshka_mm_torch.train.optimizer import named_leaves

    views = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return {p: int(t.detach().contiguous().view(views[t.element_size()])
                   .sum(dtype=torch.int64))
            for p, t in named_leaves(params) if labels[p] == "frozen"}


def _train_counters() -> dict:
    from matryoshka_mm_torch.ops import flash_attention as fl

    return {"flash_attention": fl.flash_attention_lse,
            "flash_attention_bwd_dq": fl.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fl.flash_attention_bwd_dkv}


def train_batch(cfg, dev, T=TRAIN_T, B=1):
    """One seeded batch: BOS, the image sentinel at 5, random ids, labels on
    the second half."""
    from matryoshka_mm_torch.train.train_step import M3Batch

    rng = np.random.default_rng(5)
    size = cfg.vision.image_size
    ids = np.stack([make_prompt(rng, T, cfg.llama.vocab_size)
                    for _ in range(B)]).astype(np.int64)
    labels = ids.copy()
    labels[:, :T // 2] = -100
    px = rng.standard_normal((B, 3, size, size)).astype(np.float32)
    return M3Batch(torch.as_tensor(ids, device=dev),
                   torch.as_tensor(px, device=dev),
                   torch.as_tensor(labels, device=dev),
                   torch.ones((B, T), dtype=torch.bool, device=dev))


def phase_train(dev) -> dict:
    """llava-v1.5-7b-m3, bf16 base frozen, LoRA r=128 alpha=256 on every LM
    projection, K=5 scales, T=1024, B=1, full per-layer recompute: one warm
    step and three timed ones.  Returns the launches of the timed steps."""
    import dataclasses

    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.ops.lora import add_lora, count_lora_params
    from matryoshka_mm_torch.train.optimizer import (OptimizerConfig,
                                                     named_leaves)
    from matryoshka_mm_torch.train.train_step import m3_loss, scale_buckets
    from matryoshka_mm_torch.train.trainer import (create_train_state,
                                                   host_metrics,
                                                   make_train_step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, model, _, _ = load_7b(dev)
    cfg = dataclasses.replace(model.cfg, llama=dataclasses.replace(
        model.cfg.llama, remat=True))
    gen = torch.Generator(device=dev).manual_seed(1)
    params = add_lora(model.params, gen)          # r=128, alpha=256
    opt_cfg = OptimizerConfig(learning_rate=TRAIN_LR, total_steps=10,
                              lora_enable=True)
    state, tx = create_train_state(params, opt_cfg)
    step_fn = make_train_step(cfg, tx, frozen_vision=True)
    batch = train_batch(cfg, dev)
    buckets = scale_buckets(cfg, TRAIN_T)
    L = cfg.llama.num_hidden_layers
    n_adapter = count_lora_params(params)
    tokens = sum(TRAIN_T - 1 + s for s in cfg.tokscale_list)
    print(f"[train] {card_line()}: debug://7b + LoRA r=128: "
          f"{n_adapter / 1e6:.1f} M adapter parameters in f32, "
          f"{len(tx.trainable)} trainable leaves; buckets "
          f"{[(cap, [cfg.tokscale_list[i] for i in m]) for cap, m in buckets]}"
          f"; {tokens} tokens a step")
    before = _frozen_checksums(params, tx.labels)
    counters = _train_counters()

    def counted_step(step, state):
        """((state, metrics), seconds, launches) of one step."""
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = step(state, batch)
        torch.cuda.synchronize()
        return (result, time.perf_counter() - t0,
                {k: fn.launches for k, fn in counters.items()})

    # ---- one warm step, three timed ----
    losses, norms, times = [], [], []
    total = dict.fromkeys(counters, 0)
    want = {"flash_attention": 2 * L * len(buckets),
            "flash_attention_bwd_dq": L * len(buckets),
            "flash_attention_bwd_dkv": L * len(buckets)}
    for i in range(4):
        (state, metrics), t, launches = counted_step(step_fn, state)
        m = host_metrics(metrics)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        print(f"[train] step {i + 1}: loss {m['loss']:.5f} grad_norm "
              f"{m['grad_norm']:.5f} {t * 1e3:.1f} ms launches {launches}")
        if launches != want:
            fail(f"train step {i + 1}: launches {launches}, expected {want}")
        if i == 0:
            leaves = dict(named_leaves(params))
            dead = [p for p in tx.trainable if p.endswith("lora_b")
                    and not bool(leaves[p].any())]
            if dead:
                fail(f"{len(dead)} lora_b leaves are still zero after one "
                     f"step, e.g. {dead[0]}")
        else:
            times.append(t)
            for k in total:
                total[k] += launches[k]
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        fail(f"train: losses {losses} grad norms {norms}")
    if not losses[3] < losses[0]:
        fail(f"train: the loss did not fall: {losses}")
    step_s = statistics.median(times)
    print(f"[train] {card_line()}: step {step_s * 1e3:.1f} ms (median of 3: "
          f"{[round(t * 1e3, 1) for t in times]}), {tokens / step_s:.1f} "
          f"tok/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- the same loss through attn_impl="reference" ----
    with torch.no_grad():
        got = float(m3_loss(params, cfg, batch, frozen_vision=True)[0])
        ref = float(m3_loss(params, cfg.with_attn_impl("reference"), batch,
                            frozen_vision=True)[0])
    rel = abs(got - ref) / abs(ref)
    print(f"[train] loss through the kernels {got:.5f}, through "
          f"attn_impl=reference {ref:.5f}: relative {rel:.2e} (tolerance "
          f"{TRAIN_LOSS_TOL})")
    if not rel <= TRAIN_LOSS_TOL:
        fail("train: the kernel path's loss leaves the reference path's")

    # ---- one step keeping the flash forward's out and lse ----
    keep_cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, remat_policy="names:flash_out,flash_lse"))
    keep_step = make_train_step(keep_cfg, tx, frozen_vision=True)
    (state, _), _, _ = counted_step(keep_step, state)   # warm
    torch.cuda.reset_peak_memory_stats()
    (state, _), t, launches = counted_step(keep_step, state)
    print(f"[train] remat_policy=names:flash_out,flash_lse: step "
          f"{t * 1e3:.1f} ms launches {launches} max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != dict(want, flash_attention=L * len(buckets)):
        fail("train: the recompute launched the flash forward again")

    # ---- the remat policies: one warm step and two timed each ----
    for policy in ("", "dots", "names:attn"):
        pcfg = dataclasses.replace(cfg, llama=dataclasses.replace(
            cfg.llama, remat_policy=policy))
        pstep = make_train_step(pcfg, tx, frozen_vision=True)
        (state, _), _, _ = counted_step(pstep, state)       # warm
        torch.cuda.reset_peak_memory_stats()
        ts = []
        for _ in range(2):
            (state, m), t, launches = counted_step(pstep, state)
            ts.append(t)
        flash = L * len(buckets) * (1 if policy == "names:attn" else 2)
        print(f"[train] {card_line()}: remat=True remat_policy="
              f"{policy or chr(39) * 2}: step "
              f"{statistics.median(ts) * 1e3:.1f} ms (two: "
              f"{[round(t * 1e3, 1) for t in ts]}), loss "
              f"{host_metrics(m)['loss']:.5f}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches {launches}")
        if launches != dict(want, flash_attention=flash):
            fail(f"train remat_policy={policy!r}: launches {launches}")

    after = _frozen_checksums(params, tx.labels)
    changed = [p for p in before if before[p] != after[p]]
    print(f"[train] {len(before)} frozen leaves, {len(changed)} changed")
    if changed:
        fail(f"train: frozen leaves changed, e.g. {changed[0]}")

    # ---- one step under the profiler ----
    kernels = profile_kernels(lambda: step_fn(state, batch))
    # (the wall time inside the profiler is longer than outside it)
    wall = counted_step(step_fn, state)[1] * 1e3
    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(f"[train] {card_line()}: profile of one step: device {dev_ms:.1f} "
          f"ms, wall {wall:.1f} ms, device idle "
          f"{max(0.0, 1 - dev_ms / wall):.3f}, "
          f"{sum(e.count for e in kernels)} kernels")
    groups = {}
    for e in kernels:
        key = next((g for g, words in TRAIN_KERNEL_GROUPS
                    if any(w in e.key for w in words)), "other")
        ms, n = groups.get(key, (0.0, 0))
        groups[key] = ms + dev_us(e) / 1e3, n + e.count
    print("[train] device time by kind: " + "; ".join(
        f"{g} {ms:.1f} ms ({100 * ms / max(dev_ms, 1e-9):.1f}%, x{n})"
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for e in sorted(kernels, key=lambda e: -dev_us(e))[:6]:
        print(f"[train]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:5d}  "
              f"{e.key[:80]}")
    del model, params, state
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 11: small model train steps, card against CPU
# ---------------------------------------------------------------------------

SMALL_TRAIN_TOL = 1e-3
SMALL_MOE = "t=dense_ft=cls_obj=weightedlm_loadb=switch_alpha=0.01"


def _small_train_run(params, cfg, opt_cfg, dev, text_embedder=None):
    """Step-1 gradients, then two train steps' losses and grad norms; a
    ``text_embedder`` gives the batch its router text embedding."""
    from matryoshka_mm_torch.train.train_step import m3_loss
    from matryoshka_mm_torch.train.trainer import (create_train_state,
                                                   host_metrics,
                                                   make_train_step)
    from matryoshka_mm_torch.train.optimizer import named_leaves

    state, tx = create_train_state(params, opt_cfg)
    batch = train_batch(cfg, dev, T=40, B=2)
    batch = batch._replace(attn_mask=batch.attn_mask.clone())
    batch.attn_mask[1, 33:] = False                 # a shorter second row
    if text_embedder is not None:
        batch = batch._replace(text_embed=text_embedder(
            batch.input_ids.cpu().numpy()))
    leaves = dict(named_leaves(params))
    loss, _ = m3_loss(params, cfg, batch, argmaxcost_ema=state.argmaxcost_ema,
                      frozen_vision=True)
    grads = torch.autograd.grad(loss, [leaves[p] for p in tx.trainable],
                                allow_unused=True)
    grads = {p: g.detach().cpu() for p, g in zip(tx.trainable, grads)
             if g is not None}
    step_fn = make_train_step(cfg, tx, frozen_vision=True)
    seen = []
    for _ in range(2):
        state, metrics = step_fn(state, batch)
        m = host_metrics(metrics)
        seen += [m["loss"], m["grad_norm"]]
    return grads, seen


def phase_train_small(dev) -> None:
    import copy
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.ops.lora import add_lora
    from matryoshka_mm_torch.ops.quant import quantize_llama_params
    from matryoshka_mm_torch.train.optimizer import OptimizerConfig

    counters = _train_counters()
    for label in ("moe full fine-tune", "qlora int8"):
        moe = SMALL_MOE if label.startswith("moe") else None
        base = LlavaConfig.tiny_debug(moe=moe)
        cfg = dataclasses.replace(base, llama=dataclasses.replace(
            base.llama, hidden_size=256, num_attention_heads=2,
            num_key_value_heads=2, intermediate_size=512, remat=True))
        params = init_params(cfg, "cpu", seed=4)            # Dh = 128
        opt_cfg = OptimizerConfig(learning_rate=1e-3, total_steps=10)
        if label == "qlora int8":
            quantize_llama_params(params, bits=8, fuse=False)
            params = add_lora(params, torch.Generator().manual_seed(2), r=8,
                              alpha=16.0)
            opt_cfg = dataclasses.replace(opt_cfg, lora_enable=True)
        on_card = _to(copy.deepcopy(params), dev)
        for fn in counters.values():
            fn.launches = 0
        want_g, want = _small_train_run(params, cfg, opt_cfg, "cpu")
        if any(fn.launches for fn in counters.values()):
            fail(f"small train {label}: a kernel was launched on the CPU")
        got_g, got = _small_train_run(on_card, cfg, opt_cfg, dev)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        if not all(launches.values()):
            fail(f"small train {label}: launches on the card {launches}")
        worst = max(
            (float((got_g[p] - want_g[p]).abs().max()
                   / want_g[p].abs().max().clamp(min=1e-12)), p)
            for p in want_g)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"[small train {label}] card {[round(x, 6) for x in got]}\n"
              f"[small train {label}] cpu  {[round(x, 6) for x in want]}\n"
              f"[small train {label}] losses and grad norms within "
              f"{rel:.2e}; {len(want_g)} gradients, the worst "
              f"{worst[0]:.2e} of its max ({worst[1]}); tolerance "
              f"{SMALL_TRAIN_TOL}; launches {launches}")
        if set(got_g) != set(want_g) or not rel <= SMALL_TRAIN_TOL \
                or not worst[0] <= SMALL_TRAIN_TOL:
            fail(f"small train {label}: the card leaves the CPU")


# ---------------------------------------------------------------------------
# phase 8: small model, card against CPU
# ---------------------------------------------------------------------------

def phase_small(dev) -> None:
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.models.convert import init_params

    base = LlavaConfig.tiny_debug()
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, hidden_size=256, num_attention_heads=2,
        num_key_value_heads=2, intermediate_size=512))   # Dh = 128
    params_cpu = init_params(cfg, "cpu", seed=3)
    params_dev = _to(params_cpu, dev)
    rng = np.random.default_rng(1)
    ids = rng.integers(100, 500, (2, 12)).astype(np.int32)
    ids[:, 4] = -200
    ids[1, :3] = 0
    mask = ids != 0
    px = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    gen_cfg = GenerationConfig(max_new_tokens=10, decode_chunk=4,
                               eos_token_id=-1)
    tally = graph_tally()
    got = generate(params_dev, cfg, ids, px, attention_mask=mask,
                   matryoshka_vis_token_scale="ver=v0_numtoks=4",
                   gen_cfg=gen_cfg)
    # 9 decode steps: a warm-up step, a capture, 8 replays
    check_graphs("small", tally, 1, 8)
    want = generate(params_cpu, cfg, ids, px, attention_mask=mask,
                    matryoshka_vis_token_scale="ver=v0_numtoks=4",
                    gen_cfg=gen_cfg)
    print(f"[small] card {got.tolist()}\n[small] cpu  {want.tolist()}")
    if not np.array_equal(got, want):
        fail("small model: card tokens differ from CPU tokens")

    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention

    served = {}
    for backend, counter in (("paged", paged_decode_attention),
                             ("dense", flash_decode_attention)):
        for name, params in (("card", params_dev), ("cpu", params_cpu)):
            kw = dict(page_size=16) if backend == "paged" else {}
            b = ContinuousBatcher(params, cfg, max_batch=2, prefill_len=64,
                                  max_new_tokens=16, gen_cfg=gen_cfg, chunk=4,
                                  backend=backend, **kw)
            before, tally = counter.launches, graph_tally()
            try:
                b._hold_admission = True
                reqs = [b.submit(ids[i:i + 1, 3 * i:], px[i:i + 1], numtoks=4,
                                 max_new_tokens=10) for i in range(2)]
                b._hold_admission = False
                served[backend, name] = [
                    np.concatenate(list(b.stream(r))).tolist() for r in reqs]
                if backend == "paged" and b.use_kernel != (name == "card"):
                    fail(f"small model: batcher on the {name} has use_kernel="
                         f"{b.use_kernel}")
            finally:
                b.shutdown()
            print(f"[small] {backend} batcher {name:4s} "
                  f"{served[backend, name]}")
            if (counter.launches > before) != (name == "card"):
                fail(f"small model: the {backend} batcher on the {name} "
                     f"launched its decode kernel "
                     f"{counter.launches - before} times")
            captured, replayed = (a - b for a, b in zip(graph_tally(), tally))
            print(f"[small] {backend} batcher {name}: CUDA graphs captured "
                  f"{captured}, replayed {replayed}")
            if (captured, replayed > 0) != ((1, True) if name == "card"
                                            else (0, False)):
                fail(f"small model: the {backend} batcher on the {name} did "
                     f"not replay a captured round")
    if any(out != got.tolist() for out in served.values()):
        fail("small model: a batcher's tokens on the card differ from the "
             "CPU's or from generate's")

    # float32 leaves no ties: a prefix-cache hit gives the tokens of its miss
    # and speculative decoding the plain greedy tokens, on both devices
    long_ids = rng.integers(100, 500, (1, 60)).astype(np.int32)
    long_ids[0, 4] = -200
    runs = {}
    for name, params in (("card", params_dev), ("cpu", params_cpu)):
        for option in ({}, {"prefix_cache": True}, {"speculative_k": 4}):
            b = ContinuousBatcher(params, cfg, max_batch=2, prefill_len=128,
                                  max_new_tokens=16, gen_cfg=gen_cfg, chunk=4,
                                  backend="paged", page_size=16, **option)
            try:
                outs = [np.concatenate(list(b.stream(b.submit(
                    long_ids, px[:1], numtoks=4, max_new_tokens=12)))).tolist()
                    for _ in range(2)]
                if option.get("prefix_cache") and b.stats["prefix_hits"] != 1:
                    fail("small model: the repeated prompt did not hit")
                if option.get("speculative_k") \
                        and b.spec_stats["verify_steps"] <= 0:
                    fail("small model: no speculative verify step ran")
            finally:
                b.shutdown()
            runs[name, tuple(option)] = outs
            print(f"[small] batcher {name:4s} {option} {outs[0]}")
    first = runs["card", ()][0]
    if any(o != first for outs in runs.values() for o in outs):
        fail("small model: prefix cache or speculative decoding changed the "
             "greedy tokens")


# ---------------------------------------------------------------------------
# phase 12: checkpoints on disk at full width
# ---------------------------------------------------------------------------

CKPT_SHARD_BYTES = 5 * 10**9      # the largest shard, as HF writes them
CKPT_MOE = "t=dense_ft=cls_obj=weightedlm"    # debug://tiny-moe's router
CKPT_LORA = {"r": 128, "lora_alpha": 256}
CKPT_GATE_TOL = 1e-3
CKPT_SCALES = "ver=v0_numtoks=[1,9,36,144,576]"
TOWER = "model.vision_tower.vision_tower.vision_model."


def hf_state_dict(params, cfg) -> dict:
    """The port's parameters under liuhaotian's LLaVA keys (views on the
    card; the patch embedding back as the conv kernel)."""
    lm, vis = params["llama"], params["vision_tower"]
    sd = {"model.embed_tokens.weight": lm["embed_tokens"],
          "model.norm.weight": lm["norm"], "lm_head.weight": lm["lm_head"]}
    for i, layer in enumerate(lm["layers"]):
        for k in ("input_layernorm", "post_attention_layernorm"):
            sd[f"model.layers.{i}.{k}.weight"] = layer[k]
        for group in ("self_attn", "mlp"):
            for k, w in layer[group].items():
                sd[f"model.layers.{i}.{group}.{k}.weight"] = w
    P, D = cfg.vision.patch_size, cfg.vision.hidden_size
    sd[TOWER + "embeddings.class_embedding"] = vis["class_embedding"]
    sd[TOWER + "embeddings.patch_embedding.weight"] = \
        vis["patch_embedding"].T.reshape(D, 3, P, P)
    sd[TOWER + "embeddings.position_embedding.weight"] = \
        vis["position_embedding"]
    nested = {"pre_layrnorm": vis["pre_layrnorm"],
              "post_layernorm": vis["post_layernorm"],
              "model.router": params.get("router", {})}
    for i, layer in enumerate(vis["layers"]):
        nested[f"encoder.layers.{i}"] = layer
    for j, layer in enumerate(params["mm_projector"]["layers"]):
        nested[f"model.mm_projector.{2 * j}"] = layer
    from matryoshka_mm_torch.train.optimizer import named_leaves

    for stem, tree in nested.items():
        prefix = "" if stem.startswith("model.") else TOWER
        for path, t in named_leaves(tree):
            sd[f"{prefix}{stem}.{path.replace('/', '.')}"] = t
    return sd


def write_safetensors(tensors: dict, path: Path) -> int:
    """One safetensors file (the format's header, then each tensor's bytes
    read back from the card in turn); returns the bytes written."""
    kinds = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, pos = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": kinds[t.dtype], "shape": list(t.shape),
                        "data_offsets": [pos, pos + n]}
        pos += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(t.contiguous().cpu().view(torch.uint8).numpy().data)
    return 8 + len(raw) + pos


def write_llava_dir(params, cfg, path: Path) -> int:
    """``params`` as a liuhaotian-layout directory: bf16 safetensors shards
    of at most CKPT_SHARD_BYTES and a config.json with the M3 ``config``
    dict and the ``mm_*`` keys; returns the bytes written."""
    shards, size = [{}], 0
    for name, t in hf_state_dict(params, cfg).items():
        n = t.numel() * t.element_size()
        if shards[-1] and size + n > CKPT_SHARD_BYTES:
            shards.append({})
            size = 0
        shards[-1][name] = t
        size += n
    written = sum(write_safetensors(
        shard, path / f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors")
        for i, shard in enumerate(shards))
    lc, p = cfg.llama, cfg.preset
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlavaLlamaForCausalLM"],
        "model_type": "llava_llama", "torch_dtype": "bfloat16",
        **{k: getattr(lc, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "max_position_embeddings", "rms_norm_eps",
            "rope_theta")},
        "mm_vision_tower": "openai/clip-vit-large-patch14-336",
        "mm_hidden_size": cfg.mm_hidden_size,
        "mm_projector_type": cfg.mm_projector_type,
        "mm_vision_select_layer": cfg.vision.select_layer,
        "mm_vision_select_feature": cfg.vision.select_feature,
        "mm_patch_merge_type": cfg.mm_patch_merge_type,
        "image_aspect_ratio": cfg.image_aspect_ratio,
        "tokenizer_model_max_length": cfg.tokenizer_model_max_length,
        "config": {"use_alternative": p.use_alternative,
                   "projection_type": p.projection_type,
                   "matryoshka_vis_token_scale": p.matryoshka_vis_token_scale,
                   "moe": p.moe, "projector_loc": p.projector_loc,
                   "lm_loss_type": p.lm_loss_type}}))
    return written


class PeakRss:
    """The host's peak resident set while the block runs, sampled from
    /proc/self/statm every 5 ms (the process's own peak, VmHWM, also holds
    the phases before)."""

    def __enter__(self):
        self.peak, self._stop = 0, threading.Event()
        self._thread = threading.Thread(target=self._sample)
        self._thread.start()
        return self

    @staticmethod
    def now() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _sample(self):
        while True:
            self.peak = max(self.peak, self.now())
            if self._stop.wait(0.005):
                return

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def drop_page_cache(*dirs) -> None:
    """Ask the kernel to drop the files' pages from the page cache, so that
    a load reads them from the disk (posix_fadvise; no privilege needed)."""
    for f in (f for d in dirs for f in d.iterdir() if f.is_file()):
        fd = os.open(f, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def _same_leaves(got, want) -> list:
    """Paths whose tensors differ in dtype, shape or any bit."""
    from matryoshka_mm_torch.train.optimizer import named_leaves

    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    if set(got) != set(want):
        return sorted(set(got) ^ set(want))
    return [p for p in want if not (got[p].dtype == want[p].dtype
                                    and torch.equal(got[p], want[p]))]


# phase 12's load rates by label, printed beside phase 23's
LOAD_GB_S = {}


def timed_load(label, path, dev, **kw):
    """load_pretrained_model on ``path``, timed; prints seconds, GB/s of the
    files, the device memory it added at its peak and the host's peak
    resident set."""
    from matryoshka_mm_torch.models.builder import load_pretrained_model

    rss_before = PeakRss.now()
    dirs = {Path(path), Path(kw.get("model_base") or path)}
    files = sum(f.stat().st_size for d in dirs for f in d.iterdir()
                if f.suffix in (".safetensors", ".bin"))
    drop_page_cache(*dirs)
    gc.collect()                  # a dropped model's graphs free it late
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with PeakRss() as rss:
        out = load_pretrained_model(str(path), device=str(dev), **kw)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    LOAD_GB_S[label] = files / 1e9 / secs
    print(f"[ckpt] {card_line()}: {label}: loaded {files / 1e9:.2f} GB in "
          f"{secs:.2f} s ({files / 1e9 / secs:.2f} GB/s); device memory "
          f"+{(torch.cuda.max_memory_allocated() - before) / 2**30:.2f} GiB "
          f"at its peak (page cache dropped first), "
          f"+{(torch.cuda.memory_allocated() - before) / 2**30:.2f} GiB held;"
          f" host RSS {rss_before / 2**30:.2f} GiB before, "
          f"{rss.peak / 2**30:.2f} GiB at its peak; tokenizer "
          f"{type(out[0]).__name__}")
    return out


def counted_request(model, inputs, numtoks, counters) -> tuple:
    """One request of the main path with the launch counters set to 0 just
    before it and read just after."""
    for fn in counters.values():
        fn.launches = 0
    out = run(model, inputs, numtoks, NEW_TOKENS)
    return out, {k: fn.launches for k, fn in counters.items()}


def phase_ckpt(dev) -> dict:
    """debug://7b (with a dense router) written to disk in the liuhaotian
    layout and read back: bf16, load_4bit, LoRA over it, train's
    _build_params, the router's gating_probs.  Returns the launch counts of
    the loaded models' counted requests."""
    import dataclasses
    import shutil
    import tempfile

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.generate import gating_probs
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.models.router import init_dense_gating_params
    from matryoshka_mm_torch.ops import fused_mlp, int4_matmul
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.train import train as ttrain
    from matryoshka_mm_torch.train.optimizer import named_leaves

    counters = {"int4_matmul": int4_matmul.int4_matmul,
                "quant_mlp": fused_mlp.quant_mlp,
                "decode_attention": flash_decode_attention,
                "flash_attention": flash_attention_lse}
    torch.cuda.empty_cache()
    _, ref, _, _ = load_7b(dev)
    cfg = cut_cfg(LlavaConfig.llava_v15_7b_m3(moe=CKPT_MOE))
    ref.cfg = cfg
    ref.params["router"] = init_dense_gating_params(
        torch.Generator(device=dev).manual_seed(0), cfg.mm_hidden_size,
        len(cfg.tokscale_list), dtype=torch.bfloat16, device=dev)
    L = cfg.llama.num_hidden_layers
    inputs = make_inputs(cfg)
    path = Path(tempfile.mkdtemp(prefix="m3_ckpt_"))
    total = dict.fromkeys(counters, 0)
    try:
        free = shutil.disk_usage(path).free
        t0 = time.perf_counter()
        written = write_llava_dir(ref.params, cfg, path)
        os.sync()
        secs = time.perf_counter() - t0
        print(f"[ckpt] {card_line()}: wrote {written / 1e9:.2f} GB in "
              f"{len(list(path.glob('*.safetensors')))} bf16 safetensors "
              f"shards in {secs:.2f} s ({written / 1e9 / secs:.2f} GB/s, "
              f"synced) to {path}, of {free / 1e9:.1f} GB free")

        # ---- bf16: every leaf, the prefill logits and 32 tokens ----
        tok, model, _, ctx = timed_load("bf16", path, dev)
        bad = _same_leaves(model.params, ref.params)
        print(f"[ckpt] bf16 load: {len(list(named_leaves(model.params)))} "
              f"leaves, {len(bad)} differ; config equal "
              f"{model.cfg == cfg}; context_len {ctx}")
        if bad or model.cfg != cfg:
            fail(f"ckpt: the bf16 load is not debug://7b: {bad[:4]}")
        want = run(ref, inputs[1], BATCH_SCALE, NEW_TOKENS)
        got, launches = counted_request(model, inputs[1], BATCH_SCALE,
                                        counters)
        same_logits = torch.equal(
            prefill_logits(model, cfg, inputs[1], BATCH_SCALE),
            prefill_logits(ref, cfg, inputs[1], BATCH_SCALE))
        expect = dict.fromkeys(counters, 0)
        expect.update(flash_attention=L,
                      decode_attention=(NEW_TOKENS - 1) * L)
        print(f"[ckpt] bf16 load: {NEW_TOKENS} tokens at {BATCH_SCALE} "
              f"equal {np.array_equal(got, want)}, prefill logits "
              f"bit-identical {same_logits}; launches {launches} expected "
              f"{expect}")
        if not (np.array_equal(got, want) and same_logits) \
                or launches != expect:
            fail("ckpt: the loaded model does not answer as debug://7b")
        for k in total:
            total[k] += launches[k]
        time_requests(model, inputs[1], BATCH_SCALE, "ckpt bf16",
                      reps=(2, 1))

        # ---- the router: gating_probs on the card against the CPU, in
        # float32 (the bf16 tower rounds otherwise on the two: printed) ----
        px = np.concatenate([inputs[1][1], inputs[4][1][:1]])
        gate = {k: model.params[k] for k in ("vision_tower", "router")}
        f32 = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, dtype="float32"))
        on_card = gating_probs(model.params, cfg, px).cpu()
        bf16_err = float((on_card - gating_probs(_to(gate, "cpu"), cfg,
                                                 px)).abs().max())
        gate32 = ttrain._cast_floats(gate, torch.float32)
        card32 = gating_probs(gate32, f32, px).cpu()
        err = float((card32 - gating_probs(_to(gate32, "cpu"), f32,
                                           px)).abs().max())
        print(f"[ckpt] gating_probs (bf16) {on_card.tolist()}; float32 "
              f"weights, card against CPU: within {err:.2e} (tolerance "
              f"{CKPT_GATE_TOL}); bf16, card against CPU: {bf16_err:.2e}; "
              f"bf16 against float32 on the card: "
              f"{float((on_card - card32).abs().max()):.2e}")
        if not err <= CKPT_GATE_TOL:
            fail("ckpt: gating_probs on the card leave the CPU's")
        del gate32
        pick = cfg.tokscale_list[int(on_card[0].argmax())]
        gated = run(model, inputs[1], "gateprobargmax", NEW_TOKENS)
        fixed = run(model, inputs[1], pick, NEW_TOKENS)
        print(f"[ckpt] gateprobargmax picked {pick}: tokens equal the "
              f"fixed scale's {np.array_equal(gated, fixed)}")
        if not np.array_equal(gated, fixed):
            fail("ckpt: gateprobargmax did not decode at the router's pick")
        del model

        # ---- load_4bit: every quantized leaf and 32 tokens ----
        _, model, _, _ = timed_load("load_4bit", path, dev, load_4bit=True)
        _, ref4, _, _ = load_7b(dev, load_4bit=True)
        bad = _same_leaves(model.params["llama"], ref4.params["llama"])
        want = run(ref4, inputs[1], BATCH_SCALE, NEW_TOKENS)
        del ref4
        got, launches = counted_request(model, inputs[1], BATCH_SCALE,
                                        counters)
        steps = NEW_TOKENS - 1
        expect = {"int4_matmul": (4 * L + 1) + steps * (2 * L + 1),
                  "quant_mlp": steps * L, "decode_attention": steps * L,
                  "flash_attention": L}
        print(f"[ckpt] load_4bit: {len(bad)} decoder leaves differ from "
              f"debug://7b + load_4bit; tokens equal "
              f"{np.array_equal(got, want)}; launches {launches} expected "
              f"{expect}")
        if bad or not np.array_equal(got, want) or launches != expect:
            fail("ckpt: the load_4bit load is not debug://7b + load_4bit")
        for k in total:
            total[k] += launches[k]
        time_requests(model, inputs[1], BATCH_SCALE, "ckpt load_4bit",
                      reps=(2, 1))
        del model

        # ---- LoRA over the directory ----
        lora = path / "lora"
        lora.mkdir()
        targets = [(f"model.layers.{i}.{g}.{k}", w)
                   for i, layer in enumerate(ref.params["llama"]["layers"])
                   for g in ("self_attn", "mlp")
                   for k, w in layer[g].items()]
        gen = torch.Generator(device=dev).manual_seed(3)
        r = CKPT_LORA["r"]
        adapter = {}
        for stem, w in targets:
            adapter[f"base_model.model.{stem}.lora_A.weight"] = torch.randn(
                r, w.shape[1], generator=gen, device=dev).mul_(0.01).to(
                torch.bfloat16)
            adapter[f"base_model.model.{stem}.lora_B.weight"] = torch.randn(
                w.shape[0], r, generator=gen, device=dev).mul_(0.01).to(
                torch.bfloat16)
        n_adapter = sum(t.numel() for t in adapter.values())
        torch.save({k: v.cpu() for k, v in adapter.items()},
                   lora / "adapter_model.bin")
        (lora / "adapter_config.json").write_text(json.dumps(
            {**CKPT_LORA, "target_modules": sorted(
                {s.rsplit(".", 1)[1] for s, _ in targets})}))
        shutil.copy(path / "config.json", lora / "config.json")
        print(f"[ckpt] LoRA adapter: {n_adapter / 1e6:.1f} M parameters "
              f"(r={r}) over {len(targets)} projections")
        _, model, _, _ = timed_load("LoRA over the directory", lora, dev,
                                    model_base=str(path))
        scaling = CKPT_LORA["lora_alpha"] / r
        merged = dict(named_leaves(model.params["llama"]))
        bad = []
        for stem, w in targets:
            a = adapter[f"base_model.model.{stem}.lora_A.weight"]
            b = adapter[f"base_model.model.{stem}.lora_B.weight"]
            want_w = (w.float() + scaling * (b.float() @ a.float())).to(
                torch.bfloat16)
            leaf = stem[len("model."):].replace(".", "/")
            if not torch.equal(merged.pop(leaf), want_w):
                bad.append(leaf)
        ref_rest = {p: t for p, t in named_leaves(ref.params["llama"])
                    if p in merged}
        bad += _same_leaves(merged, ref_rest)
        bad += _same_leaves({k: v for k, v in model.params.items()
                             if k != "llama"},
                            {k: v for k, v in ref.params.items()
                             if k != "llama"})
        print(f"[ckpt] LoRA: {len(targets)} merged leaves against the "
              f"float32 merge here, the rest against debug://7b: "
              f"{len(bad)} differ")
        if bad:
            fail(f"ckpt: the LoRA load differs: {bad[:4]}")
        del model, adapter

        # ---- train._build_params from the directory ----
        margs, dargs, targs = ttrain.parse_args_into_dataclasses(
            (ttrain.ModelArguments, ttrain.DataArguments,
             ttrain.TrainingArguments),
            ["--model_name_or_path", str(path), "--lora_enable", "True",
             "--lora_r", "128", "--lora_alpha", "256", "--bits", "0",
             "--matryoshka_vis_token_scale", CKPT_SCALES])
        tcfg = ttrain.build_llava_config(margs, targs, dargs)
        t0 = time.perf_counter()
        params, tcfg = ttrain._build_params(margs, targs, tcfg, dev)
        torch.cuda.synchronize()
        from matryoshka_mm_torch.ops.lora import add_lora

        want_p = add_lora(ref.params, torch.Generator(device=dev).manual_seed(
            targs.seed + 1), r=targs.lora_r, alpha=float(targs.lora_alpha))
        bad = _same_leaves(params, want_p)
        print(f"[ckpt] train._build_params from the directory in "
              f"{time.perf_counter() - t0:.2f} s: "
              f"{len(list(named_leaves(params)))} leaves, {len(bad)} differ "
              f"from debug://7b + add_lora; remat {tcfg.llama.remat}, "
              f"scales {tcfg.tokscale_list}")
        if bad or not tcfg.llama.remat or tcfg.tokscale_list != list(SCALES):
            fail(f"ckpt: _build_params differs from debug://7b: {bad[:4]}")
        del params, want_p
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return total


# ---------------------------------------------------------------------------
# phase 13: anyres and multi-image at full width
# ---------------------------------------------------------------------------

# LLaVA-1.6's published pinpoints (liuhaotian/llava-v1.6-vicuna-7b's
# config.json), which llava-next-vicuna-7b-m3 inherits
NEXT_PINPOINTS = ("[(336, 672), (672, 336), (672, 672), (1008, 336), "
                  "(336, 1008)]")
# the two images (width, height): the base + a 2 x 2 grid, and the base + a
# 3 x 1 grid
ANYRES_SIZES = ((672, 672), (1000, 400))
ANYRES_MULTI = ((3, 144), (2, 576))     # (images, scale) of the multi-image
ANYRES_4BIT = (576, 144)                # load_4bit scales, the 5-tile image
# the serving run: (scale, image) of the anyres requests, then single tiles
ANYRES_SERVE = ((36, 0), (144, 0), (144, 1), (576, 1))
ANYRES_SERVE_SINGLE = 4
ANYRES_SERVE_KW = dict(backend="paged", max_batch=8, prefill_len=3072,
                       max_new_tokens=128, page_size=64, chunk=8)
# the small float32 model's anyres fields: 56-pixel tiles
SMALL_PINPOINTS = "[(112, 56), (56, 112), (112, 112)]"


def anyres_stacks(model, rng) -> list:
    """``(tile stack (1, T, 3, 336, 336), (width, height))`` of each of
    ANYRES_SIZES: random pixels from ``rng`` through the port's
    ``process_images``."""
    from PIL import Image

    from matryoshka_mm_torch.image_processing import (ClipImageProcessor,
                                                      process_images)

    out = []
    for w, h in ANYRES_SIZES:
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        px = process_images([img], ClipImageProcessor(), model.config)
        out.append((np.asarray(px, np.float32), (w, h)))
    return out


def multi_prompt(rng, vocab, n_images):
    """A PROMPT_LEN prompt with ``n_images`` sentinels, 10 tokens apart."""
    ids = make_prompt(rng, PROMPT_LEN, vocab)
    ids[5:5 + 10 * n_images:10] = -200
    return ids[None]


def anyres_prefill(model, cfg, ids, px, size, numtoks):
    """``(last-position logits f32, device length)`` of one anyres
    prefill through ``generate``'s dispatch."""
    from matryoshka_mm_torch.generate import (GenerationConfig,
                                              _prefill_dispatch)

    dev = model.params["llama"]["norm"].device
    with torch.inference_mode():
        logits, _, lengths = _prefill_dispatch(
            model.params, cfg,
            torch.as_tensor(ids, dtype=torch.int64, device=dev),
            torch.as_tensor(px, device=dev), None, numtoks,
            GenerationConfig(max_new_tokens=NEW_TOKENS), [size])
    return logits[0].float(), int(lengths[0])


def prefill_profile(model, label, inputs, numtoks, size) -> None:
    """One 1-token request under ``torch.profiler``: its device ms, the
    flash forward's and the quantized products' ms, launches and shares;
    the CLIP tower's device ms over the tile stack in its own profile; the
    device's idle share against the request's wall time."""
    from matryoshka_mm_torch.models.llava import encode_images

    dev = model.params["llama"]["norm"].device
    wall = statistics.median(_wall(lambda: run(
        model, inputs, numtoks, 1, image_sizes=[size])) for _ in range(2))
    kernels = profile_kernels(lambda: run(model, inputs, numtoks, 1,
                                          image_sizes=[size]))
    tiles = torch.as_tensor(inputs[1][0], device=dev)
    with torch.inference_mode():
        clip = profile_kernels(lambda: encode_images(model.params, model.cfg,
                                                     tiles))
    total = sum(dev_us(e) for e in kernels)
    flash = sum(dev_us(e) for e in kernels if "flash_fwd" in e.key)
    quant = [e for e in kernels if any(k in e.key for k in QUANT_KERNELS)]
    q_us = sum(dev_us(e) for e in quant)
    clip_us = sum(dev_us(e) for e in clip)
    print(f"[{label}] {card_line()}: numtoks={numtoks} {size[0]}x{size[1]} "
          f"prefill profile: wall {wall * 1e3:.2f} ms, device "
          f"{total / 1e3:.3f} ms (idle {max(0.0, 1 - total / 1e3 / (wall * 1e3)):.3f}); "
          f"flash {flash / 1e3:.3f} ms ({100 * flash / total:.1f}%); "
          f"quantized products {q_us / 1e3:.3f} ms over "
          f"{sum(e.count for e in quant)} launches "
          f"({100 * q_us / total:.1f}%); CLIP tower over "
          f"{tiles.shape[0]} tiles {clip_us / 1e3:.3f} ms "
          f"({100 * clip_us / total:.1f}%)")


def anyres_requests(model, cfg, stacks, label) -> dict:
    """The counted main-path run: every scale of both anyres images and
    the multi-image prompts through ``generate``, 32 greedy tokens each,
    with the launch counters set to 0 just before and read just after;
    then the gates and the timings.  Returns the launches."""
    from matryoshka_mm_torch.models.llava import (anyres_token_count,
                                                  encode_images)
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse

    n_layers, vocab = cfg.llama.num_hidden_layers, cfg.llama.vocab_size
    rng = np.random.default_rng(13)
    ids = make_prompt(rng, PROMPT_LEN, vocab)[None]
    s = cfg.vision.image_size
    multi = [(multi_prompt(rng, vocab, m), rng.standard_normal(
        (m, 3, s, s)).astype(np.float32), n) for m, n in ANYRES_MULTI]
    single = [((ids, px, None), n, size) for px, size in stacks
              for n in SCALES]

    flash_attention_lse.launches = 0
    flash_decode_attention.launches = 0
    tally = graph_tally()
    for inputs, n, size in single:
        run(model, inputs, n, NEW_TOKENS, image_sizes=[size])
    for m_ids, m_px, n in multi:
        run(model, (m_ids, m_px, None), n, NEW_TOKENS)
    launches = {"flash_attention": flash_attention_lse.launches,
                "decode_attention": flash_decode_attention.launches}
    requests = len(single) + len(multi)
    want = {"flash_attention": requests * n_layers,
            "decode_attention": requests * (NEW_TOKENS - 1) * n_layers}
    print(f"[{label}] launches {launches} expected {want}")
    if launches != want:
        fail(f"{label}: the main path did not go through the kernels as "
             f"expected")
    check_graphs(label, tally, requests, requests * (NEW_TOKENS - 2))

    # ---- host spliced lengths against the prefill's device lengths ----
    for inputs, n, size in single:
        tiles = inputs[1].shape[1]
        host = PROMPT_LEN - 1 + anyres_token_count(cfg, size, tiles, n)
        _, device = anyres_prefill(model, cfg, ids, inputs[1], size, n)
        print(f"[{label}] {size[0]}x{size[1]} ({tiles} tiles) numtoks={n}: "
              f"spliced length host {host} device {device}, prefill slots "
              f"{-(-host // 64) * 64}")
        if host != device:
            fail(f"{label}: the host's spliced length differs from the "
                 f"prefill's")

    # ---- the kernel path against attn_impl="reference" at scale 576 ----
    px0, size0 = stacks[0]
    top = max(SCALES)
    got, _ = anyres_prefill(model, cfg, ids, px0, size0, top)
    ref, _ = anyres_prefill(model, cfg.with_attn_impl("reference"), ids, px0,
                            size0, top)
    compare_logits(got, ref, f"{label} {top}", need_same_top=False)
    decode_bits(model, (ids, px0, None), top, label, image_sizes=[size0])

    # ---- timings, after the counted run warmed everything up ----
    dev = model.params["llama"]["norm"].device
    for px, size in stacks:
        tiles = torch.as_tensor(px[0], device=dev)
        with torch.inference_mode():
            ms = time_ms(lambda t: encode_images(model.params, cfg, t),
                         [(tiles,)], reps=5)
        print(f"[{label}] {card_line()}: {size[0]}x{size[1]}: CLIP tower "
              f"over {tiles.shape[0]} tiles {ms:.3f} ms")
    for inputs, n, size in single + [((i, p, None), n, None)
                                     for i, p, n in multi]:
        sizes = None if size is None else [size]
        ttft = statistics.median(_wall(lambda: run(
            model, inputs, n, 1, image_sizes=sizes)) for _ in range(2))
        torch.cuda.reset_peak_memory_stats()
        full = _wall(lambda: run(model, inputs, n, NEW_TOKENS,
                                 image_sizes=sizes))
        what = (f"{size[0]}x{size[1]} ({inputs[1].shape[1]} tiles)"
                if size else f"{inputs[1].shape[0]} images")
        print(f"[{label}] {card_line()}: {what} numtoks={n:4d} TTFT "
              f"{ttft * 1e3:.2f} ms  decode "
              f"{(NEW_TOKENS - 1) / (full - ttft):.2f} tok/s  peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prefill_profile(model, label, (ids, px0, None), top, size0)
    return launches


def anyres_serving(model, cfg, stacks, label) -> dict:
    """A paged ContinuousBatcher answers 4 anyres and 4 single-tile
    requests landing as one burst: the anyres rows admit solo, the single
    tiles as one group.  Gates as phase 7's; then a repeated anyres request
    with prefix_cache=True.  Returns the launches of the counted run."""
    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.models.llava import anyres_token_count
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    counters = {"paged_attention": paged_decode_attention,
                "flash_attention": flash_attention_lse,
                "decode_attention": flash_decode_attention}
    n_layers, vocab = cfg.llama.num_hidden_layers, cfg.llama.vocab_size
    rng = np.random.default_rng(14)
    gen_cfg = GenerationConfig(max_new_tokens=128, decode_chunk=8,
                               eos_token_id=-1)
    batcher = ContinuousBatcher(model.params, cfg, gen_cfg=gen_cfg,
                                **ANYRES_SERVE_KW)
    try:
        print(f"[{label}] {card_line()}: ContinuousBatcher {ANYRES_SERVE_KW}"
              f" warm-up {batcher.warmup(numtoks=BATCH_SCALE):.2f} s")
        while batcher.decode_steps != \
                batcher.occupancy["rounds"] * batcher.chunk:
            time.sleep(0.005)
        for fn in counters.values():
            fn.launches = 0
        batcher.decode_steps = 0
        batcher.occupancy = {"rounds": 0, "active_rows": 0}
        batcher.admit_stats = {"solo": 0, "grouped": 0}
        batcher.events = []
        tally = graph_tally()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        batcher._hold_admission = True      # the burst lands as one batch
        readers = [_serve(batcher, (make_prompt(rng, PROMPT_LEN, vocab)[None],
                                    stacks[i][0][0]), n, NEW_TOKENS,
                          image_size=stacks[i][1])
                   for n, i in ANYRES_SERVE]
        readers += [_serve(batcher, serve_prompt(rng, cfg), BATCH_SCALE,
                           NEW_TOKENS) for _ in range(ANYRES_SERVE_SINGLE)]
        batcher._hold_admission = False
        outs = [r.result() for r in readers]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        steps = batcher.decode_steps
        for out in outs:
            if len(out) != NEW_TOKENS or min(out) < 0 or max(out) >= vocab:
                fail(f"{label}: a stream gave {len(out)} of {NEW_TOKENS} "
                     f"tokens in [{min(out)}, {max(out)}]")
        solo = sum(kind == "admit_solo" for _, kind, _ in batcher.events)
        groups = sum(kind == "admit_group" for _, kind, _ in batcher.events)
        want = {"paged_attention": steps * n_layers,
                "flash_attention": (solo + groups) * n_layers,
                "decode_attention": 0}
        print(f"[{label}] launches {launches} over {steps} decode steps, "
              f"{solo} solo and {groups} group prefills; expected {want}; "
              f"admissions {batcher.admit_stats}")
        if steps <= 0 or launches != want:
            fail(f"{label}: the serving path did not go through the kernels "
                 f"as expected")
        if batcher.admit_stats != {"solo": len(ANYRES_SERVE),
                                   "grouped": ANYRES_SERVE_SINGLE}:
            fail(f"{label}: the anyres rows were not admitted solo and the "
                 f"single tiles as a group")
        check_graphs(label, tally, 0, steps // batcher.chunk)
        free, total = len(batcher.alloc.free), batcher.alloc.n_allocatable
        print(f"[{label}] pages free {free} of {total}")
        if free != total:
            fail(f"{label}: pages were not returned to the free list")
        ttft = sorted(r.t_first - r.t_submit for r in readers)
        pool = nbytes(batcher.paged.k, batcher.paged.v)
        print(f"[{label}] {card_line()}: {len(outs)} requests, "
              f"{sum(map(len, outs))} tokens in {wall:.3f} s: "
              f"{sum(map(len, outs)) / wall:.2f} tok/s over the batch "
              f"(prefills included); TTFT p50 "
              f"{statistics.median(ttft) * 1e3:.1f} ms max "
              f"{ttft[-1] * 1e3:.1f} ms; pool {pool / 2**30:.2f} GiB; "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        batcher.shutdown()
    del batcher
    torch.cuda.empty_cache()

    # ---- a repeated anyres request hits its cached pages ----
    px, size = stacks[0]
    prompt = (make_prompt(rng, PROMPT_LEN, vocab)[None], px[0])
    outs, b = _short_run(model, f"{label} prefix_cache",
                         [(prompt, BATCH_SCALE, 16, {"image_size": size})] * 2,
                         prefix_cache=True, prefill_len=3072)
    spliced = PROMPT_LEN - 1 + anyres_token_count(cfg, size, px.shape[1],
                                                  BATCH_SCALE)
    pages = (spliced - 1) // 64
    print(f"[{label} prefix_cache] {b.stats}; the hit gave "
          f"{sum(x == y for x, y in zip(*outs))} of 16 tokens of the miss")
    if b.stats["prefix_hits"] != 1 \
            or b.stats["prefix_pages_reused"] != pages:
        fail(f"{label}: the repeated anyres request did not hit its {pages} "
             f"pages")
    return launches


def anyres_4bit(model, cfg, stacks, label) -> dict:
    """The same weights quantized to int4 in place: one anyres request at
    each of ANYRES_4BIT through ``generate``, counted; logits against
    disable_fused_proj(), and TTFT beside the TTFT of that route; a
    profile of each prefill."""
    from matryoshka_mm_torch.models.llava import anyres_token_count
    from matryoshka_mm_torch.ops import fused_mlp, int4_matmul
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.ops.quant import (disable_fused_proj,
                                               quantize_llama_params)

    counters = {"int4_matmul": int4_matmul.int4_matmul,
                "quant_mlp": fused_mlp.quant_mlp,
                "decode_attention": flash_decode_attention,
                "flash_attention": flash_attention_lse}
    t0 = time.perf_counter()
    quantize_llama_params(model.params, bits=4)
    torch.cuda.synchronize()
    print(f"[{label}] quantized on the card in {time.perf_counter() - t0:.1f}"
          f" s: decoder weights "
          f"{_nbytes(model.params['llama']) / 2**30:.2f} GiB")
    L = cfg.llama.num_hidden_layers
    rng = np.random.default_rng(15)
    ids = make_prompt(rng, PROMPT_LEN, cfg.llama.vocab_size)[None]
    px, size = stacks[0]
    for fn in counters.values():
        fn.launches = 0
    tally = graph_tally()
    for n in ANYRES_4BIT:
        run(model, (ids, px, None), n, NEW_TOKENS, image_sizes=[size])
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = len(ANYRES_4BIT) * (NEW_TOKENS - 1)
    slots = [-(-(PROMPT_LEN - 1 + anyres_token_count(
        cfg, size, px.shape[1], n)) // 64) * 64 for n in ANYRES_4BIT]
    prefill = sum(4 * L + 1 if rows <= int4_matmul.MAX_FUSED_ROWS else 1
                  for rows in slots)
    want = {"int4_matmul": prefill + steps * (2 * L + 1),
            "quant_mlp": steps * L, "decode_attention": steps * L,
            "flash_attention": len(ANYRES_4BIT) * L}
    print(f"[{label}] prefill slots {slots}; launches {launches} expected "
          f"{want}")
    if launches != want:
        fail(f"{label}: the main path did not go through the kernels as "
             f"expected")
    check_graphs(label, tally, len(ANYRES_4BIT),
                 len(ANYRES_4BIT) * (NEW_TOKENS - 2))
    for n in ANYRES_4BIT:
        got, _ = anyres_prefill(model, cfg, ids, px, size, n)
        with disable_fused_proj():
            want_logits, _ = anyres_prefill(model, cfg, ids, px, size, n)
        compare_logits(got, want_logits, f"{label} {n}", need_same_top=True)
        ttft = statistics.median(_wall(lambda: run(
            model, (ids, px, None), n, 1, image_sizes=[size]))
            for _ in range(2))
        full = _wall(lambda: run(model, (ids, px, None), n, NEW_TOKENS,
                                 image_sizes=[size]))
        with disable_fused_proj():
            dequant = statistics.median(_wall(lambda: run(
                model, (ids, px, None), n, 1, image_sizes=[size]))
                for _ in range(2))
        print(f"[{label}] {card_line()}: numtoks={n} TTFT {ttft * 1e3:.2f} "
              f"ms (every projection dequantized + F.linear: "
              f"{dequant * 1e3:.2f} ms)  decode "
              f"{(NEW_TOKENS - 1) / (full - ttft):.2f} tok/s")
        prefill_profile(model, label, (ids, px, None), n, size)
    return launches


def anyres_small(dev) -> None:
    """Phase 8's small model (Dh=128, float32) with anyres fields: the card
    (kernels) against the CPU (plain versions), the same greedy tokens from
    anyres and multi-image ``generate``, from the batcher's anyres
    admission on the paged and the dense backend, and from an anyres
    prefix-cache hit, which must equal its miss."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    base = LlavaConfig.tiny_debug()
    cfg = dataclasses.replace(
        base, llama=dataclasses.replace(
            base.llama, hidden_size=256, num_attention_heads=2,
            num_key_value_heads=2, intermediate_size=512),    # Dh = 128
        mm_patch_merge_type="spatial_unpad", image_aspect_ratio="anyres",
        image_grid_pinpoints=SMALL_PINPOINTS, tokenizer_model_max_length=256)
    params = {"cpu": init_params(cfg, "cpu", seed=3)}
    params["card"] = _to(params["cpu"], dev)
    rng = np.random.default_rng(2)
    ids = np.array([[1, 5, 17, -200, 42, 9]], np.int32)
    stacks = [(rng.standard_normal((5, 3, 56, 56)).astype(np.float32),
               (500, 500)),
              (rng.standard_normal((3, 3, 56, 56)).astype(np.float32),
               (300, 120))]
    multi_ids = np.array([[1, 23, -200, 57, -200, 88, -200, 14, 9]],
                         np.int32)
    multi_px = rng.standard_normal((3, 3, 56, 56)).astype(np.float32)
    long_ids = np.array([[7] * 20 + [-200] + [9] * 30], np.int32)
    gen_cfg = GenerationConfig(max_new_tokens=10, decode_chunk=4,
                               eos_token_id=-1)
    got = {}
    for name, p in params.items():
        got[name, "anyres"] = generate(
            p, cfg, ids, stacks[0][0][None], image_sizes=[stacks[0][1]],
            matryoshka_vis_token_scale="ver=v0_numtoks=16",
            gen_cfg=gen_cfg).tolist()
        got[name, "multi"] = generate(
            p, cfg, multi_ids, multi_px,
            matryoshka_vis_token_scale="ver=v0_numtoks=4",
            gen_cfg=gen_cfg).tolist()
        for backend in ("paged", "dense"):
            kw = dict(page_size=16) if backend == "paged" else {}
            b = ContinuousBatcher(p, cfg, max_batch=2, prefill_len=128,
                                  max_new_tokens=16, gen_cfg=gen_cfg,
                                  chunk=4, backend=backend, **kw)
            try:
                b._hold_admission = True
                reqs = [b.submit(ids, px, numtoks=16, max_new_tokens=10,
                                 image_size=size) for px, size in stacks]
                b._hold_admission = False
                got[name, backend] = [
                    np.concatenate(list(b.stream(r))).tolist() for r in reqs]
                if b.admit_stats != {"solo": 2, "grouped": 0}:
                    fail(f"small anyres: the {backend} batcher on the {name} "
                         f"did not admit the tile stacks solo")
            finally:
                b.shutdown()
        b = ContinuousBatcher(p, cfg, max_batch=2, prefill_len=192,
                              max_new_tokens=16, gen_cfg=gen_cfg, chunk=4,
                              backend="paged", page_size=16,
                              prefix_cache=True)
        try:
            got[name, "prefix"] = [np.concatenate(list(b.stream(b.submit(
                long_ids, stacks[0][0], numtoks=16, max_new_tokens=10,
                image_size=stacks[0][1])))).tolist() for _ in range(2)]
            if b.stats["prefix_hits"] != 1:
                fail(f"small anyres: the repeated request on the {name} did "
                     f"not hit")
        finally:
            b.shutdown()
    for key in ("anyres", "multi", "paged", "dense", "prefix"):
        print(f"[small anyres] {key:6s} card {got['card', key]}\n"
              f"[small anyres] {key:6s} cpu  {got['cpu', key]}")
        if got["card", key] != got["cpu", key]:
            fail(f"small anyres: {key}: card tokens differ from CPU tokens")
    if got["card", "paged"][0] != got["card", "anyres"][0] \
            or got["card", "dense"][0] != got["card", "anyres"][0]:
        fail("small anyres: the batchers' tokens differ from generate's")
    prefix = got["card", "prefix"]
    if prefix[0] != prefix[1]:
        fail("small anyres: the prefix-cache hit differs from its miss")


def phase_anyres(dev) -> dict:
    """LLaVA-NeXT's anyres path and multi-image prompts at the full width of
    llava-next-vicuna-7b-m3 (random bf16 weights made on the card, the
    newline included): generate, the paged batcher, then load_4bit, then
    the small model on card and CPU.  Returns the launch counts of the
    counted runs."""
    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.builder import LlavaModel
    from matryoshka_mm_torch.models.convert import init_params

    label = "anyres"
    cfg = LlavaConfig.llava_v15_7b_m3(
        image_aspect_ratio="anyres", mm_patch_merge_type="spatial_unpad",
        image_grid_pinpoints=NEXT_PINPOINTS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, device=str(dev), seed=0)
    torch.cuda.synchronize()
    if params["image_newline"].shape != (cfg.llama.hidden_size,):
        fail(f"{label}: init_params made no image_newline")
    model = LlavaModel(params, cfg)
    print(f"[{label}] llava-next-vicuna-7b-m3 widths made on the card in "
          f"{time.perf_counter() - t0:.1f} s; pinpoints {NEXT_PINPOINTS}")
    stacks = anyres_stacks(model, np.random.default_rng(12))
    print(f"[{label}] tile stacks " + ", ".join(
        f"{w}x{h}: {tuple(px.shape)}" for px, (w, h) in stacks))
    launches = anyres_requests(model, cfg, stacks, label)
    for k, n in anyres_serving(model, cfg, stacks,
                               f"{label} serve").items():
        launches[k] = launches.get(k, 0) + n
    for k, n in anyres_4bit(model, cfg, stacks, f"{label} int4").items():
        launches[k] = launches.get(k, 0) + n
    del model, params
    torch.cuda.empty_cache()
    anyres_small(dev)
    return launches


# ---------------------------------------------------------------------------
# phase 14: generate's other modes at full width
# ---------------------------------------------------------------------------

V2_BETAS = "ver=v2_numtoks=[36,576]_betas=[0.5,1]_gamma=0.1"
V2_ENTROPY = "ver=v2_numtoks=[1,9,36,144,576]_pickby=entropy"
# the counted v2 requests: (label, load, spec, batch)
V2_RUNS = (("v2 bf16", "bf16", V2_BETAS, 1), ("v2 bf16", "bf16", V2_ENTROPY, 1),
           ("v2 bf16", "bf16", V2_BETAS, 4), ("v2 int4", "int4", V2_ENTROPY, 4))
BEAMS = 3
BEAM_TOL = 0.5       # nats: the two sequences rescored by one bf16 forward
SPEC_K = 8
SPEC_PROFILE_TOKENS = 4  # the profiled speculative request: 3 verify steps
CHUNKED = (3072, 512)    # chunked_prefill's prompt tokens and chunk
GENMODES_SMALL_V2 = "ver=v2_numtoks=[1,4,16]_betas=[0.5,0.3,0.2]_gamma=0.1"


def _v2_scales(spec) -> list:
    from matryoshka_mm_torch.kvconfig import parse_kv_from_string, parse_list

    return [int(x) for x in parse_list(parse_kv_from_string(spec)["numtoks"])]


def _zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def _read(counters) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


def _held(label, launches, want) -> None:
    print(f"[{label}] launches {launches} expected {want}")
    if launches != want:
        fail(f"{label}: the path did not go through the kernels as expected")


def v2_requests(models, inputs, counters) -> dict:
    """The counted v2 requests of V2_RUNS, 32 greedy tokens each, the
    counters set to 0 just before each and read just after: K flash
    launches a layer, one decode launch a layer and step, and under int4
    the quantized products of K prefills and of 31 steps over K * B rows;
    one capture and 30 replays each.  Returns the launches summed."""
    total = dict.fromkeys(counters, 0)
    for label, load, spec, batch in V2_RUNS:
        model = models[load]
        L = model.cfg.llama.num_hidden_layers
        K, steps = len(_v2_scales(spec)), NEW_TOKENS - 1
        _zero(counters)
        tally = graph_tally()
        out = run(model, inputs[batch], None, NEW_TOKENS, spec=spec)
        launches = _read(counters)
        want = dict.fromkeys(counters, 0)
        want.update(flash_attention=K * L, decode_attention=steps * L)
        if load == "int4":
            want.update(int4_matmul=K * (4 * L + 1) + steps * (2 * L + 1),
                        quant_mlp=steps * L)
        _held(f"{label} {spec} B={batch} (K*B={K * batch})", launches, want)
        check_graphs(label, tally, 1, NEW_TOKENS - 2)
        print(f"[{label}] {spec} B={batch}: row 0 tokens "
              f"{out[0, :10].tolist()}")
        for k in total:
            total[k] += launches[k]
    return total


def v2_checks(model, inputs, label) -> None:
    """A one-scale spec gives the v0 tokens bit for bit; the captured v2
    step against the eager loop; TTFT and tok/s at K = 2 and 5 beside v0
    at 576 (B=1, medians of 2 and 1 runs)."""
    one = run(model, inputs[1], None, NEW_TOKENS,
              spec="ver=v2_numtoks=[144]_betas=[1]")
    v0 = run(model, inputs[1], 144, NEW_TOKENS)
    same = bool(np.array_equal(one, v0))
    print(f"[{label}] ver=v2_numtoks=[144]_betas=[1] vs ver=v0_numtoks=144: "
          f"tokens bit-identical {same}")
    if not same:
        fail(f"{label}: a single beta of 1 does not give the v0 tokens")
    decode_bits(model, inputs[1], None, label, spec=V2_ENTROPY)
    specs = ("ver=v0_numtoks=576", V2_BETAS, V2_ENTROPY)
    ttft = {spec: statistics.median(_wall(lambda: run(
        model, inputs[1], None, 1, spec=spec)) for _ in range(2))
        for spec in specs}
    rates = {spec: [] for spec in specs}
    for spec in specs + specs[::-1]:           # in turns: A B C C B A
        full = _wall(lambda: run(model, inputs[1], None, NEW_TOKENS,
                                 spec=spec))
        rates[spec].append((NEW_TOKENS - 1) / (full - ttft[spec]))
    for spec in specs:
        print(f"[{label}] {card_line()}: B=1 {spec} TTFT "
              f"{ttft[spec] * 1e3:.2f} ms  decode "
              f"{', '.join(f'{r:.2f}' for r in rates[spec])} tok/s (turns "
              f"v0 K=2 K=5 K=5 K=2 v0)")


def stream_check(model, inputs, label) -> None:
    """stream_generate at 144 in chunks of 8: one yield after the first
    token and one a chunk, the last equal to generate's tokens; the time to
    the first yield beside the whole stream's."""
    from matryoshka_mm_torch.generate import GenerationConfig, stream_generate

    ids, px, _ = inputs[1]
    chunk = 8
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, decode_chunk=chunk,
                           eos_token_id=-1)
    spec = f"ver=v0_numtoks={BATCH_SCALE}"
    want = model.generate(ids, images=px, matryoshka_vis_token_scale=spec,
                          max_new_tokens=NEW_TOKENS, decode_chunk=chunk,
                          eos_token_id=-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first_s, yields = None, []
    for out in stream_generate(model.params, model.cfg, ids, px,
                               matryoshka_vis_token_scale=spec, gen_cfg=gen):
        first_s = first_s or time.perf_counter() - t0
        yields.append(out)
    total_s = time.perf_counter() - t0
    n_want = 1 + -(-(NEW_TOKENS - 1) // chunk)
    same = bool(np.array_equal(yields[-1], want))
    print(f"[{label}] {card_line()}: stream_generate B=1 {spec}: "
          f"{len(yields)} yields (expected {n_want}), widths "
          f"{[y.shape[1] for y in yields]}, last equal to generate's "
          f"{same}; first yield after {first_s * 1e3:.2f} ms, the last "
          f"after {total_s * 1e3:.2f} ms")
    if len(yields) != n_want or not same:
        fail(f"{label}: stream_generate's yields are not generate's")


def sequence_logprob(model, inputs, numtoks, tokens) -> float:
    """Sum of log p(token i | prompt, tokens before i) for row 0: one
    prefill, then every token but the last as one block at the cache's
    write slot (the flash kernel at q_index_offset = the slot)."""
    from matryoshka_mm_torch.generate import _round_up, prefill_image
    from matryoshka_mm_torch.models.llama import (embed_tokens, llama_forward,
                                                  lm_head)

    ids, px, _ = inputs
    dev = model.params["llama"]["norm"].device
    p, lc = model.params["llama"], model.cfg.llama
    L = _round_up(ids.shape[1] - 1 + numtoks, 64)
    toks = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)[None]
    with torch.inference_mode():
        logits0, cache, lengths = prefill_image(
            model.params, model.cfg,
            torch.as_tensor(ids, dtype=torch.int64, device=dev),
            torch.as_tensor(px, device=dev), None, numtoks, L,
            L + toks.shape[1])
        n = toks.shape[1] - 1
        hidden, _ = llama_forward(
            p, lc, embed_tokens(p, toks[:, :n]),
            position_ids=lengths[:, None] + torch.arange(n, device=dev),
            cache=cache, q_index_offset=L)
        logits = torch.cat([logits0[:, None], lm_head(p, hidden)], dim=1)
        lp = torch.log_softmax(logits.float(), dim=-1)[0]
        return float(lp.gather(-1, toks[0, :, None]).sum())


def beam_check(model, inputs, label, counters) -> dict:
    """beam_generate with BEAMS beams at 144, 32 tokens, B=1: width 1 gives
    greedy generate's tokens; the chosen hypothesis scores at least as well
    as greedy (both rescored by one forward, BEAM_TOL); the launches of the
    counted run (L flash, 31 L decode at BEAMS rows); tok/s; the cache
    reorder's device ms at this request's cache and at 672 slots.  Returns
    the launches."""
    from matryoshka_mm_torch.generate import _reorder_cache
    from matryoshka_mm_torch.models.llama import init_kv_cache

    lc = model.cfg.llama
    L, n = lc.num_hidden_layers, BATCH_SCALE
    greedy = run(model, inputs[1], n, NEW_TOKENS)
    width1 = run(model, inputs[1], n, NEW_TOKENS, num_beams=1)
    if not np.array_equal(width1, greedy):
        fail(f"{label}: one beam differs from greedy generate")
    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beam = run(model, inputs[1], n, NEW_TOKENS, num_beams=BEAMS)
    full = time.perf_counter() - t0
    launches = _read(counters)
    _held(f"{label} {BEAMS} beams", launches,
          dict(dict.fromkeys(counters, 0), flash_attention=L,
               decode_attention=(NEW_TOKENS - 1) * L))
    lp_beam = sequence_logprob(model, inputs[1], n, beam[0])
    lp_greedy = sequence_logprob(model, inputs[1], n, greedy[0])
    print(f"[{label}] {BEAMS} beams at {n}: tokens {beam[0, :10].tolist()}, "
          f"summed log-prob {lp_beam:.3f} against greedy {lp_greedy:.3f} "
          f"(one beam = greedy: True)")
    if lp_beam < lp_greedy - BEAM_TOL:
        fail(f"{label}: the beam hypothesis scores below greedy")
    ttft = statistics.median(_wall(lambda: run(
        model, inputs[1], n, 1, num_beams=BEAMS)) for _ in range(2))
    dev = model.params["llama"]["norm"].device
    parent = torch.tensor([2, 0, 0], device=dev)
    for slots in (-(-(PROMPT_LEN - 1 + n) // 64) * 64 + NEW_TOKENS, 672):
        c = init_kv_cache(lc, BEAMS, slots, device=dev)
        moved = 2 * nbytes(c.k, c.v, c.valid, c.positions)
        ms = time_ms(lambda k, v, valid, pos: _reorder_cache(
            type(c)(k, v, valid, pos, c.write_idx, host_idx=0), parent),
            [(c.k, c.v, c.valid, c.positions)], reps=10)
        print(f"[{label}] {card_line()}: cache reorder over {BEAMS} beams "
              f"x {slots} slots: {ms:.4f} ms a step, {moved / 2**30:.3f} "
              f"GiB read and written ({moved / ms / 1e6:.1f} GB/s; byte "
              f"bound {moved / HBM_BYTES_S * 1e3:.4f} ms)")
        del c
    print(f"[{label}] {card_line()}: {BEAMS} beams at {n}: TTFT "
          f"{ttft * 1e3:.2f} ms, decode {(NEW_TOKENS - 1) / (full - ttft):.2f}"
          f" tok/s (a row's tokens; {BEAMS} rows a step, eager)")
    return launches


def spec_prompt(cfg):
    """A one-image prompt whose text repeats (a 12-token phrase 3 times)."""
    rng = np.random.default_rng(14)
    phrase = rng.integers(100, cfg.llama.vocab_size, (12,))
    ids = np.concatenate([[1, 5, -200], np.tile(phrase, 3)]).astype(np.int32)
    s = cfg.vision.image_size
    return ids[None], rng.standard_normal((1, 3, s, s)).astype(np.float32), \
        None


def spec_check(model, inputs, label, counters, quant) -> dict:
    """speculative_generate with k = SPEC_K at 144 on a repeating prompt:
    exact launches (the prefill's; each verify step's quantized products at
    k + 1 rows, qkv, o and lm_head through the prefill kernel, one
    quant_mlp a layer); under int4 the profile's count of the prefill
    kernel; the acceptance rate, tok/s beside generate's and the first
    index where the tokens differ.  Returns the launches."""
    from matryoshka_mm_torch import generate as gm

    L, n = model.cfg.llama.num_hidden_layers, BATCH_SCALE
    calls = {"n": 0}
    verify = gm._verify

    def counted(*a, **kw):
        calls["n"] += 1
        return verify(*a, **kw)

    gm._verify = counted
    try:
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(model, inputs, n, NEW_TOKENS, speculative=True)
        full = time.perf_counter() - t0
        launches, steps = _read(counters), calls["n"]
        want = dict.fromkeys(counters, 0)
        want["flash_attention"] = L
        if quant:
            want.update(int4_matmul=4 * L + 1 + steps * (2 * L + 1),
                        quant_mlp=steps * L)
        _held(f"{label} speculative k={SPEC_K} ({steps} verify steps)",
              launches, want)
        if quant:       # a short request: its profile processes quickly
            calls["n"] = 0
            kernels, _ = profile_events(lambda: run(
                model, inputs, n, SPEC_PROFILE_TOKENS, speculative=True))
            wgmma = sum(e.count for e in kernels
                        if "quant_wgmma_kernel" in e.key)
            expect = 4 * L + calls["n"] * (2 * L + 1)
            print(f"[{label}] profile of a speculative request: "
                  f"quant_wgmma_kernel x{wgmma}, expected {expect} (the "
                  f"prefill's 4 L and {2 * L + 1} a verify step of "
                  f"{SPEC_K + 1} rows)")
            if wgmma != expect:
                fail(f"{label}: the verify products did not take the "
                     f"prefill kernel")
        ttft = statistics.median(_wall(lambda: run(
            model, inputs, n, 1, speculative=True)) for _ in range(2))
    finally:
        gm._verify = verify
    plain = run(model, inputs, n, NEW_TOKENS)
    g_ttft = statistics.median(_wall(lambda: run(model, inputs, n, 1))
                               for _ in range(2))
    g_full = _wall(lambda: run(model, inputs, n, NEW_TOKENS))
    differ = np.flatnonzero(out[0] != plain[0])
    accepted = NEW_TOKENS - 1 - steps
    print(f"[{label}] {card_line()}: speculative k={SPEC_K} at {n}: "
          f"{steps} verify steps for {NEW_TOKENS - 1} tokens, acceptance "
          f"{accepted / (SPEC_K * steps):.3f} ({accepted} of "
          f"{SPEC_K * steps} drafts); decode "
          f"{(NEW_TOKENS - 1) / (full - ttft):.2f} tok/s against generate's "
          f"{(NEW_TOKENS - 1) / (g_full - g_ttft):.2f}; first index where "
          f"the tokens differ: "
          f"{int(differ[0]) if differ.size else 'none'}")
    return launches


def chunked_check(model, label, counters) -> dict:
    """chunked_prefill of a CHUNKED[0]-token text prompt in chunks of
    CHUNKED[1] against the one-shot prefill: logits cosine >= LOGIT_COS and
    the same argmax, flash launches 32 a chunk; the ms (CUDA events around
    each) and the device memory each adds at its peak, and the kernels' device ms under the
    profiler.  Returns the launches."""
    from matryoshka_mm_torch.generate import chunked_prefill, prefill_text
    from matryoshka_mm_torch.models.llama import embed_tokens

    S, chunk = CHUNKED
    L = model.cfg.llama.num_hidden_layers
    dev = model.params["llama"]["norm"].device
    rng = np.random.default_rng(15)
    ids = torch.as_tensor(rng.integers(100, model.cfg.llama.vocab_size,
                                       (1, S)), device=dev)
    valid = torch.ones((1, S), dtype=torch.bool, device=dev)
    pos = torch.arange(S, device=dev)[None]
    cap = S + 64

    def one_shot():
        return prefill_text(model.params, model.cfg, ids, valid, cap)[0]

    def chunked():
        with torch.inference_mode():
            embeds = embed_tokens(model.params["llama"], ids)
            return chunked_prefill(model.params, model.cfg, embeds, pos,
                                   valid, cap, chunk)[0]

    _zero(counters)
    got = chunked()
    launches = _read(counters)
    _held(f"{label} chunked prefill", launches,
          dict(dict.fromkeys(counters, 0), flash_attention=S // chunk * L))
    compare_logits(got[0].float(), one_shot()[0].float(),
                   f"{label} chunked vs one-shot", need_same_top=True)
    for name, fn in (("one-shot", one_shot), ("chunked", chunked)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        kernels = profile_kernels(fn)
        print(f"[{label}] {card_line()}: {name} prefill of {S} tokens"
              f"{f' in chunks of {chunk}' if name == 'chunked' else ''}: "
              f"{start.elapsed_time(end):.2f} ms between CUDA events around "
              f"it, {sum(dev_us(e) for e in kernels) / 1e3:.2f} ms of "
              f"kernels over {sum(e.count for e in kernels)} launches; peak "
              f"{peak / 2**30:.3f} GiB above the weights")
    return launches


def genmodes_small(dev) -> None:
    """Phase 8's small model (Dh=128, float32), the card (kernels) against
    the CPU (plain versions): the same tokens from v2 generate, the last
    yield of stream_generate, beam_generate, speculative_generate and the
    argmax of chunked_prefill; on the card the v2 decode replays a
    captured step."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.generate import (GenerationConfig,
                                              beam_generate, chunked_prefill,
                                              generate, speculative_generate,
                                              stream_generate)
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.models.llama import embed_tokens

    base = LlavaConfig.tiny_debug()
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, hidden_size=256, num_attention_heads=2,
        num_key_value_heads=2, intermediate_size=512))   # Dh = 128
    params = {"cpu": init_params(cfg, "cpu", seed=3)}
    params["card"] = _to(params["cpu"], dev)
    rng = np.random.default_rng(1)
    ids = rng.integers(100, 500, (1, 12)).astype(np.int32)
    ids[:, 4] = -200
    px = rng.standard_normal((1, 3, 56, 56)).astype(np.float32)
    # the speculative prompt repeats its text after the image
    repeat = np.concatenate([ids[0], ids[0, 5:], ids[0, 5:]])[None]
    text = rng.integers(100, 500, (1, 256))
    gen = GenerationConfig(max_new_tokens=10, decode_chunk=4, eos_token_id=-1)
    v0 = "ver=v0_numtoks=4"
    got = {}
    for name, p in params.items():
        tally = graph_tally()
        got[name, "v2"] = generate(p, cfg, ids, px, gen_cfg=gen,
                                   matryoshka_vis_token_scale=GENMODES_SMALL_V2)
        if name == "card":
            check_graphs("small genmodes v2", tally, 1, 8)
        got[name, "stream"] = list(stream_generate(
            p, cfg, ids, px, matryoshka_vis_token_scale=v0, gen_cfg=gen))[-1]
        got[name, "beam"] = beam_generate(p, cfg, ids, px, num_beams=3,
                                          matryoshka_vis_token_scale=v0,
                                          gen_cfg=gen)
        got[name, "speculative"] = speculative_generate(
            p, cfg, repeat, px, matryoshka_vis_token_scale=v0, gen_cfg=gen,
            k=4)
        t = torch.as_tensor(text, device=p["llama"]["norm"].device)
        with torch.inference_mode():
            logits, _ = chunked_prefill(
                p, cfg, embed_tokens(p["llama"], t),
                torch.arange(256, device=t.device)[None],
                torch.ones_like(t, dtype=torch.bool), 320, 64)
        got[name, "chunked"] = logits.argmax(-1).cpu().numpy()
    for mode in ("v2", "stream", "beam", "speculative", "chunked"):
        card, cpu = got["card", mode], got["cpu", mode]
        print(f"[small genmodes] {mode:11s} card {card.tolist()}\n"
              f"[small genmodes] {mode:11s} cpu  {cpu.tolist()}")
        if not np.array_equal(card, cpu):
            fail(f"small genmodes: {mode}: card tokens differ from CPU tokens")


def phase_genmodes(dev) -> dict:
    """generate's other modes at the full width of llava-v1.5-7b-m3
    (debug://7b, random bf16 weights from a seed, nothing cut): the counted
    v2 requests in bf16 and under load_4bit, v2's gates and timings,
    stream_generate, beam search, speculative decoding in bf16 and int4,
    chunked prefill, then the small model card vs CPU.  Returns the launch
    counts of the counted runs."""
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.ops import fused_mlp, int4_matmul
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse

    counters = {"flash_attention": flash_attention_lse,
                "decode_attention": flash_decode_attention,
                "int4_matmul": int4_matmul.int4_matmul,
                "quant_mlp": fused_mlp.quant_mlp}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    models = {"bf16": load_pretrained_model("debug://7b", device=str(dev))[1],
              "int4": load_pretrained_model("debug://7b", device=str(dev),
                                            load_4bit=True)[1]}
    print(f"[time] genmodes debug://7b in bf16 and load_4bit "
          f"{time.perf_counter() - t0:.1f} s")
    inputs = make_inputs(models["bf16"].cfg)
    launches = dict.fromkeys(counters, 0)
    label = "genmodes bf16"
    prompt = spec_prompt(models["bf16"].cfg)
    for name, fn, args in (
            ("v2 requests", v2_requests, (models, inputs, counters)),
            ("v2 checks", v2_checks, (models["bf16"], inputs, label)),
            ("stream", stream_check, (models["bf16"], inputs, label)),
            ("beam", beam_check, (models["bf16"], inputs, label, counters)),
            ("speculative bf16", spec_check,
             (models["bf16"], prompt, label, counters, False)),
            ("speculative int4", spec_check,
             (models["int4"], prompt, "genmodes int4", counters, True)),
            ("chunked prefill", chunked_check,
             (models["bf16"], label, counters))):
        t0 = time.perf_counter()
        for k, v in (fn(*args) or {}).items():
            launches[k] += v
        print(f"[time] genmodes {name} {time.perf_counter() - t0:.1f} s")
    print(f"[genmodes] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del models
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    genmodes_small(dev)
    print(f"[time] genmodes small model {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the Mistral and MPT decoder families at full width
# ---------------------------------------------------------------------------

# the kernels at the families' shapes (run with phase 3): Mistral-7B's
# attention (32 heads over 8 KV heads, a window of 4,096), a prefill past
# the window and decode rows of one request and of four
FAMILY_WINDOW = 4096
FAMILY_LONG = 4608          # a one-shot text prefill past the window
FAMILY_DECODE = (("b1 672", 1, 672), ("b1 4640", 1, 4640),
                 ("b4 4640", 4, 4640))
# the quantized products' new (N, K): Mistral's fused qkv, gate/up and
# down, MPT's up and down; decode rows 1, 8 and prefill rows 640, 3008
FAMILY_QUANT_SHAPES = {"mistral qkv": (6144, 4096),
                       "mistral gateup": (28672, 4096),
                       "mistral down": (4096, 14336),
                       "mpt up": (16384, 4096), "mpt down": (4096, 16384)}
FAMILY_QUANT_ROWS = (1, 8, 640, 3008)
FAMILY_MLP = (4096, 14336)          # Mistral's quant_mlp (D, I)
# the requests: Mistral bf16 at two scales, int4 at 576; MPT at 144
FAMILY_MISTRAL_SCALES = (36, 576)
FAMILY_MPT_SCALE = 144
# the paged batcher: Mistral 8 rows of ~700 slots (40 + 576 prompt slots,
# 64 new), MPT 4 rows at 144
FAMILY_SERVE = {"mistral": ((576, 64),) * 8, "mpt": ((FAMILY_MPT_SCALE, 32),)
                * 4}
# the small float32 models: Mistral's window and a prompt past it
FAMILY_SMALL_WINDOW = 64


def _window_pairs(S: int, window: int) -> int:
    """(query, key) pairs of a causal S-token prefill under a window."""
    return sum(min(i + 1, window) for i in range(S))


def family_attention_cases(dev) -> float:
    """The flash forward at a Mistral-7B prefill past the window (B=1, 32
    heads over 8, Dh 128, S=4,608, window 4,096) and the decode kernel at
    group 4 with the window past 4,096 slots, against their plain versions,
    timed beside the library; the window must change the rows past it.
    Returns the largest error by kernel."""
    from matryoshka_mm_torch.ops import decode_attention as dec
    from matryoshka_mm_torch.ops import flash_attention as fl

    gen = torch.Generator(device=dev).manual_seed(15)
    H, Hkv, Dh, S, W = 32, 8, 128, FAMILY_LONG, FAMILY_WINDOW
    q = _rand((1, H, S, Dh), gen, dev)
    k = _rand((1, S, Hkv, Dh), gen, dev).transpose(1, 2)
    v = _rand((1, S, Hkv, Dh), gen, dev).transpose(1, 2)
    valid = torch.ones((1, S), dtype=torch.bool, device=dev)
    kw = dict(kv_valid=valid, sliding_window=W)
    out, lse = fl.flash_attention_lse(q, k, v, **kw)
    ref_o, ref_l = fl.flash_attention_plain(q, k, v, **kw)
    whole, _ = fl.flash_attention_lse(q, k, v, kv_valid=valid)
    torch.cuda.synchronize()
    err = (out.float() - ref_o.float()).abs().max().item()
    lerr = (lse - ref_l).abs().max().item()
    bite = (whole[:, :, W:].float() - out[:, :, W:].float()).abs().max()
    print(f"[flash mistral {S}] GQA 4, window {W}: max|out-plain|={err:.3e} "
          f"max|lse-plain|={lerr:.3e}; rows past the window move by "
          f"{bite.item():.3e} without it, rows before it equal "
          f"{bool(torch.equal(whole[:, :, :W], out[:, :, :W]))}")
    if not (torch.allclose(out.float(), ref_o.float(), atol=FLASH_TOL,
                           rtol=FLASH_TOL) and lerr <= LSE_TOL):
        fail("flash at the Mistral prefill disagrees with its plain version")
    if bite.item() <= FLASH_TOL:
        fail("flash at the Mistral prefill: the window changed nothing")
    del ref_o, ref_l, whole
    ops = rotations(q, k, v)
    ms = time_ms(lambda *a: fl.flash_attention_lse(*a, **kw), ops)
    pms = time_ms(lambda *a: fl.flash_attention_plain(*a, **kw), ops, reps=2,
                  warmup=1)
    case_library_ms = library_ms("flash", ops, kv_valid=valid, window=W)
    flops = 4 * H * Dh * _window_pairs(S, W)
    b = bound(nbytes(q, k, v) + nbytes(out, lse), flops)
    print(f"[flash mistral {S}] {card_line()}: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {pms:.4f} ms  bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}  library "
          f"{case_library_ms:.4f} ms "
          f"({flops / case_library_ms / 1e9:.1f} TFLOP/s)")
    del ops, q, k, v, out, lse

    errs = {"flash_attention": err, "decode_attention": 0.0}
    sms = dec._sm_count(dev.index or 0)
    for name, B, S in FAMILY_DECODE:
        q = _rand((B, H, Dh), gen, dev)
        k = _rand((B, S, Hkv, Dh), gen, dev)
        v = _rand((B, S, Hkv, Dh), gen, dev)
        valid = torch.ones((B, S), dtype=torch.bool, device=dev)
        kv_pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
        q_pos = torch.full((B,), S - 1, device=dev, dtype=torch.int32)
        args = (q, k, v, valid, kv_pos, q_pos)
        n_split = dec.decode_splits(B, Hkv, S, sms)
        got = dec.flash_decode_attention(*args, sliding_window=W)
        again = dec.flash_decode_attention(*args, sliding_window=W)
        want = dec.decode_attention_plain(*args, sliding_window=W)
        split = dec.decode_attention_split_plain(*args, sliding_window=W,
                                                 n_split=n_split)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        se = (got.float() - split.float()).abs().max().item()
        print(f"[decode mistral {name}] B={B} S={S} Hkv={Hkv} window {W} "
              f"n_split={n_split} ({B * Hkv * n_split} blocks of {sms} SMs) "
              f"max|out-plain|={e:.3e} max|out-split plain|={se:.3e}")
        if not (torch.allclose(got.float(), want.float(), atol=FLASH_TOL,
                               rtol=FLASH_TOL)
                and torch.allclose(got.float(), split.float(),
                                   atol=FLASH_TOL, rtol=FLASH_TOL)):
            fail(f"decode mistral {name} disagrees with its plain version")
        if not torch.equal(got, again):
            fail(f"decode mistral {name}: two launches gave other bits")
        errs["decode_attention"] = max(errs["decode_attention"], e)
        ops = rotations(*args)
        ms = time_ms(lambda *a: dec.flash_decode_attention(
            *a, sliding_window=W), ops)
        plain = time_ms(lambda *a: dec.decode_attention_plain(
            *a, sliding_window=W), ops, reps=5)
        seen = valid & (q_pos[:, None] - kv_pos < W)
        case_library_ms = library_ms("decode", rotations(q, k, v, seen,
                                                         kv_pos, q_pos))
        slots = int(seen.sum())
        b = bound(2 * slots * Hkv * Dh * 2 + nbytes(q, got, valid),
                  4 * H * Dh * slots)
        print(f"[decode mistral {name}] {card_line()}: kernel {ms:.4f} ms  "
              f"plain {plain:.4f} ms  bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']}  library {case_library_ms:.4f} ms")
        del ops
    return errs


def family_quant_cases(dev) -> dict:
    """int4_matmul / int8_matmul at the families' new (N, K) for the rows
    of FAMILY_QUANT_ROWS and quant_mlp at Mistral's I = 14,336 for M = 1
    and 8, against their plain versions, two launches bit-identical, each
    timed beside dequantize + F.linear (``dequant_linear_ms``).  Returns the
    largest error by kernel."""
    return quant_shape_cases(dev, FAMILY_QUANT_SHAPES, FAMILY_QUANT_ROWS,
                             (FAMILY_MLP,), (1, 8), seed=16)


def quant_shape_cases(dev, shapes: dict, rows, mlps, mlp_rows, seed: int,
                      timed_rows=None) -> dict:
    """int4_matmul / int8_matmul at each ``(N, K)`` of ``shapes`` for every
    M of ``rows`` and quant_mlp at each ``(D, I)`` of ``mlps`` for every M
    of ``mlp_rows``, against their plain versions, two launches
    bit-identical; the rows of ``timed_rows`` (all by default) timed, the
    products beside dequantize + F.linear.  Returns the largest error by
    kernel."""
    from matryoshka_mm_torch.ops import fused_mlp as mlp
    from matryoshka_mm_torch.ops import int4_matmul as mm
    from matryoshka_mm_torch.ops import quant

    linear = torch.nn.functional.linear
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {"int4_matmul": 0.0, "int8_matmul": 0.0, "quant_mlp": 0.0}
    for bits, name in ((4, "int4_matmul"), (8, "int8_matmul")):
        fn, plain = getattr(mm, name), getattr(mm, f"{name}_plain")
        quantize = quant.quantize_array_int4 if bits == 4 \
            else quant.quantize_array
        key = quant.Q4KEY if bits == 4 else quant.QKEY
        for shape, (N, K) in shapes.items():
            leaf = quantize(_rand((N, K), gen, dev).mul_(0.02))
            w, sc = leaf[key], leaf["scale"]
            for M in rows:
                x = _rand((M, K), gen, dev)
                got = fn(x, w, sc)
                err, rel = _rel_err(got, plain(x, w, sc))
                same = torch.equal(got, fn(x, w, sc))
                torch.cuda.synchronize()
                if rel > MM_TOL or not same:
                    fail(f"{name} {shape} M={M}: rel {rel:.2e}, two "
                         f"launches the same {same}")
                errs[name] = max(errs[name], err)
                if timed_rows is not None and M not in timed_rows:
                    print(f"[{name} {shape} {N}x{K} M={M}] "
                          f"max|out-plain|={err:.3e} rel {rel:.2e}, two "
                          f"launches bit-identical")
                    continue
                ops = rotations(x, w, sc)
                ms = time_ms(fn, ops)
                dq = time_ms(lambda x, w, sc: linear(x, quant.dequantize_array(
                    {key: w, "scale": sc})), ops, reps=5)
                if M <= 8:
                    t = (nbytes(x, w, sc) + M * N * 2) / HBM_BYTES_S * 1e3
                    rate = f"{100 * t / ms:.0f}% of the byte bound {t:.4f} ms"
                else:
                    t = 2 * M * N * K / PEAK_FLOPS * 1e3
                    rate = (f"{2 * M * N * K / ms / 1e9:.1f} TFLOP/s, "
                            f"{100 * t / ms:.0f}% of the operations bound "
                            f"{t:.4f} ms")
                print(f"[{name} {shape} {N}x{K} M={M}] {card_line()}: "
                      f"max|out-plain|={err:.3e} rel {rel:.2e}, two launches "
                      f"bit-identical; kernel {ms:.4f} ms ({rate})  "
                      f"dequant_linear_ms {dq:.4f} ({dq / ms:.2f}x the "
                      f"kernel's time)")
                del ops
            del w, sc, leaf
    for D, I in mlps:
        for bits in (4, 8):
            quantize = quant.quantize_array_int4 if bits == 4 \
                else quant.quantize_array
            key = quant.Q4KEY if bits == 4 else quant.QKEY
            gate = quantize(_rand((I, D), gen, dev).mul_(0.02))
            up = quantize(_rand((I, D), gen, dev).mul_(0.02))
            gu = {key: torch.cat([gate[key], up[key]]),
                  "scale": torch.cat([gate["scale"], up["scale"]])}
            down = quantize(_rand((D, I), gen, dev).mul_(0.02))
            del gate, up
            i_orig = gu["scale"].shape[0] // 2   # as models/llama.py reads it
            for M in mlp_rows:
                x = _rand((M, D), gen, dev)
                got = mlp.quant_mlp(x, gu, down, bits, i_orig)
                err, rel = _rel_err(got, mlp.quant_mlp_plain(x, gu, down,
                                                             bits, I))
                same = torch.equal(got, mlp.quant_mlp(x, gu, down, bits,
                                                      i_orig))
                torch.cuda.synchronize()
                if rel > MLP_TOL or not same or i_orig != I:
                    fail(f"quant_mlp int{bits} I={I} M={M}: rel {rel:.2e}, "
                         f"two launches the same {same}")
                errs["quant_mlp"] = max(errs["quant_mlp"], err)
                if timed_rows is not None and M not in timed_rows:
                    print(f"[quant_mlp int{bits} I={I} M={M}] "
                          f"max|out-plain|={err:.3e} rel {rel:.2e}, two "
                          f"launches bit-identical")
                    continue
                ops = rotations(x, gu[key], gu["scale"], down[key],
                                down["scale"])
                ms = time_ms(lambda x, gq, gs, dq_, ds: mlp.quant_mlp(
                    x, {key: gq, "scale": gs}, {key: dq_, "scale": ds}, bits,
                    I), ops)
                t = (nbytes(*ops[0]) + M * D * 2) / HBM_BYTES_S * 1e3
                print(f"[quant_mlp int{bits} I={I} M={M}] {card_line()}: "
                      f"max|out-plain|={err:.3e} rel {rel:.2e}, two launches "
                      f"bit-identical; kernel {ms:.4f} ms "
                      f"({100 * t / ms:.0f}% of the byte bound {t:.4f} ms)")
                del ops
            del gu, down
    return errs


def phase_family_kernels(dev) -> None:
    """The families' kernel shapes alone (``chip_smoke.py famkernels``);
    the whole script runs them inside phase 3."""
    family_attention_cases(dev)
    family_quant_cases(dev)


def _family_model(cfg, dev, label):
    from matryoshka_mm_torch.models.builder import LlavaModel
    from matryoshka_mm_torch.models.convert import init_params

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, device=str(dev), seed=0)
    torch.cuda.synchronize()
    print(f"[{label}] made on the card in {time.perf_counter() - t0:.1f} s: "
          f"decoder {_nbytes(params['llama']) / 2**30:.2f} GiB, "
          f"{cfg.llama}")
    return LlavaModel(params, cfg)


def _counted(counters, want, label, fn):
    """``fn()`` with every counter at 0 first; its launches against
    ``want``."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    got = {k: c.launches for k, c in counters.items()}
    print(f"[{label}] launches {got} expected {want}")
    if got != want:
        fail(f"{label}: the main path did not go through the kernels as "
             f"expected")
    return out, got


def _family_counters():
    from matryoshka_mm_torch.ops import fused_mlp, int4_matmul
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention

    return {"flash_attention": flash_attention_lse,
            "decode_attention": flash_decode_attention,
            "paged_attention": paged_decode_attention,
            "int4_matmul": int4_matmul.int4_matmul,
            "quant_mlp": fused_mlp.quant_mlp}


def _add(total, launches) -> None:
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def family_serve(model, cfg, label) -> dict:
    """The paged ContinuousBatcher of phase 7 on a family's model: the
    gather path (the JAX rule for a window or alibi), no paged-kernel
    launch, every budget met, pages returned; tok/s and ms a step."""
    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    gen_cfg = GenerationConfig(max_new_tokens=128, decode_chunk=8,
                               eos_token_id=-1)
    batcher = ContinuousBatcher(model.params, cfg, gen_cfg=gen_cfg,
                                **SERVE_KW)
    try:
        if batcher.use_kernel:
            fail(f"{label}: the paged batcher chose the paged kernel")
        print(f"[{label}] {card_line()}: ContinuousBatcher {SERVE_KW} "
              f"use_kernel {batcher.use_kernel}, warm-up "
              f"{batcher.warmup(numtoks=BATCH_SCALE):.2f} s")
        arch = cfg.llama.arch
        return serve_traffic(batcher, cfg, FAMILY_SERVE[arch], (), label)
    finally:
        batcher.shutdown()


def _text_step(model, lcfg, cache, token, pos):
    """One decode step of ``token`` at ``pos`` on ``cache`` (in place) under
    the decoder config ``lcfg``: the last logits in float32."""
    from matryoshka_mm_torch.models.llama import (embed_tokens, llama_forward,
                                                  lm_head)

    p = model.params["llama"]
    with torch.inference_mode():
        h, _ = llama_forward(p, lcfg, embed_tokens(p, token[:, None]),
                             position_ids=pos[:, None], cache=cache)
        return lm_head(p, h)[0, 0].float()


def _copy_cache(cache):
    from matryoshka_mm_torch.models.llama import KVCache

    return KVCache(*(None if t is None else t.clone() for t in (
        cache.k, cache.v, cache.valid, cache.positions, cache.write_idx,
        cache.k_scale, cache.v_scale)), host_idx=cache.host_idx)


def mistral_window_check(model, cfg, label, counters) -> dict:
    """A one-shot FAMILY_LONG-token text prefill and a decode step past the
    window: the kernels against attn_impl="reference" (cosine >= LOGIT_COS),
    and against the same weights with sliding_window=0, which must move the
    logits farther than the reference path does; then a counted 32-token
    ``generate`` of that prompt (decode at slots 4,608-4,639)."""
    import dataclasses

    from matryoshka_mm_torch.generate import prefill_text

    dev = model.params["llama"]["norm"].device
    rng = np.random.default_rng(151)
    ids = rng.integers(100, cfg.llama.vocab_size, (1, FAMILY_LONG))
    ids[0, 0] = 1
    ids_t = torch.as_tensor(ids, device=dev)
    mask = torch.ones_like(ids_t, dtype=torch.bool)
    cap = FAMILY_LONG + NEW_TOKENS
    whole = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, sliding_window=0))
    out = {}
    for name, c in (("kernel", cfg), ("reference",
                                      cfg.with_attn_impl("reference")),
                    ("no window", whole)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, _ = prefill_text(model.params, c, ids_t, mask, cap)
        torch.cuda.synchronize()
        out[name] = (logits[0].float(), cache, time.perf_counter() - t0)
    kernel, cache, t_kernel = out["kernel"]
    token = kernel.argmax()[None].to(torch.int32)
    pos = torch.full((1,), FAMILY_LONG, device=dev)
    steps = {name: _text_step(model, c.llama, _copy_cache(cache), token, pos)
             for name, c in (("kernel", cfg),
                             ("reference", cfg.with_attn_impl("reference")),
                             ("no window", whole))}
    for what, got in (("prefill", {k: v[0] for k, v in out.items()}),
                      ("decode", steps)):
        cos = {k: torch.nn.functional.cosine_similarity(
            got["kernel"], got[k], dim=0).item() for k in got}
        diff = {k: (got["kernel"] - got[k]).abs().max().item() for k in got}
        print(f"[{label} {FAMILY_LONG}] {what} logits of the kernels: "
              f"cosine {cos['reference']:.6f} max|diff| "
              f"{diff['reference']:.4f} against attn_impl='reference'; "
              f"cosine {cos['no window']:.6f} max|diff| "
              f"{diff['no window']:.4f} against sliding_window=0")
        if not (cos["reference"] >= LOGIT_COS
                and torch.isfinite(got["kernel"]).all()):
            fail(f"{label}: the {what} past the window disagrees with the "
                 f"reference path")
        if not (diff["no window"] > 2 * diff["reference"]
                and cos["no window"] < cos["reference"]):
            fail(f"{label}: the window does not change the {what}")
    print(f"[{label} {FAMILY_LONG}] {card_line()}: prefill ms kernels "
          f"{t_kernel * 1e3:.1f}, reference {out['reference'][2] * 1e3:.1f}")
    del out, steps, cache
    torch.cuda.empty_cache()
    L = cfg.llama.num_hidden_layers
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention=L, decode_attention=(NEW_TOKENS - 1) * L)
    tally = graph_tally()
    _, launches = _counted(counters, want, f"{label} {FAMILY_LONG}",
                           lambda: run(model, (ids.astype(np.int32), None,
                                               None), 0, NEW_TOKENS,
                                       spec="ver=v0_numtoks=1"))
    check_graphs(f"{label} {FAMILY_LONG}", tally, 1, NEW_TOKENS - 2)
    return launches


def family_mistral(dev) -> dict:
    """Mistral-7B widths: bf16 requests, the window at 4,608 tokens, the
    paged batcher, then load_4bit in place.  Returns the counted
    launches."""
    import dataclasses

    from matryoshka_mm_torch.config import LlamaConfig, LlavaConfig
    from matryoshka_mm_torch.ops.quant import (disable_fused_proj,
                                               quantize_llama_params)

    label = "mistral"
    cfg = dataclasses.replace(LlavaConfig.llava_v15_7b_m3(),
                              llama=LlamaConfig.mistral_7b())
    model = _family_model(cfg, dev, label)
    L = cfg.llama.num_hidden_layers
    counters = _family_counters()
    inputs = make_inputs(cfg)
    total = {}

    # ---- bf16 requests, counted ----
    n = len(FAMILY_MISTRAL_SCALES)
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention=n * L,
                decode_attention=n * (NEW_TOKENS - 1) * L)
    tally = graph_tally()
    outs, launches = _counted(
        counters, want, label,
        lambda: [run(model, inputs[1], s, NEW_TOKENS)
                 for s in FAMILY_MISTRAL_SCALES])
    check_graphs(label, tally, n, n * (NEW_TOKENS - 2))
    _add(total, launches)
    print(f"[{label}] tokens at 576: {outs[-1][0, :12].tolist()}")
    compare_logits(prefill_logits(model, cfg, inputs[1], 576),
                   prefill_logits(model, cfg.with_attn_impl("reference"),
                                  inputs[1], 576), label,
                   need_same_top=False)
    decode_bits(model, inputs[1], 576, label)
    for s in FAMILY_MISTRAL_SCALES:
        time_requests(model, inputs[1], s, label, reps=(2, 1))
    time_requests(model, inputs[4], BATCH_SCALE, label, reps=(2, 1))
    decode_profile(model, inputs[1], 576, label, top=6)
    print(f"[{label}] {card_line()}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    _add(total, mistral_window_check(model, cfg, label, counters))
    _add(total, family_serve(model, cfg, f"{label} serve"))

    # ---- load_4bit, in place ----
    t0 = time.perf_counter()
    quantize_llama_params(model.params, bits=4)
    torch.cuda.synchronize()
    label = "mistral int4"
    print(f"[{label}] quantized on the card in {time.perf_counter() - t0:.1f}"
          f" s: decoder {_nbytes(model.params['llama']) / 2**30:.2f} GiB")
    steps = NEW_TOKENS - 1
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention=L, decode_attention=steps * L,
                int4_matmul=(4 * L + 1) + steps * (2 * L + 1),
                quant_mlp=steps * L)
    tally = graph_tally()
    _, launches = _counted(counters, want, label,
                           lambda: run(model, inputs[1], 576, NEW_TOKENS))
    check_graphs(label, tally, 1, NEW_TOKENS - 2)
    _add(total, launches)
    got = prefill_logits(model, cfg, inputs[1], 576)
    with disable_fused_proj():
        ref = prefill_logits(model, cfg, inputs[1], 576)
    compare_logits(got, ref, label, need_same_top=True)
    decode_bits(model, inputs[1], 576, label)
    time_requests(model, inputs[1], 576, label, reps=(2, 1))
    decode_profile(model, inputs[1], 576, label, prefill=False, top=4)
    del model
    return total


def family_mpt(dev) -> dict:
    """MPT-7B widths: bf16 and int8-KV requests at 144 (alibi: no attention
    kernel), the paged batcher, then load_4bit in place (128 products a
    decode step, no quant_mlp).  Returns the counted launches."""
    import dataclasses

    from matryoshka_mm_torch.config import LlamaConfig, LlavaConfig
    from matryoshka_mm_torch.models.builder import LlavaModel
    from matryoshka_mm_torch.ops.quant import (disable_fused_proj,
                                               quantize_llama_params)

    label = "mpt"
    cfg = dataclasses.replace(LlavaConfig.llava_v15_7b_m3(),
                              llama=LlamaConfig.mpt_7b())
    model = _family_model(cfg, dev, label)
    if "lm_head" in model.params["llama"]:
        fail("mpt: init_params made an lm_head; the head is tied")
    L, s = cfg.llama.num_hidden_layers, FAMILY_MPT_SCALE
    counters = _family_counters()
    inputs = make_inputs(cfg)
    total = {}
    none = dict.fromkeys(counters, 0)

    tally = graph_tally()
    outs, launches = _counted(counters, none, label,
                              lambda: run(model, inputs[1], s, NEW_TOKENS))
    check_graphs(label, tally, 1, NEW_TOKENS - 2)
    _add(total, launches)
    decode_bits(model, inputs[1], s, label)
    time_requests(model, inputs[1], s, label, reps=(2, 1))
    time_requests(model, inputs[4], s, label, reps=(2, 1))
    decode_profile(model, inputs[1], s, label, top=6)
    print(f"[{label}] {card_line()}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kv8 = LlavaModel(model.params, cfg.with_kv_cache_dtype("int8"))
    out8, launches = _counted(counters, none, f"{label} kv8",
                              lambda: run(kv8, inputs[1], s, NEW_TOKENS))
    _add(total, launches)
    same = int((out8[0] == outs[0]).sum())
    print(f"[{label} kv8] tokens int8 KV {out8[0, :16].tolist()}\n"
          f"[{label} kv8] tokens bf16 KV {outs[0][:16].tolist()}  "
          f"({same} of {NEW_TOKENS} equal)")
    del kv8

    _add(total, family_serve(model, cfg, f"{label} serve"))

    t0 = time.perf_counter()
    quantize_llama_params(model.params, bits=4)
    torch.cuda.synchronize()
    label = "mpt int4"
    head = model.params["llama"]["embed_tokens"]
    print(f"[{label}] quantized on the card in {time.perf_counter() - t0:.1f}"
          f" s: decoder {_nbytes(model.params['llama']) / 2**30:.2f} GiB, "
          f"tied head {head.dtype}")
    if head.dtype != torch.bfloat16:
        fail(f"{label}: the tied head was quantized")
    steps = NEW_TOKENS - 1
    want = dict(none, int4_matmul=4 * L + steps * 4 * L)
    tally = graph_tally()
    _, launches = _counted(counters, want, label,
                           lambda: run(model, inputs[1], s, NEW_TOKENS))
    check_graphs(label, tally, 1, NEW_TOKENS - 2)
    _add(total, launches)
    got = prefill_logits(model, cfg, inputs[1], s)
    with disable_fused_proj():
        ref = prefill_logits(model, cfg, inputs[1], s)
    compare_logits(got, ref, label, need_same_top=False)
    decode_bits(model, inputs[1], s, label)
    time_requests(model, inputs[1], s, label, reps=(2, 1))
    time_requests(model, inputs[4], s, label, reps=(2, 1))
    decode_profile(model, inputs[1], s, label, prefill=False, top=4)
    del model
    return total


def families_small(dev) -> None:
    """A small float32 model of each family (Dh = 128; Mistral with GQA 2
    and a window of FAMILY_SMALL_WINDOW under prompts past it), the card
    (kernels, gather path) against the same weights on the CPU (plain
    versions): the same greedy tokens from generate, the dense and the
    paged batcher, and chunked_prefill's argmax."""
    import dataclasses

    from matryoshka_mm_torch.config import LlamaConfig, LlavaConfig
    from matryoshka_mm_torch.generate import (GenerationConfig,
                                              chunked_prefill, generate,
                                              prefill_image)
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.models.llama import embed_tokens
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    rng = np.random.default_rng(4)
    ids = np.concatenate([[[1, 5, -200]], rng.integers(5, 500, (1, 80))],
                         1).astype(np.int32)
    ids2 = np.concatenate([[[1, 9, 11, -200]], rng.integers(5, 500, (1, 70))],
                          1).astype(np.int32)
    px = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    gen_cfg = GenerationConfig(max_new_tokens=10, decode_chunk=4,
                               eos_token_id=-1)
    text = rng.integers(5, 500, (2, 192)).astype(np.int64)
    valid = np.ones((2, 192), bool)
    valid[1, :29] = False
    pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0)
    for arch in ("mistral", "mpt"):
        extra = dict(num_key_value_heads=1,
                     sliding_window=FAMILY_SMALL_WINDOW) \
            if arch == "mistral" else dict(num_key_value_heads=2)
        cfg = dataclasses.replace(LlavaConfig.tiny_debug(), llama=LlamaConfig(
            arch=arch, vocab_size=512, hidden_size=256, intermediate_size=512,
            num_hidden_layers=4, num_attention_heads=2, dtype="float32",
            max_position_embeddings=512, **extra),
            tokenizer_model_max_length=256)
        params = {"cpu": init_params(cfg, "cpu", seed=5)}
        params["card"] = _to(params["cpu"], dev)
        got, prefill = {}, {}
        for where, p in params.items():
            d = torch.device("cpu") if where == "cpu" else dev
            got[where, "generate"] = generate(
                p, cfg, ids, px[:1], matryoshka_vis_token_scale=
                "ver=v0_numtoks=16", gen_cfg=gen_cfg)[0].tolist()
            for backend in ("dense", "paged"):
                kw = dict(page_size=16) if backend == "paged" else {}
                b = ContinuousBatcher(p, cfg, max_batch=2, prefill_len=128,
                                      max_new_tokens=16, gen_cfg=gen_cfg,
                                      chunk=4, backend=backend, **kw)
                try:
                    b._hold_admission = True
                    reqs = [b.submit(i, px[j:j + 1], numtoks=16,
                                     max_new_tokens=10)
                            for j, i in enumerate((ids, ids2))]
                    b._hold_admission = False
                    got[where, backend] = [
                        np.concatenate(list(b.stream(r))).tolist()
                        for r in reqs]
                finally:
                    b.shutdown()
            with torch.inference_mode():
                logits, _ = chunked_prefill(
                    p, cfg, embed_tokens(p["llama"], torch.as_tensor(
                        text, device=d)), torch.as_tensor(pos, device=d),
                    torch.as_tensor(valid, device=d), 208, chunk=64)
                got[where, "chunked"] = logits.argmax(-1).tolist()
                # the logits themselves: a tied random head echoes its input
                # token, so MPT's greedy tokens say little on their own
                prefill[where] = prefill_image(
                    p, cfg, torch.as_tensor(ids, device=d),
                    torch.as_tensor(px[:1], device=d), None, 16, 128,
                    144)[0][0].float().cpu()
        for key in ("generate", "dense", "paged", "chunked"):
            print(f"[small {arch}] {key:8s} card {got['card', key]}\n"
                  f"[small {arch}] {key:8s} cpu  {got['cpu', key]}")
            if got["card", key] != got["cpu", key]:
                fail(f"small {arch}: {key}: card tokens differ from CPU "
                     f"tokens")
        if got["card", "dense"][0] != got["card", "generate"]:
            fail(f"small {arch}: the batcher's tokens differ from generate's")
        diff = (prefill["card"] - prefill["cpu"]).abs().max().item()
        scale = prefill["cpu"].abs().max().item()
        print(f"[small {arch}] prefill logits card vs CPU: max|diff| "
              f"{diff:.3e} of max|logit| {scale:.3e}")
        if not diff <= 1e-3 * scale:
            fail(f"small {arch}: the card's prefill logits differ from the "
                 f"CPU's")


def phase_families(dev) -> dict:
    """The Mistral and MPT families at full width (random bf16 weights made
    on the card by init_params, the llava-v1.5-7b-m3 vision half), one
    model at a time, then the small float32 models card against CPU.
    Returns the launch counts of the counted runs."""
    total = {}
    for name, fn in (("mistral", family_mistral), ("mpt", family_mpt),
                     ("small", families_small)):
        t0 = time.perf_counter()
        _add(total, fn(dev) or {})
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] families {name} {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 16: multi-LoRA serving at full width; the BERT text embedder, S2,
# and their small models card against CPU
# ---------------------------------------------------------------------------

LORA_R, LORA_ALPHA = 128, 256.0     # the 7B LoRA recipe of phase 10
LORA_B_STD = 0.01                   # seeded lora_b: each adapter moves logits
LORA_NAMES = (None, "alpha", "beta")
LORA_SALT_PROMPT = 60               # 59 + 144 = 203 tokens: 3 full pages
BERT_PROMPTS, BERT_TOKENS = 8, 40
S2_SCALES = (336, 672, 1008)        # 1 + 4 + 9 = 14 tiles an image
S2_COS = 0.99


def make_adapters(params, dev, r=LORA_R, alpha=LORA_ALPHA, seed=11) -> dict:
    """``{name: extract_lora tree}`` of ``add_lora`` over ``params`` with
    every ``lora_b`` drawn from a seed, so that each adapter changes the
    model."""
    from matryoshka_mm_torch.ops.lora import add_lora, extract_lora

    out = {}
    for i, name in enumerate(LORA_NAMES[1:]):
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        tree = extract_lora(add_lora(params, gen, r=r, alpha=alpha))
        for layer in tree["llama"]["layers"]:
            for mod in layer.values():
                for leaf in mod.values():
                    leaf["lora_b"].normal_(0.0, LORA_B_STD, generator=gen)
        out[name] = tree
    return out


def lora_first_logits(batcher, adapters, cfg, label) -> None:
    """Each adapter's first-token logits from the batcher's prefill (its
    load_lora tree, the kernels) against generate's prefill on load_lora
    params with attn_impl="reference": cosine >= LOGIT_COS."""
    import types

    from matryoshka_mm_torch.ops.lora import load_lora
    from matryoshka_mm_torch.serve.batching import _Request

    rng = np.random.default_rng(12)
    ids, px = serve_prompt(rng, cfg)
    for name in LORA_NAMES:
        req = _Request(0, ids, px, 144, 8, lora_id=name)
        with torch.inference_mode():
            got = batcher._prefill([req])[0][0].float()
            solo = types.SimpleNamespace(
                params=batcher.params if name is None
                else load_lora(batcher.params, adapters[name]))
            want = prefill_logits(solo, cfg.with_attn_impl("reference"),
                                  (ids, px, None), 144)
        compare_logits(got, want, f"{label} first token {name}",
                       need_same_top=False)


def lora_tokens_check(batcher, cfg, label) -> None:
    """One prompt under each adapter: the adapters change the tokens; a
    repeat of one adapter's prompt hits its own salted chain and no
    other (the prefix cache is on)."""
    rng = np.random.default_rng(13)
    prompt = serve_prompt(rng, cfg, LORA_SALT_PROMPT)
    hits0 = batcher.stats["prefix_hits"]
    outs = {n: _serve(batcher, prompt, 144, 16, lora_id=n).result()
            for n in LORA_NAMES}
    after_three = batcher.stats["prefix_hits"] - hits0
    again = _serve(batcher, prompt, 144, 16, lora_id="alpha").result()
    hits = batcher.stats["prefix_hits"] - hits0
    print(f"[{label}] one prompt under each adapter: {outs}; prefix hits "
          f"after the three {after_three}, after alpha's repeat {hits}; the "
          f"repeat gave {sum(a == b for a, b in zip(again, outs['alpha']))} "
          f"of 16 of alpha's tokens")
    if outs["alpha"] == outs[None] or outs["beta"] == outs[None]:
        fail(f"{label}: an adapter does not change the tokens")
    if after_three != 0 or hits != 1:
        fail(f"{label}: the prefix chains are not salted by the adapter")


def lora_round_checks(batcher, adapters, cfg, label) -> None:
    """Stop the scheduler with 8 rows of the three adapters in mid-decode;
    on that live pool: the replayed round against the eager round (bits),
    the eager round's device ms a step with and without the pack."""
    from matryoshka_mm_torch.serve.paged_cache import paged_pool_decode

    rng = np.random.default_rng(14)
    readers = [_serve(batcher, serve_prompt(rng, cfg), n, 128,
                      lora_id=LORA_NAMES[i % 3])
               for i, (n, _) in enumerate(SERVE_BURST)]
    while min(len(r.tokens) for r in readers) < 24 and batcher.error is None:
        time.sleep(0.005)
    batcher._stop = True
    batcher._thread.join(60)
    if batcher._thread.is_alive() or batcher.error is not None:
        fail(f"{label}: the scheduler did not stop cleanly")
    torch.cuda.synchronize()
    print(f"[{label}] live rows' adapters "
          f"{batcher.lora_idx.tolist()}")
    captured_round_check(batcher, label)
    lens = batcher.lengths[batcher.active].tolist()
    rows = len(lens)

    def eager(pack):
        return lambda: paged_pool_decode(
            batcher.params["llama"], cfg.llama, batcher.gen_cfg,
            batcher.chunk, batcher.paged, batcher.tables, batcher._state(),
            use_kernel=True, generator=batcher._generator,
            lora_pack=pack, lora_idx=batcher.lora_idx)

    with torch.inference_mode():
        base = round_profile(eager(None), batcher, rows, label + " no pack",
                             "eager")
        packed = round_profile(eager(batcher.lora_pack), batcher, rows,
                               label + " pack", "eager")
        replay = round_profile(lambda: batcher._round_graph(batcher._state()),
                               batcher, rows, label + " pack", "replayed")
    ms = [sum(dev_us(e) for e in k) / 1e3 / batcher.chunk
          for k in (base, packed, replay)]
    print(f"[{label}] {card_line()}: live rows {rows} of ~{int(np.mean(lens))} "
          f"tokens; device ms a step: eager without the pack {ms[0]:.3f}, "
          f"with it {ms[1]:.3f} (the delta {ms[1] - ms[0]:.3f} ms a step), "
          f"replayed with it {ms[2]:.3f}; pack "
          f"{batcher.lora_pack.nbytes() / 2**30:.3f} GiB")


def lora_serve(model, adapters, cfg, label) -> dict:
    """The counted 12-request run under the three adapters in turn, then
    the checks; returns its launches."""
    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    gen_cfg = GenerationConfig(max_new_tokens=128, decode_chunk=8,
                               eos_token_id=-1)
    b = ContinuousBatcher(model.params, cfg, gen_cfg=gen_cfg,
                          adapters=adapters, prefix_cache=True, **SERVE_KW)
    print(f"[{label}] {card_line()}: ContinuousBatcher {SERVE_KW} "
          f"prefix_cache adapters {sorted(adapters)} (r={b.lora_pack.rank}, "
          f"pack {b.lora_pack.nbytes() / 2**30:.3f} GiB) warm-up "
          f"{b.warmup(numtoks=144):.2f} s")
    # the adapters in turn, two requests each: the burst forms groups of
    # one adapter and one scale, and lone rows
    names = [LORA_NAMES[i // 2 % 3]
             for i in range(len(SERVE_BURST + SERVE_LATE))]
    launches = serve_traffic(b, cfg, SERVE_BURST, SERVE_LATE, label,
                             lora_ids=names)
    lora_tokens_check(b, cfg, label)
    lora_round_checks(b, adapters, cfg, label)     # stops the scheduler
    lora_first_logits(b, adapters, cfg, label)
    b.shutdown()
    return launches


def lora_small(dev) -> None:
    """A small float32 model (Dh = 128) with two rank-8 adapters, the card
    against the CPU: the batcher's tokens under each adapter equal that
    adapter's solo generate on its load_lora params, on either device, and
    the card's equal the CPU's."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.ops.lora import load_lora
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    base = LlavaConfig.tiny_debug()
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, hidden_size=256, num_attention_heads=2,
        num_key_value_heads=2, intermediate_size=512))
    params = {"cpu": init_params(cfg, "cpu", seed=3)}
    params["card"] = _to(params["cpu"], dev)
    adapters = {"cpu": make_adapters(params["cpu"], "cpu", r=8, alpha=16.0)}
    adapters["card"] = _to(adapters["cpu"], dev)
    rng = np.random.default_rng(15)
    ids = rng.integers(100, 500, (1, 12)).astype(np.int32)
    ids[0, 4] = -200
    px = rng.standard_normal((1, 3, 56, 56)).astype(np.float32)
    gen_cfg = GenerationConfig(max_new_tokens=10, decode_chunk=4,
                               eos_token_id=-1)
    served, solo = {}, {}
    for where in ("card", "cpu"):
        b = ContinuousBatcher(params[where], cfg, max_batch=3,
                              prefill_len=64, max_new_tokens=16,
                              gen_cfg=gen_cfg, chunk=4, backend="paged",
                              page_size=16, adapters=adapters[where])
        tally = graph_tally()
        try:
            b._hold_admission = True
            reqs = [b.submit(ids, px, numtoks=4, max_new_tokens=10,
                             lora_id=n) for n in LORA_NAMES]
            b._hold_admission = False
            served[where] = [np.concatenate(list(b.stream(r))).tolist()
                             for r in reqs]
        finally:
            b.shutdown()
        replays = graph_tally()[1] - tally[1]
        if (where == "card") != (replays > 0):
            fail(f"small lora: the {where} batcher replayed {replays} rounds")
        solo[where] = [generate(
            params[where] if n is None else
            load_lora(params[where], adapters[where][n]), cfg, ids, px,
            matryoshka_vis_token_scale="ver=v0_numtoks=4",
            gen_cfg=gen_cfg)[0].tolist() for n in LORA_NAMES]
        print(f"[small lora] {where} batcher {served[where]}\n"
              f"[small lora] {where} generate {solo[where]}")
    if not (served["card"] == solo["card"] == served["cpu"] == solo["cpu"]):
        fail("small lora: the batcher's tokens differ from generate's or "
             "the card's from the CPU's")
    if served["cpu"][1] == served["cpu"][0]:
        fail("small lora: the adapter does not change the tokens")


def bert_check(dev) -> None:
    """bert_forward at bge-small-en-v1.5 widths (random weights) for 8
    prompts of ~40 tokens, timed; then the small textcls train, the card
    against the CPU (losses and grad norms within SMALL_TRAIN_TOL)."""
    import copy
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.builder import DebugTokenizer
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.models.text_embedder import (BertConfig,
                                                          TextEmbedder,
                                                          bert_forward,
                                                          init_bert_params)
    from matryoshka_mm_torch.train.optimizer import OptimizerConfig

    class Prompts(DebugTokenizer):
        """Renders each row as a conversation the prompt regex finds."""

        def batch_decode(self, batch, skip_special_tokens=True):
            return [f"USER: describe picture {int(r[-1])} ASSISTANT:"
                    for r in batch]

    bcfg = BertConfig.bge_small()
    bp = init_bert_params(torch.Generator(device=dev).manual_seed(0), bcfg,
                          device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(150, bcfg.vocab_size, (BERT_PROMPTS, BERT_TOKENS + 2),
                        generator=g, device=dev)
    mask = torch.ones_like(ids)
    mask[1::2, -6:] = 0                          # ragged prompts
    with torch.no_grad():
        out = bert_forward(bp, bcfg, ids, mask)
        ms = time_ms(lambda i, m: bert_forward(bp, bcfg, i, m), [(ids, mask)])
    print(f"[bert] {card_line()}: bert_forward at bge-small widths "
          f"(12 layers, 384 wide), {BERT_PROMPTS} prompts x "
          f"{BERT_TOKENS + 2} tokens, float32: {ms:.3f} ms; finite "
          f"{bool(torch.isfinite(out).all())}")
    if not torch.isfinite(out).all():
        fail("bert_forward gave non-finite states")

    base = LlavaConfig.tiny_debug(moe="t=dense_ft=textcls_obj=weightedlm")
    cfg = dataclasses.replace(base, text_embed_dim=32,
                              llama=dataclasses.replace(
        base.llama, hidden_size=256, num_attention_heads=2,
        num_key_value_heads=2, intermediate_size=512, remat=True))
    params = init_params(cfg, "cpu", seed=4)
    tiny = BertConfig.tiny_debug()
    bert_cpu = init_bert_params(torch.Generator().manual_seed(0), tiny,
                                device="cpu")
    opt_cfg = OptimizerConfig(learning_rate=1e-3, total_steps=10)
    seen = {}
    for where, d, p, b in (("cpu", "cpu", params, bert_cpu),
                           ("card", dev, _to(copy.deepcopy(params), dev),
                            _to(bert_cpu, dev))):
        emb = TextEmbedder(Prompts(cfg.llama.vocab_size), params=b, cfg=tiny)
        seen[where] = _small_train_run(p, cfg, opt_cfg, d,
                                       text_embedder=emb)[1]
    rel = max(abs(a - b) / abs(b) for a, b in zip(seen["card"], seen["cpu"]))
    print(f"[small train textcls] card {[round(x, 6) for x in seen['card']]}"
          f"\n[small train textcls] cpu  {[round(x, 6) for x in seen['cpu']]}"
          f"\n[small train textcls] within {rel:.2e} (tolerance "
          f"{SMALL_TRAIN_TOL})")
    if not rel <= SMALL_TRAIN_TOL:
        fail("small textcls train: the card leaves the CPU")


def s2_check(params, cfg, dev) -> None:
    """s2_multiscale_forward at ViT-L/14-336 over (336, 672, 1008): bf16
    against float32 on the card (cosine >= S2_COS); the 336-only case
    against clip_vision_forward bit for bit; ms of the bf16 pyramid."""
    from matryoshka_mm_torch.models.clip import (clip_vision_forward,
                                                 s2_multiscale_forward)

    import dataclasses

    vcfg = cfg.vision
    tower = params["vision_tower"]
    tower32 = _to_f32(tower)
    g = torch.Generator(device=dev).manual_seed(16)
    px = torch.randn((1, 3, max(S2_SCALES), max(S2_SCALES)), generator=g,
                     device=dev)
    with torch.no_grad():
        got = s2_multiscale_forward(tower, px, vcfg, scales=S2_SCALES)
        want = s2_multiscale_forward(tower32, px, dataclasses.replace(
            vcfg, dtype="float32"), scales=S2_SCALES)
        cos = torch.nn.functional.cosine_similarity(
            got.float().flatten(), want.flatten(), dim=0).item()
        small = px[..., :vcfg.image_size, :vcfg.image_size]
        one = s2_multiscale_forward(tower, small, vcfg,
                                    scales=(vcfg.image_size,))
        same = bool(torch.equal(one, clip_vision_forward(
            tower, small, vcfg)["patch"]))
        ms = time_ms(lambda x: s2_multiscale_forward(tower, x, vcfg,
                                                     scales=S2_SCALES),
                     [(px,)], reps=5, warmup=1)
    print(f"[s2] {card_line()}: s2_multiscale_forward {S2_SCALES} "
          f"(14 tiles) -> {tuple(got.shape)} {got.dtype}: bf16 against "
          f"float32 cosine {cos:.6f}; {vcfg.image_size} alone equals "
          f"clip_vision_forward bit for bit {same}; {ms:.2f} ms in bf16")
    if got.shape != (1, vcfg.num_patches, vcfg.hidden_size * len(S2_SCALES)) \
            or cos < S2_COS or not same:
        fail("s2_multiscale_forward: wrong shape, bf16 far from float32, or "
             "the one-scale case differs from the tower")


def phase_lora(dev) -> dict:
    """Returns the launches of the counted runs, by kernel."""
    from matryoshka_mm_torch.generate import GenerationConfig
    from matryoshka_mm_torch.models.builder import load_pretrained_model
    from matryoshka_mm_torch.ops.quant import quantize_llama_params
    from matryoshka_mm_torch.serve.batching import ContinuousBatcher

    t0 = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[time] lora {what} {now - t0[0]:.1f} s")
        t0[0] = now

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, model, _, _ = load_7b(dev)
    cfg = model.cfg
    adapters = make_adapters(model.params, dev)
    lap("debug://7b and two adapters")
    s2_check(model.params, cfg, dev)
    lap("s2")
    launches = {}
    for k, n in lora_serve(model, adapters, cfg, "lora bf16").items():
        launches[k] = launches.get(k, 0) + n
    lap("bf16 serving")
    # the same traffic with no adapter, for the comparison
    plain = ContinuousBatcher(model.params, cfg, gen_cfg=GenerationConfig(
        max_new_tokens=128, decode_chunk=8, eos_token_id=-1),
        prefix_cache=True, **SERVE_KW)
    try:
        plain.warmup(numtoks=144)
        serve_traffic(plain, cfg, SERVE_BURST, SERVE_LATE,
                      "lora bf16 no adapters")
    finally:
        plain.shutdown()
    del plain
    torch.cuda.empty_cache()
    lap("bf16 serving with no adapter")
    # the int4 base, unfused so that every projection takes its delta
    quantize_llama_params(model.params, 4, fuse=False)
    torch.cuda.empty_cache()
    for k, n in lora_serve(model, adapters, cfg, "lora int4").items():
        launches[k] = launches.get(k, 0) + n
    print(f"[lora] {card_line()}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, adapters
    torch.cuda.empty_cache()
    lap("int4 serving")
    lora_small(dev)
    lap("small model")
    bert_check(dev)
    lap("bert")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the serving front end at full width
# ---------------------------------------------------------------------------

FRONT_MODEL = "llava-v1.5-7b-m3"
FRONT_SAMPLED = 2               # sampled requests beside the batched ones
FRONT_SAMPLED_KW = {"temperature": 0.7, "top_p": 0.9, "max_new_tokens": 32}
# the debug tokenizer writes these words often: a stop list that cuts
FRONT_STOP = ["yes", "no"]
FRONT_SCHEMA = {"type": "object", "properties": {"B": {"type": "boolean"}}}
FRONT_REDECODE_TOKENS = 64
FRONT_CHUNK = 8                 # the worker's decode chunk, and its batcher's
FRONT_TIMEOUT_S = 300


def frontend_modules():
    """The port's front-end modules.  Each calls ``build_logger`` when it
    is imported, which sends ``sys.stdout`` and ``sys.stderr`` into the
    logger: the script keeps its own, and its last lines go to the real
    stdout."""
    import types

    saved = sys.stdout, sys.stderr
    try:
        from matryoshka_mm_torch.serve import (cli, controller, model_worker,
                                               sglang_worker)
    finally:
        sys.stdout, sys.stderr = saved
    return types.SimpleNamespace(cli=cli, controller=controller,
                                 model_worker=model_worker,
                                 sglang_worker=sglang_worker)


def front_prompt(rng, words=PROMPT_LEN) -> str:
    """A one-image vicuna-v1 prompt of ``words`` seeded words."""
    from matryoshka_mm_torch.conversation import conv_templates

    conv = conv_templates["llava_v1"].copy()
    text = " ".join(f"w{int(i)}" for i in rng.integers(0, 10**6, words))
    conv.append_message(conv.roles[0], "<image>\n" + text)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def front_image(rng, size=(400, 300)) -> str:
    """A PNG of seeded pixels, base64, as a client sends it."""
    import base64
    import io

    from PIL import Image

    w, h = size
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _chunks(raw) -> list:
    """Decoded JSON chunks of a ``\\0``-delimited byte stream."""
    return [json.loads(c) for c in raw.split(b"\0") if c.strip()]


class HttpFront:
    """The controller and the worker (its SGLang app: the worker protocol
    plus ``/generate``) served by aiohttp on localhost, both in one event
    loop on a thread of this process; ``requests`` is the client."""

    mode = "HTTP"

    def __init__(self, mods, make_worker):
        import asyncio
        import socket

        import requests

        self.requests = requests
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.runners = []
        self.controller = mods.controller.Controller("shortest_queue")
        self.ctrl_url = self._serve(mods.controller.build_app(self.controller))
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        self.worker_url = f"http://127.0.0.1:{sock.getsockname()[1]}"
        self.worker = make_worker(self.ctrl_url, self.worker_url)
        self._serve(mods.sglang_worker.build_sglang_app(self.worker), sock)

    def _run(self, coro):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def _serve(self, app, sock=None) -> str:
        from aiohttp import web

        async def start():
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.SockSite(runner, sock) if sock is not None \
                else web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            return runner

        runner = self._run(start())
        self.runners.append(runner)
        host, port = runner.addresses[0][:2]
        return f"http://{host}:{port}"

    def stream(self, params):
        r = self.requests.post(self.ctrl_url + "/worker_generate_stream",
                               json=params, stream=True,
                               timeout=FRONT_TIMEOUT_S)
        for chunk in r.iter_lines(decode_unicode=False, delimiter=b"\0"):
            if chunk:
                yield json.loads(chunk)

    def sglang(self, body) -> tuple:
        r = self.requests.post(self.worker_url + "/generate", json=body,
                               timeout=FRONT_TIMEOUT_S)
        return r.status_code, r.json()

    def status(self) -> dict:
        return self.requests.post(self.worker_url + "/worker_get_status",
                                  timeout=60).json()

    def close(self):
        for runner in reversed(self.runners):
            self._run(runner.cleanup())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        if self.thread.is_alive():
            fail("frontend: the server loop did not stop")
        self.loop.close()


class _InProcessResponse:
    def __init__(self, payload=None, chunks=()):
        self.status_code, self.payload, self.chunks = 200, payload, chunks

    def json(self):
        return self.payload

    def iter_lines(self, decode_unicode=False, delimiter=b"\0"):
        for chunk in self.chunks:
            yield from (c for c in chunk.split(delimiter) if c)


class InProcessFront:
    """Where aiohttp or requests is missing: the same controller and worker
    objects, the controller's ``worker_api_generate_stream`` driven
    directly, and its POSTs to the worker (and the worker's to the
    controller) routed to the objects by a stand-in for ``requests``."""

    mode = "in-process"

    class RequestException(Exception):
        pass

    def __init__(self, mods, make_worker):
        import types

        self.mods = mods
        self.exceptions = types.SimpleNamespace(
            RequestException=self.RequestException)
        self.saved = sys.modules.get("requests")
        sys.modules["requests"] = self        # what the modules import
        self.controller = mods.controller.Controller("shortest_queue")
        self.ctrl_url, self.worker_url = "inproc://controller", \
            "inproc://worker"
        self.worker = make_worker(self.ctrl_url, self.worker_url)

    def post(self, url, json=None, **kw):
        c, w = self.controller, getattr(self, "worker", None)
        if url == self.ctrl_url + "/register_worker":
            c.register_worker(json["worker_name"], json["check_heart_beat"],
                              json.get("worker_status"))
            return _InProcessResponse({})
        if url == self.ctrl_url + "/receive_heart_beat":
            return _InProcessResponse({"exist": c.receive_heart_beat(
                json["worker_name"], json["queue_length"])})
        if url == self.worker_url + "/worker_generate_stream":
            return _InProcessResponse(chunks=w.generate_stream_gate(json))
        if url == self.worker_url + "/worker_get_status":
            return _InProcessResponse(w.get_status())
        raise self.RequestException(f"no in-process route for {url}")

    def stream(self, params):
        for chunk in self.controller.worker_api_generate_stream(params):
            yield json.loads(chunk.rstrip(b"\0"))

    def sglang(self, body) -> tuple:
        """What the SGLang app's JSON ``/generate`` answers."""
        params = self.mods.sglang_worker._params_from_sglang(body)
        last = _chunks(b"".join(self.worker.generate_stream_gate(params)))[-1]
        if last["error_code"] != 0:
            return 500, {"text": last["text"],
                         "meta_info": {"error_code": last["error_code"]}}
        return 200, {"text": last["text"][len(params["prompt"]):],
                     "meta_info": {"error_code": 0}}

    def status(self) -> dict:
        return self.worker.get_status()

    def close(self):
        if self.saved is None:
            sys.modules.pop("requests", None)
        else:
            sys.modules["requests"] = self.saved


def front_client(stream, params, rec) -> threading.Thread:
    """A client thread: takes ``stream(params)``'s chunks and keeps them,
    the time of the first one and of the last in ``rec``."""

    def go():
        rec["t_submit"] = time.perf_counter()
        try:
            for chunk in stream(params):
                if "t_first" not in rec:
                    rec["t_first"] = time.perf_counter()
                rec.setdefault("chunks", []).append(chunk)
        except Exception as e:       # noqa: BLE001: read by the main thread
            rec["error"] = repr(e)
        rec["t_end"] = time.perf_counter()

    t = threading.Thread(target=go, daemon=True)
    t.start()
    return t


def front_request_checks(label, params, rec) -> str:
    """Every chunk of a request has error_code 0 and the prompt in front;
    returns the completion."""
    if "error" in rec or not rec.get("chunks"):
        fail(f"{label}: the stream failed: {rec.get('error', 'no chunk')}")
    codes = [c["error_code"] for c in rec["chunks"]]
    if any(codes):
        fail(f"{label}: error codes {codes}: {rec['chunks'][-1]['text']}")
    text = rec["chunks"][-1]["text"]
    if not text.startswith(params["prompt"]):
        fail(f"{label}: the answer does not continue the prompt")
    return text[len(params["prompt"]):]


class SoloTally:
    """``generate.stream_generate`` wrapped: each call's yields, tokens and
    times (the worker imports it at each request, so it gets the
    wrapper)."""

    def __init__(self):
        import matryoshka_mm_torch.generate as G

        self.module, self.orig, self.calls = G, G.stream_generate, []
        G.stream_generate = self.wrapped

    def wrapped(self, *args, **kw):
        rec = {"t0": time.perf_counter(), "yields": 0, "tokens": 0}
        self.calls.append(rec)
        for ids in self.orig(*args, **kw):
            rec["yields"] += 1
            rec["tokens"] = int(np.shape(ids)[1])
            rec.setdefault("t_first", time.perf_counter())
            rec["t_end"] = time.perf_counter()
            yield ids

    def close(self):
        self.module.stream_generate = self.orig


class BatchTally:
    """The worker's batcher's ``stream`` wrapped: tokens streamed."""

    def __init__(self, batcher):
        self.batcher, self.orig, self.tokens = batcher, batcher.stream, 0
        self.lock = threading.Lock()
        batcher.stream = self.wrapped

    def wrapped(self, req):
        for chunk in self.orig(req):
            with self.lock:
                self.tokens += int(np.size(chunk))
            yield chunk

    def close(self):
        del self.batcher.stream


def front_traffic(stream, batcher, counters, label, seed,
                  sampled=0) -> dict:
    """Phase 7's 12 greedy requests through ``stream``, 8 as a burst and 4
    late, with ``sampled`` sampled requests (the solo stream, each
    capturing its decode while the batcher's rounds replay) sent once the
    burst decodes; returns the launches.  Each call's prompts and images
    are new (``seed``): no prefix-cache hit between calls."""
    rng = np.random.default_rng(seed)
    greedy = [{"model": FRONT_MODEL, "prompt": front_prompt(rng),
               "images": [front_image(rng)], "temperature": 0.0,
               "max_new_tokens": new,
               "matryoshka_vis_token_scale": f"ver=v0_numtoks={n}"}
              for n, new in SERVE_BURST + SERVE_LATE]
    extra = [{"model": FRONT_MODEL, "prompt": front_prompt(rng),
              "images": [front_image(rng)],
              "matryoshka_vis_token_scale": "ver=v0_numtoks=144",
              **FRONT_SAMPLED_KW} for _ in range(sampled)]
    solo, batched = SoloTally(), BatchTally(batcher)
    recs = [{} for _ in greedy + extra]
    rounds = batcher.occupancy["rounds"]
    _zero(counters)
    t0 = time.perf_counter()
    try:
        batcher._hold_admission = True         # the burst lands as one batch
        threads = [front_client(stream, p, r) for p, r in
                   zip(greedy[:len(SERVE_BURST)], recs)]
        deadline = time.perf_counter() + 60
        while batcher.pending.qsize() < len(SERVE_BURST):
            if time.perf_counter() > deadline or any("error" in r
                                                     for r in recs):
                fail(f"{label}: {batcher.pending.qsize()} of the burst "
                     f"reached the batcher")
            time.sleep(0.005)
        t_held = time.perf_counter()
        batcher._hold_admission = False
        while batcher.occupancy["rounds"] < rounds + 2 \
                and batcher.error is None:
            time.sleep(0.002)                   # the burst is decoding now
        threads += [front_client(stream, p, r) for p, r in
                    zip(extra, recs[len(greedy):])]
        for i, p in enumerate(greedy[len(SERVE_BURST):]):
            threads.append(front_client(stream, p,
                                        recs[len(SERVE_BURST) + i]))
            time.sleep(0.05)
        for t in threads:
            t.join(FRONT_TIMEOUT_S)
            if t.is_alive():
                fail(f"{label}: a request did not end")
        torch.cuda.synchronize()
    finally:
        batcher._hold_admission = False
        solo.close()
        batched.close()
    launches = _read(counters)
    for i, (p, r) in enumerate(zip(greedy + extra, recs)):
        front_request_checks(f"{label} request {i}", p, r)
    g_recs, s_recs = recs[:len(greedy)], recs[len(greedy):]
    wall = max(r["t_end"] for r in g_recs) - t0
    ttft = sorted(r["t_first"] - r["t_submit"] for r in g_recs)
    print(f"[{label}] {card_line()}: {len(greedy)} greedy requests, "
          f"{batched.tokens} tokens in {wall:.3f} s: "
          f"{batched.tokens / wall:.2f} tok/s over the batch (prefills "
          f"included); TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms max "
          f"{ttft[-1] * 1e3:.1f} ms; the burst's 8 requests were all with "
          f"the batcher {(t_held - t0) * 1e3:.1f} ms after the first was "
          f"sent")
    if len(solo.calls) != sampled:
        fail(f"{label}: {len(solo.calls)} requests took the solo stream, "
             f"expected the {sampled} sampled ones")
    for i, (c, r) in enumerate(zip(solo.calls, s_recs)):
        rate = (c["tokens"] - 1) / (c["t_end"] - c["t_first"])
        print(f"[{label}] {card_line()}: sampled request {i} beside the "
              f"batch: {c['tokens']} tokens, TTFT "
              f"{(r['t_first'] - r['t_submit']) * 1e3:.1f} ms, decode "
              f"{rate:.2f} tok/s")
    print(f"[{label}] launches {launches}")
    return launches


def front_quiet_solo(front, counters, n_layers) -> dict:
    """One sampled request through the controller with nothing else
    running: a flash launch a layer for its prefill and a decode launch a
    layer a decode step, as phase 4 counts them."""
    rng = np.random.default_rng(18)
    params = {"model": FRONT_MODEL, "prompt": front_prompt(rng),
              "images": [front_image(rng)],
              "matryoshka_vis_token_scale": "ver=v0_numtoks=144",
              **FRONT_SAMPLED_KW}
    solo, rec = SoloTally(), {}
    _zero(counters)
    try:
        t = front_client(front.stream, params, rec)
        t.join(FRONT_TIMEOUT_S)
        torch.cuda.synchronize()
    finally:
        solo.close()
    launches = _read(counters)
    front_request_checks("frontend quiet solo", params, rec)
    (call,) = solo.calls
    steps = min(params["max_new_tokens"] - 1, FRONT_CHUNK * (call["yields"] - 1))
    _held("frontend quiet solo", launches,
          {"paged_attention": 0, "flash_attention": n_layers,
           "decode_attention": n_layers * steps})
    return launches


def front_sglang(front) -> None:
    """A constrained request and one with a stop list on the SGLang
    route."""
    import re as _re

    from matryoshka_mm_torch.serve.constrained import regex_for_json_schema

    rng = np.random.default_rng(19)
    status, body = front.sglang({
        "text": front_prompt(rng), "image_data": front_image(rng),
        "matryoshka_vis_token_scale": "ver=v0_numtoks=9",
        "sampling_params": {"temperature": 0.0, "max_new_tokens": 48,
                            "json_schema": FRONT_SCHEMA}})
    print(f"[frontend] SGLang json_schema: {status} {body}")
    if status != 200 or body["meta_info"]["error_code"] != 0 or not \
            _re.fullmatch(regex_for_json_schema(FRONT_SCHEMA), body["text"]):
        fail("frontend: the constrained SGLang request")
    status, body = front.sglang({
        "text": front_prompt(rng), "image_data": front_image(rng),
        "matryoshka_vis_token_scale": "ver=v0_numtoks=144",
        "sampling_params": {"temperature": 0.0, "max_new_tokens": 64,
                            "stop": FRONT_STOP}})
    print(f"[frontend] SGLang stop {FRONT_STOP}: {status} {body}")
    if status != 200 or body["meta_info"]["error_code"] != 0 or any(
            s in body["text"] for s in FRONT_STOP):
        fail("frontend: the SGLang request with a stop list")


def front_redecode_ms(tokenizer, vocab) -> float:
    """Host ms that one 64-token request spends in the batcher path's
    re-decode of its whole answer at every chunk (the first token, then
    chunks of 8), with the worker's tokenizer: median of 50."""
    toks = np.random.default_rng(20).integers(4, vocab, FRONT_REDECODE_TOKENS)
    pieces = [toks[:1]] + [toks[i:i + FRONT_CHUNK] for i in
                           range(1, FRONT_REDECODE_TOKENS, FRONT_CHUNK)]
    times = []
    for _ in range(50):
        t0, acc = time.perf_counter(), []
        for chunk in pieces:
            acc.extend(int(t) for t in np.ravel(chunk))
            tokenizer.decode(acc, skip_special_tokens=True)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def small_front_model(dirname: Path) -> Path:
    """Phase 8's small float32 model (Dh=128) with a tiny CLIP tower at
    336 pixels (the front end's default image size), saved as a checkpoint
    of the port."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.utils.checkpoint import save_checkpoint

    base = LlavaConfig.tiny_debug()
    # the worker keeps room for the 576 patches of a 336-pixel image in the
    # context, whatever the scale: 2,048 positions
    cfg = dataclasses.replace(
        base, llama=dataclasses.replace(
            base.llama, hidden_size=256, num_attention_heads=2,
            num_key_value_heads=2, intermediate_size=512,
            max_position_embeddings=2048),
        vision=dataclasses.replace(base.vision, image_size=336))
    path = dirname / "llava-small-f32"
    save_checkpoint(str(path), init_params(cfg, "cpu", seed=3), cfg)
    return path


def front_small(mods, dev) -> None:
    """The small float32 model behind two workers on the card, one with
    the paged batcher and one without: a greedy request through each path
    and one CLI turn give the text of the port's generate."""
    import base64
    import builtins
    import contextlib
    import io
    import tempfile

    from PIL import Image

    from matryoshka_mm_torch.conversation import conv_templates
    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.mm_utils import (process_images,
                                              tokenizer_image_token)

    tmp = Path(tempfile.mkdtemp(prefix="m3_front_"))
    try:
        path = small_front_model(tmp)
        rng = np.random.default_rng(21)
        b64 = front_image(rng, (300, 240))
        question = " ".join(f"q{int(i)}" for i in rng.integers(0, 999, 9))
        conv = conv_templates["llava_v1"].copy()
        conv.append_message(conv.roles[0], "<image>\n" + question)
        conv.append_message(conv.roles[1], None)
        prompt, new = conv.get_prompt(), 24
        params = {"prompt": prompt, "images": [b64], "temperature": 0.0,
                  "max_new_tokens": new,
                  "matryoshka_vis_token_scale": "ver=v0_numtoks=9"}
        texts = {}
        for kind, kw in (("batcher", dict(continuous_batching=True,
                                          kv_backend="paged", max_batch=2,
                                          pool_prefill_len=128,
                                          pool_max_new=64)),
                         ("solo", {})):
            w = mods.model_worker.ModelWorker(
                "", "", "small", True, str(path), None, None,
                device=str(dev), **kw)
            try:
                tally = SoloTally()
                try:
                    chunks = _chunks(b"".join(w.generate_stream_gate(params)))
                finally:
                    tally.close()
                if [c["error_code"] for c in chunks] != [0] * len(chunks):
                    fail(f"frontend small {kind}: {chunks[-1]}")
                if (len(tally.calls) == 1) != (kind == "solo"):
                    fail(f"frontend small: the {kind} request took the "
                         f"wrong path")
                texts[kind] = chunks[-1]["text"][len(prompt):]
            finally:
                if w.batcher is not None:
                    w.batcher.shutdown()
        # the port's generate on the same weights, prompt and image
        tok, model = w.tokenizer, w.model
        img = Image.open(io.BytesIO(base64.b64decode(b64)))
        px = np.asarray(process_images([img], w.image_processor,
                                       model.config), np.float32)
        ids = np.asarray(tokenizer_image_token(prompt, tok), np.int64)[None]
        out = generate(model.params, model.cfg, ids, px,
                       matryoshka_vis_token_scale="ver=v0_numtoks=9",
                       gen_cfg=GenerationConfig(
                           max_new_tokens=new, eos_token_id=tok.eos_token_id,
                           pad_token_id=0, decode_chunk=FRONT_CHUNK))
        want = tok.decode([int(t) for t in out[0] if t != 0],
                          skip_special_tokens=True)
        # one CLI turn: the question on stdin, then end of input
        img.save(tmp / "q.png")
        answers = iter([question])
        real_input, out_buf = builtins.input, io.StringIO()

        def fake_input(prompt_text=""):
            try:
                return next(answers)
            except StopIteration:
                raise EOFError from None

        builtins.input = fake_input
        try:
            with contextlib.redirect_stdout(out_buf):
                mods.cli.main(mods.cli.parse_args([
                    "--model-path", str(path), "--image-file",
                    str(tmp / "q.png"), "--device", str(dev),
                    "--conv-mode", "llava_v1", "--temperature", "0",
                    "--max-new-tokens", str(new),
                    "--matryoshka_vis_token_scale", "9"]))
        finally:
            builtins.input = real_input
        said = out_buf.getvalue()
        marker = f"{conv.roles[1]}: "
        texts["cli"] = said[said.index(marker) + len(marker):].split("\n")[0]
        print(f"[frontend small] {card_line()}: generate {want!r}; "
              + "; ".join(f"{k} {v!r}" for k, v in texts.items()))
        if not want or any(v != want for v in texts.values()):
            fail("frontend small: a front-end path's text differs from "
                 "generate's")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def front_native() -> None:
    """The port's C++ preprocessing builds here and gives the PIL path's
    bits."""
    from PIL import Image

    from matryoshka_mm_torch.image_processing import ClipImageProcessor
    from matryoshka_mm_torch.native import (clip_preprocess_native,
                                            library_path, native_available)

    t0 = time.perf_counter()
    if not native_available():
        fail("frontend: the native image library did not build")
    build_s = time.perf_counter() - t0
    proc = ClipImageProcessor()
    rgb = np.random.default_rng(22).integers(0, 256, (412, 517, 3),
                                             dtype=np.uint8)
    im = proc.center_crop(proc.resize_shortest_edge(Image.fromarray(rgb)))
    pil = ((np.asarray(im, np.float32) / 255.0
            - np.asarray(proc.image_mean, np.float32))
           / np.asarray(proc.image_std, np.float32)).transpose(2, 0, 1)
    got = clip_preprocess_native(rgb, 336, 336, proc.image_mean,
                                 proc.image_std)
    print(f"[frontend] native {library_path().name} in {build_s:.2f} s; "
          f"max |native - PIL| {float(np.abs(got - pil).max())}")
    if not np.array_equal(got, pil):
        fail("frontend: the native preprocessing differs from PIL's")


def phase_frontend(dev) -> dict:
    """Returns the launches of the counted runs, by kernel."""
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention

    saved = sys.stdout, sys.stderr
    t0 = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[time] frontend {what} {now - t0[0]:.1f} s")
        t0[0] = now

    counters = {"paged_attention": paged_decode_attention,
                "flash_attention": flash_attention_lse,
                "decode_attention": flash_decode_attention}
    try:
        mods = frontend_modules()
        try:
            import aiohttp
            import requests

            print(f"[frontend] aiohttp {aiohttp.__version__} and requests "
                  f"{requests.__version__} import: the front end runs over "
                  f"HTTP on localhost")
            Front = HttpFront
        except ImportError as e:
            print(f"[frontend] {e}: the front end runs in process "
                  f"(Controller.worker_api_generate_stream -> "
                  f"ModelWorker.generate_stream_gate)")
            Front = InProcessFront
        front_native()
        torch.cuda.empty_cache()
        made = {}

        def make_worker(ctrl_url, worker_url):
            made["w"] = mods.model_worker.ModelWorker(
                ctrl_url, worker_url, "smoke", False, "debug://7b", None,
                FRONT_MODEL, device=str(dev), continuous_batching=True,
                kv_backend="paged", max_batch=8, prefix_cache=True,
                warmup=True, limit_model_concurrency=10,
                kv_cache_dtype="auto")
            return made["w"]

        front = None
        try:
            front = Front(mods, make_worker)
            worker = front.worker
            lap("debug://7b behind the worker (made, warmed up, registered)")
            cfg, batcher = worker.model.cfg, worker.batcher
            kv = cfg.llama.kv_cache_dtype or "bf16"
            print(f"[frontend] {card_line()}: kv_cache_dtype auto -> {kv} "
                  f"(pool of {batcher.capacity} slots x {batcher.max_batch} "
                  f"rows)")
            if cfg.llama.kv_cache_dtype:
                fail("frontend: kv_cache_dtype auto did not pick bf16")
            if front.controller.list_models() != [FRONT_MODEL]:
                fail("frontend: the worker did not register")
            launches = front_traffic(front.stream, batcher, counters,
                                     "frontend", 17, FRONT_SAMPLED)
            if launches["paged_attention"] <= 0:
                fail("frontend: the batched traffic launched no paged "
                     "attention")
            lap("traffic")
            # the same traffic without the sampled requests, then straight
            # into the worker (no HTTP, no controller): what each layer adds
            front_traffic(front.stream, batcher, counters,
                          "frontend greedy only", 117)
            front_traffic(lambda p: (json.loads(c.rstrip(b"\0")) for c in
                                     worker.generate_stream_gate(p)),
                          batcher, counters, "frontend worker in process",
                          217)
            lap("traffic without the sampled requests, and in process")
            front_sglang(front)
            lap("SGLang requests")
            for k, n in front_quiet_solo(front, counters,
                                         cfg.llama.num_hidden_layers).items():
                launches[k] += n
            status = front.status()
            print(f"[frontend] status {status}")
            if not status.get("batcher", {}).get("healthy"):
                fail("frontend: the worker is not healthy")
            ms = front_redecode_ms(worker.tokenizer, cfg.llama.vocab_size)
            print(f"[frontend] host re-decode of a {FRONT_REDECODE_TOKENS}-"
                  f"token answer at every chunk: {ms:.3f} ms a request "
                  f"(DebugTokenizer)")
        finally:
            worker = made.pop("w", None)
            if worker is not None:
                worker.no_register = True       # its heartbeat thread stops
            if front is not None:
                front.close()
            if worker is not None:
                if worker.batcher is not None:
                    worker.batcher.shutdown()
                worker.model = worker.batcher = None
            gc.collect()
            torch.cuda.empty_cache()
        lap("7B worker")
        front_small(mods, dev)
        lap("small model")
    finally:
        sys.stdout, sys.stderr = saved
    return launches


EVAL_SIZES = ((640, 480), (500, 375), (640, 427), (427, 640))   # COCO's
EVAL_OBJECTS = ("dog", "car", "person", "chair", "bottle", "cup", "clock",
                "bird")
EVAL_IMAGES = 8
EVAL_QUESTIONS = 16
POPE_PROMPT = ("Is there a {} in the image?\nAnswer the question using a "
               "single word or phrase.")
# (label, --batch-size, scale): B=1 and B=8 at 144, then a two-point sweep
EVAL_RUNS = (("b1 144", 1, 144), ("b8 144", 8, 144), ("b8 1", 8, 1),
             ("b8 576", 8, 576))
EVAL_NEW_TOKENS = 32
EVAL_MODEL = "debug://7b"
EVAL_KEYS = {"question_id", "prompt", "text", "answer_id", "model_id",
             "metadata"}


def eval_data(root: Path, seed=18) -> dict:
    """POPE-style data from a seed: EVAL_IMAGES JPEGs at COCO sizes,
    EVAL_QUESTIONS questions (two an image) with POPE's prompt, the yes/no
    labels in question order, and the files the other generators read."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    images = root / "val2014"
    images.mkdir()
    names = []
    for i in range(EVAL_IMAGES):
        w, h = EVAL_SIZES[i % len(EVAL_SIZES)]
        # blocks of colour, upsampled: a photo's low frequencies, not noise
        small = rng.integers(0, 256, (h // 16, w // 16, 3), dtype=np.uint8)
        names.append(f"COCO_val2014_{i:012d}.jpg")
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
            images / names[-1], quality=90)
    questions, labels = [], []
    for i in range(EVAL_QUESTIONS):
        obj = EVAL_OBJECTS[(3 * i) % len(EVAL_OBJECTS)]
        questions.append({"question_id": i, "image": names[i // 2],
                          "text": POPE_PROMPT.format(obj),
                          "category": "random"})
        labels.append({"question_id": i,
                       "label": "yes" if rng.random() < 0.5 else "no"})

    def jsonl(name, rows):
        with open(root / name, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        return str(root / name)

    science = root / "science.json"
    with open(science, "w") as f:
        json.dump([{"id": "s0", "image": names[0], "conversations": [
                        {"from": "human", "value": "<image>\nWhich animal "
                         "is shown?\nOptions: (A) cat (B) dog"}]},
                   {"id": "s1", "conversations": [
                       {"from": "human", "value": "What is two plus two?\n"
                        "Options: (A) 3 (B) 4"}]}], f)
    qbench = root / "qbench.json"
    with open(qbench, "w") as f:
        json.dump([{"img_path": names[i], "question": "How is the clarity "
                    "of the image?", "candidates": ["good", "poor"]}
                   for i in range(2)], f)
    return {"images": str(images), "questions": jsonl("pope.jsonl",
                                                      questions),
            "two": jsonl("two.jsonl", questions[:2]),
            "labels": jsonl("labels.jsonl", labels),
            "science": str(science), "qbench": str(qbench)}


class EvalTally:
    """Wraps ``LlavaModel.generate`` and ``generate._decode_loop`` while
    open: each generate call's start, its first token on the host (the
    decode loop's first yield, after the prefill's sync), its end, its
    rows and columns, its generated tokens (non-pad) and the ms its decode
    graph's warm-up and capture took."""

    def __enter__(self):
        from matryoshka_mm_torch import generate as gen
        from matryoshka_mm_torch.models import builder
        from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

        self.calls = []
        self._real = (builder.LlavaModel.generate, gen._decode_loop)
        real_generate, real_loop = self._real
        calls = self.calls

        def graph_ms():
            return (CapturedStep.warmup_s + CapturedStep.capture_s) * 1e3

        def generate(model, *a, **kw):
            rec = {"t0": time.perf_counter(), "graph_ms": -graph_ms()}
            calls.append(rec)
            out = real_generate(model, *a, **kw)
            rec["t1"] = time.perf_counter()
            rec["graph_ms"] += graph_ms()
            rec["rows"], rec["cols"] = out.shape
            rec["tokens"] = int((out != kw.get("pad_token_id", 0)).sum())
            return out

        def decode_loop(*a, **kw):
            it = real_loop(*a, **kw)
            first = next(it)
            calls[-1]["first"] = time.perf_counter()
            yield first
            yield from it

        builder.LlavaModel.generate = generate
        gen._decode_loop = decode_loop
        return self

    def __exit__(self, *exc):
        from matryoshka_mm_torch import generate as gen
        from matryoshka_mm_torch.models import builder

        builder.LlavaModel.generate, gen._decode_loop = self._real


def read_answers(path, label) -> list:
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        if not EVAL_KEYS <= set(r):
            fail(f"{label}: an answer line lacks {EVAL_KEYS - set(r)}")
    return rows


def eval_loader_run(label, argv, data, counters, n_layers) -> dict:
    """One ``model_vqa_loader`` run of the POPE questions on EVAL_MODEL,
    scored by ``eval_pope``; gates and prints; returns its launches."""
    import contextlib
    import io

    from matryoshka_mm_torch.eval import eval_pope, model_vqa_loader
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    args = model_vqa_loader.build_parser().parse_args(argv)
    for c in counters.values():
        c.launches = 0
    graph0 = (CapturedStep.captures, CapturedStep.warmup_s,
              CapturedStep.capture_s)
    t0 = time.perf_counter()
    with EvalTally() as tally:
        model_vqa_loader.eval_model(args)
    wall = time.perf_counter() - t0
    launches = _read(counters)
    calls = tally.calls
    rows = read_answers(args.answers_file, label)
    ids = sorted(r["question_id"] for r in rows)
    if ids != list(range(EVAL_QUESTIONS)):
        fail(f"{label}: answers for {ids}, want every one of "
             f"{EVAL_QUESTIONS} questions once")
    want = {"flash_attention": n_layers * len(calls),
            "decode_attention": n_layers * sum(c["cols"] - 1
                                               for c in calls)}
    print(f"[eval {label}] launches {launches} expected {want}")
    if launches != want or min(launches.values()) <= 0:
        fail(f"eval {label}: the loader did not go through the flash and "
             f"decode kernels as expected")
    captures = CapturedStep.captures - graph0[0]
    warm_ms = (CapturedStep.warmup_s - graph0[1]) * 1e3
    cap_ms = (CapturedStep.capture_s - graph0[2]) * 1e3
    if captures != len(calls):
        fail(f"eval {label}: {captures} captures for {len(calls)} calls")
    span = calls[-1]["t1"] - calls[0]["t0"]
    tokens = sum(c["tokens"] for c in calls)
    ttft = sorted((c["first"] - c["t0"]) * 1e3 for c in calls)
    # each call's warm-up + capture against its own wall; the run's first
    # call, the cold one, apart
    later = calls[1:] or calls
    share = statistics.median(c["graph_ms"] / 1e3 / (c["t1"] - c["t0"])
                              for c in later)
    per_call = (
        f"a call after the first: warm-up + capture median "
        f"{statistics.median(c['graph_ms'] for c in later):.2f} ms, "
        f"{share:.1%} of its wall (first call {calls[0]['graph_ms']:.2f} "
        f"ms, TTFT {(calls[0]['first'] - calls[0]['t0']) * 1e3:.2f} ms)")
    answers = sorted(rows, key=lambda r: r["question_id"])
    with contextlib.redirect_stdout(io.StringIO()):
        pope = eval_pope.eval_pope(answers, data["labels"])
    print(f"[eval {label}] {card_line()}: {len(calls)} generate calls of "
          f"{calls[0]['rows']}-{max(c['rows'] for c in calls)} rows; "
          f"eval_model {wall:.3f} s (load included), generate calls "
          f"{span:.3f} s: {EVAL_QUESTIONS / span:.2f} questions/s, "
          f"{tokens / span:.1f} generated tok/s ({tokens} tokens); TTFT "
          f"p50 {statistics.median(ttft):.2f} ms (a call's start to its "
          f"first token on the host) max {ttft[-1]:.2f} ms; warm-up "
          f"{warm_ms:.2f} ms + capture {cap_ms:.2f} ms of the decode "
          f"graphs = {(warm_ms + cap_ms) / 1e3 / span:.1%} of the generate "
          f"calls' wall ({captures} captures); {per_call}; POPE F1 "
          f"{pope['f1']:.4f} "
          f"accuracy {pope['accuracy']:.4f} yes ratio "
          f"{pope['yes_ratio']:.4f} (random weights)")
    return launches


def eval_small(root: Path, data: dict, dev) -> None:
    """Phase 8's small float32 model (Dh=128, a CLIP tower at 336 pixels)
    on the card: gate 1, the loader's answers at --batch-size 1 and 8
    equal; gate 2, two chunks merged equal the whole run; model_vqa,
    model_vqa_science (an image row and a text-only row) and
    model_vqa_qbench answer 2 questions each."""
    from matryoshka_mm_torch.eval import (model_vqa, model_vqa_loader,
                                          model_vqa_qbench,
                                          model_vqa_science)

    path = str(small_front_model(root))
    common = ["--model-path", path, "--device", str(dev), "--image-folder",
              data["images"], "--matryoshka_vis_token_scale",
              "ver=v0_numtoks=36"]

    def loader(name, *extra):
        out = str(root / f"{name}.jsonl")
        model_vqa_loader.eval_model(model_vqa_loader.build_parser()
                                    .parse_args(common + [
                                        "--question-file",
                                        data["questions"],
                                        "--answers-file", out,
                                        "--max_new_tokens", "16", *extra]))
        return {r["question_id"]: r["text"]
                for r in read_answers(out, f"eval small {name}")}

    b1, b8 = loader("small-b1"), loader("small-b8", "--batch-size", "8")
    print(f"[eval small] float32, {card_line()}: answers at batch 1 "
          f"{'equal' if b1 == b8 else 'DIFFER from'} batch 8 "
          f"({len(b1)} questions; first {b1[0]!r})")
    if len(b1) != EVAL_QUESTIONS or b1 != b8:
        fail("eval small: the loader's answers at --batch-size 1 and 8 "
             "differ")
    merged = {}
    for k in range(2):
        merged.update(loader(f"small-chunk{k}", "--batch-size", "8",
                             "--num-chunks", "2", "--chunk-idx", str(k)))
    print(f"[eval small] two chunks merged "
          f"{'equal' if merged == b1 else 'DIFFER from'} the whole run")
    if merged != b1:
        fail("eval small: --num-chunks 2 merged differs from the whole run")
    for mod, argv, n in (
            (model_vqa, ["--question-file", data["two"], "--temperature",
                         "0"], 2),
            (model_vqa_science, ["--question-file", data["science"],
                                 "--temperature", "0",
                                 "--single-pred-prompt"], 2),
            (model_vqa_qbench, ["--questions-file", data["qbench"]], 2)):
        name = mod.__name__.rsplit(".", 1)[1]
        out = str(root / f"{name}.jsonl")
        t0 = time.perf_counter()
        mod.eval_model(mod.build_parser().parse_args(
            common + argv + ["--answers-file", out]))
        with open(out) as f:
            rows = [json.loads(line) for line in f]
        print(f"[eval small] {name}: {len(rows)} answers in "
              f"{time.perf_counter() - t0:.2f} s, first "
              f"{str(rows[0].get('text', rows[0].get('response')))[:40]!r}")
        if len(rows) != n:
            fail(f"eval small: {name} gave {len(rows)} answers, want {n}")
    try:
        import pandas
        have = f"pandas {pandas.__version__} imports here"
    except ImportError:
        have = "pandas does not import here"
    print(f"[eval small] model_vqa_mmbench ({have}) and model_qa (sampled) "
          f"are held to the JAX package by the CPU tests "
          f"(tests/test_torch_eval_generators.py), not here")


def phase_eval(dev) -> dict:
    """Returns the launches of the counted 7B runs, by kernel."""
    import tempfile

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse

    counters = {"flash_attention": flash_attention_lse,
                "decode_attention": flash_decode_attention}
    n_layers = LlavaConfig.llava_v15_7b_m3().llama.num_hidden_layers
    t0 = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[time] eval {what} {now - t0[0]:.1f} s")
        t0[0] = now

    launches = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory(prefix="m3_eval_") as tmp:
        root = Path(tmp)
        data = eval_data(root)
        for label, bs, scale in EVAL_RUNS:
            out = str(root / f"answers-{label.replace(' ', '-')}.jsonl")
            _add(launches, eval_loader_run(label, [
                "--model-path", EVAL_MODEL, "--device", str(dev),
                "--image-folder", data["images"], "--question-file",
                data["questions"], "--answers-file", out, "--temperature",
                "0", "--conv-mode", "llava_v1", "--batch-size", str(bs),
                "--max_new_tokens", str(EVAL_NEW_TOKENS),
                "--matryoshka_vis_token_scale",
                f"ver=v0_numtoks={scale}"], data, counters, n_layers))
            gc.collect()
            torch.cuda.empty_cache()
            lap(f"{EVAL_MODEL} {label}")
        eval_small(root, data, dev)
        lap("small model")
    return launches


HARNESS_MODEL = "debug://7b"
HARNESS_SCALE = 144
HARNESS_NEW_TOKENS = 32
HARNESS_BATCH = 8
HARNESS_LL_SCALES = (144, 576)
HARNESS_LL_REQUESTS = 8           # a scale
HARNESS_VIDEO_SIZE = (640, 480)
HARNESS_VIDEO_FRAMES = 8
HARNESS_VIDEOS = 2
HARNESS_VIDEO_TOKENS = 8          # eval_llava_multiplechoice's answers
HARNESS_SMALL_DOCS = 8
HARNESS_SMALL_TOL = 1e-4          # loglikelihood, card against CPU, float32
# the small model splices at most 128 positions (its
# tokenizer_model_max_length): a scale that leaves the continuation in
# (at 144 the splice drops it and the adapter raises ValueError)
HARNESS_SMALL_LL_SCALE = 36
HARNESS_MEM_SLACK = 256 << 20     # bytes a closed worker may leave allocated


def harness_task(root: Path, data: dict, name: str) -> dict:
    """The shipped ``pope`` task over phase 18's questions and JPEGs (its
    prompt, post prompt and scoring hooks), as a local JSON, with
    HARNESS_NEW_TOKENS new tokens; registered under ``name``."""
    from matryoshka_mm_torch.lmms_eval.api.registry import (get_task,
                                                            register_task)

    with open(data["questions"]) as f, open(data["labels"]) as g:
        docs = [{"question": q["text"].split("\n")[0], "answer": lab["label"],
                 "image": q["image"]}
                for q, lab in zip(map(json.loads, f), map(json.loads, g))]
    path = root / f"{name}.json"
    path.write_text(json.dumps(docs))
    cfg = dict(get_task("pope"), task=name, dataset_path=str(path),
               dataset_kwargs={"image_folder": data["images"]},
               generation_kwargs={"max_new_tokens": HARNESS_NEW_TOKENS,
                                  "temperature": 0.0})
    register_task(name, cfg)
    return cfg


def _harness_counters() -> dict:
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.ops.paged_attention import paged_decode_attention

    return {"flash_attention": flash_attention_lse,
            "decode_attention": flash_decode_attention,
            "paged_attention": paged_decode_attention}


def _generate_gates(label, calls, launches, n_layers, captures,
                    new_tokens) -> None:
    """Exact flash (n_layers a generate call) and decode launches
    (n_layers a decode step, replays included), every call decoding
    ``new_tokens`` and capturing its step once."""
    cols = [c["cols"] for c in calls]
    want = {"flash_attention": n_layers * len(calls),
            "decode_attention": n_layers * (new_tokens - 1) * len(calls),
            "paged_attention": 0}
    print(f"[harness {label}] {len(calls)} generate calls of "
          f"{[c['rows'] for c in calls]} rows and {cols} tokens; launches "
          f"{launches} expected {want}; {captures} captures")
    if launches != want or cols != [new_tokens] * len(calls):
        fail(f"harness {label}: not the flash and decode launches of "
             f"{len(calls)} generate calls of {new_tokens} tokens each")
    if captures != len(calls):
        fail(f"harness {label}: {captures} captures for {len(calls)} calls")


def harness_generate(task, counters, n_layers) -> dict:
    """``simple_evaluate`` over the 16-doc task on the 7B model at batch
    HARNESS_BATCH; returns its launches."""
    from matryoshka_mm_torch.lmms_eval.evaluator import simple_evaluate
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    _zero(counters)
    captures = CapturedStep.captures
    t0 = time.perf_counter()
    with EvalTally() as tally:
        res = simple_evaluate(
            model="llava",
            model_args=f"pretrained={HARNESS_MODEL},"
                       f"batch_size={HARNESS_BATCH},device=cuda",
            tasks=[task["task"]],
            matryoshka_vis_token_scale=f"ver=v0_numtoks={HARNESS_SCALE}",
            log_samples=True)
    wall = time.perf_counter() - t0
    launches = _read(counters)
    calls = tally.calls
    _generate_gates("generate_until", calls, launches, n_layers,
                    CapturedStep.captures - captures, HARNESS_NEW_TOKENS)
    agg = res["results"][task["task"]]
    samples = res["samples"][task["task"]]
    f1, acc = agg["pope_metrics/f1"], agg["pope_metrics/accuracy"]
    if len(samples) != EVAL_QUESTIONS or agg["samples"] != EVAL_QUESTIONS:
        fail(f"harness generate_until: {len(samples)} samples, want "
             f"{EVAL_QUESTIONS}")
    if not all(isinstance(s["resps"][0], str) for s in samples) or not (
            0.0 <= f1 <= 1.0 and 0.0 <= acc <= 1.0):
        fail(f"harness generate_until: responses or POPE metrics out of "
             f"range ({agg})")
    span = calls[-1]["t1"] - calls[0]["t0"]
    tokens = sum(c["tokens"] for c in calls)
    print(f"[harness generate_until] {card_line()}: simple_evaluate "
          f"{wall:.3f} s (model load included); generate calls {span:.3f} "
          f"s: {EVAL_QUESTIONS / span:.2f} questions/s, {tokens / span:.1f} "
          f"generated tok/s ({tokens} tokens); POPE F1 {f1:.4f} accuracy "
          f"{acc:.4f} (random weights); first response "
          f"{samples[0]['resps'][0][:40]!r}")
    return launches


def _ll_requests(task, n) -> list:
    """``loglikelihood`` requests over the first ``n`` docs of ``task``:
    the prompt with its image, and the label as a sentence."""
    from PIL import Image

    from matryoshka_mm_torch.lmms_eval.api.instance import Instance
    from matryoshka_mm_torch.lmms_eval.api.task import ConfigurableTask

    t = ConfigurableTask(task)
    folder = Path(task["dataset_kwargs"]["image_folder"])
    out = []
    for i, doc in enumerate(t.docs()[:n]):
        obj = doc["question"].split()[3]
        cont = (f" {doc['answer'].capitalize()}, there is "
                f"{'a' if doc['answer'] == 'yes' else 'no'} {obj} in the "
                f"image.")
        image = Image.open(folder / doc["image"]).convert("RGB")
        out.append(Instance("loglikelihood", doc,
                            (t.doc_to_text(doc), cont, image), 0,
                            task["task"], i))
    return out


def harness_loglikelihood(task, counters, n_layers) -> dict:
    """The llava adapter's ``loglikelihood`` on the 7B model,
    HARNESS_LL_REQUESTS requests with an image at each of
    HARNESS_LL_SCALES; one request's logits against
    attn_impl="reference"; returns the launches."""
    from matryoshka_mm_torch.lmms_eval.api.registry import get_model

    lm = get_model("llava")(pretrained=HARNESS_MODEL, device="cuda")
    reqs = _ll_requests(task, HARNESS_LL_REQUESTS)
    total = {}
    for scale in HARNESS_LL_SCALES:
        lm.matryoshka_vis_token_scale = f"ver=v0_numtoks={scale}"
        lm.loglikelihood(reqs[:1])          # the scale's first call, untimed
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.loglikelihood(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _read(counters)
        _held(f"harness loglikelihood {scale}", launches, {
            "flash_attention": n_layers * len(reqs), "decode_attention": 0,
            "paged_attention": 0})
        _add(total, launches)
        lps = [lp for lp, _ in out]
        if not np.isfinite(lps).all():
            fail(f"harness loglikelihood {scale}: a logprob is not finite "
                 f"({lps})")
        print(f"[harness loglikelihood {scale}] {card_line()}: "
              f"{len(reqs)} requests in {dt:.3f} s: {len(reqs) / dt:.2f} "
              f"requests/s, {dt / len(reqs) * 1e3:.2f} ms a request; "
              f"logprobs {min(lps):.2f} .. {max(lps):.2f}, greedy "
              f"{sum(g for _, g in out)} of {len(out)}")
    got, labels = lm.request_logits(reqs[0])
    cfg = lm.model.cfg
    lm.model.cfg = cfg.with_attn_impl("reference")
    want, _ = lm.request_logits(reqs[0])
    lm.model.cfg = cfg
    rows = torch.nonzero(labels[0, 1:] >= 0).flatten()
    cos = torch.nn.functional.cosine_similarity(
        got[0, rows].flatten(), want[0, rows].flatten(), dim=0).item()
    print(f"[harness loglikelihood] kernel vs attn_impl=\"reference\" "
          f"logits over the {len(rows)} scored positions at scale "
          f"{HARNESS_LL_SCALES[-1]}: cosine {cos:.6f} (gate >= {LOGIT_COS})")
    if cos < LOGIT_COS:
        fail(f"harness loglikelihood: kernel logits cosine {cos:.6f} "
             f"against the reference attention")
    return total


def harness_sglang(task, counters, model, label) -> tuple:
    """The llava_sglang adapter with its in-process worker (paged batcher,
    prefix cache) over ``task``; after ``close()`` no thread of the run is
    alive and the device memory is back where it was.  Returns (launches,
    responses)."""
    from matryoshka_mm_torch.lmms_eval.evaluator import simple_evaluate

    gc.collect()
    torch.cuda.empty_cache()
    threads = set(threading.enumerate())
    mem0 = torch.cuda.memory_allocated()
    _zero(counters)
    t0 = time.perf_counter()
    res = simple_evaluate(
        model="llava_sglang",
        model_args=f"pretrained={model},parallel={HARNESS_BATCH},"
                   f"max_batch={HARNESS_BATCH},device=cuda",
        tasks=[task["task"]],
        matryoshka_vis_token_scale=f"ver=v0_numtoks={HARNESS_SCALE}",
        log_samples=True)
    wall = time.perf_counter() - t0
    launches = _read(counters)
    resps = [s["resps"][0] for s in res["samples"][task["task"]]]
    gc.collect()
    torch.cuda.empty_cache()
    left = [t.name for t in threading.enumerate()
            if t not in threads and t.is_alive()]
    mem = torch.cuda.memory_allocated() - mem0
    print(f"[harness sglang {label}] {card_line()}: {len(resps)} questions "
          f"in {wall:.3f} s (worker load included): "
          f"{len(resps) / wall:.2f} questions/s; launches {launches}; after "
          f"close() {len(left)} new threads alive, {mem / 2**20:.1f} MiB "
          f"more allocated than before")
    if launches["paged_attention"] <= 0:
        fail(f"harness sglang {label}: no paged-attention launch")
    if res["results"][task["task"]]["samples"] != len(resps) or not all(
            isinstance(r, str) for r in resps):
        fail(f"harness sglang {label}: responses {resps}")
    if left or mem > HARNESS_MEM_SLACK:
        fail(f"harness sglang {label}: close() left threads {left} or "
             f"{mem} bytes behind")
    return launches, resps


def harness_videos(root: Path, seed=19) -> tuple:
    """HARNESS_VIDEOS seeded mp4s (blocks of colour drifting frame to
    frame) and a multiple-choice QA csv over them."""
    import cv2
    import pandas as pd

    rng = np.random.default_rng(seed)
    vdir = root / "videos"
    vdir.mkdir()
    w, h = HARNESS_VIDEO_SIZE
    rows = []
    for v in range(HARNESS_VIDEOS):
        out = cv2.VideoWriter(str(vdir / f"v{v}.mp4"),
                              cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
        small = rng.integers(0, 256, (h // 32, w // 32, 3), dtype=np.uint8)
        for i in range(HARNESS_VIDEO_FRAMES):
            out.write(cv2.resize(np.roll(small, i, axis=1), (w, h),
                                 interpolation=cv2.INTER_LINEAR))
        out.release()
        rows.append({"question_id": v, "video_name": f"v{v}.mp4",
                     "question": "What moves across the frames",
                     "options": "A. a block of colour\nB. nothing",
                     "answer": "A"})
    qa = root / "videos.csv"
    pd.DataFrame(rows).to_csv(qa, index=False)
    return vdir, qa


def harness_igvlm(root: Path, counters, n_layers) -> dict:
    """eval_llava_multiplechoice's run over the seeded videos on the 7B
    model; returns its launches."""
    from matryoshka_mm_torch.igvlm import eval_llava_multiplechoice as mc
    from matryoshka_mm_torch.utils.cuda_graph import CapturedStep

    vdir, qa = harness_videos(root)
    args = mc.build_parser().parse_args([
        "--path_qa_pair_csv", str(qa), "--path_video", str(vdir),
        "--path_result", str(root / "videos-preds.csv"), "--model-path",
        HARNESS_MODEL, "--device", "cuda"])
    _zero(counters)
    captures = CapturedStep.captures
    t0 = time.perf_counter()
    with EvalTally() as tally:
        df, acc = mc.run(args)
    wall = time.perf_counter() - t0
    calls = tally.calls
    preds = list(df["pred"])
    if len(preds) != HARNESS_VIDEOS or not all(
            isinstance(p, str) and not p.startswith("ERROR") for p in preds):
        fail(f"harness igvlm: predictions {preds}")
    launches = _read(counters)
    _generate_gates("igvlm", calls, launches, n_layers,
                    CapturedStep.captures - captures, HARNESS_VIDEO_TOKENS)
    span = sum(c["t1"] - c["t0"] for c in calls)
    print(f"[harness igvlm] {card_line()}: {HARNESS_VIDEOS} videos of "
          f"{HARNESS_VIDEO_FRAMES} frames at {HARNESS_VIDEO_SIZE}, 6-frame "
          f"grids at the full 576 tokens: run {wall:.3f} s (load "
          f"included), generate {span / len(calls):.3f} s a video, "
          f"{wall / HARNESS_VIDEOS:.3f} s a video end to end; preds "
          f"{preds}; accuracy {acc['accuracy']:.2f} (random weights)")
    return launches


def harness_small(root: Path, data: dict, counters) -> None:
    """Phase 8's small float32 model: the llava adapter's answers at batch
    HARNESS_BATCH equal batch 1 on the card; a second llava_sglang run in
    this process answers as the llava adapter; ``loglikelihood`` on the
    card equals the CPU's within HARNESS_SMALL_TOL."""
    from matryoshka_mm_torch.lmms_eval.api.instance import Instance
    from matryoshka_mm_torch.lmms_eval.api.registry import (get_model,
                                                            register_task)
    from matryoshka_mm_torch.lmms_eval.evaluator import simple_evaluate

    path = str(small_front_model(root))
    task = harness_task(root, data, "pope_harness_small")
    resps = {}
    for bs in (1, HARNESS_BATCH):
        res = simple_evaluate(
            model="llava",
            model_args=f"pretrained={path},batch_size={bs},device=cuda",
            tasks=[task["task"]], limit=HARNESS_SMALL_DOCS,
            matryoshka_vis_token_scale=f"ver=v0_numtoks={HARNESS_SCALE}",
            log_samples=True)
        resps[bs] = [s["resps"][0] for s in res["samples"][task["task"]]]
    same = resps[1] == resps[HARNESS_BATCH]
    print(f"[harness small] float32, {card_line()}: generate_until at batch "
          f"{HARNESS_BATCH} {'equals' if same else 'DIFFERS from'} batch 1 "
          f"over {len(resps[1])} docs (first {resps[1][0]!r})")
    if not same or len(resps[1]) != HARNESS_SMALL_DOCS:
        fail("harness small: generate_until at batch 8 differs from batch 1")
    task8 = dict(task, task="pope_harness_small8")
    path8 = root / "pope_harness_small8.json"
    path8.write_text(json.dumps(json.loads(
        Path(task["dataset_path"]).read_text())[:HARNESS_SMALL_DOCS]))
    task8["dataset_path"] = str(path8)
    register_task(task8["task"], task8)
    _, served = harness_sglang(task8, counters, path, "small, second run")
    print(f"[harness small] llava_sglang answers "
          f"{'equal' if served == resps[1] else 'DIFFER from'} the llava "
          f"adapter's")
    if served != resps[1]:
        fail(f"harness small: llava_sglang answered {served}, the llava "
             f"adapter {resps[1]}")
    args = [r.arguments for r in _ll_requests(task, 3)]
    args[2] = args[2][:2] + (None,)             # a text-only request
    scale = f"ver=v0_numtoks={HARNESS_SMALL_LL_SCALE}"
    got, want = (get_model("llava")(
        pretrained=path, device=d, matryoshka_vis_token_scale=scale)
        .loglikelihood([Instance("loglikelihood", {}, a, 0, "ll", i)
                        for i, a in enumerate(args)])
        for d in ("cuda", "cpu"))
    err = max(abs(g[0] - w[0]) / abs(w[0]) for g, w in zip(got, want))
    flags = [g[1] for g in got] == [w[1] for w in want]
    print(f"[harness small] loglikelihood card vs CPU over 2 image requests "
          f"at {HARNESS_SMALL_LL_SCALE} and 1 text-only: logprobs "
          f"{[round(g[0], 4) for g in got]}, greatest relative error {err:.2e} (gate "
          f"{HARNESS_SMALL_TOL}), greedy flags "
          f"{'equal' if flags else 'DIFFER'}")
    if err > HARNESS_SMALL_TOL or not flags:
        fail("harness small: loglikelihood on the card differs from the CPU")


def phase_harness(dev) -> dict:
    """Returns the launches of the counted 7B runs, by kernel."""
    import importlib
    import tempfile

    from matryoshka_mm_torch.config import LlavaConfig

    have = []
    for name in ("yaml", "pandas", "cv2"):
        mod = importlib.import_module(name)
        have.append(f"{name} {mod.__version__}")
    print(f"[harness] {', '.join(have)} import here: the task corpus loads "
          f"from its YAML files, IG-VLM reads its csv and videos")
    frontend_modules()     # the worker's modules, imported keeping stdout
    counters = _harness_counters()
    n_layers = LlavaConfig.llava_v15_7b_m3().llama.num_hidden_layers
    t0 = [time.perf_counter()]

    def lap(what):
        gc.collect()
        torch.cuda.empty_cache()
        now = time.perf_counter()
        print(f"[time] harness {what} {now - t0[0]:.1f} s")
        t0[0] = now

    launches = {}
    with tempfile.TemporaryDirectory(prefix="m3_harness_") as tmp:
        root = Path(tmp)
        data = eval_data(root)
        task = harness_task(root, data, "pope_harness")
        _add(launches, harness_generate(task, counters, n_layers))
        lap("generate_until")
        _add(launches, harness_loglikelihood(task, counters, n_layers))
        lap("loglikelihood")
        _add(launches, harness_sglang(task, counters, HARNESS_MODEL,
                                      "7b")[0])
        lap("llava_sglang")
        _add(launches, harness_igvlm(root, counters, n_layers))
        lap("igvlm")
        harness_small(root, data, counters)
        lap("small model")
    return launches


# ---------------------------------------------------------------------------
# phase 20: tensor-parallel inference, two ranks over gloo on one card
# ---------------------------------------------------------------------------

TP_RANKS = 2
TP_SCALES = (144, 576)
# (label, bits, scales) of the quantized engines
TP_QUANT_RUNS = (("int4", 4, (144, 576)), ("int8", 8, (144,)))
# the local shapes of a 7B rank: fused qkv, o (K sharded), gate/up, down
# (K sharded), the vocabulary-sharded lm_head
TP_SHAPES = {f"tp{tp} {name}": shape for tp, shapes in (
    (2, {"qkv": (6144, 4096), "o": (4096, 2048), "gateup": (11008, 4096),
         "down": (4096, 5504), "lm_head": (16000, 4096)}),
    (4, {"qkv": (3072, 4096), "o": (4096, 1024), "gateup": (5504, 4096),
         "down": (4096, 2752), "lm_head": (8000, 4096)}))
    for name, shape in shapes.items()}
TP_ROWS = (1, 8, 640)           # a decode step, a batch of 8, a prefill at 576
TP_MLPS = ((4096, 5504), (4096, 2752))   # quant_mlp (D, I) at tp = 2 and 4
TP_MLP_ROWS = (1, 8, 32)
TP_HEADS = (16, 8)              # a rank's heads at tp = 2 and 4
TP_SMALL_TOL = 1e-5             # float32 logits: the TP sums in another order
TP_PROFILE_TOKENS = 9           # the profiled run: 8 decode steps
TP_FORCED_STEPS = 4             # 7B decode steps held against one card's


def tp_attention_cases(dev) -> dict:
    """The flash forward (640 queries against 672 slots, left-padded) and
    the decode kernel (672 slots) at a rank's heads, bf16, against their
    plain versions, two launches bit-identical, timed."""
    from matryoshka_mm_torch.ops import decode_attention as dec
    from matryoshka_mm_torch.ops import flash_attention as fl

    gen = torch.Generator(device=dev).manual_seed(21)
    Dh, Sq, Sk, pad = 128, 640, 672, 23
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    for H in TP_HEADS:
        q = _rand((1, H, Sq, Dh), gen, dev)
        k = _rand((1, Sk, H, Dh), gen, dev).transpose(1, 2)
        v = _rand((1, Sk, H, Dh), gen, dev).transpose(1, 2)
        valid = torch.zeros((1, Sk), dtype=torch.bool, device=dev)
        valid[0, pad:Sq] = True
        out, lse = fl.flash_attention_lse(q, k, v, kv_valid=valid)
        again, _ = fl.flash_attention_lse(q, k, v, kv_valid=valid)
        ref_o, ref_l = fl.flash_attention_plain(q, k, v, kv_valid=valid)
        torch.cuda.synchronize()
        err = (out.float() - ref_o.float()).abs().max().item()
        lerr = (lse - ref_l).abs().max().item()
        if not (torch.allclose(out.float(), ref_o.float(), atol=FLASH_TOL,
                               rtol=FLASH_TOL) and lerr <= LSE_TOL
                and torch.equal(out, again)):
            fail(f"flash at {H} heads: max err {err:.3e}, lse {lerr:.3e}, "
                 f"two launches the same {torch.equal(out, again)}")
        fms = time_ms(lambda *a: fl.flash_attention_lse(*a, kv_valid=valid),
                      rotations(q, k, v))
        errs["flash_attention"] = max(errs["flash_attention"], err)

        qd = _rand((1, H, Dh), gen, dev)
        kc, vc = _rand((1, Sk, H, Dh), gen, dev), _rand((1, Sk, H, Dh), gen,
                                                         dev)
        kv_pos = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
        q_pos = torch.tensor([Sq - 1], device=dev, dtype=torch.int32)
        args = (qd, kc, vc, valid, kv_pos, q_pos)
        got = dec.flash_decode_attention(*args)
        same = torch.equal(got, dec.flash_decode_attention(*args))
        want = dec.decode_attention_plain(*args)
        torch.cuda.synchronize()
        derr = (got.float() - want.float()).abs().max().item()
        if not (torch.allclose(got.float(), want.float(), atol=FLASH_TOL,
                               rtol=FLASH_TOL) and same):
            fail(f"decode at {H} heads: max err {derr:.3e}, two launches "
                 f"the same {same}")
        dms = time_ms(dec.flash_decode_attention, rotations(*args))
        errs["decode_attention"] = max(errs["decode_attention"], derr)
        n_split = dec.decode_splits(1, H, Sk, dec._sm_count(dev.index or 0))
        print(f"[tp kernels H={H}] {card_line()}: flash max|out-plain|="
              f"{err:.3e} max|lse-plain|={lerr:.3e} {fms:.4f} ms; decode "
              f"n_split={n_split} max|out-plain|={derr:.3e} {dms:.4f} ms; "
              f"two launches bit-identical")
    return errs


def _tree_copy(tree):
    """The dicts and lists of a parameter tree anew, its tensors shared: a
    tree to quantize in place while the float one stays whole."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy(v) for v in tree]
    return tree


def _k_shard_mismatches(state, leaves) -> list:
    """On a rank: the layers whose o or down shard does not dequantize to
    the columns of the whole weight (``leaves``: each layer's (o, down)
    quantized leaves, handed over as CUDA IPC handles) bit for bit."""
    from matryoshka_mm_torch.ops.quant import dequantize_array

    bad = []
    for i, (o, down) in enumerate(leaves):
        layer = state.local["layers"][i]
        for whole, shard in ((o, layer["self_attn"]["o_proj"]),
                             (down, layer["mlp"]["down_proj"])):
            w = dequantize_array(whole)
            k = w.shape[1] // state.tp
            if not torch.equal(dequantize_array(shard),
                               w[:, state.rank * k:(state.rank + 1) * k]):
                bad.append(i)
    return bad


def _peak_gib(state) -> float:
    return torch.cuda.max_memory_allocated(state.device) / 2**30


def _tp_launches(eng, label, want) -> dict:
    """Every rank's launch counters against ``want`` (the counts of one
    card, per rank); returns them summed over the ranks."""
    counts = eng.launch_counts()
    for r, c in enumerate(counts):
        print(f"[tp {label}] rank {r} launches {c}")
        if c != want:
            fail(f"tp {label}: rank {r} launched {c}, one card {want}")
    return {k: sum(c[k] for c in counts) for k in want}


def _coll_ms(fn) -> tuple:
    """``(wall ms, ms inside the TP collectives)`` of ``fn`` on rank 0,
    the second from ``torch.profiler``'s ``tp.*`` ranges."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    coll = sum(e.cpu_time_total for e in prof.key_averages()
               if e.key.startswith("tp."))
    return wall * 1e3, coll / 1e3


def tp_timings(model, inputs, label, full) -> None:
    """TTFT and ms a decode step of TP generate at scale 144 (two ranks
    sharing this card over gloo; ``full``: the wall s of the counted
    NEW_TOKENS request there), the collectives' share of a decode step
    from the profiler, and one card's generate on the same weights."""
    from matryoshka_mm_torch.generate import generate

    n = TP_SCALES[0]
    ttft = statistics.median(_wall(lambda: run(model, inputs, n, 1))
                             for _ in range(2))
    step = (full - ttft) / (NEW_TOKENS - 1) * 1e3
    w1, c1 = _coll_ms(lambda: run(model, inputs, n, 1))
    w9, c9 = _coll_ms(lambda: run(model, inputs, n, TP_PROFILE_TOKENS))
    share = (c9 - c1) / (w9 - w1)
    ids, px, mask = inputs

    def solo(tokens):
        generate(model.params, model.cfg, ids, px, attention_mask=mask,
                 matryoshka_vis_token_scale=f"ver=v0_numtoks={n}",
                 gen_cfg=_gcfg(tokens))
        torch.cuda.synchronize()

    s_ttft = statistics.median(_wall(lambda: solo(1)) for _ in range(2))
    s_full = _wall(lambda: solo(NEW_TOKENS))
    s_step = (s_full - s_ttft) / (NEW_TOKENS - 1) * 1e3
    print(f"[tp {label}] {card_line()}: two ranks sharing this card over "
          f"gloo, scale {n}, B=1: TTFT {ttft * 1e3:.2f} ms, {step:.2f} ms a "
          f"decode step ({1e3 / step:.2f} tok/s); the collectives "
          f"{(c9 - c1) / (TP_PROFILE_TOKENS - 1):.2f} ms of "
          f"{(w9 - w1) / (TP_PROFILE_TOKENS - 1):.2f} ms a profiled step "
          f"({100 * share:.1f}%, rank 0's host time in tp.* ranges); one "
          f"card on the same weights: TTFT {s_ttft * 1e3:.2f} ms, "
          f"{s_step:.2f} ms a step (captured).  Facts about two ranks on "
          f"one card over gloo, not about NCCL across cards")


def _gcfg(tokens, **kw):
    from matryoshka_mm_torch.generate import GenerationConfig

    return GenerationConfig(max_new_tokens=tokens, eos_token_id=-1, **kw)


def tp_small(dev) -> None:
    """Phase 8's small float32 model (Dh = 128, 2 heads: one a rank), two
    ranks over gloo on this card against one card and the CPU."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.generate import generate, prefill_image
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.parallel.tp_decode import TPEngine

    base = LlavaConfig.tiny_debug()
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, hidden_size=256, num_attention_heads=2,
        num_key_value_heads=2, intermediate_size=512))   # Dh = 128
    params_cpu = init_params(cfg, "cpu", seed=3)
    params_dev = _to(params_cpu, dev)
    rng = np.random.default_rng(1)
    ids = rng.integers(100, 500, (2, 12)).astype(np.int32)
    ids[:, 4] = -200
    ids[1, :3] = 0
    mask = ids != 0
    px = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    spec = "ver=v0_numtoks=4"
    greedy = _gcfg(10, decode_chunk=4)
    sampled = _gcfg(10, decode_chunk=4, do_sample=True, temperature=0.8,
                    top_p=0.9)
    eng = TPEngine(params_dev, cfg, TP_RANKS, devices=[dev] * TP_RANKS,
                   backend="gloo")
    try:
        for what, p, m in (("image", px, mask), ("text", None, mask)):
            got = eng.generate(ids, p, attention_mask=m,
                               matryoshka_vis_token_scale=spec,
                               gen_cfg=greedy)
            card = generate(params_dev, cfg, ids, p, attention_mask=m,
                            matryoshka_vis_token_scale=spec, gen_cfg=greedy)
            cpu = generate(params_cpu, cfg, ids, p, attention_mask=m,
                           matryoshka_vis_token_scale=spec, gen_cfg=greedy)
            print(f"[tp small {what}] tp {got.tolist()}\n[tp small {what}] "
                  f"one card {card.tolist()}\n[tp small {what}] cpu "
                  f"{cpu.tolist()}")
            if not (np.array_equal(got, card) and np.array_equal(got, cpu)):
                fail(f"tp small {what}: TP greedy tokens differ from one "
                     f"card's or the CPU's")
        L = 64
        want = prefill_image(params_dev, cfg, torch.as_tensor(
            ids, dtype=torch.int64, device=dev), torch.as_tensor(
            px, device=dev), torch.as_tensor(mask, device=dev), 4, L,
            L + 1)[0]
        got = eng.prefill(ids, px, attention_mask=mask,
                          matryoshka_vis_token_scale=spec)
        err = (got - want).abs().max().item()
        print(f"[tp small] prefill logits max|tp - one card| = {err:.3e} "
              f"(limit {TP_SMALL_TOL})")
        if err > TP_SMALL_TOL:
            fail("tp small: prefill logits differ from one card's")
        outs = {}
        for name, fn in (
                ("tp", lambda g: eng.generate(
                    ids, px, attention_mask=mask,
                    matryoshka_vis_token_scale=spec, gen_cfg=sampled,
                    generator=g)),
                ("eager", lambda g: generate(
                    params_dev, cfg, ids, px, attention_mask=mask,
                    matryoshka_vis_token_scale=spec, gen_cfg=sampled,
                    generator=g, cuda_graph=False)),
                ("captured", lambda g: generate(
                    params_dev, cfg, ids, px, attention_mask=mask,
                    matryoshka_vis_token_scale=spec, gen_cfg=sampled,
                    generator=g))):
            outs[name] = fn(torch.Generator(device=dev).manual_seed(7))
        print(f"[tp small sampled] tp {outs['tp'].tolist()}; one card eager "
              f"equal {np.array_equal(outs['tp'], outs['eager'])}, captured "
              f"equal {np.array_equal(outs['tp'], outs['captured'])}")
        if not np.array_equal(outs["tp"], outs["eager"]):
            fail("tp small: sampled tokens differ from one card's")
    finally:
        eng.close()


def one_card_forced(params, cfg, inputs, numtoks, tokens) -> torch.Tensor:
    """One card's teacher-forced logits (B, k + 1, V) f32: the prefill's
    last position, then an eager decode step on each column of ``tokens``
    (B, k), as ``TPEngine.forced_logits``."""
    from matryoshka_mm_torch.generate import (GenerationConfig, _decode_step,
                                              _round_up, prefill_image)

    dev = params["llama"]["embed_tokens"].device
    ids, px, mask = inputs
    L = _round_up(ids.shape[1] - 1 + numtoks, 64)
    with torch.inference_mode():
        logits, cache, lengths = prefill_image(
            params, cfg, torch.as_tensor(ids, dtype=torch.int64, device=dev),
            torch.as_tensor(px, device=dev),
            None if mask is None else torch.as_tensor(mask, device=dev),
            numtoks, L, L + tokens.shape[1])
        out = [logits]
        finished = torch.zeros(ids.shape[0], dtype=torch.bool, device=dev)
        for tok in torch.as_tensor(tokens, device=dev).unbind(1):
            out.append(_decode_step(params, cfg, GenerationConfig(), cache,
                                    tok, lengths, finished, None)[3])
            lengths = lengths + 1
    return torch.stack(out, 1).float()


def tp_7b(dev) -> dict:
    """debug://7b through load_pretrained_model(tp_size=2) with both ranks
    on this card over gloo: bf16 at TP_SCALES, then the same weights under
    load_4bit and load_8bit (fuse=False), each with exact launches per
    rank, prefill logits against one card, and the timings."""
    from matryoshka_mm_torch.models.builder import (LlavaModel,
                                                    load_pretrained_model)
    from matryoshka_mm_torch.ops.quant import quantize_llama_params
    from matryoshka_mm_torch.parallel.tp_decode import TPEngine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, model, _, _ = load_pretrained_model(
        "debug://7b", device=str(dev), tp_size=TP_RANKS,
        tp_devices=[dev] * TP_RANKS, tp_backend="gloo")
    eng = model.tp_engine
    cfg = model.cfg
    L = cfg.llama.num_hidden_layers
    peaks = [torch.cuda.max_memory_allocated(dev) / 2**30] \
        + eng.call(_peak_gib)[1:]
    print(f"[tp bf16] debug://7b made and cut into {TP_RANKS} shards in "
          f"{time.perf_counter() - t0:.1f} s; peak device memory by rank "
          f"{[f'{p:.2f} GiB' for p in peaks]} (rank 0 holds the whole model "
          f"and its shard)")
    inputs = make_inputs(cfg)[1]
    ids, px, _ = inputs
    launches = {}

    def counted(label, engine, scales, want_q, L):
        """The counted requests of an L-layer engine; returns their tokens
        and the wall s of the first."""
        engine.generate(ids, px, gen_cfg=_gcfg(1),
                        matryoshka_vis_token_scale=f"ver=v0_numtoks="
                                                   f"{scales[0]}")  # warm-up
        engine.reset_launch_counts()
        outs, walls = {}, []
        for n in scales:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[n] = engine.generate(
                ids, px, matryoshka_vis_token_scale=f"ver=v0_numtoks={n}",
                gen_cfg=_gcfg(NEW_TOKENS))
            walls.append(time.perf_counter() - t0)
            if outs[n].shape != (1, NEW_TOKENS):
                fail(f"tp {label}: output {outs[n].shape}")
        k = len(scales)
        want = {"flash_attention": k * L,
                "decode_attention": k * L * (NEW_TOKENS - 1),
                "int4_matmul": 0, "int8_matmul": 0, "quant_mlp": 0}
        want.update({name: k * n for name, n in want_q.items()})
        _add(launches, _tp_launches(engine, label, want))
        return outs, walls[0]

    def against_one_card(label, engine, params, cfg, outs):
        """The prefill logits and those of TP_FORCED_STEPS decode steps,
        teacher-forced with one card's greedy tokens, against one card's
        (each at cosine >= LOGIT_COS); the greedy tokens side by side."""
        from matryoshka_mm_torch.generate import generate

        for n, got in outs.items():
            spec = f"ver=v0_numtoks={n}"
            one = generate(params, cfg, ids, px,
                           matryoshka_vis_token_scale=spec,
                           gen_cfg=_gcfg(NEW_TOKENS))
            forced = one[:, :TP_FORCED_STEPS]
            tp_l = engine.forced_logits(ids, px, forced,
                                        matryoshka_vis_token_scale=spec)[0]
            one_l = one_card_forced(params, cfg, inputs, n, forced)[0]
            compare_logits(tp_l[0], one_l[0], f"tp {label} {n}",
                           need_same_top=False)
            cos = torch.nn.functional.cosine_similarity(tp_l[1:], one_l[1:],
                                                        dim=-1)
            finite = bool(torch.isfinite(tp_l).all())
            print(f"[tp {label} {n}] teacher-forced decode steps 1-"
                  f"{TP_FORCED_STEPS}: cosine against one card "
                  f"{[round(c, 6) for c in cos.tolist()]} finite {finite} "
                  f"(limit {LOGIT_COS})")
            if not finite or float(cos.min()) < LOGIT_COS:
                fail(f"tp {label} {n}: TP decode logits disagree with one "
                     f"card's")
            same = int((got == one).cumprod(axis=1).sum())
            print(f"[tp {label} {n}] tokens {got[0, :12].tolist()}; the "
                  f"first {same} of {NEW_TOKENS} equal one card's")

    outs, full = counted("bf16", eng, TP_SCALES, {}, L)
    against_one_card("bf16", eng, model.params, cfg, outs)
    tp_timings(model, inputs, "bf16", full)
    eng.close()

    for label, bits, scales in TP_QUANT_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        # the quantized engines at SMOKE_DEPTH layers (the script's time)
        llama = model.params["llama"]
        qparams = {**model.params, "llama": _tree_copy(
            {**llama, "layers": llama["layers"][:SMOKE_DEPTH]})}
        qcfg, qL = cut_cfg(cfg), SMOKE_DEPTH
        quantize_llama_params(qparams, bits, fuse=False)
        t0 = time.perf_counter()
        eng = TPEngine(qparams, qcfg, TP_RANKS, devices=[dev] * TP_RANKS,
                       backend="gloo")
        print(f"[tp {label}] engine up in {time.perf_counter() - t0:.1f} s")
        try:
            name = f"int{bits}_matmul"
            outs, full = counted(label, eng, scales, {
                name: 4 * qL + 1 + (NEW_TOKENS - 1) * (2 * qL + 1),
                "quant_mlp": (NEW_TOKENS - 1) * qL}, qL)
            against_one_card(label, eng, qparams, qcfg, outs)
            whole = [(layer["self_attn"]["o_proj"], layer["mlp"]["down_proj"])
                     for layer in qparams["llama"]["layers"]]
            bad = eng.call(_k_shard_mismatches, whole)
            print(f"[tp {label}] every rank's o and down K-shards of all "
                  f"{qL} layers against the whole weight's columns, "
                  f"dequantized: mismatching layers by rank {bad}")
            if any(bad):
                fail(f"tp {label}: a K-shard is not the whole weight's "
                     f"columns")
            if bits == 4:
                qmodel = LlavaModel(qparams, qcfg)
                qmodel.tp_engine = eng
                tp_timings(qmodel, inputs, label, full)
                del qmodel
        finally:
            eng.close()
        del qparams, whole
    return launches


def phase_tp(dev) -> tuple:
    """Returns the launches of the counted 7B runs, by kernel, summed over
    the ranks, and the largest error of each kernel at the shard shapes."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[time] tp {what} {now - t0[0]:.1f} s")
        t0[0] = now

    errs = quant_shape_cases(dev, TP_SHAPES, TP_ROWS, TP_MLPS, TP_MLP_ROWS,
                             seed=20, timed_rows=(1,))
    errs.update(tp_attention_cases(dev))
    lap("kernels at the shard shapes")
    tp_small(dev)
    lap("small model")
    launches = tp_7b(dev)
    lap("7B")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 21: training across ranks (parallel/sharding.py)
# ---------------------------------------------------------------------------

SHARD_SMALL_TOL = 1e-5    # small f32 model: loss, grad_norm, updated leaves
SHARD_GN_TOL = 2e-2       # 7B: grad_norm against one card, relative
SHARD_COS = 0.99          # 7B: cosine of the flattened trainable gradients
SHARD_DP_LAYERS = 2       # 7B at dp = 2: full width, fewer layers
SHARD_WAIT_S = 900        # a world's processes: killed past it
# every case of phase 21: (name, model, recipe, mesh, rows, layers)
SHARD_WORLDS = (
    (2, (("small moe (2, 1)", "small", "moe", (2, 1), 4, None),
         ("small moe (1, 2)", "small", "moe", (1, 2), 4, None),
         ("7b lora tp=2", "7b", "lora", (1, 2), 1, SMOKE_DEPTH),
         ("7b lora dp=2", "7b", "lora", (2, 1), 2, SHARD_DP_LAYERS))),
    (4, (("small moe (2, 2)", "small", "moe", (2, 2), 4, None),)),
)


def _shard_model(model, recipe, layers, dev):
    """``(params, cfg, opt_cfg)`` of a phase 21 or 22 case, the same on
    every rank: phase 11's small float32 MoE model (Dh = 128) or phase 10's
    7B LoRA recipe (bf16 base, r = 128, alpha = 256, remat), its first
    ``layers`` decoder layers where given; recipe ``qlora`` is the small
    MoE model's LoRA over a ``--bits 4`` base."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.ops.lora import add_lora
    from matryoshka_mm_torch.train.optimizer import OptimizerConfig

    if model == "small":
        base = LlavaConfig.tiny_debug(moe=SMALL_MOE if recipe in ("moe",
                                                                  "qlora")
                                      else None)
        cfg = dataclasses.replace(base, llama=dataclasses.replace(
            base.llama, hidden_size=256, num_attention_heads=2,
            num_key_value_heads=2, intermediate_size=512, remat=True))
        params = _to(init_params(cfg, "cpu", seed=4), dev)
        # eps 1: Adam's first update, lr * g / (|g| + eps), is then near
        # lr * g, not lr * sign(g), so the updated leaves can be compared
        opt_cfg = OptimizerConfig(learning_rate=1e-3, total_steps=10,
                                  adam_eps=1.0)
    else:
        from matryoshka_mm_torch.models.builder import load_pretrained_model

        _, m, _, _ = load_pretrained_model("debug://7b", device=str(dev))
        params, cfg = m.params, dataclasses.replace(
            m.cfg, llama=dataclasses.replace(m.cfg.llama, remat=True))
        opt_cfg = OptimizerConfig(learning_rate=TRAIN_LR, total_steps=10)
    if recipe == "qlora":
        from matryoshka_mm_torch.ops.quant import quantize_llama_params

        # train()'s --bits 4 base: the same leaves, unfused
        quantize_llama_params(params, bits=4, min_size=1 << 16, fuse=False)
    if recipe in ("lora", "qlora"):
        params = add_lora(params, torch.Generator(device=dev).manual_seed(1),
                          **({} if model == "7b" else {"r": 8,
                                                       "alpha": 16.0}))
        # add_lora starts lora_b at 0, which leaves every lora_a with a
        # zero gradient: a seeded start gives each one a gradient that the
        # comparison sees
        gen = torch.Generator(device=dev).manual_seed(2)
        for b in _lora_bs(params):
            b.normal_(0.0, 1e-3, generator=gen)
        opt_cfg = dataclasses.replace(opt_cfg, lora_enable=True)
    if layers:
        params["llama"]["layers"] = params["llama"]["layers"][:layers]
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
            cfg.llama, num_hidden_layers=layers))
    return params, cfg, opt_cfg


def _lora_bs(tree):
    """The ``lora_b`` leaves of ``tree``."""
    if isinstance(tree, dict):
        if "lora_b" in tree:
            yield tree["lora_b"]
            return
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _lora_bs(v)


def _shard_batch(cfg, dev, B):
    """``train_batch`` with its second half of rows holding 8 labels each,
    so that the data ranks hold different numbers of valid labels."""
    T = TRAIN_T if cfg.llama.hidden_size == 4096 else 40
    batch = train_batch(cfg, dev, T=T, B=B)
    if B > 1:
        batch.labels[B // 2:, :T - 8] = -100
    return batch


def _one_card(model, params, cfg, opt_cfg, batch, counted) -> dict:
    """The one-card reference of a phase 21 case on rank 0: the small
    model's step (its updated trainable leaves), or the 7B loss and
    gradients without the update."""
    import copy

    from matryoshka_mm_torch.train.optimizer import named_leaves
    from matryoshka_mm_torch.train.train_step import m3_loss
    from matryoshka_mm_torch.train.trainer import (create_train_state,
                                                   global_norm, host_metrics,
                                                   make_train_step)

    if model == "small":
        mine = copy.deepcopy(params)
        st, tx = create_train_state(mine, opt_cfg)
        (st, m), t, launches = counted(lambda: make_train_step(
            cfg, tx, frozen_vision=True)(st, batch))
        leaves = dict(named_leaves(mine))
        return {"metrics": host_metrics(m), "launches": launches, "s": t,
                "leaves": {p: leaves[p].detach().clone()
                           for p in tx.trainable}}
    _, tx = create_train_state(params, opt_cfg)
    leaves = dict(named_leaves(params))
    trainable = [leaves[p] for p in tx.trainable]

    def step():
        loss, _ = m3_loss(params, cfg, batch, frozen_vision=True)
        return loss.detach(), torch.autograd.grad(loss, trainable,
                                                  allow_unused=True)

    (loss, grads), t, launches = counted(step)
    return {"metrics": {"loss": float(loss),
                        "grad_norm": float(global_norm(grads))},
            "launches": launches, "s": t,
            "grads": dict(zip(tx.trainable, grads))}


def _shard_case(case, rank, dev, world):
    """One case on this rank: the one-card step on rank 0 first (the
    reference), then the placed step on every rank, counted and under the
    CPU profiler; returns rank 0's lines and errors (other ranks: none)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from matryoshka_mm_torch.parallel import make_mesh, put_batch
    from matryoshka_mm_torch.parallel.collectives import collective_seconds
    from matryoshka_mm_torch.parallel.sharding import (full_tree, local_tree,
                                                       mesh_llama_cfg,
                                                       shard_params)
    from matryoshka_mm_torch.train.optimizer import named_leaves
    from matryoshka_mm_torch.train.train_step import M3Batch
    from matryoshka_mm_torch.train.trainer import (create_train_state,
                                                   host_metrics,
                                                   make_train_step)

    name, model, recipe, shape, B, layers = case
    laps, t0 = [], [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        laps.append(f"{what} {now - t0[0]:.1f} s")
        t0[0] = now

    params, cfg, opt_cfg = _shard_model(model, recipe, layers, dev)
    batch = _shard_batch(cfg, dev, B)
    counters = _train_counters()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t, {
            k: c.launches for k, c in counters.items()}

    lap("model")
    ref = _one_card(model, params, cfg, opt_cfg, batch, counted) \
        if rank == 0 else None
    lap("one-card step")
    mesh = make_mesh(shape, device_type=dev.type)
    placed = shard_params(mesh, params)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state, tx = create_train_state(placed, opt_cfg)
    before = _frozen_checksums(local_tree(placed), tx.labels)
    grads_seen = {}
    update = tx.update

    def spy(grads, opt_state, p):
        grads_seen.update(grads)
        return update(grads, opt_state, p)

    tx.update = spy
    step_fn = make_train_step(cfg, tx, frozen_vision=True)
    rows = M3Batch(*put_batch(mesh, tuple(batch), device=dev))
    lap("placing")
    # the collectives' share: host time inside parallel/collectives.py's
    # sp.* collectives (on gloo each waits for its result)
    c0 = collective_seconds()
    (state, metrics), t, launches = counted(lambda: step_fn(state, rows))
    coll_s = collective_seconds() - c0
    lap("placed step")
    m = host_metrics(metrics)
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0)
    after = _frozen_checksums(local_tree(placed), tx.labels)
    frozen_changed = sum(before[p] != after[p] for p in before)
    leaves = dict(named_leaves(placed))
    if model == "small":
        got = full_tree({p: leaves[p] for p in tx.trainable})
    else:
        got = full_tree({p: DTensor.from_local(
            grads_seen[p], leaves[p].device_mesh, leaves[p].placements,
            run_check=False, shape=leaves[p].shape,
            stride=leaves[p].stride()) for p in tx.trainable})
    lap("gathering")
    every = [None] * world
    dist.all_gather_object(every, {"launches": launches, "peak": peak,
                                   "s": t, "coll_s": coll_s,
                                   "frozen_changed": frozen_changed})
    if rank != 0:
        return [], []
    lcfg = mesh_llama_cfg(cfg.llama, mesh)
    errors = []
    want = ref["launches"]
    rel = {k: abs(m[k] - ref["metrics"][k]) / abs(ref["metrics"][k])
           for k in ("loss", "grad_norm")}
    if model == "small":
        # the updated trainable leaves as one vector within
        # SHARD_SMALL_TOL, and each leaf within phase 11's tolerance: a
        # zero-initialized bias holds one update, whose relative error is
        # its gradient's (the router's sums over the batch cancel)
        diff = sum(float((got[p].double() - ref["leaves"][p].double())
                         .square().sum()) for p in got)
        size = sum(float(ref["leaves"][p].double().square().sum())
                   for p in got)
        flat = (diff / size) ** 0.5
        worst = max((float((got[p].float() - ref["leaves"][p].float()).abs()
                           .max() / ref["leaves"][p].abs().max()
                           .clamp(min=1e-12)), p) for p in got)
        check = (f"updated leaves {flat:.2e} as one vector, the worst leaf "
                 f"{worst[0]:.2e} of its max ({worst[1]})")
        if max(rel.values()) > SHARD_SMALL_TOL or flat > SHARD_SMALL_TOL \
                or worst[0] > SMALL_TRAIN_TOL:
            errors.append(f"{name}: leaves the one-card step ({rel}, "
                          f"{flat}, {worst})")
    else:
        num = den_a = den_b = 0.0
        for p, g in got.items():
            r = ref["grads"][p]
            if r is None:
                r = torch.zeros_like(g)
            num += float((g.double() * r.double()).sum())
            den_a += float(g.double().square().sum())
            den_b += float(r.double().square().sum())
        cos = num / max((den_a * den_b) ** 0.5, 1e-30)
        check = f"gradient cosine {cos:.6f}"
        if rel["loss"] > TRAIN_LOSS_TOL or rel["grad_norm"] > SHARD_GN_TOL \
                or not cos >= SHARD_COS:
            errors.append(f"{name}: leaves the one-card step ({rel}, "
                          f"cosine {cos})")
    for r, e in enumerate(every):
        if e["launches"] != want:
            errors.append(f"{name}: rank {r} launched {e['launches']}, "
                          f"one card {want}")
        if e["frozen_changed"]:
            errors.append(f"{name}: rank {r} changed "
                          f"{e['frozen_changed']} frozen leaves")
    lines = [
        f"[shard {name}] {card_line()}: mesh (data, model) = {shape}, "
        f"{world} ranks on one card over gloo, B={B}, "
        f"{cfg.llama.num_hidden_layers} layers, "
        f"{lcfg.num_attention_heads} heads / {lcfg.num_key_value_heads} KV "
        f"heads a rank: loss {m['loss']:.6f} (one card "
        f"{ref['metrics']['loss']:.6f}, rel {rel['loss']:.2e}), grad_norm "
        f"{m['grad_norm']:.6f} (one card {ref['metrics']['grad_norm']:.6f}, "
        f"rel {rel['grad_norm']:.2e}), {check}; launches a rank "
        f"{[e['launches'] for e in every]} (one card {want}); frozen leaves "
        f"changed {[e['frozen_changed'] for e in every]}",
        f"[shard {name}] {card_line()}: step {every[0]['s']:.3f} s (the "
        f"first; one card {ref['s']:.3f} s), its collectives "
        f"{every[0]['coll_s']:.3f} s "
        f"({100 * every[0]['coll_s'] / every[0]['s']:.1f}%, rank 0's host "
        f"time in the sp.* collectives); peak GiB by rank "
        f"{[round(e['peak'], 2) for e in every]}; rank 0: "
        + ", ".join(laps)]
    return lines, errors


def _shard_rank(rank, world, init_file, cases, out, device_type,
                probe=False):
    """One rank of a phase 21 world: a fresh process sharing the card with
    the others over gloo (and its host's cores: ``cpu_count // world``
    threads each)."""
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from matryoshka_mm_torch.parallel import initialize_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(backend="gloo", init_file=init_file, rank=rank,
                           world_size=world)
    dev = torch.device(device_type, torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    if probe:
        _gloo_probe(rank, dev)
    lines, errors = [], []
    for case in cases:
        t0 = time.perf_counter()
        got = _shard_case(case, rank, dev, world)
        errors += got[1]
        if rank == 0:
            lines += got[0] + [f"[time] shard {case[0]} "
                               f"{time.perf_counter() - t0:.1f} s"]
            print("\n".join(lines[-3:]), flush=True)
    if rank == 0:
        Path(out).write_text(json.dumps({"lines": lines, "errors": errors}))
    dist.destroy_process_group()


def shard_worlds() -> list:
    """Run each world of SHARD_WORLDS as fresh processes on the card (the
    first also probes gloo); returns the errors of every case."""
    import multiprocessing as mp
    import tempfile

    ctx = mp.get_context("spawn")
    errors = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (world, cases) in enumerate(SHARD_WORLDS):
            init, out = f"{tmp}/init{i}", f"{tmp}/out{i}.json"
            procs = [ctx.Process(target=_shard_rank,
                                 args=(r, world, init, cases, out, "cuda",
                                       i == 0))
                     for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + SHARD_WAIT_S
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in procs]
            if any(codes) or not Path(out).exists():
                errors.append(f"world {i} ({world} ranks): exit codes "
                              f"{codes}")
                continue
            errors += json.loads(Path(out).read_text())["errors"]
    return errors


def _gloo_probe(rank, dev) -> None:
    """Which collectives gloo takes on CUDA tensors between the ranks of
    this world on one card, and their ms at phase 21's sizes."""
    import torch.distributed as dist

    n = dist.get_world_size()
    for what, rows in (("the activations of the largest bucket", 3 * 1059),
                       ("one row", 1), ("an o_proj weight", 4096)):
        x = torch.ones((rows, 4096), dtype=torch.bfloat16, device=dev)
        whole = torch.ones((n * rows, 4096), dtype=torch.bfloat16,
                           device=dev)
        calls = {
            "all_reduce": lambda: dist.all_reduce(x),
            "all_gather_into_tensor":
                lambda: dist.all_gather_into_tensor(whole, x),
            "reduce_scatter_tensor":
                lambda: dist.reduce_scatter_tensor(x, whole)}
        out = {}
        for op, go in calls.items():
            try:
                go()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    go()
                torch.cuda.synchronize()
                out[op] = f"{(time.perf_counter() - t0) / 3 * 1e3:.2f} ms"
            except RuntimeError as e:     # what gloo refuses, said plainly
                out[op] = f"refused: {str(e)[:120]}"
        if rank == 0:
            print(f"[shard probe] {card_line()}: gloo, {n} processes, CUDA "
                  f"bf16 ({rows}, 4096) a rank = "
                  f"{x.numel() * 2 / 2**20:.1f} MiB, {what}: {out}",
                  flush=True)


def _dtensor_probe_rank(rank, world, init_file) -> None:
    """One rank of the DTensor probe: a bf16 (4096, 4096) part a rank,
    ``Shard(0)`` over the ranks on CUDA tensors over gloo, gathered by
    DTensor's ``redistribute``, then its backward (a reduce-scatter), then
    ``full_tensor``; rank 0 prints each as it ends."""
    import faulthandler

    faulthandler.enable()
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from matryoshka_mm_torch.parallel import initialize_distributed

    initialize_distributed(backend="gloo", init_file=init_file, rank=rank,
                           world_size=world)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    x = torch.ones((4096, 4096), dtype=torch.bfloat16, device=dev)
    d = DTensor.from_local(x, mesh, [Shard(0)], run_check=False)

    def backward():
        leaf = d.detach().requires_grad_()
        y = leaf.redistribute(mesh, [Replicate()]).to_local(
            grad_placements=[Partial()])
        y.backward(torch.ones_like(y))

    for what, go in (("redistribute to Replicate", lambda: d.redistribute(
            mesh, [Replicate()]).to_local()),
                     ("its backward from Partial", backward),
                     ("full_tensor", d.full_tensor)):
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        if rank == 0:
            print(f"[shard probe] {card_line()}: DTensor {what} taken, "
                  f"{(time.perf_counter() - t0) * 1e3:.2f} ms (the first "
                  f"call)", flush=True)
    dist.destroy_process_group()


def dtensor_probe() -> None:
    """Whether DTensor's redistribution, which runs through functional
    collectives, takes CUDA tensors over gloo: two fresh processes on this
    card (a segfault kills them, so they are not phase 21's ranks)."""
    import multiprocessing as mp
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_dtensor_probe_rank,
                             args=(r, 2, f"{tmp}/init"))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    print(f"[shard probe] {card_line()}: DTensor's redistribution on CUDA "
          f"tensors over gloo, torch {torch.__version__}, 2 processes: exit "
          f"codes {[p.exitcode for p in procs]} (negative: killed by that "
          f"signal)", flush=True)


def shard_kernel_times(dev) -> dict:
    """#1 and #3 at a 7B training rank's shapes under tp = 2 (16 heads,
    Dh 128, the 1,059- and 1,599-token buckets, causal, bf16, a
    left-padded row): kernel, plain version, bound and library ms; returns
    each kernel's largest error."""
    from matryoshka_mm_torch.ops import flash_attention as fl

    gen = torch.Generator(device=dev).manual_seed(21)
    errs = {"flash_attention": 0.0, "flash_attention_bwd_dq": 0.0,
            "flash_attention_bwd_dkv": 0.0}
    for S in (1059, 1599):
        q, k, v, valid = _flash_operands(gen, dev, torch.bfloat16, 1, 16, 16,
                                         S, S, 128, 37)
        do = torch.randn_like(q)
        out, lse = fl.flash_attention_lse(q, k, v, kv_valid=valid)
        args = (q, k, v, valid, out, lse, do)
        got = (out, fl.flash_attention_bwd_dq(*args),
               *fl.flash_attention_bwd_dkv(*args))
        want = (fl.flash_attention_plain(q, k, v, kv_valid=valid)[0],
                *fl.flash_attention_bwd_plain(*args))
        rel = [float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp(min=1.0))
               for g, w in zip(got, want)]
        if rel[0] > FLASH_TOL or max(rel[1:]) > BWD_TOL[torch.bfloat16]:
            fail(f"shard kernels at 16 heads, S={S}: {rel}")
        for name, e in zip(errs, (rel[0], rel[1], max(rel[2:]))):
            errs[name] = max(errs[name], e)
        ops = rotations(*args)
        t = {"fwd": time_ms(lambda *a: fl.flash_attention_lse(
                 *a[:3], kv_valid=a[3]), ops),
             "fwd_plain": time_ms(lambda *a: fl.flash_attention_plain(
                 *a[:3], kv_valid=a[3]), ops, reps=3, warmup=1),
             "dq": time_ms(fl.flash_attention_bwd_dq, ops, reps=10),
             "dkv": time_ms(fl.flash_attention_bwd_dkv, ops, reps=10),
             "dq_plain": time_ms(fl.flash_attention_bwd_dq_plain, ops,
                                 reps=3, warmup=1),
             "dkv_plain": time_ms(fl.flash_attention_bwd_dkv_plain, ops,
                                  reps=3, warmup=1),
             "lib": library_ms("flash", rotations(q, k, v), kv_valid=valid),
             "lib_bwd": library_ms("flash_bwd", rotations(q, k, v, do),
                                   kv_valid=valid)}
        pairs = _pairs(valid, S, S)
        b_fwd = bound(nbytes(q, k, v, out, lse), 4 * 16 * 128 * pairs)
        b_dq = bound(nbytes(q, k, v, out, do, lse, lse, q),
                     6 * 16 * 128 * pairs)
        b_dkv = bound(nbytes(q, k, v, do, lse, lse, k, v),
                      8 * 16 * 128 * pairs)
        print(f"[shard kernels S={S}] {card_line()}: 16 heads a rank "
              f"(tp = 2), errors {[f'{e:.1e}' for e in rel]}; forward "
              f"{t['fwd']:.4f} ms (plain {t['fwd_plain']:.4f}, bound "
              f"{b_fwd['bound_ms']:.4f} by {b_fwd['bound_by']}, library "
              f"{t['lib']:.4f}); dq {t['dq']:.4f} ms (plain "
              f"{t['dq_plain']:.4f}, bound {b_dq['bound_ms']:.4f}), dk/dv "
              f"{t['dkv']:.4f} ms (plain {t['dkv_plain']:.4f}, bound "
              f"{b_dkv['bound_ms']:.4f}); library backward {t['lib_bwd']:.4f} "
              f"ms", flush=True)
        del ops
    return errs


def phase_shard(dev) -> dict:
    """Phase 21: #1 and #3 at a training rank's shapes, then train steps
    across ranks that share this card over gloo, each against the
    one-card step on the same batch.  Returns the kernels' errors at the
    shard shapes."""
    gc.collect()
    torch.cuda.empty_cache()
    errs = shard_kernel_times(dev)
    gc.collect()
    torch.cuda.empty_cache()
    dtensor_probe()
    errors = shard_worlds()
    if errors:
        fail("shard: " + "; ".join(errors))
    return errs


# ---------------------------------------------------------------------------
# phase 22: the pipeline, ring attention and the placed-weight repairs, two
# ranks over gloo on one card
# ---------------------------------------------------------------------------

PIPE_STAGES, PIPE_MICRO = 2, 4
PIPE_B, PIPE_T, PIPE_PAD = 4, 1024, 100   # rows, tokens, row 3's left pad
PIPE_LAYERS = SMOKE_DEPTH
# the pipeline's hidden states and embeds gradients, and MPT's logits at
# (1, 2), are gated on bit identity with one card (the same kernels on the
# same rows, each row's sums in the same order); the cosines are printed
QUANT_COS = 0.9999        # int4 / int8 logits at (1, 2) against one card
RING_S, RING_H, RING_DH = 8192, 32, 128
RING_VALID = 7192         # the padded case: keys past it are padding
# ring attention and #1 at the ring's blocks, bf16, against a bf16 result
# and against float32 attention of the same inputs, as a share of
# max|want|: the output's rounding alone is up to half a bf16 ulp (2**-8
# of a value), two roundings may differ by one ulp (up to 2**-7), and the
# probabilities' rounding to bf16 adds to both
RING_TOL = 1e-2
RING_F32_S = 2048         # the differentiable path, float32
RING_F32_TOL = 1e-4       # of max|reference|: f32 sums in another order
MPT_LAYERS = 4            # MPT-7B widths at (1, 2), fewer layers
QUANT_LAYERS = 2          # debug://7b widths quantized at (1, 2)
PIPE_WAIT_S = 600         # the world's processes: killed past it
# the --bits 4 LoRA step of phase 21's small MoE model at both meshes
SHARD_QLORA = (("small moe qlora int4 (2, 1)", "small", "qlora", (2, 1), 4,
                None),
               ("small moe qlora int4 (1, 2)", "small", "qlora", (1, 2), 4,
                None))


def _pipe_llama_cfg(layers=PIPE_LAYERS, **kw):
    """debug://7b's decoder config (4,096 wide, 32 heads, FFN 11,008,
    bf16), ``layers`` deep."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig

    return dataclasses.replace(LlavaConfig.llava_v15_7b_m3().llama,
                               num_hidden_layers=layers, **kw)


def _pipe_layer(lc, i, dev) -> dict:
    """Decoder layer ``i`` at ``lc``'s widths, random from its own seed, so
    that a stage builds only its layers and one card the same ones."""
    gen = torch.Generator(device=dev).manual_seed(2200 + i)
    D, I, Dh = lc.hidden_size, lc.intermediate_size, lc.head_dim
    H, Hkv = lc.num_attention_heads, lc.num_key_value_heads

    def w(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16).mul_(0.02)

    ones = functools.partial(torch.ones, D, dtype=torch.bfloat16, device=dev)
    return {"input_layernorm": ones(), "post_attention_layernorm": ones(),
            "self_attn": {"q_proj": w(H * Dh, D), "k_proj": w(Hkv * Dh, D),
                          "v_proj": w(Hkv * Dh, D), "o_proj": w(D, H * Dh)},
            "mlp": {"gate_proj": w(I, D), "up_proj": w(I, D),
                    "down_proj": w(D, I)}}


def _pipe_inputs(lc, dev):
    """The pipeline's rows: embeddings, positions and validity (row 3
    left-padded by PIPE_PAD) and the cotangent of the hidden states."""
    gen = torch.Generator(device=dev).manual_seed(2201)
    shape = (PIPE_B, PIPE_T, lc.hidden_size)
    embeds = torch.randn(shape, generator=gen, device=dev,
                         dtype=torch.bfloat16)
    valid = torch.ones((PIPE_B, PIPE_T), dtype=torch.bool, device=dev)
    valid[3, :PIPE_PAD] = False
    pos = (valid.long().cumsum(1) - 1).clamp(min=0)
    cot = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    return embeds, pos, valid, cot


def pipe_one_card(dev) -> dict:
    """One card's ``llama_forward`` over all PIPE_LAYERS layers on the
    pipeline's weights and rows, forward and backward to the embeddings
    (remat, as the pipeline): the reference of the pipeline case."""
    from matryoshka_mm_torch.models.llama import llama_forward

    lc = _pipe_llama_cfg(remat=True)
    params = {"layers": [_pipe_layer(lc, i, dev) for i in range(PIPE_LAYERS)],
              "norm": torch.ones(lc.hidden_size, dtype=torch.bfloat16,
                                 device=dev)}
    embeds, pos, valid, cot = _pipe_inputs(lc, dev)

    def run():
        e = embeds.detach().requires_grad_(True)
        h, _ = llama_forward(params, lc, e, position_ids=pos,
                             attn_valid=valid)
        h.backward(cot)
        return h.detach(), e.grad

    run()                                   # warm, as the pipeline's ranks
    torch.cuda.reset_peak_memory_stats(dev)
    (hidden, grad), t, launches = _pipe_counted(_train_counters(), run)
    out = {"s": t, "launches": launches, "hidden": hidden.float().cpu(),
           "grad": grad.float().cpu(),
           "peak": torch.cuda.max_memory_allocated(dev) / 2**30}
    del params, hidden, grad
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pipe_probe_rank(rank, world, init_file) -> None:
    """One rank of the shift probe: a bf16 (1024, 4096) CUDA tensor (one
    pipeline microbatch's activations) to the other rank and back, first
    staged through the host as ``collectives.ring_shift`` does, then by
    gloo's own send and receive of the CUDA tensor; rank 0 prints each
    route's outcome as it ends (a route that kills the process shows in
    the exit codes)."""
    import faulthandler

    faulthandler.enable()
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from matryoshka_mm_torch.parallel import initialize_distributed
    from matryoshka_mm_torch.parallel.collectives import ring_shift

    initialize_distributed(backend="gloo", init_file=init_file, rank=rank,
                           world_size=world)
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((1024, 4096), float(rank), dtype=torch.bfloat16,
                   device=dev)
    peer = 1 - rank

    def say(route, what):
        if rank == 0:
            print(f"[pipe probe] {card_line()}: gloo, 2 processes, CUDA bf16 "
                  f"(1024, 4096) = 8.0 MiB, {route}: {what}", flush=True)

    group = dist.group.WORLD
    ring_shift([x], group)          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        got = ring_shift([x], group)[0]
    torch.cuda.synchronize()
    say("staged through the host (ring_shift)",
        f"{(time.perf_counter() - t0) / 3 * 1e3:.2f} ms, right values "
        f"{bool((got == peer).all())}")
    dist.barrier()
    try:
        t0 = time.perf_counter()
        send = dist.isend(x, peer)
        got = torch.empty_like(x)
        dist.irecv(got, peer).wait()
        send.wait()
        torch.cuda.synchronize()
        say("gloo's send / recv of the CUDA tensor",
            f"taken, {(time.perf_counter() - t0) * 1e3:.2f} ms, right values "
            f"{bool((got == peer).all())}")
    except RuntimeError as e:      # what gloo refuses, said plainly
        say("gloo's send / recv of the CUDA tensor",
            f"refused: {str(e)[:160]}")
    dist.destroy_process_group()


def pipe_probe() -> None:
    """Which route the ring shift takes between two ranks on this card:
    two fresh processes of their own (a crash kills them, not the
    phase's ranks)."""
    import multiprocessing as mp
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_pipe_probe_rank,
                             args=(r, 2, f"{tmp}/init")) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    # the phase's own ranks take the staged route and fail the phase if it
    # fails; here a route that kills its process is a finding to print
    print(f"[pipe probe] {card_line()}: torch {torch.__version__}, exit "
          f"codes {[p.exitcode for p in procs]} (negative: killed by that "
          f"signal, after the staged route printed)", flush=True)


def _pipe_counted(counters, fn):
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k: c.launches
                                           for k, c in counters.items()}


def _pipe_pipeline(rank, dev, tmp) -> dict:
    """The 7B decoder as PIPE_STAGES stages: this rank builds its stage's
    layers only; one warm run, then a counted one, forward and backward to
    the embeddings."""
    from matryoshka_mm_torch.parallel.collectives import collective_seconds
    from matryoshka_mm_torch.parallel.pipeline import (make_pp_mesh,
                                                       pipelined_decoder,
                                                       stage_range)

    lc = _pipe_llama_cfg(remat=True)
    mesh = make_pp_mesh(PIPE_STAGES, device_type="cuda")
    s = mesh.get_local_rank("stage")
    params = {"layers": [_pipe_layer(lc, i, dev) for i in
                         stage_range(PIPE_LAYERS, PIPE_STAGES, s)],
              "norm": torch.ones(lc.hidden_size, dtype=torch.bfloat16,
                                 device=dev)}
    embeds, pos, valid, cot = _pipe_inputs(lc, dev)
    counters = _train_counters()

    def run():
        e = embeds.detach().requires_grad_(True)
        h = pipelined_decoder(params, lc, e, pos, valid, mesh,
                              n_microbatches=PIPE_MICRO)
        h.backward(cot)
        return h.detach(), e.grad

    run()
    torch.cuda.reset_peak_memory_stats(dev)
    c0 = collective_seconds()
    (hidden, grad), t, launches = _pipe_counted(counters, run)
    torch.save({"grad": grad.float().cpu(),
                "hidden": hidden.float().cpu() if rank == 0 else None},
               f"{tmp}/pipe{rank}.pt")
    return {"s": t, "shift_s": collective_seconds() - c0, "stage": s,
            "launches": launches,
            "peak": torch.cuda.max_memory_allocated(dev) / 2**30}


def _ring_inputs(dev, S, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((1, RING_H, S, RING_DH), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype) for _ in range(4)]


RING_CASES = (("causal", True, None), ("non-causal", False, None),
              ("causal padded", True, RING_VALID))


def _exact_attention(q, k, v, **kw):
    """Float32 attention of ``q``, ``k``, ``v`` (the plain version on their
    float32 values, so no probability is rounded), eight heads at a time
    to bound the score matrix: the reference the bf16 results are held to
    by share of their largest value."""
    from matryoshka_mm_torch.ops import flash_attention as fl

    return torch.cat([fl.flash_attention_plain(
        *(t[:, h:h + 8].float() for t in (q, k, v)), **kw)[0]
        for h in range(0, q.shape[1], 8)], dim=1)


def _share(got, want) -> float:
    """max|got - want| as a share of max|want|."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _pipe_ring(rank, dev) -> tuple:
    """Ring attention over the two ranks at 7B's attention widths: each
    flash case against one card's kernel and float32 attention over the
    whole sequence (rank 0, before the ring runs), counted and timed; then the differentiable path
    in float32 against ``attention_reference``'s gradients on one card.
    Returns (rank 0's lines and errors, this rank's launches by case)."""
    from matryoshka_mm_torch.ops import flash_attention as fl
    from matryoshka_mm_torch.ops.attention import attention_reference
    from matryoshka_mm_torch.parallel import make_mesh
    from matryoshka_mm_torch.parallel.collectives import collective_seconds
    from matryoshka_mm_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh((1, 2), axis_names=("data", "seq"), device_type="cuda")
    i = mesh.get_local_rank("seq")
    Sl = RING_S // 2
    q, k, v, _ = _ring_inputs(dev, RING_S, torch.bfloat16, 2202)
    lines, errors, launches = [], [], {}
    counters = {"flash_attention": fl.flash_attention_lse}
    for name, causal, valid_to in RING_CASES:
        valid = torch.ones((1, RING_S), dtype=torch.bool, device=dev)
        if valid_to is not None:
            valid[:, valid_to:] = False
        want = exact = None
        if rank == 0:
            want = fl.flash_attention_lse(q, k, v, causal=causal,
                                          kv_valid=valid)[0]
            exact = _exact_attention(q, k, v, causal=causal, kv_valid=valid)
        blk = [t[:, :, i * Sl:(i + 1) * Sl].contiguous() for t in (q, k, v)]
        vblk = valid[:, i * Sl:(i + 1) * Sl].contiguous()
        args = (*blk, mesh)
        kw = dict(causal=causal, kv_valid=vblk, use_flash=True)
        ring_attention(*args, **kw)              # warm
        c0 = collective_seconds()
        out, t, n = _pipe_counted(counters, lambda: ring_attention(*args,
                                                                    **kw))
        shift = collective_seconds() - c0
        every = _gather_objects((out.cpu(), n, t, shift))
        launches[name] = n["flash_attention"]
        if rank == 0:
            got = torch.cat([e[0] for e in every], dim=2).to(dev)
            e = float((got.float() - want.float()).abs().max())
            rel, rel_x = _share(got, want), _share(got, exact)
            counts = [e[1]["flash_attention"] for e in every]
            expect = [r + 1 if causal else 2 for r in range(2)]
            if max(rel, rel_x) > RING_TOL:
                errors.append(f"ring {name}: {rel} of max|one card|, {rel_x} "
                              f"of max|float32 attention|")
            if counts != expect:
                errors.append(f"ring {name}: #1 launched {counts} by rank, "
                              f"expected {expect}")
            lines.append(
                f"[pipe ring {name}] {card_line()}: B=1, H={RING_H}, "
                f"Dh={RING_DH}, S={RING_S} ({Sl} a rank), bf16, use_flash: "
                f"max|ring - one card| {e:.3e}, {rel:.2e} of max|one card| "
                f"and {rel_x:.2e} of max|float32 attention| (tolerance "
                f"{RING_TOL}), #1 launches by "
                f"rank {counts} (expected {expect}); ms by rank "
                f"{[round(x[2] * 1e3, 2) for x in every]}, ring.shift share "
                f"{[round(100 * x[3] / x[2], 1) for x in every]}%")
    # the differentiable path, float32, against attention_reference
    q, k, v, g = _ring_inputs(dev, RING_F32_S, torch.float32, 2203)
    Sl = RING_F32_S // 2
    want = None
    if rank == 0:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = attention_reference(*leaves, causal=True)
        ref.backward(g)
        want = [ref.detach()] + [t.grad for t in leaves]
    blk = [t[:, :, i * Sl:(i + 1) * Sl].clone().requires_grad_(True)
           for t in (q, k, v)]
    out = ring_attention(*blk, mesh, causal=True)
    out.backward(g[:, :, i * Sl:(i + 1) * Sl])
    every = _gather_objects([t.detach().cpu() for t in
                             [out] + [b.grad for b in blk]])
    if rank == 0:
        rels = []
        for j, name in enumerate(("out", "dq", "dk", "dv")):
            got = torch.cat([e[j] for e in every], dim=2).to(dev)
            w = want[j]
            rels.append(float((got - w).abs().max()
                              / w.abs().max().clamp(min=1.0)))
        if max(rels) > RING_F32_TOL:
            errors.append(f"ring f32 gradients: {rels} of max|reference|")
        lines.append(
            f"[pipe ring f32] {card_line()}: S={RING_F32_S} ({Sl} a rank), "
            f"causal, the default path with its gradients against "
            f"attention_reference on one card: out, dq, dk, dv "
            f"{[f'{r:.2e}' for r in rels]} of max|reference| (tolerance "
            f"{RING_F32_TOL})")
    return lines, errors, launches


def _gather_objects(obj) -> list:
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, obj)
    return every


def _pipe_mpt(rank, dev) -> tuple:
    """MPT-7B widths (MPT_LAYERS layers, bf16) placed at (1, 2): every model
    rank runs the whole decoder; logits of a 64-token prompt against one
    card's (rank 0, before placing)."""
    import dataclasses

    from matryoshka_mm_torch.config import LlamaConfig, LlavaConfig
    from matryoshka_mm_torch.models.convert import _llama_tree, _random_maker
    from matryoshka_mm_torch.models.llama import llama_logits
    from matryoshka_mm_torch.parallel import make_mesh
    from matryoshka_mm_torch.parallel.sharding import (compute_view,
                                                       shard_params)

    lc = LlamaConfig.mpt_7b(num_hidden_layers=MPT_LAYERS, dtype="bfloat16")
    cfg = dataclasses.replace(LlavaConfig.llava_v15_7b_m3(), llama=lc)
    gen = torch.Generator(device=dev).manual_seed(2204)
    params = {"llama": _llama_tree(lc, _random_maker(gen, dev))}
    ids = torch.randint(0, lc.vocab_size, (1, 64), device=dev,
                        generator=gen)
    with torch.no_grad():
        want = llama_logits(params["llama"], lc, ids) if rank == 0 else None
        mesh = make_mesh((1, 2), device_type="cuda")
        view, vcfg = compute_view(shard_params(mesh, params), cfg)
        got = llama_logits(view["llama"], vcfg.llama, ids)
    if rank != 0:
        return [], []
    cos = _cosine(got, want)
    err = float((got - want).abs().max())
    line = (f"[pipe mpt (1, 2)] {card_line()}: MPT-7B widths, {MPT_LAYERS} "
            f"layers, bf16, 32 heads on each model rank (none split): logits "
            f"of 64 tokens against one card, cosine {cos:.6f}, max error "
            f"{err:.3e}, bit-identical {bool(torch.equal(got, want))}")
    return [line], ([] if torch.equal(got, want) else
                    [f"mpt (1, 2): logits differ from one card's (cosine "
                     f"{cos}, max error {err}), where they are "
                     f"bit-identical"])


def _cosine(a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0))


def _pipe_quant(rank, dev) -> tuple:
    """debug://7b widths (QUANT_LAYERS layers) under int4 and int8
    (``fuse=False``) placed at (1, 2): each rank's products on the
    quantized kernels at its shard's shapes (q/k/v and gate/up by rows, o
    and down by inputs, the int4 ones packed again at their own width);
    logits of a 64-token prompt (the prefill kernel) and of one token (the
    decode kernel) against one card's, and the launches of each."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.models.convert import _llama_tree, _random_maker
    from matryoshka_mm_torch.models.llama import llama_logits
    from matryoshka_mm_torch.ops.int4_matmul import int4_matmul, int8_matmul
    from matryoshka_mm_torch.ops.quant import quantize_llama_params
    from matryoshka_mm_torch.parallel import make_mesh
    from matryoshka_mm_torch.parallel.sharding import (compute_view,
                                                       shard_params)

    lc = _pipe_llama_cfg(QUANT_LAYERS)
    cfg = dataclasses.replace(LlavaConfig.llava_v15_7b_m3(), llama=lc)
    counters = {"int4_matmul": int4_matmul, "int8_matmul": int8_matmul}
    lines, errors, launches = [], [], {k: 0 for k in counters}
    mesh = make_mesh((1, 2), device_type="cuda")
    for bits in (4, 8):
        gen = torch.Generator(device=dev).manual_seed(2205)
        params = {"llama": _llama_tree(lc, _random_maker(gen, dev))}
        quantize_llama_params(params, bits=bits, fuse=False)
        ids = torch.randint(0, lc.vocab_size, (1, 64), device=dev,
                            generator=gen)
        with torch.no_grad():
            one = [_pipe_counted(counters, lambda x=x: llama_logits(
                params["llama"], lc, x)) for x in (ids, ids[:, :1])]
            view, vcfg = compute_view(shard_params(mesh, params), cfg)
            got = [_pipe_counted(counters, lambda x=x: llama_logits(
                view["llama"], vcfg.llama, x)) for x in (ids, ids[:, :1])]
        name = f"int{bits}_matmul"
        for _, _, n in got:
            launches[name] += n[name]
        every = _gather_objects(([g[0].cpu() for g in got],
                                 [g[2][name] for g in got]))
        if rank == 0:
            want_n = [o[2][name] for o in one]
            coss = [_cosine(g[0], o[0]) for g, o in zip(got, one)]
            for r, (_, n) in enumerate(every):
                if n != want_n:
                    errors.append(f"int{bits} (1, 2): rank {r} launched "
                                  f"{name} {n}, one card {want_n}")
            if min(coss) < QUANT_COS:
                errors.append(f"int{bits} (1, 2): logits cosine {coss} "
                              f"(limit {QUANT_COS})")
            lines.append(
                f"[pipe int{bits} (1, 2)] {card_line()}: debug://7b widths, "
                f"{QUANT_LAYERS} layers, fuse=False, 16 heads a rank: logits "
                f"cosine against one card {[f'{c:.6f}' for c in coss]} "
                f"(limit {QUANT_COS}; 64 "
                f"tokens, 1 token); {name} launches by rank "
                f"{[e[1] for e in every]} (one card {want_n})")
        del params, view
    return lines, errors, launches


def _pipe_beam(rank, dev) -> tuple:
    """beam_generate on phase 8's small float32 model placed at (1, 2) by
    ``shard_model_for_inference`` (which pins reference attention): its
    tokens against one card's, reference attention too (rank 0, before
    placing)."""
    import dataclasses

    from matryoshka_mm_torch.config import LlavaConfig
    from matryoshka_mm_torch.generate import GenerationConfig, beam_generate
    from matryoshka_mm_torch.models.convert import init_params
    from matryoshka_mm_torch.parallel import (make_mesh,
                                              shard_model_for_inference)

    base = LlavaConfig.tiny_debug()
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, hidden_size=256, num_attention_heads=2,
        num_key_value_heads=2, intermediate_size=512,
        attn_impl="reference"))
    params = init_params(cfg, str(dev), seed=3)
    rng = np.random.default_rng(22)
    ids = rng.integers(100, 500, (1, 12)).astype(np.int32)
    ids[0, 4] = -200
    px = rng.standard_normal((1, 3, 56, 56)).astype(np.float32)
    kw = dict(num_beams=3, matryoshka_vis_token_scale="ver=v0_numtoks=4",
              gen_cfg=GenerationConfig(max_new_tokens=8, eos_token_id=-1))
    want = beam_generate(params, cfg, ids, px, **kw) if rank == 0 else None
    placed, pcfg, _ = shard_model_for_inference(
        params, cfg, mesh=make_mesh((1, 2), device_type="cuda"))
    got = beam_generate(placed, pcfg, ids, px, **kw)
    every = _gather_objects(got.tolist())
    if rank != 0:
        return [], []
    same = all(e == want.tolist() for e in every)
    return ([f"[pipe beam (1, 2)] {card_line()}: small float32 model, 3 "
             f"beams, 8 tokens: one card {want.tolist()}, placed by rank "
             f"{every}, equal {same}"],
            [] if same else ["beam (1, 2): tokens differ from one card"])


def _pipe_rank(rank, world, tmp, out) -> None:
    """One rank of phase 22's world: a fresh process sharing the card with
    the other over gloo (``cpu_count // world`` threads)."""
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from matryoshka_mm_torch.parallel import initialize_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(backend="gloo", init_file=f"{tmp}/init",
                           rank=rank, world_size=world)
    dev = torch.device("cuda", torch.cuda.current_device())
    lines, errors, times = [], [], []

    def lap(what, t0):
        times.append(f"{what} {time.perf_counter() - t0:.1f} s")
        return time.perf_counter()

    t0 = time.perf_counter()
    pipe = _pipe_pipeline(rank, dev, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = lap("pipeline", t0)
    ring_lines, ring_errors, ring_launches = _pipe_ring(rank, dev)
    t0 = lap("ring", t0)
    mpt = _pipe_mpt(rank, dev)
    t0 = lap("mpt", t0)
    qlines, qerrors, qlaunches = _pipe_quant(rank, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = lap("int4/int8", t0)
    beam = _pipe_beam(rank, dev)
    t0 = lap("beam", t0)
    for case in SHARD_QLORA:
        got = _shard_case(case, rank, dev, world)
        lines += got[0]
        errors += got[1]
    lap("qlora", t0)
    every = _gather_objects({"pipe": pipe, "ring": ring_launches,
                             "quant": qlaunches})
    if rank == 0:
        lines = ring_lines + mpt[0] + qlines + beam[0] + lines + [
            f"[pipe] rank 0: " + ", ".join(times)]
        errors = ring_errors + mpt[1] + qerrors + beam[1] + errors
        Path(out).write_text(json.dumps({
            "lines": lines, "errors": errors, "ranks": every}))
    dist.destroy_process_group()


def pipe_kernel_errors(dev) -> dict:
    """#1 and #3 at a pipeline microbatch's shapes (one row of 1,024
    tokens, 32 heads, Dh 128, bf16, left-padded) against their plain
    versions, and #1 at the blocks a ring step gives it (4,096 queries
    against 4,096 keys, 32 heads, Dh 128, bf16): an earlier rank's block
    (full), the rank's own (diagonal-causal) and a block of padding keys
    only (every lse -1e30, a zero output), against the plain version and
    float32 attention.  Returns each kernel's largest error, as phase 21
    reports them."""
    from matryoshka_mm_torch.ops import flash_attention as fl

    gen = torch.Generator(device=dev).manual_seed(2206)
    q, k, v, valid = _flash_operands(gen, dev, torch.bfloat16, 1, 32, 32,
                                     PIPE_T, PIPE_T, 128, PIPE_PAD)
    do = torch.randn_like(q)
    out, lse = fl.flash_attention_lse(q, k, v, kv_valid=valid)
    args = (q, k, v, valid, out, lse, do)
    got = (out, fl.flash_attention_bwd_dq(*args),
           *fl.flash_attention_bwd_dkv(*args))
    want = (fl.flash_attention_plain(q, k, v, kv_valid=valid)[0],
            *fl.flash_attention_bwd_plain(*args))
    mb = [float((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp(min=1.0))
          for g, w in zip(got, want)]
    if mb[0] > FLASH_TOL or max(mb[1:]) > BWD_TOL[torch.bfloat16]:
        fail(f"pipe kernels at a microbatch's shapes: {mb}")
    print(f"[pipe kernels] {card_line()}: a microbatch (1 x {PIPE_T}, 32 "
          f"heads, Dh 128, bf16, {PIPE_PAD} pad): forward, dq, dk, dv "
          f"{[f'{e:.1e}' for e in mb]} of max|plain|", flush=True)
    del q, k, v, do, args, got, want
    Sl = RING_S // 2
    q, k, v, _ = _ring_inputs(dev, Sl, torch.bfloat16, 2207)
    ring = []
    for block in ("full", "diagonal", "keyless"):
        valid = torch.full((1, Sl), block != "keyless", dtype=torch.bool,
                           device=dev)
        kw = dict(causal=block == "diagonal", kv_valid=valid)
        out, lse = fl.flash_attention_lse(q, k, v, **kw)
        want_o, want_l = fl.flash_attention_plain(q, k, v, **kw)
        lerr = float((lse - want_l).abs().max())
        if block == "keyless":
            rel = rel_x = float(out.float().abs().max())
            ok = bool((lse == fl.LSE_MASKED).all()) and not out.any()
            say = (f"every lse {fl.LSE_MASKED:g} "
                   f"{bool((lse == fl.LSE_MASKED).all())}, max|out| {rel:g}")
        else:
            rel = _share(out, want_o)
            rel_x = _share(out, _exact_attention(q, k, v, **kw))
            ok = max(rel, rel_x) <= RING_TOL
            say = (f"{rel:.2e} of max|plain| and {rel_x:.2e} of "
                   f"max|float32 attention| (tolerance {RING_TOL})")
        print(f"[pipe kernels] {card_line()}: #1 at a ring block ({block}, "
              f"1 x {Sl} queries x {Sl} keys, 32 heads, Dh 128, bf16): {say}, "
              f"max|lse - plain| {lerr:.1e} (tolerance {LSE_TOL})",
              flush=True)
        if not ok or lerr > LSE_TOL:
            fail(f"pipe kernels: #1 at a ring block ({block}): {say}, lse "
                 f"error {lerr}")
        ring.append(max(rel, rel_x))
    return {"flash_attention": max(mb[0], *ring),
            "flash_attention_bwd_dq": mb[1],
            "flash_attention_bwd_dkv": max(mb[2:])}


def phase_pipe(dev) -> tuple:
    """Phase 22: the ring shift probe; one card's reference of the 7B
    pipeline; then one world of two ranks on this card over gloo: the
    pipeline, ring attention, MPT at (1, 2), the quantized products at
    their shard shapes, beam search on placed weights and the --bits 4 LoRA
    step.  Returns (the main path's launches, the kernels' errors)."""
    import multiprocessing as mp
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    errs = pipe_kernel_errors(dev)
    pipe_probe()
    ref = pipe_one_card(dev)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/out.json"
        procs = [ctx.Process(target=_pipe_rank, args=(r, 2, tmp, out))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + PIPE_WAIT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes) or not Path(out).exists():
            fail(f"pipe: world of 2 ranks exit codes {codes}")
        res = json.loads(Path(out).read_text())
        got = [torch.load(f"{tmp}/pipe{r}.pt") for r in range(2)]
    errors = list(res["errors"])
    ranks = res["ranks"]
    hidden = got[0]["hidden"]
    cos_h = _cosine(hidden, ref["hidden"])
    err_h = float((hidden - ref["hidden"]).abs().max())
    cos_g = [_cosine(g["grad"], ref["grad"]) for g in got]
    err_g = [float((g["grad"] - ref["grad"]).abs().max()) for g in got]
    if err_h != 0 or any(err_g):
        errors.append(f"pipeline: max error {err_h} (hidden), {err_g} "
                      f"(embeds gradient by rank) against one card, where "
                      f"they are bit-identical (cosines {cos_h}, {cos_g})")
    # a stage runs L / S layers for each of M microbatches; remat runs each
    # layer's forward again in the backward
    per = PIPE_LAYERS // PIPE_STAGES * PIPE_MICRO
    want = {"flash_attention": 2 * per, "flash_attention_bwd_dq": per,
            "flash_attention_bwd_dkv": per}
    for r, e in enumerate(ranks):
        if e["pipe"]["launches"] != want:
            errors.append(f"pipeline: rank {r} launched "
                          f"{e['pipe']['launches']}, expected {want}")
    p = [e["pipe"] for e in ranks]
    print(f"[pipe 7b] {card_line()}: debug://7b's decoder ({PIPE_LAYERS} "
          f"layers, 4,096 wide, bf16, remat), S={PIPE_STAGES} stages of "
          f"{PIPE_LAYERS // PIPE_STAGES} layers, M={PIPE_MICRO}, B={PIPE_B} "
          f"x {PIPE_T} tokens, forward and backward to the embeddings: "
          f"hidden cosine {cos_h:.6f} (max error {err_h:.3e}), embeds "
          f"gradient cosine by rank {[f'{c:.6f}' for c in cos_g]} (max error "
          f"{[f'{e:.3e}' for e in err_g]}) against one card's llama_forward; "
          f"launches by rank {[x['launches'] for x in p]} (expected {want}; "
          f"one card {ref['launches']})", flush=True)
    print(f"[pipe 7b] {card_line()}: step {[round(x['s'], 3) for x in p]} s "
          f"by rank (one card {ref['s']:.3f} s), the shift's share "
          f"{[round(100 * x['shift_s'] / x['s'], 1) for x in p]}% (host time "
          f"in pp.shift / pp.broadcast), peak GiB by rank "
          f"{[round(x['peak'], 2) for x in p]} (one card "
          f"{ref['peak']:.2f})", flush=True)
    print("\n".join(res["lines"]), flush=True)
    if errors:
        fail("pipe: " + "; ".join(errors))
    launches = {}
    for e in ranks:
        for k, n in e["pipe"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
        launches["flash_attention"] += sum(e["ring"].values())
        for k, n in e["quant"].items():
            launches[k] = launches.get(k, 0) + n
    return launches, errs


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 23: the JAX package's orbax checkpoints
# ---------------------------------------------------------------------------

ORBAX_FIXTURE = REPO / "tests" / "data" / "torch_orbax"
ORBAX_DECODE_REPS = 20
ORBAX_WEIGHTS = "fp16_l1_check"


def orbax_decoder() -> None:
    """The decoder built on this host and held against the committed
    frames; its MB/s on the largest one."""
    import hashlib

    from matryoshka_mm_torch.native import zstd

    t0 = time.perf_counter()
    zstd.lib()
    build_s = time.perf_counter() - t0
    table = json.loads((ORBAX_FIXTURE / "frames.json").read_text())
    frames = {name: (ORBAX_FIXTURE / "frames" / f"{name}.zst").read_bytes()
              for name in table}
    for name, entry in table.items():
        data = zstd.decompress(frames[name])
        if len(data) != entry["size"] or \
                hashlib.sha256(data).hexdigest() != entry["sha256"]:
            fail(f"orbax: zstd frame {name} decodes to other bytes")
    rates = []
    # the largest frame, and the level-1 float16 one (a weight-like chunk,
    # as the JAX package writes them: mostly Huffman-coded literals)
    for name in (max(frames, key=lambda n: len(frames[n])), ORBAX_WEIGHTS):
        out = bytearray(table[name]["size"])
        t0 = time.perf_counter()
        for _ in range(ORBAX_DECODE_REPS):
            zstd.decompress_into(frames[name], out)
        secs = (time.perf_counter() - t0) / ORBAX_DECODE_REPS
        rates.append(f"{name} ({len(frames[name])} bytes, level "
                     f"{table[name]['level']}, {table[name]['size']} "
                     f"decoded) {table[name]['size'] / 1e6 / secs:.1f} MB/s")
    print(f"[orbax] zstd decoder built in {build_s:.2f} s; {len(table)} "
          f"committed frames decode to their SHA-256; decoded on one host "
          f"core, mean of {ORBAX_DECODE_REPS}: " + "; ".join(rates))


def orbax_tiny(dev, counters) -> dict:
    """The committed JAX-written tiny checkpoint served in float32 on the
    card: the JAX tokens recorded beside it; launches of #1 and #2."""
    from matryoshka_mm_torch.generate import GenerationConfig, generate
    from matryoshka_mm_torch.models.builder import load_pretrained_model

    rec = json.loads((ORBAX_FIXTURE / "tokens.json").read_text())
    _, model, _, _ = load_pretrained_model(str(ORBAX_FIXTURE / "ckpt"),
                                           device=str(dev))
    cfg = model.cfg
    if cfg.llama.dtype != "float32" or model.params["llama"][
            "embed_tokens"].dtype != torch.float32:
        fail("orbax: the tiny checkpoint did not load in float32")
    ids = np.asarray(rec["input_ids"], np.int32)
    px = np.random.default_rng(rec["pixel_seed"]).standard_normal(
        rec["pixel_shape"]).astype(np.float32)
    for fn in counters.values():
        fn.launches = 0
    got = generate(model.params, cfg, ids, px,
                   matryoshka_vis_token_scale=rec[
                       "matryoshka_vis_token_scale"],
                   gen_cfg=GenerationConfig(**rec["gen"]))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    L, n = cfg.llama.num_hidden_layers, rec["gen"]["max_new_tokens"]
    expect = dict.fromkeys(counters, 0)
    expect.update(flash_attention=L, decode_attention=(n - 1) * L)
    print(f"[orbax] JAX-written tiny checkpoint (float32, {L} layers, Dh "
          f"{cfg.llama.head_dim}): tokens {got.tolist()}, JAX's "
          f"{rec['tokens']}; launches {launches} expected {expect}")
    if got.tolist() != rec["tokens"] or launches != expect:
        fail("orbax: the JAX-written tiny checkpoint does not give the JAX "
             "tokens through the kernels")
    return launches


def orbax_load(label, path, dev, **kw):
    """load_pretrained_model on an orbax directory, timed as timed_load
    times phase 12's: seconds, GB/s of the files, device memory at the
    peak, the host's peak RSS."""
    from matryoshka_mm_torch.models.builder import load_pretrained_model

    files = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    drop_page_cache(*{f.parent for f in path.rglob("*") if f.is_file()})
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rss_before = PeakRss.now()
    t0 = time.perf_counter()
    with PeakRss() as rss:
        out = load_pretrained_model(str(path), device=str(dev), **kw)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"[orbax] {card_line()}: {label}: read {files / 1e9:.2f} GB in "
          f"{secs:.2f} s ({files / 1e9 / secs:.2f} GB/s; phase 12's "
          f"safetensors bf16 load in this call: "
          + (f"{LOAD_GB_S['bf16']:.2f} GB/s" if "bf16" in LOAD_GB_S
             else "not run") +
          f"); device memory +{(torch.cuda.max_memory_allocated() - before) / 2**30:.2f}"
          f" GiB at its peak, +{(torch.cuda.memory_allocated() - before) / 2**30:.2f}"
          f" GiB held; host RSS {rss_before / 2**30:.2f} GiB before, "
          f"{rss.peak / 2**30:.2f} GiB at its peak (page cache dropped "
          f"first)")
    return out


def phase_orbax(dev) -> dict:
    """The JAX package's orbax checkpoint format on the card host: the
    decoder, the JAX-written tiny checkpoint, debug://7b written by
    save_checkpoint and read back in bf16 and under load_4bit.  Returns
    the launch counts of the counted requests."""
    import dataclasses
    import shutil
    import tempfile

    from matryoshka_mm_torch.models.builder import (_quantize,
                                                    load_pretrained_model)
    from matryoshka_mm_torch.ops import fused_mlp, int4_matmul
    from matryoshka_mm_torch.ops.decode_attention import flash_decode_attention
    from matryoshka_mm_torch.ops.flash_attention import flash_attention_lse
    from matryoshka_mm_torch.train.optimizer import named_leaves
    from matryoshka_mm_torch.utils.checkpoint import save_checkpoint

    counters = {"int4_matmul": int4_matmul.int4_matmul,
                "quant_mlp": fused_mlp.quant_mlp,
                "decode_attention": flash_decode_attention,
                "flash_attention": flash_attention_lse}
    orbax_decoder()
    total = orbax_tiny(dev, counters)

    torch.cuda.empty_cache()
    _, ref, _, _ = load_7b(dev)
    cfg = ref.cfg
    L = cfg.llama.num_hidden_layers
    inputs = make_inputs(cfg)
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in named_leaves(ref.params))
    path = Path(tempfile.mkdtemp(prefix="m3_orbax_"))
    try:
        free = shutil.disk_usage(path).free
        if free < 1.05 * nbytes:
            fail(f"orbax: {free / 1e9:.1f} GB free beside {path}, the "
                 f"checkpoint takes {nbytes / 1e9:.1f} GB")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with PeakRss() as rss:
            save_checkpoint(str(path), ref.params, cfg)
            os.sync()
        secs = time.perf_counter() - t0
        files = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
        print(f"[orbax] {card_line()}: save_checkpoint of debug://7b ({L} "
              f"layers, bf16, {nbytes / 1e9:.2f} GB of leaves): wrote "
              f"{files / 1e9:.2f} GB in {secs:.2f} s ({files / 1e9 / secs:.2f}"
              f" GB/s, synced) to {path}, of {free / 1e9:.1f} GB free; "
              f"device memory +{(torch.cuda.max_memory_allocated() - before) / 2**30:.2f}"
              f" GiB at its peak; host RSS {rss.peak / 2**30:.2f} GiB at "
              f"its peak")

        # ---- bf16: every leaf and 32 tokens ----
        _, model, _, _ = orbax_load("bf16", path, dev)
        bad = _same_leaves(model.params, ref.params)
        want = run(ref, inputs[1], BATCH_SCALE, NEW_TOKENS)
        got, launches = counted_request(model, inputs[1], BATCH_SCALE,
                                        counters)
        expect = dict.fromkeys(counters, 0)
        expect.update(flash_attention=L,
                      decode_attention=(NEW_TOKENS - 1) * L)
        print(f"[orbax] bf16: {len(list(named_leaves(model.params)))} "
              f"leaves, {len(bad)} differ; config equal {model.cfg == cfg};"
              f" {NEW_TOKENS} tokens at {BATCH_SCALE} equal "
              f"{np.array_equal(got, want)}; launches {launches} expected "
              f"{expect}")
        if bad or model.cfg != cfg or not np.array_equal(got, want) \
                or launches != expect:
            fail(f"orbax: the bf16 read is not debug://7b: {bad[:4]}")
        for k in total:
            total[k] += launches[k]
        del model

        # ---- load_4bit: the model in memory quantized in place ----
        _, model, _, _ = orbax_load("load_4bit", path, dev, load_4bit=True)
        _quantize(ref.params, False, True, True)
        bad = _same_leaves(model.params, ref.params)
        want = run(ref, inputs[1], BATCH_SCALE, NEW_TOKENS)
        got, launches = counted_request(model, inputs[1], BATCH_SCALE,
                                        counters)
        steps = NEW_TOKENS - 1
        expect = {"int4_matmul": (4 * L + 1) + steps * (2 * L + 1),
                  "quant_mlp": steps * L, "decode_attention": steps * L,
                  "flash_attention": L}
        print(f"[orbax] load_4bit: {len(bad)} leaves differ from the model "
              f"in memory under load_4bit; tokens equal "
              f"{np.array_equal(got, want)}; launches {launches} expected "
              f"{expect}")
        if bad or not np.array_equal(got, want) or launches != expect:
            fail(f"orbax: the load_4bit read differs: {bad[:4]}")
        for k in total:
            total[k] += launches[k]
        del model, ref
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return total


def timed(phase, dev):
    """Run one phase; print its wall seconds."""
    t0 = time.perf_counter()
    out = phase(dev)
    print(f"[time] {phase.__name__} {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=()) -> int:
    if not (REPO / "matryoshka_mm_torch" / "csrc").is_dir():
        print("chip_smoke: the matryoshka_mm_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    if argv:
        # a subset for work on one phase: `chip_smoke.py kernels quant slice
        # qslice paged hbm serve smallinfer bwd train small ckpt anyres
        # genmodes families famkernels lora frontend eval harness tp shard
        # pipe orbax` runs phases 3 (attention kernels), 3 (quantized
        # products), 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, phase 3's
        # cases at the families' shapes, 16, 17, 18, 19, 20, 21, 22 and 23
        # alone and prints no result line
        for name in argv:
            phases = {"kernels": phase_kernels, "quant": phase_quant_kernels,
             "slice": phase_slice, "smallinfer": phase_small,
             "qslice": phase_quant_slice, "paged": phase_paged_kernels,
             "hbm": phase_hbm, "serve": phase_serving,
             "bwd": phase_bwd_kernels, "train": phase_train,
             "small": phase_train_small, "ckpt": phase_ckpt,
             "anyres": phase_anyres, "genmodes": phase_genmodes,
             "families": phase_families, "famkernels": phase_family_kernels,
             "lora": phase_lora, "frontend": phase_frontend,
             "eval": phase_eval, "harness": phase_harness, "tp": phase_tp,
             "shard": phase_shard, "pipe": phase_pipe,
             "orbax": phase_orbax}
            timed(phases[name], dev)
        print(f"partial run {argv}: no result")
        return 1
    rec = timed(phase_kernels, dev)
    rec.update(timed(phase_quant_kernels, dev))
    launches = timed(phase_slice, dev)["launches"]
    quant_launches = timed(phase_quant_slice, dev)
    for k, n in quant_launches.items():
        launches[k] = launches.get(k, 0) + n
    rec.update(timed(phase_paged_kernels, dev))
    hbm_rec, hbm_launches, read_gb_s = timed(phase_hbm, dev)
    rec.update(hbm_rec)
    launches.update(hbm_launches)
    for k, n in timed(phase_serving, dev).items():
        launches[k] = launches.get(k, 0) + n
    timed(phase_small, dev)
    rec.update(timed(phase_bwd_kernels, dev))
    for k, n in timed(phase_train, dev).items():
        launches[k] = launches.get(k, 0) + n
    timed(phase_train_small, dev)
    for k, n in timed(phase_ckpt, dev).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in timed(phase_anyres, dev).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in timed(phase_genmodes, dev).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in timed(phase_families, dev).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in timed(phase_lora, dev).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in timed(phase_frontend, dev).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in timed(phase_eval, dev).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in timed(phase_harness, dev).items():
        launches[k] = launches.get(k, 0) + n
    tp_launches, tp_errs = timed(phase_tp, dev)
    for k, n in tp_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, e in tp_errs.items():
        rec[k]["err"] = max(rec[k]["err"], e)
    for k, e in timed(phase_shard, dev).items():
        rec[k]["err"] = max(rec[k]["err"], e)
    pipe_launches, pipe_errs = timed(phase_pipe, dev)
    for k, n in pipe_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, e in pipe_errs.items():
        rec[k]["err"] = max(rec[k]["err"], e)
    for k, n in timed(phase_orbax, dev).items():
        launches[k] = launches.get(k, 0) + n
    if [m for m in sys.modules
            if m.split(".")[0] in ("jax", "matryoshka_mm_tpu")]:
        fail("jax or the JAX package was imported")
    sources = {
        "flash_attention": ("flash_attention.cu",
                            "matryoshka_mm_tpu/ops/flash_attention.py:59"),
        "decode_attention": ("decode_attention.cu",
                             "matryoshka_mm_tpu/ops/decode_attention.py:53"),
        "int4_matmul": ("quant_matmul.cu",
                        "matryoshka_mm_tpu/ops/int4_matmul.py:198"),
        "int8_matmul": ("quant_matmul.cu",
                        "matryoshka_mm_tpu/ops/int4_matmul.py:316"),
        "quant_mlp": ("fused_mlp.cu", "matryoshka_mm_tpu/ops/fused_mlp.py:96"),
        "paged_attention": ("paged_attention.cu",
                            "matryoshka_mm_tpu/ops/paged_attention.py:71"),
        "hbm_read": ("hbm_probe.cu", "matryoshka_mm_tpu/ops/hbm_probe.py:36"),
        "hbm_copy": ("hbm_probe.cu", "matryoshka_mm_tpu/ops/hbm_probe.py:56"),
        "flash_attention_bwd_dq": (
            "flash_attention_bwd.cu",
            "matryoshka_mm_tpu/ops/flash_attention.py:199"),
        "flash_attention_bwd_dkv": (
            "flash_attention_bwd.cu",
            "matryoshka_mm_tpu/ops/flash_attention.py:267"),
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"matryoshka_mm_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": rec[name]["err"], "ms": rec[name]["ms"],
                "plain_ms": rec[name]["plain_ms"],
                "bound_ms": rec[name]["bound_ms"],
                "bound_by": rec[name]["bound_by"],
                "library_ms": rec[name]["library_ms"]}
               for name, (src, replaces) in sources.items()]
    ratio = HBM_BYTES_S / 1e9 / read_gb_s
    print(f"[bounds] {card}: bytes over the measured hbm_read rate "
          f"({read_gb_s:.1f} GB/s) instead of {HBM_BYTES_S / 1e9:.0f} GB/s: "
          + ", ".join(f"{k['name']} {k['bound_ms'] * ratio:.4f} ms"
                      for k in kernels if k["bound_by"] == "bytes"))
    if any(k["launches"] <= 0 for k in kernels):
        fail("a kernel of the main path was never launched")
    print(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
