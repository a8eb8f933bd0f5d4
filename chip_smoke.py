#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase, then the result lines
    python3 chip_smoke.py --only 2d,3d   # those phases alone, no result line

Drives ``repro_torch`` only (never JAX, never ``repro``), in phases; any
failure exits non-zero and none is caught:

1. build the four CUDA kernel libraries from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all started
   together), print ptxas's registers and spills, and check that the
   bitserial, flash and paged kernels spill nothing;
2. hold the bitserial kernel against its plain PyTorch version at the
   main path's shapes (granite-3-2b's projections at M 4 and 512, f32 and
   bf16, per-tensor and per-group scales; gemma3-12b's 7 projections in
   bf16 at decode, M 2, and at its 2 x 4096-token prefill, M 8192;
   the MoE slices' projections and heads in bf16 at the M their paths
   run: qwen2-moe-a2.7b's 2048 x 2048 at M 8, 2048 and 4096 and its 2048
   x 152064 head at M 4 and 8, phi3.5-moe's 4096 x 4096 and 4096 x 1024
   at M 4 and 1024 and its 4096 x 32256 head at M 4; recurrentgemma-9b's
   4096 x 4096, 4096 x 256 (its one K/V head), 4096 x 12288 and 12288 x
   4096 at its decode M 8; llama-3.2-vision-11b's 4096 x 14336, 14336 x
   4096 and 4096 x 128256 head at M 4 and its cross K/V projection, 4096
   x 1024, at M 1600 and 6400; musicgen-large's shapes are granite's M 4
   rows), check a second call
   bitwise equal, ``active=a`` bitwise against
   ``truncate_packed`` for every a, and that decode runs the split-K
   kernel and bf16 prefill the wgmma tile (the profiler names both; a
   profiler session whose trace holds no device event is taken again),
   and time the kernel, the plain version and ``torch.matmul`` against
   the dequantised weight (a yardstick only; the port never calls it),
   with each prefill row's TFLOP/s and share of the bf16 peak, and each
   layer's 7 projections summed; then the runtime plane count (a device
   tensor) at the M of the policies' serving path (8 lanes, the verify's
   8 x 4 rows, and 40) on granite-3-2b's projections, f32 and bf16,
   bitwise against the static kernel over ``truncate_packed`` at the same
   M for every a, timed beside it;
2b. hold the paged-attention kernel against its plain version at the
   continuous slices' shapes (granite-3-2b's d 64, G 4: f32, bf16, one
   windowed case; gemma3-12b's global layers, d 256, G 2: f32, bf16; the
   MoE slices' d 128 at G 1 (qwen2-moe, MHA) and G 4 (phi3.5-moe, and
   llama-3.2-vision-11b): f32, bf16; musicgen-large's d 64 at G 1; ragged
   positions with inactive lanes), check that scrambled stale
   table entries and NaN in never-live blocks leave its output bitwise
   unchanged, and time the kernel, the plain version and one
   ``scaled_dot_product_attention`` call on K/V already gathered into
   lane-contiguous form (a yardstick only; kernel and SDPA as the median
   of 5 timings, since calls of tens of microseconds swing up to 2x);
2c. hold the grouped bgl_sumsq kernel (per-row sums of squares, the BSQ
   regulariser's) against its plain version one view at a time at the
   training slice's shapes and two ragged ones, f32 and bf16, and at the
   plane views of the paper pipeline's ResNet-20, reduced qwen2-moe and
   train_lm_bsq's lm-100m (f32), within 1e-5 of each row's plain value, a
   second call bitwise equal, timed beside one ``torch.linalg.vector_norm``
   call; then grouped, one launch per BSQ step's regulariser call
   (phase 6's 1-layer granite-3-2b's 16 views, 11.66 GB; ResNet-20's 44; reduced
   qwen2-moe's 24; lm-100m's 18, 5.81 GB), forward within 1e-5 per row,
   bitwise each view's one-view call and a second call, and the backward
   kernel (one launch) bitwise the plain ``x * (2 g)[:, None]`` and
   ``torch._foreach_mul``; each timed beside its bound, the one-view calls
   summed (forward) or the plain per-view ops (backward), one library call
   (``torch._foreach_norm`` over the row views forward,
   ``torch._foreach_mul`` backward; yardsticks only) and the wrapper's
   host time;
2d. hold the flash-attention kernel against its plain version at the
   prefill shapes (granite-3-2b's bucket, gemma3-12b's 2 x 4096 tokens
   causal and with window 1024, a non-causal case, a ragged length,
   qwen2-moe's 4 x 1024 tokens at d 128 MHA, phi3.5-moe's 4 x 256 at d
   128 G 4, recurrentgemma-9b's 2 x 4096 tokens at d 256 G 16, window
   2048, llama-3.2-vision-11b's 4 x 1024 at d 128 G 4, musicgen-large's 4
   x 1024 at d 64 MHA),
   f32 within 1e-5 and bf16 within 2e-2 of max |plain|, a second call
   bitwise equal, and time the kernel, the plain version and one
   ``scaled_dot_product_attention`` call (a yardstick only); 2b and 2d
   print each row's rate, its share of the bound and kernel / SDPA;
3. full-width granite-3-2b cut to 1 layer (2 until phase 6g), f32, 6-bit packed: the card
   (kernels) against the CPU (plain path) on the same params;
3b. the same 1-layer model through the continuous paged-kernel engine
   on the card (3 requests of 16-44 prompt tokens and 4 new on 2 lanes,
   reused), the bucketed engine on the card and the continuous engine on
   the CPU: identical greedy tokens (phase 3's 2 new tokens and 3b's
   short prompts keep the CPU side, the script's slowest host work,
   short);
3c. reduced granite-3-2b, f32: two BSQ train steps from one state on
   the card and on the CPU agree within 1e-5 relative, and the masks
   after a requant are equal; then one BSQ step's gradients under every
   remat policy ("nothing", "dots", "mlp_names", "dots_offload"): the
   card's bitwise those with remat off or within phase 3's tolerance (the
   largest difference printed), the CPU's bitwise, card against CPU within
   phase 3's tolerance;
3d. full-width gemma3-12b cut to one superblock (5 local + 1 global
   layers), f32, 6-bit packed, card against CPU through the bucketed
   engine (a 2048-token prompt wraps every ring in prefill, a 1020-token
   one wraps it in decode) and the chunked paged-kernel engine: every
   logit row within the phase-3 tolerance, identical greedy tokens;
3e. full-width granite-3-2b cut to 1 layer (2 before PR 25), f32, through
   the continuous paged-kernel engine with the scheduler policies, card
   against CPU: precision tiers with a forced degrade schedule, spec
   decode, and overcommit that
   preempts; identical tokens, plane logs and counts, the card's replay
   of each plane log equal to its tokens, spec tokens equal to a
   non-speculative run's, the host syncs of each spec round counted;
3f. full-width qwen2-moe-a2.7b cut to 2 layers, f32, 6-bit packed, card
   against CPU (the same weights unpacked to f32) through the bucketed
   engine (prompts of 64 and 200 tokens) and the chunked paged-kernel
   engine (chunks of 64, 4 lanes): the CPU routes every MoE call as the
   card did (routing is a step function of gates that the two sum in
   other orders; the tokens that would have routed otherwise are
   counted), every logit row within the phase-3 tolerance, identical
   greedy tokens, launches exact, the share of dropped assignments
   printed; then phase 3c's two BSQ steps on reduced qwen2-moe;
3g. the recurrent mixers, f32, card against CPU: mamba2-130m at full
   width and depth (24 SSD layers, nothing packable) and recurrentgemma-9b
   at full width cut to one superblock (rglru, rglru, local; 6-bit packed,
   the CPU holding the weights unpacked) with its 256000-row tied head:
   ``forward``, the bucketed engine (prefill and 8 decode steps) and the
   chunked paged-kernel engine (4 lanes, chunks of 64); every logit row
   within the phase-3 tolerance, identical greedy tokens, launches exact;
3h. the frontends, f32, card against CPU: llama-3.2-vision-11b at full
   width cut to one superblock (4 "attn" + 1 "attn+cross"), 6-bit packed
   (the CPU holding the weights unpacked), 1600 random cross tokens per
   lane: ``forward``, ``prefill`` and 8 ``decode_step`` calls with the
   cross embeds, ``prefill_chunk`` and paged-kernel ``decode_step`` with
   them, one decode step at a device-tensor ``active_planes`` bitwise the
   step on ``truncate_packed`` weights; musicgen-large at full width cut
   to 2 layers, ``embeds`` through ``prefill`` and ``decode_step``; every
   logit row within the phase-3 tolerance, greedy tokens identical,
   launches exact;
4. full-width granite-3-2b cut to 10 of its 40 layers (``SLICE_LAYERS``),
   bf16, 6-bit packed, served by the
   bucketed ServeEngine (8 requests, two buckets, 32 tokens each), with
   the bitserial and flash launch counts checked exactly;
4b. the continuous slice: the same model through
   ``ServeEngine(continuous=True, paged=True, paged_kernel=True)`` (8
   lanes, 64 blocks of 32 rows), 16 requests on Poisson arrivals, with
   the kernels' launch counts checked exactly and the pool drained;
4d. the policies' slice: the same model, traffic and engine on 40 blocks
   overcommitted 1.5x: the quality probe at 1..6 planes and its tier
   table, then half the requests "economy" with the degrade loop (it
   must preempt and shed or restore), then spec decode (3 draft planes,
   gamma 4; it must accept a draft), the runtime-plane launches checked
   exactly against the scheduler's own count of calls that passed a
   plane count, TTFT, decode ms per step, tokens/s and the bf16
   agreement of the replay and of spec with phase 4b's tokens printed;
5. ``torch.profiler`` over a few decode steps of one bucket, and over a
   short continuous run: device busy time, idle share and the device
   ops by time;
4c. full-width 48-layer gemma3-12b, bf16, 6-bit packed: bucketed (2 x
   4096 and 2 x 1024 prompt tokens, 32 new each; exactly 48 flash
   launches per prefill call, 40 windowed) and continuous (chunked,
   paged, the paged kernel; 8 lanes, 12 requests with prompts uniform in
   [512, 3072] on Poisson arrivals, so that lanes serve a second request;
   exactly 8 paged launches per decode step, the pool drained), and a
   profiled decode step;
4e. full-width, full-depth qwen2-moe-a2.7b (24 layers, 60 routed experts
   top-4 and 4 shared, MHA, untied 152064-row head), bf16, 6-bit packed
   attention and head, bf16 experts: bucketed (two buckets of 4, prompts
   of 128 and 1024 tokens, 32 new each; exactly 97 bitserial launches per
   prefill call or decode step and 24 flash per prefill call) and
   continuous (chunks of 256, paged, the paged kernel; 8 lanes, 256
   blocks of 32 rows, 16 requests with prompts uniform in [64, 1024] on
   Poisson arrivals; exactly 24 paged launches per decode step, the pool
   drained): TTFT beside its operation bound, decode ms per step beside
   its byte bound (the experts the step's routing needs, and every
   expert, which the dense (E, C) dispatch reads), tokens/s, peak
   memory, the
   weights' bytes, the dropped share per mode, a profiled decode step
   with the expert products' device time, and one layer's expert
   products by CUDA events;
4f. phi3.5-moe-42b-a6.6b at its full width cut to 4 of 32 layers (its
   experts, never packed, would take 80.5 GB in bf16), bf16, 6-bit
   packed: bucketed, 4 requests of 256 prompt tokens, 16 new, launches
   exact;
4g. full-width, full-depth recurrentgemma-9b (38 layers: 12 x (rglru,
   rglru, local) + 2 rglru; one K/V head of 256, window 2048, GeGLU,
   256000-row tied head), bf16, 6-bit packed attention and MLP, the
   RG-LRU matrices held in bf16 (checked): bucketed (2 x 4096 and 2 x 1024
   prompt tokens, 32 new; the 4096 ones wrap the rings in prefill) and
   continuous (chunks of 256, the paged policy, 8 lanes, 16 requests with
   prompts uniform in [512, 3072] on Poisson arrivals); launches exact
   (bitserial on the 162 packed projections of each model call, flash once
   per prefill call and local layer, paged never); TTFT beside its
   operation bound, decode ms per step beside its byte bound (every weight
   once, the RG-LRU state read and written, the ring rows), tokens/s, peak
   memory, weight bytes, a profiled decode step;
4h. full-width, full-depth mamba2-130m (24 SSD layers), bf16: bucketed (4 x
   256 and 4 x 1024 prompt tokens, multiples of its ssm_chunk) and
   continuous (chunks of 256, the paged policy, 8 lanes, 16 requests with
   prompts in [64, 1024]); the same numbers, and every kernel's launch
   count 0 (the model has none on its path);
4i. full-width, full-depth llama-3.2-vision-11b (40 layers, 8 of them
   "attn+cross"), bf16, 6-bit packed: the model API with the cross
   sublayers live (buckets of 4 x 128 and 4 x 1024 prompt tokens, 1600
   cross tokens per request, 32 new tokens through ``prefill`` and
   ``decode_step(cross_embeds=)``; the cross K and V are projected anew at
   every step, as in JAX), then the continuous paged-kernel engine (8
   lanes, 16 requests, prompts uniform in [128, 1024] on Poisson
   arrivals; text only, as JAX's engine serves it); launches exact (313
   bitserial per model call with the cross sublayers, 281 without, 40
   flash per prefill, 40 paged per decode step); TTFT and decode ms per
   step beside their bounds, tokens/s, peak memory, weight bytes and a
   profiled decode step with the cross K/V products' device time;
4j. full-width, full-depth musicgen-large (48 MHA layers of 32 heads of
   64), bf16, 6-bit packed: ``prefill`` of 4 x 1024 embed frames and 32
   ``decode_step`` calls fed (4, 1, 2048) embeds, then the bucketed engine
   on tokens (4 x 256 and 4 x 1024) and the continuous paged-kernel engine
   (prompts in [64, 1024]); launches exact (289 bitserial per model call,
   48 flash per prefill, 48 paged per decode step);
4k. serving on a 2x2 ("data", "model") mesh: 4 ranks on the one card
   (``launch.mesh.run_on_mesh``, backend gloo: NCCL refuses two ranks on
   one GPU), each holding its block of every weight and of the KV pool.
   First paged over 4 lanes x 4 K/V heads and flash over 2 lanes x 4 K/V
   heads against their plain versions; then on the ranks: which
   collectives gloo takes on CUDA tensors (a probe); the phase-3 model
   (2 layers, f32, 6-bit) through the bucketed engine and the model API,
   greedy tokens equal and logits within 1e-4 of the same model in this
   process on the card, every rank's logits bitwise alike; then granite-3-2b
   cut to 6 of its 40 layers (``MESH_LAYERS``, 10 until phase 6g): f32
   prefill logits against this process (printed); bf16 bucketed (4 x 128
   tokens), continuous with the paged kernel (4 requests on 8 lanes, one
   128-token chunk per prompt) and spec decode (5 of 6 planes drafting,
   under which drafts are accepted: at least one must be), each rank's packed bytes
   (a quarter), kernel launches (bitserial static and runtime, paged and
   flash, each non-zero on every rank), decode ms per step, TTFT and
   collectives.  Then bitserial against its plain version at every
   (M, K, N, dtype) the ranks gave it (recorded on each rank), at least
   a rank's four blocks at M 4, 8, 512 and 1024 in bf16 and M 4 and 512
   in f32, ``active=a`` bitwise ``truncate_packed``; last, at that depth
   in bf16, the ranks' prefill logits against this process's, plain and
   computing each product as two K halves added as the ranks add them
   (the witness of where the tokens part; agreements printed), and the
   bucketed tokens against this process's; its decode ms per step on a
   line of its own;
4l. every other layer kind and the MoE FFN on the same 2x2 mesh, each
   model at its published widths cut to the smallest depth that holds
   each of its kinds (``MESH_KINDS``: gemma3-12b 6 layers, its rings
   split over K/V heads; recurrentgemma-9b 3, its one K/V head's ring
   split over slots and the RG-LRU state over lanes; mamba2-130m 6 of
   24 (all 24 before phase 6g took the time);
   llama-3.2-vision-11b 5 with 1600 cross tokens a lane; qwen2-moe-a2.7b
   2, 30 of 60 experts a rank).  This process's f32 references first (the
   bucketed engine's tokens, the model API's logits, the MoE routing);
   then
   one spawn of the ranks runs each model: f32 parity (tokens equal,
   logits within 1e-4 of max(1, max|logit|), bitwise alike on every
   rank; a routing that differs
   from one process's must be a near-tie, and takes its experts), then
   bf16 6-bit bucketed (4 x 256) and continuous with the paged kernel,
   each rank's packed and float bytes against the whole model's,
   launches of bitserial, paged and flash (windowed apart) checked
   non-zero exactly where the model's kinds run them, scheduler digests
   alike, decode ms per step, TTFT and collectives per decode step
   printed; the vision model's decode with its cross tokens timed.
   Then each kernel against its plain version at every shape the ranks
   gave it (``_record_kernel_shapes``), at least recurrentgemma's
   windowed prefill on half the query heads of its K/V head, gemma3's
   paged decode on 4 of 8 K/V heads and the cross K/V at M 6400;
6. the BSQ training slice: full-width granite-3-2b cut to 1 layer (2
   until phase 6f took their time),
   trained through ``repro_torch.launch.train.run``: 4 steps with a
   requant at steps 2 and 4 and no checkpoint (until phase 6h took their
   time, a checkpoint at step 2, 16 GB, and a second run resumed from it,
   its restore held bit for bit; 6f's reduced checkpoints and the CPU
   tests hold checkpoint I/O now).  The bgl_sumsq launches are
   checked exactly (one grouped forward and one backward launch per
   step, and no serving kernel launches), every step's loss
   finite (the config's remat, "nothing", as JAX
   trains); then the final scheme, ``export_packed``, a profile of two
   train steps and 4 requests served from the exported packed weights
   through the bitserial and flash kernels; last, where activations set
   the peak (4 full-width layers, float weights, one 4096-token
   sequence), the loss's gradients per remat policy ("none", "nothing",
   "dots", "mlp_names", "dots_offload"): median ms and peak
   ``max_memory_allocated`` beside the dry run's meta estimate, checked
   nothing < dots <= none, nothing < mlp_names < none, and dots_offload
   about nothing's device bytes (its saved set in host memory);
6b. full-width ResNet-20 (width 16), f32, one batch of 64 gaussian_blobs
   images: two BSQ steps of the paper pipeline from one state on the card
   and on the CPU, the CPU fed the card's 4-bit activations (each input
   held against the card's, the ones that round to the other level
   counted): losses within 1e-5 relative, plane gradients within 1e-4 of
   their max, masks after a requant equal;
6c. the paper's pipeline through ``repro_torch.examples.resnet20_bsq_paper``
   at its defaults (width 16, batch 64, 60 BSQ steps, requant every 20),
   then 30 steps of the DoReFa finetune under the found scheme: the
   bgl_sumsq launches checked exactly (one forward and one backward per
   BSQ step over its 44 views, none while finetuning), no serving kernel,
   every loss finite; ms per step beside
   the step's bound, peak memory, bits/param, compression, per-layer
   bits, held-out top-1, and a profile of three BSQ steps;
6d. the LM examples at their defaults, each one's kernel launches
   checked exactly: quickstart, serve_quantized (the packed export served
   through the bitserial and flash kernels, its greedy tokens printed),
   fault_tolerance (resumes from its own checkpoint) and train_lm_bsq cut
   to 40 steps without a workdir (the card machine's disk);
6e. the dry run's counter (``repro_torch.roofline.analysis`` on meta
   tensors) against the card: ``roofline.hw``'s data-sheet figures beside
   the card's memory and SM count; phase 4's decode step (40-layer
   granite-3-2b, bf16, 6-bit, 4 lanes at 128 + 32 positions) and phase
   6's BSQ train step (2 layers, batch 8 x 64) each run on the card and
   counted on meta: the packed tree's (the state's) bytes and the kernel
   launches equal exactly, the measured median step at least the
   analysis bound (the eager port's own op traffic), its share of that
   bound and of the limit no implementation passes (the weights and
   cache read once; the state read and written once), the term that
   bounds it and the top 5 ops by bytes printed; the counter's FLOPs and bytes of each phase-2
   bitserial call exactly ``bitserial_work``'s.  The dry-run CLI runs as
   processes on the host beside phases 3-3h, waited for before phase 4,
   so that no timed phase runs beside them (``DRYRUNS``): ``python -m
   repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k``
   printing ``[ok]``, and the production meshes,
   granite-3-2b x train_4k and x decode_32k on 16x16 and 2x16x16 as rank
   0 sees them, and hillclimb's A3 (16x16) and A6 (2x16x16): each record
   ``ok``, JAX's microbatches (16 and 8), collective bytes non-zero; each
   one's memory, terms and collective bytes by kind printed (computed,
   the collective term at one NVLink direction), A6 read against A3;
6f. BSQ training on a ("data", "model") mesh: 4 gloo ranks on the card
   (``launch.mesh.run_on_mesh``).  On 2x2, full-width granite-3-2b cut to
   1 layer (2 until phase 6g), f32 (activations too), 2 steps of 4 x 64 tokens through
   ``train.step.make_bsq_train_step(mesh=)`` and a third at microbatches
   2, hoisted (each rank's rows its block of each microbatch): each rank holds its block
   of every plane, moment and batch (FSDP over "data", Megatron pairs
   over "model"); its launches (exactly 3 + 3 bgl_sumsq, nothing else),
   its kernel against the plain version on its own plane rows (backward
   bitwise), its state's sampled fingerprints and its export of the
   trained blocks (``core.bsq.export_packed_blocks``) served through one
   bucketed decode; then, after the ranks exit, one process trains the
   same model on the whole batches: losses within 1e-5 (the clipped
   second step's gradient norm 1e-4), sampled state within 1e-4 of each
   block's max |x|, each rank's planes and sign bytes equal to the block
   of the one process's export (scales within 1e-5), tokens equal.  The
   reduced config's step-2 checkpoint from 2x2 resumes on 4x1 to step 4
   within 1e-5 of one process's 4 steps; a compressed BSQ step on 4x1
   (params alike on every rank, 1 + 1 launches per rank).  The kernel at
   a rank's row shapes is timed beside its bound, plain version and
   ``_foreach_norm``/``_foreach_mul``;
6g. BSQ training of every other layer kind on the same 2x2 mesh, f32, 2
   steps of 4 x 64 tokens each: mamba2-130m at its published width and
   all 24 layers (about 7 GB of BSQ state a rank), and reduced
   qwen2-moe-a2.7b (2 of 4 experts a "model" rank, their (layer, expert)
   groups split), recurrentgemma-9b (rglru and a local layer of one K/V
   head), gemma3-12b (local) and llama-3.2-vision-11b ("+cross", random
   cross embeds): per rank and model exactly 2 + 2 bgl_sumsq launches
   and nothing else, each rank's kernel against its plain version on its
   own rows (the split expert rows among them; backward bitwise), the
   routing near-ties counted; after the ranks exit, one process trains
   each model on the whole batches: losses within 1e-5, the first
   gradient norm within 1e-4 and the next within ``MK_GRAD_NORM_TOL``,
   sampled state within 1e-4 of each block's max |x| (the reps' scales
   and their moments within ``MK_SCALE_TOL``; a leaf that starts at zero,
   a sum of gradients, may instead meet 1e-5 plus 2e-4 |x|), and the last step's
   worst gradient leaves printed.
   Then ``bgl_sumsq`` at a full-width qwen2-moe-a2.7b rank's expert rows
   of one layer (w_gate and w_up (1, 30, 2048, 704), w_down (1, 30, 704,
   2048), 8 planes, wp and wn: 8.30 GB f32) against its plain version,
   timed beside its bound, the plain version, ``_foreach_norm`` and
   ``_foreach_mul``;
6h. BSQ training on a 2x2x2 ("pod", "data", "model") mesh: 8 gloo ranks
   sharing the card, f32, 2 steps of 8 x 64 tokens, then one at
   microbatches 2 hoisted and one not: mamba2-130m at its published
   width cut to the depth ``ph_depth`` reckons (printed: each pod holds a
   second copy of the BSQ state), reduced granite-3-2b and qwen2-moe-a2.7b
   (its router loss summed over both data axes); per rank and model
   exactly 5 + 5 bgl_sumsq launches (1 a plain or hoisted step, 2 the
   other) and nothing else, its kernel on its own rows against its plain
   version; after the ranks exit one process runs the same steps on the
   whole batches, held by 6g's bars; granite's export served through one
   bucketed decode on the 8 ranks gives one process's tokens, and
   bitserial and flash hold to their plain versions at every shape the
   ranks gave them; each rank's collective bytes of one step of the dry
   run's train config equal the dry run's meta count on 2x2x2 exactly;
   collectives and seconds per step printed beside one process's;
7. a ``{"kernels": [...]}`` line (the bitserial, runtime-plane, paged
   and flash entries add phase 4k's launches, summed over its ranks, and
   their times at a rank's shapes; the bitserial, paged and flash entries
   phase 4l's launches and the count and worst error of the shapes its
   ranks gave them; the bitserial decode and prefill
   entries, the runtime-plane entry with phase 4d's launches, flash and
   paged also carry ``vs_library``, their time over the library call's:
   below 1 beats it; the bitserial, flash, paged and bgl_sumsq entries
   add the MoE and recurrent phases' launches and the kernels at their
   shapes; the
   bgl_sumsq forward and backward entries carry the grouped times,
   phase 6f's launches per rank and times at a rank's rows, phase
   6g's launches and times at the expert rows, and phase 6h's launches;
   the bitserial and flash entries 6h's served launches and the shapes
   its ranks gave them), the
   card's name and power limit, and the final ``{"ok": true, ...}``
   line.

Exits non-zero without a CUDA device, and when the repo's ``src`` is not
beside it.  The per-shape table goes to ``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import gc
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
# the card's data-sheet rates (HBM bytes/s; FLOP/s by dtype, f32 outside the
# tensor cores, bf16 dense), set by main() from repro_torch.roofline.hw, the
# one source of them: the script imports the port only once it has found it
HBM_BYTES_PER_S = None
PEAK_FLOPS = None
N_BITS = 6
MATMUL_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
# the 7 projections of one granite-3-2b layer, as (K, N)
LAYER_PROJ = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
              (2048, 8192), (2048, 8192), (8192, 2048)]
# ... and of one gemma3-12b layer (q, k, v, o, gate, up, down), timed in
# bf16 at decode (M 2, a bucket of 2) and at its 2 x 4096-token prefill
GEMMA3_PROJ = [(3840, 4096), (3840, 2048), (3840, 2048), (4096, 3840),
               (3840, 15360), (3840, 15360), (15360, 3840)]
GEMMA3_M = (2, 8192)
# the MoE slices' packed projections, as ((K, N), the M values their paths
# run), in bf16.  qwen2-moe-a2.7b (phase 4e): q, k, v and o are 2048 x 2048,
# at 8 lanes (continuous decode), a chunk of 8 lanes x 256 tokens and the
# 4 x 1024-token bucket (M 4 and 512, the bucket of 4 x 128, are granite's
# rows above); its untied head (2048 x 152064) runs on each lane's last
# token only: M 4 (a bucket) and 8 (the lanes).  phi3.5-moe-42b-a6.6b
# (phase 4f, a bucket of 4 x 256 tokens): q and o 4096 x 4096, k and v
# 4096 x 1024 at M 4 and 1024, its head 4096 x 32256 at M 4
QWEN2_PROJ, QWEN2_HEAD = (2048, 2048), (2048, 152064)
PHI_PROJ = [(4096, 4096), (4096, 1024)]
PHI_HEAD = (4096, 32256)
MOE_ROWS = [(QWEN2_PROJ, (8, 2048, 4096)), (QWEN2_HEAD, (4, 8))] \
    + [(kn, (4, 1024)) for kn in PHI_PROJ] + [(PHI_HEAD, (4,))]
# recurrentgemma-9b's 7 packed projections of a local layer (q, k, v, o, and
# the GeGLU gate, up, down), as (K, N): its one K/V head of 256 makes k and v
# 4096 x 256 (an rglru layer packs only the MLP); timed in bf16 at M 8, the
# decode M of its continuous run (8 lanes)
RG_PROJ = [(4096, 4096), (4096, 256), (4096, 256), (4096, 4096), (4096, 12288),
           (4096, 12288), (12288, 4096)]
RG_ROWS = [(kn, (8,)) for kn in sorted(set(RG_PROJ))]
# llama-3.2-vision-11b (phases 2, 4i): a layer's q, k, v, o (32 query heads
# on 8 K/V heads of 128) and SwiGLU gate, up, down, as (K, N), and its untied
# head, at the decode M of a bucket of 4 (q, k, v, o are phi3.5-moe's M 4
# rows); its cross sublayers' k and v project every cross token of every
# lane at every model call, prefill and decode: M 1600 (one request) and
# 6400 (a bucket of 4)
VISION, AUDIO = "llama-3.2-vision-11b", "musicgen-large"
VISION_PROJ = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096), (4096, 14336),
               (4096, 14336), (14336, 4096)]
VISION_HEAD = (4096, 128256)
VISION_CROSS_KV = (4096, 1024)
VISION_CROSS_M = (1600, 6400)
# musicgen-large (phases 2, 4j): q, k, v, o (32 MHA heads of 64), the GELU
# MLP's up and down and its 2048-row head at M 4; every one of these shapes
# is a granite-3-2b row of phase 2 at M 4
MUSICGEN_PROJ = [(2048, 2048)] * 4 + [(2048, 8192), (8192, 2048)]
MUSICGEN_HEAD = (2048, 2048)
FRONTEND_ROWS = [((4096, 14336), (4,)), ((14336, 4096), (4,)), (VISION_HEAD, (4,)),
                 (VISION_CROSS_KV, VISION_CROSS_M)]
# the frontends' serving runs (phases 4i, 4j): 32 new tokens, prompts up to
# 1024 tokens, continuous on 8 lanes with 256 blocks of 32 rows, chunks of 256
F_MAX_NEW, F_MAX_LEN, F_N_BLOCKS = 32, 1024 + 32, 256
# phase 3g holds the card to the CPU within phase 3's tolerance, or within
# this many times the logit change that a one-step f32 nudge of every
# embedding value causes on the CPU, whichever is larger: full-depth mamba2
# amplifies rounding past 1e-4 of its logits (PERF.md §6)
ROUNDING_FACTOR = 4
# the recurrent slices' serving runs (phases 4g, 4h): chunks of 256, 32 new
R_CHUNK, R_MAX_NEW = 256, 32
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of max |plain|, see phase 2
# paged attention, of max |plain|: f32, an online softmax against a
# one-pass one; bf16, the kernel rounds K to q's dtype and p to V's dtype
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PAGED_REPEATS = 5  # time_ms runs whose median times a paged call
# the continuous slice (phase 4b): 8 lanes, 64 blocks of 32 rows
SLOTS, BLOCK, N_BLOCKS, MAX_LEN = 8, 32, 64, 512
# phases 4, 4b, 5 and 4d's granite-3-2b: 10 of its 40 layers, cut to keep
# the script well inside its time limit beside the mesh phases (40 until
# phase 4l, 20 until phase 6g)
SLICE_LAYERS = 10
# the policies' slice (phase 4d): 40 blocks overcommitted 1.5x; draft
# steps at 3 of 6 planes, up to 4 a round; the runtime-plane kernel's M
# values on that path (phase 2): 8 lanes, the verify chunk 8 x 4, and 40
P_BLOCKS, P_OVERCOMMIT, DRAFT_PLANES, GAMMA = 40, 1.5, 3, 4
ACTIVE_M = (SLOTS, SLOTS * GAMMA, 40)
# gemma3-12b's continuous run (phase 4c): 8 lanes, 512 blocks of 32 rows,
# prompts up to 3072 tokens and 32 new ones
G_MAX_LEN, G_N_BLOCKS = 3104, 512
# the MoE slices: qwen2-moe-a2.7b's continuous run (phase 4e) on 8 lanes,
# 256 blocks of 32 rows, chunks of 256, prompts up to 1024 tokens and 32 new
# ones; the 2-layer parity (3f) in chunks of 64 on 4 lanes
Q_MAX_LEN, Q_N_BLOCKS, Q_CHUNK, Q_MAX_NEW = 1024 + 32, 256, 256, 32
# phases 3f and the MoE train parity impose the card's routing on the CPU;
# at most this share of the routed tokens may have routed otherwise there
# (a near-tie of f32 gates summed in another order).  A wrong gate or top-k
# on the card would show as far more
ROUTE_DIFFER_SHARE = 0.01
# phase 6's depth: 1 layer since phase 6f (2 before; a checkpoint of the
# 2-layer state took 70 s to write and 90 s to read)
TRAIN_LAYERS = 1
# bgl_sumsq (phase 2c): the (bits x groups, rest) plane views of phase 6's
# BSQ train step of full-width granite-3-2b (9 planes; TRAIN_LAYERS layers
# per stacked tensor, a group each), and two ragged shapes
BGL_EMBED, BGL_QO, BGL_KV, BGL_MLP = (9, 101_187_584), (9 * TRAIN_LAYERS, 4_194_304), \
    (9 * TRAIN_LAYERS, 1_048_576), (9 * TRAIN_LAYERS, 16_777_216)
BGL_SHAPES = [BGL_MLP, BGL_QO, BGL_KV, BGL_EMBED, (7, 1_000_003), (1, 33)]
# the 16 views of one train step's regulariser call (one grouped launch): wp
# and wn of the embedding, wq, wo, wk, wv and the three MLP projections
BGL_STEP = [BGL_EMBED] * 2 + [BGL_QO] * 4 + [BGL_KV] * 4 + [BGL_MLP] * 6
BGL_TOL = 1e-5  # of each row's plain value: f32 sums of non-negative terms
# ... and the paper pipeline's plane views (phases 2c, 6b, 6c): each of
# ResNet-20's 22 quantised tensors (width 16, in name order) is one group
# of 9 planes, a (9, numel) view; a BSQ step's regulariser call groups wp
# and wn of each, 44 views over 270,896 parameters, in one launch
RESNET_TENSOR_C = [432, 640] + [2304] * 6 + [4608, 9216, 512] + [9216] * 4 \
    + [18432, 36864, 2048] + [36864] * 4
RESNET_BGL_SHAPES = sorted({(9, C) for C in RESNET_TENSOR_C})
# the paper pipeline (phase 6c) at its defaults, then the DoReFa finetune
RESNET_WIDTH, RESNET_BATCH, RESNET_STEPS, RESNET_FT_STEPS = 16, 64, 60, 30
# phase 6b: each quantised activation's input, card against CPU, within
# this share of the layer's max |input| (f32 convs summed in other orders)
RESNET_ACT_TOL = 1e-4
# the training slice (phase 6)
# steps; requant and checkpoint interval (8 and 4 before phase 6g took the time)
TRAIN_STEPS, TRAIN_INTERVAL = 4, 2


def checked_engine_cls():
    from repro_torch.serve import ServeEngine

    class CheckedEngine(ServeEngine):
        """Counts non-finite logits without a host sync per step."""
        bad = None

        def _sample(self, logits, temperatures, any_hot):
            import torch

            nonfinite = (~torch.isfinite(logits)).sum()
            self.bad = nonfinite if self.bad is None else self.bad + nonfinite
            return super()._sample(logits, temperatures, any_hot)

    return CheckedEngine


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def check(ok, what) -> None:
    """Fail the run (an assert would vanish under ``python -O``)."""
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def bitserial_work(M, K, N, dtype_name, n_bits=N_BITS, groups=1):
    """(FLOPs, bytes) of one bitserial call: x read, the ``n_bits`` planes,
    the sign and the ``groups`` f32 scales read, the output written once."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = M * K * elt + (n_bits + 1) * (K // 8) * N + 4 * groups + M * N * elt
    return 2.0 * M * K * N, nbytes


def bound_ms(M, K, N, dtype_name, n_bits=N_BITS, groups=1):
    flops, nbytes = bitserial_work(M, K, N, dtype_name, n_bits, groups)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profile_decode(engine, reqs, cfg, card, steps=4, n_experts=0):
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps of one bucket, after the counted run.  Device busy time
    is the sum of the device events (one stream, so they do not
    overlap); the idle share is 1 - busy / wall under the profiler.
    ``n_experts`` (a MoE model) also sums the device time of the expert
    products, each call of ``moe._experts`` under a profiler range."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe, transformer

    dev = engine.device
    plen = len(reqs[0].tokens)
    experts = moe._experts

    def ranged(*a, **kw):
        with torch.profiler.record_function("moe._experts"):
            return experts(*a, **kw)
    with torch.inference_mode():
        prompts = torch.from_numpy(np.stack([r.tokens for r in reqs]).astype(np.int64)).to(dev)
        logits, cache = transformer.prefill(engine.params, {"tokens": prompts}, cfg,
                                            engine.max_len)
        tok = logits.argmax(-1, keepdim=True)
        logits, cache = transformer.decode_step(engine.params, cache, tok, plen, cfg)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                mock.patch.object(moe, "_experts", ranged if n_experts else experts):
            t0 = time.perf_counter()
            for t in range(steps):
                logits, cache = transformer.decode_step(engine.params, cache, tok,
                                                        plen + 1 + t, cfg)
                tok = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = {}
    for e in prof.events():
        # a record_function range shows on the device too, spanning its
        # kernels: not busy time of its own
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "moe._experts":
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        print(f"[profile] decode step: wall {wall_ms:.2f} ms under the profiler; device "
              f"time not measured (the profiler saw no device events) [{card}]")
        return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": None}
    busy = sum(t for t, _ in by_name.values()) / steps
    ops = sum(n for _, n in by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[profile] decode step, bucket of {len(reqs)}, {cfg.n_layers} layers: wall "
          f"{wall_ms:.2f} ms under the profiler, device busy {busy:.2f} ms "
          f"(idle {1 - busy / wall_ms:.1%}), {ops:.0f} device ops per step [{card}]")
    for name, (t, n) in top:
        print(f"[profile]   {t / steps:8.3f} ms/step {n / steps:6.0f}x  {name[:90]}")
    rep = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
           "device_ops_per_step": ops,
           "top": [{"name": k, "ms_per_step": t / steps, "count_per_step": n / steps}
                   for k, (t, n) in top]}
    if n_experts:
        # the device time of the kernels each range's ops launched (the
        # profiler's tree: a range's total includes its children's)
        us = calls = 0
        for e in prof.events():
            if e.name == "moe._experts" and e.device_type == torch.autograd.DeviceType.CPU:
                dt = getattr(e, "device_time_total", None)
                us += e.cuda_time_total if dt is None else dt
                calls += 1
        rep["expert_products_ms_per_step"] = us / 1e3 / steps if us else None
        rep["expert_calls_per_step"] = calls / steps
        print(f"[profile]   expert products (moe._experts, {calls / steps:.0f} calls per step): "
              + (f"{us / 1e3 / steps:.3f} ms/step of {busy:.2f} busy" if us else
                 "device time not measured (the range carries none)") + f" [{card}]",
              flush=True)
    return rep


def device_ms_by_name(prof):
    """Device time (ms) and event count of a profile, by kernel name."""
    import torch

    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


def profiled_kernel_names(fn, calls=3, sessions=4):
    """The names of the device kernels that ``calls`` calls of ``fn`` run,
    from torch.profiler, and the number of profiler sessions it took.  A
    session whose trace holds no device event at all (CUPTI delivered
    none; the calls ran, since the synchronize inside raised nothing) is
    taken again, up to ``sessions`` times; a trace with device events is
    final, whatever kernels it names."""
    import torch

    for n in range(1, sessions + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = sorted(device_ms_by_name(prof))
        if names:
            break
        print(f"[profile] session {n} of {sessions} saw no device events; profiling again",
              flush=True)
    return names, n


def paged_kernel_phase(dev, card, time_ms, median_ms):
    """Phase 2b: the paged-attention kernel against its plain version at
    the continuous slices' shapes, with ragged positions and two inactive
    lanes: granite-3-2b's (8 lanes, 8 KV heads of 4 query heads, d = 64,
    blocks of 32 rows, 16 table entries per lane, a pool of 64 blocks;
    f32, bf16, one windowed case) and gemma3-12b's global layers (8 KV
    heads of 2 query heads, d = 256, 97 table entries per lane, a pool of
    512 blocks of which each lane owns 64; f32 and bf16) and the MoE
    slices' d 128 (16 KV heads of 1, and 8 of 4; 33 table entries per
    lane, a pool of 256 blocks; f32 and bf16)."""
    import torch

    rows = []
    for dt, window in ((torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, 100)):
        rows.append(paged_case(dev, card, time_ms, median_ms, dt, window, KV=8, G=4, d=64,
                               nb_lane=MAX_LEN // BLOCK, n_blocks=N_BLOCKS,
                               pos=[-1, 0, 31, 100, 255, 200, -1, 63]))
    for dt in (torch.float32, torch.bfloat16):
        rows.append(paged_case(dev, card, time_ms, median_ms, dt, None, KV=8, G=2, d=256,
                               nb_lane=G_MAX_LEN // BLOCK, n_blocks=G_N_BLOCKS,
                               pos=[-1, 0, 511, 1000, 2047, 1500, -1, 64]))
    # the MoE slices' d 128: qwen2-moe's MHA (16 KV heads of 1 query head) on
    # phase 4e's table (33 entries per lane, 256 blocks), and phi3.5-moe's G 4
    for KV, G in ((16, 1), (8, 4)):
        for dt in (torch.float32, torch.bfloat16):
            rows.append(paged_case(dev, card, time_ms, median_ms, dt, None, KV=KV, G=G, d=128,
                                   nb_lane=-(-Q_MAX_LEN // BLOCK), n_blocks=Q_N_BLOCKS,
                                   pos=[-1, 0, 31, 300, 1023, 700, -1, 64]))
    # musicgen-large's d 64 MHA (32 K/V heads of one query head) on phase 4j's
    # table (33 entries per lane, 256 blocks); llama-vision's d 128 G 4 is
    # phi3.5-moe's row above
    for dt in (torch.float32, torch.bfloat16):
        rows.append(paged_case(dev, card, time_ms, median_ms, dt, None, KV=32, G=1, d=64,
                               nb_lane=-(-F_MAX_LEN // BLOCK), n_blocks=F_N_BLOCKS,
                               pos=[-1, 0, 31, 300, 1023, 700, -1, 64]))
    print("[paged] kernel == plain within tolerance; inactive lanes exact zeros; stale "
          "entries and NaN never-live blocks leave it bitwise unchanged", flush=True)
    return rows


def paged_case(dev, card, time_ms, median_ms, dt, window, *, KV, G, d, nb_lane, n_blocks,
               pos):
    """One shape of phase 2b: lane-disjoint shuffled tables whose entries
    past a lane's own blocks name other lanes' blocks (stale ids)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    B = len(pos)
    gen = torch.Generator(device=dev).manual_seed(2 + d)
    own = torch.randperm(n_blocks, generator=gen, device=dev).reshape(B, n_blocks // B)
    stale = torch.randint(0, n_blocks, (B, nb_lane - n_blocks // B), generator=gen, device=dev)
    table = torch.cat([own, stale], 1).to(torch.int32).contiguous()
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    live = [int(p) // BLOCK + 1 if p >= 0 else 0 for p in pos.tolist()]
    check(max(live) <= n_blocks // B, f"positions {pos.tolist()} outgrow the lanes' blocks")
    scrambled = table.clone()
    for b in range(B):
        scrambled[b, live[b]:] = (scrambled[b, live[b]:] + 7) % n_blocks
    used = {int(table[b, j]) for b in range(B) for j in range(live[b])}
    dead = torch.tensor(sorted(set(range(n_blocks)) - used), device=dev)
    L = nb_lane * BLOCK
    kpos = torch.arange(L, device=dev)
    dname = str(dt).split(".")[-1]
    q = torch.randn((B, KV, G, d), generator=gen, device=dev).to(dt)
    k = torch.randn((n_blocks, BLOCK, KV, d), generator=gen, device=dev).to(dt)
    v = torch.randn((n_blocks, BLOCK, KV, d), generator=gen, device=dev).to(dt)
    got = ops.paged_attention(q, k, v, table, pos, window=window)
    want = ref.paged_attention_ref(q, k, v, table, pos, window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale_ = want.float().abs().max().item()
    what = f"paged kernel {dname} d={d} G={G} window={window}"
    check(bool(torch.isfinite(got).all()) and err <= PAGED_TOL[dname] * scale_,
          f"{what} vs plain: max err {err} > {PAGED_TOL[dname]} x {scale_}")
    for b in range(B):
        if pos[b] < 0:
            check(torch.equal(got[b], torch.zeros_like(got[b])),
                  f"{what}: inactive lane {b} is not exact zeros")
    check(torch.equal(got, ops.paged_attention(q, k, v, table, pos, window=window)),
          f"{what}: a second call differs")
    k2, v2 = k.clone(), v.clone()
    k2[dead] = float("nan")
    v2[dead] = float("nan")
    check(torch.equal(got, ops.paged_attention(q, k2, v2, scrambled, pos, window=window)),
          f"{what}: scrambled stale entries or NaN never-live blocks changed the output")
    del k2, v2
    # yardstick: one SDPA call on K/V gathered into (B, KV, L, d) beforehand
    kc = k[table.long()].reshape(B, L, KV, d).transpose(1, 2).contiguous()
    vc = v[table.long()].reshape(B, L, KV, d).transpose(1, 2).contiguous()
    valid = kpos[None, :] <= pos[:, None]
    if window is not None:
        valid &= (pos[:, None] - kpos[None, :]) < window
    mask = valid[:, None, None, :]
    qs = q.reshape(B, KV * G, 1, d)
    # the kernel and SDPA take tens of microseconds and swing up to 2x from
    # one time_ms to the next: the median of PAGED_REPEATS of them
    row = {
        "dtype": dname, "window": window, "B": B, "KV": KV, "G": G, "d": d,
        "block_size": BLOCK, "blocks_per_lane": nb_lane, "pos": pos.tolist(),
        "max_abs_err": err, "max_abs_plain": scale_,
        "ms": median_ms(lambda: ops.paged_attention(q, k, v, table, pos, window=window)),
        "plain_ms": time_ms(lambda: ref.paged_attention_ref(q, k, v, table, pos,
                                                            window=window), iters=5),
        "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=mask, enable_gqa=True)),
    }
    # the least the card could take: each live K/V row read once, q read
    # and the output written once; 4 d flops per live row and head
    live_rows = sum(min(p + 1, window or p + 1, L) for p in pos.tolist() if p >= 0)
    elt = q.element_size()
    nbytes = (2 * live_rows * KV * d * elt + 2 * q.numel() * elt
              + 4 * (table.numel() + pos.numel()))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * live_rows * KV * G * d / PEAK_FLOPS[dname]
    row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    row["live_rows"] = live_rows
    # device time of each of the call's two kernels (split walk, merge),
    # warm L2, from the profiler: the part of the call each one takes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.paged_attention(q, k, v, table, pos, window=window)
        torch.cuda.synchronize()
    row["kernel_us_warm"] = {
        ("merge" if "paged_attention_merge" in n else "split" if "paged_attention_split" in n
         else n[:40]):
        1e3 * t / c for n, (t, c) in device_ms_by_name(prof).items()}
    row["gb_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
    row["of_bound"] = row["bound_ms"] / row["ms"]
    row["vs_library"] = row["ms"] / row["library_ms"]
    print(f"[paged] {dname} d={d} G={G} window={window} pos={pos.tolist()}: max_err={err:.3e} "
          f"(max|plain|={scale_:.3e}) kernel {row['ms']:.4f} ms ({row['gb_per_s']:.1f} GB/s, "
          f"{100 * row['of_bound']:.1f} % of bound), bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}, {live_rows} live rows), plain {row['plain_ms']:.4f} ms, "
          f"sdpa(gathered) {row['library_ms']:.4f} ms (kernel/sdpa {row['vs_library']:.2f}); "
          f"warm us by kernel {row['kernel_us_warm']} [{card}]", flush=True)
    return row


def flash_bound(BH, BHkv, S, d, window, causal, dname):
    """The least time the card could take for one flash launch: q, k, v
    read once and the output written once, against 4 d flops per live
    (query, key) pair and query head at the dtype's peak."""
    live = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i if causal else S - 1
        live += hi - lo + 1
    elt = 4 if dname == "float32" else 2
    t_bytes = (2 * BH + 2 * BHkv) * S * d * elt / HBM_BYTES_PER_S
    t_ops = 4.0 * d * live * BH / PEAK_FLOPS[dname]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), live


def flash_kernel_phase(dev, card, time_ms):
    """Phase 2d: the flash-attention kernel against its plain version at
    the prefill shapes of the main paths: granite-3-2b's bucket (4 x 32
    query heads over 32 K/V rows, d 64, 128 tokens), gemma3-12b's (2 x 16
    query heads over 16 K/V rows, d 256, 4096 tokens, causal and window
    1024), a non-causal case, a ragged length, and the MoE slices' d 128
    (qwen2-moe's 4 x 16 heads, MHA, 1024 tokens; phi3.5-moe's 4 x 32 over
    4 x 8, 256 tokens); f32 and bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    cases = [  # name, BH, BHkv, S, d, window, causal
        ("granite-prefill", 4 * 32, 4 * 8, 128, 64, None, True),
        ("gemma3-global", 2 * 16, 2 * 8, 4096, 256, None, True),
        ("gemma3-local", 2 * 16, 2 * 8, 4096, 256, 1024, True),
        ("non-causal", 8, 8, 512, 64, None, False),
        ("ragged", 16, 8, 1000, 256, 300, True),
        # the MoE slices at d 128: qwen2-moe's 4 x 1024-token bucket (MHA,
        # 16 heads) and phi3.5-moe's 4 x 256 (32 query heads over 8 K/V)
        ("qwen2-moe-prefill", 4 * 16, 4 * 16, 1024, 128, None, True),
        ("phi35-moe-prefill", 4 * 32, 4 * 8, 256, 128, None, True),
        # recurrentgemma-9b's 2 x 4096-token bucket: 16 query heads on one
        # K/V head (G 16) of d 256, window 2048
        ("recurrentgemma-local", 2 * 16, 2 * 1, 4096, 256, 2048, True),
        # the frontends' 4 x 1024-token prefills: llama-3.2-vision-11b's 32
        # query heads on 8 K/V heads of 128, musicgen-large's 32 MHA heads of 64
        ("llama-vision-prefill", 4 * 32, 4 * 8, 1024, 128, None, True),
        ("musicgen-prefill", 4 * 32, 4 * 32, 1024, 64, None, True),
    ]
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for name, BH, BHkv, S, d, window, causal in cases:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[-1]
            q = torch.randn((BH, S, d), generator=gen, device=dev).to(dt)
            k = torch.randn((BHkv, S, d), generator=gen, device=dev).to(dt)
            v = torch.randn((BHkv, S, d), generator=gen, device=dev).to(dt)
            kw = dict(causal=causal, window=window)
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale_ = want.float().abs().max().item()
            what = f"flash kernel {name} {dname}"
            check(bool(torch.isfinite(got).all()) and err <= PAGED_TOL[dname] * scale_,
                  f"{what} vs plain: max err {err} > {PAGED_TOL[dname]} x {scale_}")
            check(torch.equal(got, ops.flash_attention(q, k, v, **kw)),
                  f"{what}: a second call differs")
            del want
            # yardstick: one SDPA call on (B, H, S, d) views, K/V not broadcast
            q4, k4, v4 = q[None], k[None], v[None]
            if window is None:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q4, k4, v4, is_causal=causal, enable_gqa=True)
            else:
                pos = torch.arange(S, device=dev)
                mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q4, k4, v4, attn_mask=mask, enable_gqa=True)
            b_ms, b_by, live = flash_bound(BH, BHkv, S, d, window, causal, dname)
            row = {
                "case": name, "dtype": dname, "BH": BH, "BHkv": BHkv, "S": S, "d": d,
                "window": window, "causal": causal, "max_abs_err": err, "max_abs_plain": scale_,
                "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), iters=3),
                "library_ms": time_ms(lib),
                "bound_ms": b_ms, "bound_by": b_by, "live_pairs": live,
            }
            row["tflops"] = 4.0 * d * live * BH / (row["ms"] * 1e-3) / 1e12
            row["of_bound"] = b_ms / row["ms"]
            row["vs_library"] = row["ms"] / row["library_ms"]
            rows.append(row)
            print(f"[flash] {name} BH={BH}/{BHkv} S={S} d={d} window={window} causal={causal} "
                  f"{dname}: max_err={err:.3e} (max|plain|={scale_:.3e}) kernel "
                  f"{row['ms']:.4f} ms ({row['tflops']:.2f} TFLOP/s, "
                  f"{100 * row['of_bound']:.1f} % of bound), bound {row['bound_ms']:.4f} ms "
                  f"({b_by}), plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
                  f"(kernel/sdpa {row['vs_library']:.2f}) [{card}]", flush=True)
            del q, k, v, got
    print("[flash] kernel == plain within tolerance (f32 1e-5, bf16 2e-2 of max|plain|); "
          "second calls bitwise equal", flush=True)
    return rows


class LogitTap:
    """Records the logits the serving paths compute, through the module
    attributes the engines call: every row of ``transformer.prefill``,
    the active rows of ``decode_step``, and the rows of
    ``prefill_chunk`` whose lane had real tokens (idle lanes compute
    garbage by design)."""

    def __init__(self):
        from repro_torch.models import transformer

        self.tf = transformer
        self.orig = {n: getattr(transformer, n) for n in ("prefill", "decode_step",
                                                          "prefill_chunk")}
        self.rows = []

    def __enter__(self):
        tf, orig, rows = self.tf, self.orig, self.rows

        def prefill(*a, **kw):
            logits, cache = orig["prefill"](*a, **kw)
            rows.append(logits.float().cpu())
            return logits, cache

        def decode_step(params, cache, tokens, pos, cfg, active=None, **kw):
            logits, cache = orig["decode_step"](params, cache, tokens, pos, cfg, active=active,
                                                **kw)
            rows.append(logits.float().cpu() if active is None
                        else logits[active].float().cpu())
            return logits, cache

        def prefill_chunk(params, cache, tokens, start, n_valid, cfg, **kw):
            logits, cache = orig["prefill_chunk"](params, cache, tokens, start, n_valid, cfg,
                                                  **kw)
            rows.append(logits[n_valid > 0].float().cpu())
            return logits, cache

        tf.prefill, tf.decode_step, tf.prefill_chunk = prefill, decode_step, prefill_chunk
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.tf, n, f)


def gemma3_parity(dev, card):
    """Phase 3d: full-width gemma3-12b cut to one superblock (5 local + 1
    global layers), f32, 6-bit packed: the card (kernels) against the CPU
    (plain versions), through the bucketed engine (a 2048-token prompt
    that wraps every ring during prefill, and a 1020-token one whose
    decode crosses the first wrap) and the chunked paged-kernel engine
    (prompts of 1100 and 1020 tokens in 512-token chunks, 2 lanes).
    Every computed logit row within the phase-3 tolerance, identical
    greedy tokens.  The CPU holds the same weights unpacked once to f32
    (``unpack_to_float``): its plain bitserial version would unpack every
    weight at every call, some 10 s per step at this width."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.packing import PackedWeight, tree_map_with_path, unpack_to_float
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.scheduler import SchedulerPolicy

    cfg = get_config("gemma3-12b").scaled(n_layers=6, dtype="float32", kv_cache_dtype="float32")
    t0 = time.perf_counter()
    p_gpu = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev,
                                    pack_bits=N_BITS)
    p_cpu = tree_map_with_path(
        lambda _, w: (unpack_to_float(w) if isinstance(w, PackedWeight) else w).cpu(), p_gpu)
    init_s = time.perf_counter() - t0
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)

    def req(uid, n, max_new):
        return Request(uid=uid, tokens=task.sample(np.random.default_rng(60 + uid), 1, n)[0, :n]
                       .astype(np.int32), max_new=max_new)

    runs = {
        "bucketed": ([req(0, 2048, 4), req(1, 1020, 8)], None, {}),
        "chunked-paged": ([req(2, 1100, 4), req(1, 1020, 8)], [0, 0], dict(
            continuous=True, policy=SchedulerPolicy(
                n_slots=2, chunked_prefill=True, chunk_sizes=(512,), paged=True,
                block_size=BLOCK, paged_kernel=True))),
    }
    rep = {"init_s": init_s}
    for name, (reqs, arrivals, kw) in runs.items():
        out, taps, secs = {}, {}, {}
        for side, params, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, torch.device("cpu"))):
            eng = ServeEngine(params, cfg, max_len=2048 + 8, device=d, **kw)
            fa.reset_launches()
            t0 = time.perf_counter()
            with LogitTap() as tap:
                res = eng.generate(reqs, arrival_steps=arrivals)
            if d.type == "cuda":
                torch.cuda.synchronize()
                flash = (fa.launches, fa.windowed_launches)
            secs[side] = time.perf_counter() - t0
            out[side] = {r.uid: r.tokens.tolist() for r in res}
            taps[side] = tap.rows
            if eng.scheduler is not None:
                pool = eng.scheduler.pool
                check(pool.allocator.free_count == pool.n_blocks,
                      f"3d {name} {side}: the pool did not drain")
        check(len(taps["cuda"]) == len(taps["cpu"]),
              f"3d {name}: {len(taps['cuda'])} logit calls on the card, {len(taps['cpu'])} on "
              "the CPU")
        dlog = max((a - b).abs().max().item() for a, b in zip(taps["cuda"], taps["cpu"]))
        lmax = max(b.abs().max().item() for b in taps["cpu"])
        n_prefill = len(reqs) if name == "bucketed" else 0
        check(flash == (n_prefill * cfg.n_layers, n_prefill * cfg.layer_pattern.count("local")),
              f"3d {name}: flash launches {flash}, expected {n_prefill} prefill calls x 6 "
              "(5 windowed)")
        print(f"[parity-gemma3] 6-layer full-width f32 {name}: card {secs['cuda']:.1f} s, cpu "
              f"{secs['cpu']:.1f} s; {len(taps['cpu'])} logit calls, max|dlogit| {dlog:.3e} "
              f"(max|logit| {lmax:.3e}); flash launches {flash[0]} ({flash[1]} windowed); "
              f"tokens {out['cuda']} [{card}]", flush=True)
        check(out["cuda"] == out["cpu"], f"3d {name}: greedy tokens differ card vs cpu: {out}")
        check(dlog <= 1e-4 * max(1.0, lmax), f"3d {name}: logits differ by {dlog}")
        rep[name] = {"tokens": out["cuda"], "max_abs_dlogit": dlog, "max_abs_logit": lmax,
                     "logit_calls": len(taps["cpu"]), "card_s": secs["cuda"],
                     "cpu_s": secs["cpu"], "flash_launches": list(flash)}
    print("[parity-gemma3] card == cpu: greedy tokens identical, logits within 1e-4 of "
          "max(1, max|logit|), rings wrapped in prefill and in decode", flush=True)
    return rep


def gemma3_slice(dev, card, engine_cls):
    """Phase 4c: full-width 48-layer gemma3-12b, bf16, 6-bit packed, served
    bucketed (4 requests: 2 x 4096 and 2 x 1024 prompt tokens, 32 new
    each) and continuous (chunked, paged, the paged kernel; 8 lanes, 512
    blocks of 32 rows, 12 requests with prompts uniform in [512, 3072]
    (seed 0), Poisson arrivals at 0.5 per step, 32 new tokens each), then
    a profiled decode step."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.packing import packed_leaves
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import poisson_arrivals
    from repro_torch.models import transformer
    from repro_torch.obs.metrics import percentile
    from repro_torch.serve import Request
    from repro_torch.serve.scheduler import SchedulerPolicy

    cfg = get_config("gemma3-12b")
    n_local = cfg.layer_pattern.count("local") * cfg.n_superblocks
    n_proj = 7  # packed projections per layer; the tied head is the float embedding
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                     pack_bits=N_BITS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    packed_bytes = sum(pw.hbm_bytes() for pw in packed_leaves(params))
    n_packed = sum(1 for _ in packed_leaves(params))
    # the engine serves the embedding in the compute dtype (drawn in f32)
    embed_bytes = params["embed"].numel() * torch.finfo(cfg.compute_dtype).bits // 8
    print(f"[gemma3] gemma3-12b {cfg.n_layers} layers ({n_local} local, window {cfg.window}) "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}: "
          f"init+pack {init_s:.1f} s, packed weights {packed_bytes / 1e9:.4f} GB in {n_packed} "
          f"stacked leaves, tied embedding {embed_bytes / 1e9:.4f} GB served, init peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]", flush=True)
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    rep = {"init_s": init_s, "packed_weight_bytes": packed_bytes, "embed_bytes": embed_bytes}

    # ---- bucketed
    max_new, lens = 32, [4096, 4096, 1024, 1024]
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(70 + i), 1, n)[0, :n]
                    .astype(np.int32), max_new=max_new) for i, n in enumerate(lens)]
    engine = engine_cls(params, cfg, max_len=4096 + max_new, device=dev)
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:64], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    for m in (bsm, fa, pa):
        m.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen_toks = np.stack([r.tokens for r in sorted(results, key=lambda r: r.uid)])
    check(gen_toks.shape == (4, max_new), f"gemma3 bucketed tokens of shape {gen_toks.shape}")
    check(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all(), "token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    calls = 2  # prefill calls: one per bucket
    check(fa.launches == calls * cfg.n_layers and fa.windowed_launches == calls * n_local,
          f"flash launches {fa.launches} ({fa.windowed_launches} windowed), expected "
          f"{calls} x {cfg.n_layers} ({calls} x {n_local} windowed)")
    expected = calls * max_new * cfg.n_layers * n_proj
    check(bsm.launches == expected and pa.launches == 0,
          f"bitserial launches {bsm.launches} (expected {expected}), paged {pa.launches}")
    check(bsm.prefill_launches == calls * cfg.n_layers * n_proj,
          f"{bsm.prefill_launches} bitserial prefill launches, expected {calls} x "
          f"{cfg.n_layers} x {n_proj}")
    # one bucket's cache (2 lanes, bf16, K and V): rings of window slots in
    # the local layers, max_len rows in the global ones
    row_bytes = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    ring_bytes = n_local * 2 * cfg.window * row_bytes
    kv_bytes = (cfg.n_layers - n_local) * 2 * (4096 + max_new) * row_bytes
    buckets = {}
    for r in results:
        buckets.setdefault(len(reqs[r.uid].tokens), []).append(r)
    rep["bucketed"] = {"wall_s": wall, "tokens": int(gen_toks.size),
                       "tokens_per_s": gen_toks.size / wall, "serve_peak_bytes": peak,
                       "ring_bytes_per_bucket": ring_bytes, "kv_bytes_per_bucket": kv_bytes,
                       "flash_launches": fa.launches, "flash_windowed": fa.windowed_launches,
                       "bitserial_launches": bsm.launches,
                       "bitserial_prefill_launches": bsm.prefill_launches, "buckets": {}}
    for plen, rs in sorted(buckets.items()):
        ttft = float(np.mean([r.prefill_ms for r in rs]))
        dms = float(np.mean([r.decode_ms_per_tok for r in rs]))
        rep["bucketed"]["buckets"][plen] = {"ttft_ms": ttft, "decode_ms_per_step": dms}
        print(f"[gemma3] bucket prompt={plen} x{len(rs)}: TTFT {ttft:.2f} ms, decode "
              f"{dms:.3f} ms per step [{card}]", flush=True)
    print(f"[gemma3] bucketed: 4 requests, {gen_toks.size} tokens in {wall:.3f} s = "
          f"{gen_toks.size / wall:.2f} tok/s; serve peak memory {peak / 1e9:.3f} GB; per "
          f"bucket of 2 at max_len {4096 + max_new}: rings {ring_bytes / 1e6:.1f} MB, global KV "
          f"{kv_bytes / 1e6:.1f} MB; flash launches {fa.launches} == {calls} x {cfg.n_layers} "
          f"({fa.windowed_launches} windowed); bitserial launches {bsm.launches} == {calls} x "
          f"{max_new} x {cfg.n_layers} x {n_proj} [{card}]", flush=True)
    rep["profile"] = profile_decode(engine, reqs[2:], cfg, card, steps=2)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # ---- continuous: 12 requests on 8 lanes, so that lanes, their rings
    # and pool blocks serve a second request
    n_req = 12
    lens = np.random.default_rng(0).integers(512, 3073, size=n_req)
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(i), 1, 3072)[0, :n]
                    .astype(np.int32), max_new=max_new) for i, n in enumerate(lens)]
    arrivals = poisson_arrivals(n_req, 0.5, seed=0)
    policy = SchedulerPolicy(n_slots=SLOTS, chunked_prefill=True, chunk_sizes=(256, 128),
                             paged=True, block_size=BLOCK, n_blocks=G_N_BLOCKS,
                             paged_kernel=True)
    engine = engine_cls(params, cfg, max_len=G_MAX_LEN, device=dev, continuous=True,
                        policy=policy)
    sched, pool = engine.scheduler, engine.scheduler.pool
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:64], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    sched.reset_telemetry()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    for m in (bsm, fa, pa):
        m.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(reqs, arrival_steps=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    got = {r.uid: r for r in results}
    check(sorted(got) == list(range(n_req)), f"gemma3 continuous results for {sorted(got)}")
    for r in results:
        check(len(r.tokens) == max_new and ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all(),
              f"uid {r.uid}: {len(r.tokens)} tokens, or a token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    n_global = cfg.n_layers - n_local
    check(pa.launches == steps * n_global,
          f"{pa.launches} paged launches, expected {steps} steps x {n_global}")
    check(bsm.launches == (steps + chunks) * cfg.n_layers * n_proj and fa.launches == 0,
          f"{bsm.launches} bitserial launches (expected ({steps} + {chunks}) x {cfg.n_layers} x "
          f"{n_proj}), {fa.launches} flash (chunked prefill reads the cache)")
    check(pool.allocator.free_count == pool.n_blocks and pool.allocator.committed == 0,
          f"blocks leaked: free {pool.allocator.free_count}/{pool.n_blocks}, committed "
          f"{pool.allocator.committed}")
    check(engine.obs.recorder.leaked == [], f"leaked spans {engine.obs.recorder.leaked}")
    ttft = [got[i].prefill_ms for i in range(n_req)]
    rep["continuous"] = {
        "requests": n_req, "max_new": max_new, "prompt_lens": lens.tolist(),
        "arrivals": arrivals, "chunk_sizes": list(policy.chunk_sizes), "wall_s": wall,
        "tokens": n_req * max_new, "tokens_per_s": n_req * max_new / wall,
        "ttft_ms_p50": percentile(ttft, 50), "ttft_ms_p90": percentile(ttft, 90),
        "decode_steps": steps, "prefill_chunks": chunks,
        "decode_ms_per_step": sched.decode_ms_total / max(steps, 1),
        "mean_occupancy": sched.mean_occupancy(),
        "mean_block_occupancy": sched.mean_block_occupancy(),
        "admit_blocked_total": sched._c_blocked.value,
        "serve_peak_bytes": peak, "cache_bytes": pool.cache_bytes(),
        "ring_bytes": pool.ring_bytes(), "paged_launches": pa.launches,
        "bitserial_launches": bsm.launches,
    }
    c = rep["continuous"]
    print(f"[gemma3] continuous: {n_req} requests x {max_new} tokens, prompts {lens.min()}-"
          f"{lens.max()} ({lens.sum()} tokens), Poisson arrivals at 0.5/step over "
          f"{arrivals[-1]} steps, chunks {policy.chunk_sizes}: {c['tokens']} tokens in "
          f"{wall:.3f} s = {c['tokens_per_s']:.2f} tok/s; TTFT p50 {c['ttft_ms_p50']:.1f} ms, "
          f"p90 {c['ttft_ms_p90']:.1f} ms; decode {c['decode_ms_per_step']:.3f} ms per step "
          f"({steps} steps, mean occupancy {c['mean_occupancy']:.2f}), {chunks} prefill chunks, "
          f"admission blocked {c['admit_blocked_total']:.0f} steps [{card}]", flush=True)
    print(f"[gemma3] continuous: serve peak memory {peak / 1e9:.3f} GB; cache "
          f"{c['cache_bytes'] / 1e9:.3f} GB ({c['ring_bytes'] / 1e9:.3f} GB rings of "
          f"{SLOTS} lanes, the rest {G_N_BLOCKS} + 1 blocks x {BLOCK} rows of {n_global} global "
          f"layers); mean block occupancy {c['mean_block_occupancy']:.2f}; paged launches "
          f"{pa.launches} == {steps} x {n_global}; bitserial {bsm.launches} == ({steps} + "
          f"{chunks}) x {cfg.n_layers} x {n_proj}; pool drained [{card}]", flush=True)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def continuous_parity(cfg2, p_gpu, p_cpu, dev, card):
    """Phase 3b: the 1-layer model through the continuous paged-kernel
    engine on the card (4 requests on 2 lanes), the bucketed engine on
    the card and the continuous engine on the CPU: identical greedy
    tokens."""
    import numpy as np
    import torch

    from repro_torch.data import MarkovLM
    from repro_torch.serve import Request, ServeEngine

    task = MarkovLM(vocab=cfg2.vocab_size, seed=3)
    # short prompts and 4 new tokens: the CPU side of this phase is the
    # script's slowest host work, cut to pay for phase 4k
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(10 + i), 1, n)[0, :n]
                    .astype(np.int32), max_new=4) for i, n in enumerate((16, 28, 44))]
    arrivals = [0, 0, 2]
    kw = dict(continuous=True, n_slots=2, paged=True, block_size=32, paged_kernel=True)
    runs = {
        "continuous-cuda": ServeEngine(p_gpu, cfg2, max_len=128, device=dev, **kw),
        "bucketed-cuda": ServeEngine(p_gpu, cfg2, max_len=128, device=dev),
        "continuous-cpu": ServeEngine(p_cpu, cfg2, max_len=128, device="cpu", **kw),
    }
    toks = {}
    for name, eng in runs.items():
        res = eng.generate(reqs, arrival_steps=arrivals)
        toks[name] = {r.uid: r.tokens.tolist() for r in res}
        check(sorted(toks[name]) == [0, 1, 2], f"{name}: results {sorted(toks[name])}")
        if eng.scheduler is not None:
            pool = eng.scheduler.pool
            check(pool.allocator.free_count == pool.n_blocks and pool.allocator.committed == 0,
                  f"{name}: the pool did not drain")
    torch.cuda.synchronize()
    for name in runs:
        print(f"[parity] {cfg2.n_layers}-layer full-width f32 {name}: {toks[name]}")
    check(toks["continuous-cuda"] == toks["bucketed-cuda"] == toks["continuous-cpu"],
          "continuous (cuda), bucketed (cuda) and continuous (cpu) greedy tokens differ")
    print("[parity] continuous paged-kernel (cuda, 3 requests on 2 lanes) == bucketed (cuda) "
          "== continuous (cpu) greedy tokens", flush=True)
    return toks["continuous-cuda"]


def continuous_slice(params, cfg, dev, card, engine_cls):
    """Phase 4b: full-width granite-3-2b through the continuous paged-
    kernel engine: 16 requests (prompts uniform in [16, 300], seed 0),
    32 new tokens each, Poisson arrivals at 0.5 per step."""
    import numpy as np
    import torch

    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import poisson_arrivals
    from repro_torch.obs.metrics import percentile
    from repro_torch.serve import Request

    n_req, max_new = 16, 32
    lens = np.random.default_rng(0).integers(16, 301, size=n_req)
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(i), 1, 300)[0, :n]
                    .astype(np.int32), max_new=max_new) for i, n in enumerate(lens)]
    arrivals = poisson_arrivals(n_req, 0.5, seed=0)
    engine = engine_cls(params, cfg, max_len=MAX_LEN, device=dev, continuous=True,
                        n_slots=SLOTS, paged=True, block_size=BLOCK, n_blocks=N_BLOCKS,
                        paged_kernel=True)
    sched, pool = engine.scheduler, engine.scheduler.pool
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:16], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    sched.reset_telemetry()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    bsm.reset_launches()
    pa.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(reqs, arrival_steps=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    got = {r.uid: r for r in results}
    check(sorted(got) == list(range(n_req)), f"continuous slice results for {sorted(got)}")
    for r in results:
        check(len(r.tokens) == max_new and ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all(),
              f"uid {r.uid}: {len(r.tokens)} tokens, or a token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    check(pa.launches == steps * cfg.n_layers,
          f"{pa.launches} paged launches, expected {steps} steps x {cfg.n_layers}")
    # the tied head is the float embedding: 7 packed projections per layer
    check(bsm.launches == (steps + chunks) * cfg.n_layers * 7,
          f"{bsm.launches} bitserial launches, expected ({steps} + {chunks}) x "
          f"{cfg.n_layers} x 7")
    check(pool.allocator.free_count == pool.n_blocks and pool.allocator.committed == 0,
          f"blocks leaked: free {pool.allocator.free_count}/{pool.n_blocks}, committed "
          f"{pool.allocator.committed}")
    check(engine.obs.recorder.leaked == [], f"leaked spans {engine.obs.recorder.leaked}")
    ttft = [got[i].prefill_ms for i in range(n_req)]
    hd = cfg.resolved_head_dim
    unpaged = 2 * cfg.n_layers * SLOTS * MAX_LEN * cfg.n_kv_heads * hd * 2  # K+V, bf16
    rep = {
        "requests": n_req, "max_new": max_new, "prompt_lens": lens.tolist(),
        "arrivals": arrivals, "wall_s": wall, "tokens": n_req * max_new,
        "tokens_per_s": n_req * max_new / wall,
        "ttft_ms_p50": percentile(ttft, 50), "ttft_ms_p90": percentile(ttft, 90),
        "decode_steps": steps, "prefill_chunks": chunks,
        "decode_ms_per_step": sched.decode_ms_total / max(steps, 1),
        "mean_occupancy": sched.mean_occupancy(),
        "mean_block_occupancy": sched.mean_block_occupancy(),
        "serve_peak_bytes": peak, "kv_pool_bytes": pool.cache_bytes(),
        "kv_unpaged_bytes": unpaged,
        "admit_blocked_total": sched._c_blocked.value,
        "paged_launches": pa.launches, "bitserial_launches": bsm.launches,
        "result_tokens": {r.uid: r.tokens.tolist() for r in results},
    }
    print(f"[continuous] {n_req} requests x {max_new} tokens, prompts {lens.min()}-"
          f"{lens.max()}, Poisson arrivals at 0.5/step over {arrivals[-1]} steps: "
          f"{rep['tokens']} tokens in {wall:.3f} s = {rep['tokens_per_s']:.1f} tok/s; TTFT p50 "
          f"{rep['ttft_ms_p50']:.2f} ms, p90 {rep['ttft_ms_p90']:.2f} ms; decode "
          f"{rep['decode_ms_per_step']:.3f} ms per step ({steps} steps, mean occupancy "
          f"{rep['mean_occupancy']:.2f}), {chunks} prefill chunks [{card}]", flush=True)
    print(f"[continuous] serve peak memory {peak / 1e9:.3f} GB; KV pool "
          f"{rep['kv_pool_bytes'] / 1e6:.1f} MB ({N_BLOCKS} + 1 blocks x {BLOCK} rows) against "
          f"{unpaged / 1e6:.1f} MB unpaged ({SLOTS} x {MAX_LEN}); mean block occupancy "
          f"{rep['mean_block_occupancy']:.2f}; serve_admit_blocked_total "
          f"{rep['admit_blocked_total']:.0f}; paged launches {pa.launches} == {steps} x "
          f"{cfg.n_layers}; bitserial launches {bsm.launches} == ({steps} + {chunks}) x "
          f"{cfg.n_layers} x 7; pool drained [{card}]", flush=True)
    return engine, reqs, rep


def _count_syncs_per_round(sched):
    """Wrap ``sched._spec_round`` so that each round counts the host syncs
    it makes (``torch.cuda.set_sync_debug_mode`` warns at every one: a
    device-to-host read, a blocking host-to-device copy).  A measurement
    hook of this script; returns the list the counts land in."""
    import warnings

    import torch

    counts = []
    inner = sched._spec_round

    def counted(queue, now):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                inner(queue, now)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in seen))

    sched._spec_round = counted
    return counts


def policies_parity(dev, card):
    """Phase 3e: full-width granite-3-2b cut to 1 layer (2 before PR 25,
    cut for the script's time), f32, 6-bit
    packed, through the continuous paged-kernel engine on the card
    (kernels) and on the CPU (plain path), 3 lanes, 3 requests of 12
    prompt tokens and 6 new ones, in three runs: (a) tiers {"economy": 4}
    (uid 1 economy) with degrade on a forced shed-and-restore schedule;
    (b) spec decode (3 draft planes, gamma 4) on a tiered engine, every
    request "full", so its verify passes the plane count too; (c)
    overcommit 2.0 on 5 blocks of 8 rows, tiers {"economy": 5} (uid 2
    economy), which must preempt.  Each run: identical tokens, plane
    logs, preemptions, spec and degrade counts on the card and the CPU,
    the pool drained on both, the card's static-truncation replay of
    each plane log equal to its tokens, and one runtime-plane launch per
    packed projection of each call that passed a plane count; (b)'s
    tokens equal a non-speculative run's on the card."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.packing import tree_to
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.models import transformer
    from repro_torch.obs.quality import replay_plane_log
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.scheduler import SchedulerPolicy

    cfg2 = get_config("granite-3-2b").scaled(n_layers=1, dtype="float32",
                                             kv_cache_dtype="float32")
    p_gpu = transformer.init_params(cfg2, torch.Generator(device=dev).manual_seed(1), dev,
                                    pack_bits=N_BITS)
    p_cpu = tree_to(p_gpu, "cpu")
    task = MarkovLM(vocab=cfg2.vocab_size, seed=3)
    prompts = [task.sample(np.random.default_rng(20 + i), 1, 12)[0].astype(np.int32)
               for i in range(3)]
    max_len = 32

    def reqs(precision):
        return [Request(uid=i, tokens=p, max_new=6, tier="latency" if i == 0 else "throughput",
                        precision=precision(i)) for i, p in enumerate(prompts)]

    base = dict(n_slots=3, chunked_prefill=True, chunk_sizes=(16,), paged=True, block_size=8,
                paged_kernel=True)
    runs = {
        "a-tiers-degrade": (dict(precision_tiers={"economy": 4}, degrade=True),
                            lambda i: "economy" if i == 1 else "full",
                            lambda step: step % 3),
        "b-spec": (dict(spec_decode=True, draft_planes=DRAFT_PLANES, gamma=GAMMA,
                        precision_tiers={"economy": 4}), lambda i: "full", None),
        "c-overcommit": (dict(n_blocks=5, overcommit=2.0, precision_tiers={"economy": 5}),
                         lambda i: "economy" if i == 2 else "full", None),
    }
    rep = {}
    for name, (kw, precision, force) in runs.items():
        got = {}
        for side, params, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, torch.device("cpu"))):
            eng = ServeEngine(params, cfg2, max_len=max_len, device=d, continuous=True,
                              policy=SchedulerPolicy(**base, **kw))
            sched = eng.scheduler
            sched.force_shed = force
            syncs = (_count_syncs_per_round(sched) if side == "cuda" and kw.get("spec_decode")
                     else None)
            bsm.reset_launches()
            t0 = time.perf_counter()
            res = {r.uid: r for r in eng.generate(reqs(precision))}
            if side == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            pool = sched.pool
            check(sorted(res) == [0, 1, 2], f"3e {name} {side}: results {sorted(res)}")
            check(pool.allocator.free_count == pool.n_blocks and pool.allocator.committed == 0
                  and eng.obs.recorder.leaked == [], f"3e {name} {side}: the pool did not drain")
            got[side] = {
                "tokens": {u: r.tokens.tolist() for u, r in res.items()},
                "plane_log": {u: r.plane_log.tolist() for u, r in res.items()},
                "preemptions": sched.preemptions_total(),
                "spec": [sched.spec_rounds, sched.spec_drafted, sched.spec_accepted],
                "degrade": [sched.degrade_sheds, sched.degrade_restores],
                "plane_dispatches": sched.plane_dispatches()}
            if side == "cuda":
                check(bsm.active_launches == 7 * cfg2.n_layers * sched.plane_dispatches() > 0,
                      f"3e {name}: {bsm.active_launches} runtime-plane launches, expected 7 x "
                      f"{cfg2.n_layers} x {sched.plane_dispatches()}")
                got["cuda_s"], got["active_launches"] = secs, bsm.active_launches
                if syncs is not None:
                    got["syncs_per_round"] = syncs
                for u, r in res.items():
                    replay = replay_plane_log(p_gpu, cfg2, prompts[u], r.plane_log, max_len)
                    check(replay.tolist() == r.tokens.tolist(),
                          f"3e {name}: the card's replay of uid {u}'s plane log "
                          f"{r.plane_log.tolist()} gives {replay.tolist()}, served "
                          f"{r.tokens.tolist()}")
            else:
                got["cpu_s"] = secs
        check(got["cuda"] == got["cpu"], f"3e {name}: card {got['cuda']} != cpu {got['cpu']}")
        rep[name] = got
        print(f"[policies-parity] {name}: card == cpu (tokens, plane logs, preemptions "
              f"{got['cuda']['preemptions']}, spec rounds/drafted/accepted "
              f"{got['cuda']['spec']}, sheds/restores {got['cuda']['degrade']}); replay == "
              f"served on the card; {got['active_launches']} runtime-plane launches == 7 x "
              f"{cfg2.n_layers} x {got['cuda']['plane_dispatches']}; card {got['cuda_s']:.1f} "
              f"s, cpu {got['cpu_s']:.1f} s [{card}]", flush=True)
    check(rep["a-tiers-degrade"]["cuda"]["degrade"][0] > 0
          and rep["a-tiers-degrade"]["cuda"]["degrade"][1] > 0, "3e (a): no shed and restore")
    check(rep["b-spec"]["cuda"]["spec"][2] > 0, "3e (b): no draft accepted")
    check(rep["c-overcommit"]["cuda"]["preemptions"] > 0, "3e (c): never preempted")
    plain = ServeEngine(p_gpu, cfg2, max_len=max_len, device=dev, continuous=True,
                        policy=SchedulerPolicy(**base))
    plain_toks = {r.uid: r.tokens.tolist() for r in plain.generate(reqs(lambda i: "full"))}
    check(plain_toks == rep["b-spec"]["cuda"]["tokens"],
          f"3e (b): spec tokens {rep['b-spec']['cuda']['tokens']} != non-spec {plain_toks}")
    syncs = rep["b-spec"]["syncs_per_round"]
    print(f"[policies-parity] (b) spec tokens == non-speculative tokens on the card; host "
          f"syncs per spec round {syncs} (min {min(syncs)}, max {max(syncs)}) [{card}]",
          flush=True)
    return rep


def policies_slice(params, cfg, dev, card, engine_cls, ref_tokens):
    """Phase 4d: full-width granite-3-2b (phase 4's SLICE_LAYERS), bf16, 6-bit packed,
    through the continuous paged-kernel engine (8 lanes, 40 blocks of 32
    rows overcommitted 1.5x) on phase 4b's traffic: 16 requests, prompts
    uniform in [16, 300], Poisson arrivals at 0.5 per step, 32 new tokens
    each.  First ``quality_probe`` at 1..6 planes on a 4 x 128-token batch
    and ``precision_tiers_from_probe({"economy": 0.9})``; then the odd
    uids served as "economy" with that table and the degrade loop; then
    every request again with spec decode (3 draft planes, gamma 4).
    Launch counts checked exactly; bf16 agreement shares reported."""
    import numpy as np
    import torch

    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import poisson_arrivals
    from repro_torch.obs.metrics import percentile
    from repro_torch.obs.quality import precision_tiers_from_probe, quality_probe, \
        replay_plane_log
    from repro_torch.serve import Request

    n_req, max_new = 16, 32
    lens = np.random.default_rng(0).integers(16, 301, size=n_req)
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    toks = [task.sample(np.random.default_rng(i), 1, 300)[0, :n].astype(np.int32)
            for i, n in enumerate(lens)]
    arrivals = poisson_arrivals(n_req, 0.5, seed=0)
    probe_toks = task.sample(np.random.default_rng(99), 4, 128)[:, :128].astype(np.int32)
    t0 = time.perf_counter()
    rows = quality_probe(params, cfg, probe_toks, plane_counts=range(1, N_BITS + 1))
    tiers = precision_tiers_from_probe(rows, {"economy": 0.9})
    probe_s = time.perf_counter() - t0
    for r in rows:
        print(f"[policies] quality probe, {r.planes} planes: logit MSE {r.logit_mse:.6e}, "
              f"top-1 agreement {r.top1_agreement:.4f} (4 x 128 tokens) [{card}]")
    print(f"[policies] precision_tiers_from_probe({{'economy': 0.9}}) = {tiers}; probe "
          f"{probe_s:.1f} s", flush=True)
    rep = {"probe": [r.to_dict() for r in rows], "tiers": tiers, "probe_s": probe_s}
    runs = {
        "tiers": (dict(precision_tiers=tiers, degrade=True),
                  lambda i: "economy" if i % 2 else "full"),
        "spec": (dict(spec_decode=True, draft_planes=DRAFT_PLANES, gamma=GAMMA),
                 lambda i: "full"),
    }
    for name, (kw, precision) in runs.items():
        reqs = [Request(uid=i, tokens=t, max_new=max_new, precision=precision(i))
                for i, t in enumerate(toks)]
        engine = engine_cls(params, cfg, max_len=MAX_LEN, device=dev, continuous=True,
                            n_slots=SLOTS, paged=True, block_size=BLOCK, n_blocks=P_BLOCKS,
                            paged_kernel=True, overcommit=P_OVERCOMMIT, **kw)
        sched, pool = engine.scheduler, engine.scheduler.pool
        engine.generate([Request(uid=100, tokens=toks[0][:16], max_new=6)])  # warm-up
        torch.cuda.synchronize()
        sched.reset_telemetry()
        torch.cuda.reset_peak_memory_stats()
        engine.bad = None
        bsm.reset_launches()
        pa.reset_launches()
        t0 = time.perf_counter()
        results = engine.generate(reqs, arrival_steps=arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = {r.uid: r for r in results}
        check(sorted(got) == list(range(n_req)), f"4d {name}: results for {sorted(got)}")
        for r in results:
            check(len(r.tokens) == max_new
                  and ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all(),
                  f"4d {name} uid {r.uid}: {len(r.tokens)} tokens, or one outside the vocab")
        check(int(engine.bad.item()) == 0, f"4d {name}: {int(engine.bad.item())} non-finite "
                                          "logits")
        check(pool.allocator.free_count == pool.n_blocks and pool.allocator.committed == 0,
              f"4d {name}: blocks leaked")
        check(engine.obs.recorder.leaked == [], f"4d {name}: leaked spans")
        per = 7 * cfg.n_layers  # packed projections per model call (the head is float)
        planes = sched.plane_dispatches()
        check(bsm.active_launches == per * planes > 0,
              f"4d {name}: {bsm.active_launches} runtime-plane launches, expected {per} x "
              f"{planes} (tiered dispatches {sched.tier_dispatches}, draft steps "
              f"{sched.draft_steps}, tiered verifies {sched.tier_verifies})")
        # every model call: tiered decode dispatches or draft steps (paged
        # decode), untiered verify chunks and prefill chunks (static)
        decode_calls = sched.tier_dispatches + sched.draft_steps
        static_calls = sched.prefill_chunks + (sched.spec_rounds - sched.tier_verifies)
        check(pa.launches == decode_calls * cfg.n_layers,
              f"4d {name}: {pa.launches} paged launches, expected {decode_calls} x "
              f"{cfg.n_layers}")
        check(bsm.launches == per * (planes + static_calls),
              f"4d {name}: {bsm.launches} bitserial launches, expected {per} x ({planes} + "
              f"{static_calls})")
        ttft = [got[i].prefill_ms for i in range(n_req)]
        steps = sched.decode_steps
        r = {"wall_s": wall, "tokens_per_s": n_req * max_new / wall,
             "ttft_ms_p50": percentile(ttft, 50), "ttft_ms_p90": percentile(ttft, 90),
             "decode_steps": steps, "decode_ms_per_step": sched.decode_ms_total / max(steps, 1),
             "prefill_chunks": sched.prefill_chunks, "preemptions": sched.preemptions_total(),
             "peak_bytes": peak, "bitserial_launches": bsm.launches,
             "active_launches": bsm.active_launches, "paged_launches": pa.launches,
             "tier_dispatches": sched.tier_dispatches, "draft_steps": sched.draft_steps,
             "spec_rounds": sched.spec_rounds, "spec_drafted": sched.spec_drafted,
             "spec_accepted": sched.spec_accepted, "sheds": sched.degrade_sheds,
             "restores": sched.degrade_restores}
        if name == "tiers":
            check(r["preemptions"] > 0, "4d tiers: never preempted")
            check(sched.degrade_events_total() > 0, "4d tiers: no degrade transition")
            by_tier = {}
            for u, res in got.items():
                by_tier.setdefault(precision(u), []).extend(res.plane_log[1:].tolist())
            r["mean_decode_planes"] = {t: float(np.mean(v)) for t, v in by_tier.items()}
            # the bf16 replay (M 1, contiguous cache) of four lanes' plane logs
            agree = total = 0
            for u in range(4):
                replay = replay_plane_log(params, cfg, toks[u], got[u].plane_log, MAX_LEN)
                agree += int((replay == got[u].tokens).sum())
                total += len(replay)
            r["replay_agreement"] = agree / total
            extra = (f"degrade sheds {r['sheds']} restores {r['restores']}; mean decode planes "
                     f"per tier {r['mean_decode_planes']}; tiered dispatches "
                     f"{r['tier_dispatches']}; bf16 replay agreement (uids 0-3) "
                     f"{agree}/{total} = {r['replay_agreement']:.4f}")
        else:
            check(r["spec_accepted"] > 0, "4d spec: no draft accepted")
            same = sum(int((got[u].tokens == np.asarray(ref_tokens[u])).sum())
                       for u in range(n_req))
            r["spec_vs_plain_agreement"] = same / (n_req * max_new)
            r["accept_rate"] = sched.spec_accept_rate()
            extra = (f"spec rounds {r['spec_rounds']}, draft steps {r['draft_steps']}, "
                     f"drafted {r['spec_drafted']}, accepted {r['spec_accepted']} (rate "
                     f"{r['accept_rate']:.4f}); bf16 agreement with phase 4b's non-spec tokens "
                     f"{same}/{n_req * max_new} = {r['spec_vs_plain_agreement']:.4f}")
        rep[name] = r
        print(f"[policies] {name}: {n_req} requests x {max_new} tokens in {wall:.3f} s = "
              f"{r['tokens_per_s']:.1f} tok/s; TTFT p50 {r['ttft_ms_p50']:.2f} ms, p90 "
              f"{r['ttft_ms_p90']:.2f} ms; decode {r['decode_ms_per_step']:.3f} ms per step "
              f"({steps} steps), {r['prefill_chunks']} prefill chunks; preemptions "
              f"{r['preemptions']}; peak memory {peak / 1e9:.3f} GB; runtime-plane launches "
              f"{r['active_launches']} == {per} x {planes}; paged launches "
              f"{r['paged_launches']} == {decode_calls} x {cfg.n_layers}; bitserial launches "
              f"{r['bitserial_launches']} == {per} x ({planes} + {static_calls}); {extra} "
              f"[{card}]", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return rep


def profile_continuous(engine, reqs, card):
    """Phase 5, continuous: torch.profiler over a short run of 8 requests
    (prompts cut to 128 tokens, 8 new tokens, all at step 0): device busy
    time against wall time, and the kernels by device time."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    work = [dataclasses.replace(r, uid=200 + i, tokens=r.tokens[:128], max_new=8)
            for i, r in enumerate(reqs[:8])]
    engine.generate(work[:1])  # warm-up
    torch.cuda.synchronize()
    sched = engine.scheduler
    sched.reset_telemetry()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(work)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_name(prof)
    if not by_name:
        print(f"[profile] continuous run: wall {wall_ms:.2f} ms under the profiler; device "
              f"time not measured (the profiler saw no device events) [{card}]")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    paged = {k: tn for k, tn in by_name.items() if "paged_attention" in k}
    print(f"[profile] continuous run, 8 requests x (128 prompt + 8 new), {sched.decode_steps} "
          f"decode steps, {sched.prefill_chunks} prefill chunks: wall {wall_ms:.2f} ms under the "
          f"profiler, device busy {busy:.2f} ms (idle {1 - busy / wall_ms:.1%}) [{card}]")
    for name, (t, n) in top:
        print(f"[profile]   {t:9.3f} ms {n:6d}x  {name[:90]}")
    if paged:  # a call is two kernels, the split walk and the merge
        t = sum(t for t, _ in paged.values())
        calls = sum(n for k, (_, n) in paged.items() if "merge" not in k)
        print(f"[profile]   paged_attention: {t:.3f} ms in {calls} calls (split walk and "
              f"merge), {1e3 * t / max(calls, 1):.2f} us each [{card}]")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "decode_steps": sched.decode_steps, "prefill_chunks": sched.prefill_chunks,
            "top": [{"name": k, "ms": t, "count": n} for k, (t, n) in top]}


def bgl_bound(xs, backward=False):
    """(ms, "bytes" or "operations"): the least the card could take for the
    sums of squares of the views ``xs`` (each read once, the f32 sums
    written once; two flops per element at the f32 rate) or for their
    gradients (each read once and its gradient written once, g read once;
    two flops per element)."""
    n = sum(x.numel() for x in xs)
    rows = sum(x.shape[0] for x in xs)
    nbytes = sum(x.numel() * x.element_size() for x in xs) * (2 if backward else 1) + 4 * rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * n / PEAK_FLOPS["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bgl_group_views():
    """The views of the grouped rows: one BSQ step's regulariser call each
    (every wp, then every wn), f32: phase 6's full-width granite-3-2b
    (TRAIN_LAYERS layers, 16 views), ResNet-20 width 16 (44, 19.5 MB), reduced
    qwen2-moe-a2.7b (24, per-(layer, expert) groups for the routed
    experts) and phase 6d's train_lm_bsq model, lm-100m (18, 12 stacked
    layers, 5.81 GB).  The last two are the shapes of their BSQ states,
    built as phases 3f and 6d build them (lm-100m's on the meta device,
    so no memory); the rows get random values."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.core import BSQConfig
    from repro_torch.examples.train_lm_bsq import LM_100M
    from repro_torch.optim import SGDM
    from repro_torch.train import init_bsq_state, state_reps

    regularizer = importlib.import_module("repro_torch.core.regularizer")

    def views(cfg, bsq_cfg, device):
        state, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, bsq_cfg, SGDM(),
                                    device)
        reps = list(state_reps(state, ctx).values())
        return [tuple(regularizer._rows(getattr(r, k), r.group_axes).shape)
                for k in ("wp", "wn") for r in reps]

    return {"granite-step": BGL_STEP,
            "resnet20-step": [(9, C) for C in RESNET_TENSOR_C] * 2,
            "qwen2-moe-reduced": views(reduced_config("qwen2-moe-a2.7b"),
                                       BSQConfig(n_init=8, compute_dtype=torch.float32), "cpu"),
            "lm-100m-step": views(LM_100M, BSQConfig(n_init=8, mode="static",
                                                     compute_dtype=torch.float32), "meta")}


def bgl_kernel_phase(dev, card, time_ms, report):
    """Phase 2c: the grouped bgl_sumsq kernel, one view at a time at the
    training slice's plane views and two ragged shapes (f32 and bf16) and
    at the plane views of ResNet-20, reduced qwen2-moe and lm-100m (f32);
    then grouped (:func:`bgl_group_views`), one launch per BSQ step's
    regulariser call, and its backward, one launch too: forward within
    BGL_TOL of the plain version per row, each view's sums bitwise its
    single-view call's, a second call bitwise; backward bitwise the plain
    ``x * (2 g)[:, None]`` and ``torch._foreach_mul``.  Each grouped row is
    timed beside its bound, the per-view calls it replaces summed (the
    one-view kernel forward, the plain per-view ops backward) and one
    library call (``torch._foreach_norm`` over its row views forward,
    ``torch._foreach_mul`` backward; yardsticks the port never calls)."""
    import torch

    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    cases = [("granite", shape, dt) for shape in BGL_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [("resnet20", shape, torch.float32) for shape in RESNET_BGL_SHAPES]
    groups = bgl_group_views()
    cases += [(model, shape, torch.float32)
              for model, group in (("qwen2-moe", "qwen2-moe-reduced"), ("lm-100m", "lm-100m-step"))
              for shape in sorted(set(groups[group]))]
    for model, (R, C), dt in cases:
        dname = str(dt).split(".")[-1]
        x = torch.randn((R, C), generator=gen, device=dev).to(dt)
        got = ops.bgl_sumsq(x)
        want = ref.bgl_sumsq_ref(x)
        torch.cuda.synchronize()
        rel = ((got - want).abs() / want).max().item()
        err = (got - want).abs().max().item()
        what = f"bgl_sumsq ({R}, {C}) {dname}"
        check(bool(torch.isfinite(got).all()) and rel <= BGL_TOL,
              f"{what} vs plain: max relative error {rel} > {BGL_TOL}")
        check(torch.equal(got, ops.bgl_sumsq(x)), f"{what}: a second call differs")
        row = {
            "model": model, "R": R, "C": C, "dtype": dname, "max_rel_err": rel,
            "max_abs_err": err,
            "max_plain": want.max().item(),
            "ms": time_ms(lambda: ops.bgl_sumsq(x)),
            "plain_ms": time_ms(lambda: ref.bgl_sumsq_ref(x), iters=5),
            "library_ms": time_ms(lambda: torch.linalg.vector_norm(x, dim=1,
                                                                   dtype=torch.float32)),
        }
        row["bound_ms"], row["bound_by"] = bgl_bound([x])
        rows.append(row)
        print(f"[bgl] {model} ({R}, {C}) {dname}: max rel err {rel:.3e} (abs {err:.3e} of "
              f"{row['max_plain']:.4e}); kernel {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
              f"vector_norm {row['library_ms']:.4f} ms [{card}]", flush=True)
        del x, got, want
    print(f"[bgl] one view a time: kernel == plain within {BGL_TOL} relative per row; second "
          "calls bitwise equal", flush=True)
    report["bgl"] = rows

    def host_ms(fn, n=20):
        """The wrapper's host time per call (the calls queue behind each other)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        return t

    single = {(r["R"], r["C"]): r for r in rows if r["dtype"] == "float32"}
    grouped = []
    for name, shapes in groups.items():
        xs = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        n_rows = sum(x.shape[0] for x in xs)
        bgl.reset_launches()
        got = ops.bgl_sumsq_grouped(xs)
        check(bgl.launches == 1, f"{name}: {bgl.launches} launches for {len(xs)} views")
        want = ref.bgl_sumsq_grouped_ref(xs)
        torch.cuda.synchronize()
        rel = ((got - want).abs() / want).max().item()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()) and rel <= BGL_TOL,
              f"bgl grouped {name} vs plain: max relative error {rel} > {BGL_TOL}")
        check(torch.equal(got, ops.bgl_sumsq_grouped(xs)), f"bgl grouped {name}: a second "
                                                            "call differs")
        check(torch.equal(got, torch.cat([ops.bgl_sumsq(x) for x in xs])),
              f"bgl grouped {name}: a view's sums differ from its single-view call's")
        del want
        g = torch.rand((n_rows,), generator=gen, device=dev)
        gs = torch.split(g, [x.shape[0] for x in xs])
        bgl.reset_launches()
        grads = bgl.bgl_sumsq_grouped_backward_cuda(xs, g)
        check(bgl.backward_launches == 1, f"{name}: {bgl.backward_launches} backward launches")
        for i, (x, gi) in enumerate(zip(xs, gs)):
            check(torch.equal(grads[i], ref.bgl_sumsq_grad_ref(x, gi)),
                  f"bgl grouped backward {name} view {i}: not the plain bits")
        again = bgl.bgl_sumsq_grouped_backward_cuda(xs, g)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"bgl grouped backward {name}: a second call differs")
        # the library yardstick of the backward: one _foreach_mul over the
        # views by (2 g)[:, None] per view (2 g made once, outside the timing)
        g2 = [t[:, None] for t in torch.split(2 * g, [x.shape[0] for x in xs])]
        lib_grads = torch._foreach_mul(xs, g2)
        check(all(torch.equal(a, b) for a, b in zip(grads, lib_grads)),
              f"bgl grouped backward {name}: _foreach_mul gives other bits than the kernel")
        del grads, again, lib_grads
        row_views = [x[r] for x in xs for r in range(x.shape[0])]
        spin = 4_000_000  # about 2 ms: longer than any of these calls' host side
        fwd = {"ms": time_ms(lambda: ops.bgl_sumsq_grouped(xs), spin=spin),
               "per_view_ms": sum(single[s]["ms"] for s in shapes),
               "plain_ms": time_ms(lambda: ref.bgl_sumsq_grouped_ref(xs), iters=5, spin=spin),
               "library_ms": time_ms(lambda: torch._foreach_norm(row_views), spin=spin)}
        fwd["bound_ms"], fwd["bound_by"] = bgl_bound(xs)
        fwd["host_ms"] = host_ms(lambda: ops.bgl_sumsq_grouped(xs))
        plain_bwd = time_ms(lambda: [ref.bgl_sumsq_grad_ref(x, gi) for x, gi in zip(xs, gs)],
                            iters=5, spin=spin)
        bwd = {"ms": time_ms(lambda: bgl.bgl_sumsq_grouped_backward_cuda(xs, g), spin=spin),
               "per_view_ms": plain_bwd, "plain_ms": plain_bwd,
               "library_ms": time_ms(lambda: torch._foreach_mul(xs, g2), spin=spin)}
        bwd["bound_ms"], bwd["bound_by"] = bgl_bound(xs, backward=True)
        bwd["host_ms"] = host_ms(lambda: bgl.bgl_sumsq_grouped_backward_cuda(xs, g))
        nbytes = sum(x.numel() * x.element_size() for x in xs)
        rec = {"group": name, "views": len(xs), "rows": n_rows, "bytes": nbytes,
               "max_rel_err": rel, "max_abs_err": err, "forward": fwd, "backward": bwd,
               "backward_max_abs_err": 0.0}  # bitwise the plain version: checked above
        grouped.append(rec)
        print(f"[bgl] grouped {name}: {len(xs)} views, {n_rows} rows, {nbytes / 1e6:.1f} MB "
              f"f32, 1 launch: max rel err {rel:.3e}; forward {fwd['ms']:.4f} ms ("
              f"{fwd['bound_ms'] / fwd['ms']:.1%} of its bound {fwd['bound_ms']:.4f} ms, "
              f"{fwd['bound_by']}), the "
              f"{len(xs)} one-view calls summed "
              f"{fwd['per_view_ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, _foreach_norm "
              f"{fwd['library_ms']:.4f} ms, host {1e3 * fwd['host_ms']:.1f} us per call; "
              f"backward {bwd['ms']:.4f} ms ({bwd['bound_ms'] / bwd['ms']:.1%} of its bound "
              f"{bwd['bound_ms']:.4f} ms), the per-view plain ops {bwd['plain_ms']:.4f} ms, "
              f"_foreach_mul {bwd['library_ms']:.4f} ms, host {1e3 * bwd['host_ms']:.1f} us per "
              f"call [{card}]", flush=True)
        del xs, row_views, got, g, gs, g2
    print(f"[bgl] grouped: one launch each way per group; forward within {BGL_TOL} per row, "
          "bitwise its one-view calls and a second call; backward bitwise the plain "
          "x * (2 g)[:, None], _foreach_mul and a second call", flush=True)
    report["bgl_grouped"] = grouped


def train_parity(dev, card, arch="granite-3-2b"):
    """Phase 3c: reduced ``arch`` (granite-3-2b; qwen2-moe-a2.7b in phase
    3f), f32, two BSQ train steps from one state on the card and on the
    CPU, then a requant.  A MoE model's CPU side routes as the card did
    (:class:`CardRouting`)."""
    import numpy as np
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.core import BSQConfig
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train import init_bsq_state, make_bsq_train_step, make_requant_step
    from repro_torch.tree import tree_map

    cfg = reduced_config(arch)
    bsq_cfg = BSQConfig(n_init=8, alpha=5e-3, compute_dtype=torch.float32)
    opt = SGDM()
    states = {}
    states["cpu"], ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, bsq_cfg, opt,
                                        "cpu")
    states["cuda"] = tree_map(lambda x: x.clone() if x.ndim == 0 else x.to(dev, copy=True),
                               states["cpu"])
    step = make_bsq_train_step(ctx, opt, step_decay(0.2, [100]))
    task = MarkovLM(vocab=cfg.vocab_size, seed=13)
    batches = [task.batch(np.random.default_rng(i), 4, 16) for i in range(2)]
    got = {"cpu": [], "cuda": []}
    bgl.reset_launches()
    routing = CardRouting()
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        with routing.record() if name == "cuda" else routing.replay():
            for b in batches:
                states[name], m = step(states[name], {k: torch.from_numpy(v).long().to(d)
                                                      for k, v in b.items()})
                got[name].append({k: float(m[k]) for k in ("ce", "aux", "reg", "total")})
    check(routing.tokens == sum(e.shape[0] * e.shape[1] for e in routing.calls),
          "the CPU did not replay every routed call of the card")
    check(routing.differ <= ROUTE_DIFFER_SHARE * routing.tokens,
          f"{routing.differ} of {routing.tokens} tokens would have routed otherwise on the CPU: "
          f"more than {ROUTE_DIFFER_SHARE:.0%}")
    # one grouped launch per regulariser evaluation (one per step) and one
    # for its backward
    check((bgl.launches, bgl.backward_launches) == (2, 2),
          f"{bgl.launches} bgl_sumsq launches and {bgl.backward_launches} backward launches "
          "on the card over 2 steps, expected 2 and 2")
    for i, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
        for k in a:
            check(abs(a[k] - b[k]) <= 1e-5 * abs(b[k]),
                  f"{arch} train step {i} {k}: card {a[k]} vs cpu {b[k]}")
    rq = make_requant_step(ctx)
    masks = {n: rq(states[n])["masks"] for n in states}
    for name in masks["cpu"]:
        check(torch.equal(masks["cuda"][name].cpu(), masks["cpu"][name]),
              f"masks after requant differ for {name}")
    print(f"[train-parity] reduced {arch} f32, 2 BSQ steps: card {got['cuda']} cpu "
          f"{got['cpu']}; within 1e-5 relative; masks after requant equal; "
          f"{bgl.launches} + {bgl.backward_launches} bgl_sumsq launches (forward + backward) on "
          f"the card over 2 steps, each over all {2 * len(ctx.meta)} plane views; "
          f"{routing.differ} of {routing.tokens} routed tokens would have routed "
          f"otherwise on the CPU [{card}]", flush=True)
    return {"card": got["cuda"], "cpu": got["cpu"], "bgl_launches": bgl.launches,
            "bgl_backward_launches": bgl.backward_launches,
            "near_ties": routing.differ, "routed_tokens": routing.tokens}


REMAT_POLICIES = ("none", "nothing", "dots", "mlp_names", "dots_offload")


def remat_parity(dev, card):
    """Phase 3c's remat rows: reduced granite-3-2b, f32, the gradients of one
    BSQ step's loss under every remat policy, on the card and on the CPU:
    each policy's card gradients bitwise those with remat off, or within
    phase 3's tolerance with the largest difference printed; the CPU's
    bitwise; card against CPU within phase 3's tolerance."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.core import BSQConfig
    from repro_torch.data import MarkovLM
    from repro_torch.optim import SGDM
    from repro_torch.train import bsq_loss, init_bsq_state
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import flatten_with_path, tree_map

    cfg = reduced_config("granite-3-2b")
    bsq_cfg = BSQConfig(n_init=8, alpha=5e-3, compute_dtype=torch.float32)
    state, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, bsq_cfg, SGDM(), "cpu")
    batch = MarkovLM(vocab=cfg.vocab_size, seed=13).batch(np.random.default_rng(0), 4, 16)
    grads = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        trainable = tree_map(lambda x: x.to(d, copy=True), state["trainable"])
        masks = tree_map(lambda x: x.to(d, copy=True), state["masks"])
        b = {k: torch.from_numpy(v).long().to(d) for k, v in batch.items()}
        for pol in REMAT_POLICIES:
            c = dataclasses.replace(ctx, cfg=cfg.scaled(remat=True, remat_policy=pol))
            _, _, g = value_and_grad(lambda tr: bsq_loss(tr, masks, b, c), trainable)
            grads[name, pol] = {k: v.cpu() for k, v in flatten_with_path(g)}
    rows = {}
    for pol in REMAT_POLICIES[1:]:
        diffs = {}
        for name in ("cuda", "cpu"):
            got, off = grads[name, pol], grads[name, "none"]
            diffs[name] = max(float((got[k] - off[k]).abs().max()) / max(
                float(off[k].abs().max()), 1e-30) for k in off)
        check(diffs["cpu"] == 0.0, f"remat {pol!r}: CPU gradients differ from remat off "
              f"({diffs['cpu']:.3e} of the largest)")
        check(diffs["cuda"] <= TOL["float32"], f"remat {pol!r}: card gradients "
              f"{diffs['cuda']:.3e} of the largest from remat off, over {TOL['float32']}")
        vs_cpu = max(float((grads["cuda", pol][k] - grads["cpu", pol][k]).abs().max()) / max(
            float(grads["cpu", pol][k].abs().max()), 1e-30) for k in grads["cpu", pol])
        check(vs_cpu <= TOL["float32"], f"remat {pol!r}: card against CPU {vs_cpu:.3e} of "
              f"the largest gradient, over {TOL['float32']}")
        rows[pol] = {"card_vs_off": diffs["cuda"], "card_vs_cpu": vs_cpu}
    print(f"[remat-parity] reduced granite-3-2b f32, one BSQ step's gradients under "
          f"{', '.join(REMAT_POLICIES[1:])}: card against remat off "
          + ", ".join(f"{p} {'bitwise' if r['card_vs_off'] == 0 else format(r['card_vs_off'], '.3e')}"
                      for p, r in rows.items())
          + f"; CPU bitwise; card against CPU at most "
          f"{max(r['card_vs_cpu'] for r in rows.values()):.3e} of each leaf's largest "
          f"(tolerance {TOL['float32']}) [{card}]", flush=True)
    return rows


def profile_train(state, ctx, dev, card, steps=2):
    """torch.profiler over two more BSQ train steps of the slice: device
    busy and idle share, the top device ops, bgl_sumsq's share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import MarkovLM, sharded_lm_iterator
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train import make_bsq_train_step

    step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [100]))
    data = sharded_lm_iterator(MarkovLM(vocab=ctx.cfg.vocab_size, seed=13), 8, 64, seed=1,
                               device=dev)
    batches = [next(data) for _ in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, m = step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = device_ms_by_name(prof)
    if not by_name:
        print(f"[profile] train step: wall {wall_ms:.2f} ms under the profiler; device time "
              f"not measured (the profiler saw no device events) [{card}]")
        return state, {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": None}
    busy = sum(t for t, _ in by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    bgl = [(t, n) for k, (t, n) in by_name.items() if "bgl_" in k]
    bgl_ms = sum(t for t, _ in bgl) / steps
    bgl_bwd_ms = sum(t for k, (t, _) in by_name.items() if "bgl_grad" in k) / steps
    print(f"[profile] BSQ train step, {TRAIN_LAYERS}-layer full-width granite-3-2b, batch 8 x 64: "
          f"wall "
          f"{wall_ms:.2f} ms under the profiler, device busy {busy:.2f} ms (idle "
          f"{1 - busy / wall_ms:.1%}); bgl_sumsq {bgl_ms:.3f} ms per step ({bgl_ms / busy:.1%} "
          f"of the busy time, {sum(n for _, n in bgl) / steps:.0f} kernels; the backward "
          f"{bgl_bwd_ms:.3f} ms of it) [{card}]")
    for name, (t, n) in top:
        print(f"[profile]   {t / steps:9.3f} ms/step {n / steps:6.0f}x  {name[:90]}")
    return state, {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
                   "bgl_ms_per_step": bgl_ms, "bgl_backward_ms_per_step": bgl_bwd_ms,
                   "top": [{"name": k, "ms_per_step": t / steps, "count_per_step": n / steps}
                           for k, (t, n) in top]}


REMAT_SHAPE = (4, 1, 4096)  # layers of full-width granite-3-2b, batch, sequence


def remat_memory(dev, card):
    """Phase 6's remat rows, where activations set the peak: full-width
    granite-3-2b cut to 4 layers, float weights, one 4096-token sequence
    (one row of train_4k), the loss's gradients under each remat policy:
    the median ms and median peak of ``max_memory_allocated`` above the
    weights of three, and the dry run's estimate of it (the counter's peak of live
    meta bytes; on meta "dots_offload" has no host to move its set to).
    Checks that "nothing" < "dots" <= "none" and "nothing" < "mlp_names"
    < "none" in peak, and that "dots_offload" holds about the device bytes
    of "nothing": above it by less than a quarter of what "dots" adds."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.optim import SGDM
    from repro_torch.roofline import analysis
    from repro_torch.train import abstract_plain_state
    from repro_torch.train.step import value_and_grad

    L, B, S = REMAT_SHAPE
    cfg = get_config("granite-3-2b").scaled(n_layers=L)
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32, device=dev,
                              generator=gen) for k in ("tokens", "labels")}
    mparams = abstract_plain_state(cfg, SGDM())["params"]
    mbatch = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    rows = {}
    for pol in REMAT_POLICIES:
        c = cfg.scaled(remat_policy=pol)
        with analysis.Counter() as counter:
            value_and_grad(lambda p: transformer.loss_fn(p, mbatch, c), mparams)
        times, peaks = [], []
        for _ in range(3):
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _, grads = value_and_grad(lambda p: transformer.loss_fn(p, batch, c), params)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() - base)
            total = float(loss)
            check(total == total and abs(total) < float("inf"), f"remat {pol!r}: loss {total}")
            del loss, grads
        rows[pol] = {"ms": sorted(times)[1], "step_ms": times, "peak_bytes": sorted(peaks)[1],
                     "meta_peak_bytes": counter.peak_live}
    peak = {p: r["peak_bytes"] for p, r in rows.items()}
    check(peak["nothing"] < peak["dots"] <= peak["none"], f"remat peaks: nothing "
          f"{peak['nothing']}, dots {peak['dots']}, none {peak['none']}")
    check(peak["nothing"] < peak["mlp_names"] < peak["none"], f"remat peaks: nothing "
          f"{peak['nothing']}, mlp_names {peak['mlp_names']}, none {peak['none']}")
    check(peak["dots_offload"] - peak["nothing"] < (peak["dots"] - peak["nothing"]) / 4,
          f"remat peaks: dots_offload {peak['dots_offload']} keeps its saved set on the "
          f"device (nothing {peak['nothing']}, dots {peak['dots']})")
    print(f"[train-remat] the loss's gradients of full-width granite-3-2b cut to {L} layers, "
          f"{B} x {S} tokens, per remat policy: median ms of 3, peak max_memory_allocated above "
          f"the weights (the dry run's meta estimate): "
          + ", ".join(f"{p} {r['ms']:.1f} ms, {r['peak_bytes'] / 1e9:.3f} GB "
                      f"({r['meta_peak_bytes'] / 1e9:.3f})" for p, r in rows.items())
          + f"; nothing < dots <= none, nothing < mlp_names < none, dots_offload "
          f"{(peak['dots_offload'] - peak['nothing']) / 1e9:+.3f} GB of nothing against dots' "
          f"{(peak['dots'] - peak['nothing']) / 1e9:+.3f} [{card}]", flush=True)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def bsq_slice(dev, card):
    """Phase 6: BSQ-train full-width granite-3-2b (TRAIN_LAYERS layers) through the
    launcher (requant every TRAIN_INTERVAL steps, no checkpoint), export, serve."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import export_packed, merge_params
    from repro_torch.core.bitrep import total_numel
    from repro_torch.core.requant import forward_value
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import train as launcher
    from repro_torch.serve import Request
    from repro_torch.train import state_reps

    full = get_config("granite-3-2b")
    cfg = full.scaled(n_layers=TRAIN_LAYERS)
    workdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    # the first checkpoint would fall past the run's end: phase 6 writes none
    # (6f's reduced 2x2 -> 4x1 resume holds the card's checkpoint I/O; the
    # 2x2 <-> 2x2x2 resume is tested on the CPU, tests/test_torch_pod_mesh.py)
    a = launcher.build_parser().parse_args([
        "--full", "--steps", str(TRAIN_STEPS), "--requant-interval", str(TRAIN_INTERVAL),
        "--ckpt-interval", str(TRAIN_STEPS + 1), "--workdir", str(workdir)])
    print(f"[train] granite-3-2b at its published width (d_model={cfg.d_model}, d_ff="
          f"{cfg.d_ff}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}->{cfg.padded_vocab}); reduced: "
          f"n_layers {full.n_layers} -> {cfg.n_layers} so the BSQ state fits one card; "
          f"BSQ n_init=8 (9 planes), alpha={a.alpha}, static, bf16 weights; SGDM, "
          f"step_decay({a.lr}) over --steps, batch {a.batch} x seq {a.seq}, grad "
          f"clip 1.0; {TRAIN_STEPS} steps, requant at steps {TRAIN_INTERVAL} and "
          f"{TRAIN_STEPS}, no checkpoint", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for m in (bgl, bsm, pa, fa):
        m.reset_launches()
    t0 = time.perf_counter()
    out = launcher.run(cfg, a, log_interval=1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state, ctx, scheme, hist = out["state"], out["ctx"], out["scheme"], out["history"]
    n_rep = len(ctx.meta)
    check(n_rep == 8, f"{n_rep} quantised tensors, expected 8")
    # one grouped launch over the 16 plane views per step, one backward
    check(launches["bgl_sumsq"] == launches["bgl_sumsq_backward"] == TRAIN_STEPS,
          f"{launches['bgl_sumsq']} bgl_sumsq launches and {launches['bgl_sumsq_backward']} "
          f"backward launches, expected {TRAIN_STEPS} each")
    check(launches["bitserial_matmul"] == launches["paged_attention"]
          == launches["flash_attention"] == 0,
          f"training launched serving kernels: {launches}")
    check([h["step"] for h in hist] == list(range(1, TRAIN_STEPS + 1)),
          f"history steps {[h['step'] for h in hist]}")
    for h in hist:
        check(all(np.isfinite(h[k]) for k in ("ce", "reg", "total", "grad_norm")),
              f"non-finite metrics at step {h['step']}: {h}")
    dts = [h["dt"] for h in hist]
    # the first step pays for first-call allocations
    step_ms = 1e3 * float(np.median(dts[1:]))
    nq = ctx.total_quant_params
    print(f"[train] {TRAIN_STEPS} steps in {train_s:.1f} s (the init, the requants and the "
          f"final one included); ms per step {step_ms:.1f} (median of the steps after the "
          f"first; step 1 {1e3 * dts[0]:.1f}); peak memory "
          f"{peak / 1e9:.2f} GB; {nq:,} quantised parameters; bgl_sumsq launches "
          f"{launches['bgl_sumsq']} + {launches['bgl_sumsq_backward']} backward == "
          f"{TRAIN_STEPS} + {TRAIN_STEPS}, each over {2 * n_rep} plane views [{card}]",
          flush=True)
    for h in hist:
        print(f"[train]   step {h['step']}: ce {h['ce']:.4f} reg {h['reg']:.2f} total "
              f"{h['total']:.4f} grad_norm {h['grad_norm']:.4f} lr {h['lr']:.4g} dt "
              f"{1e3 * h['dt']:.1f} ms")
    print(f"[train] final scheme: {scheme.bits_per_param:.3f} bits/param, compression "
          f"{scheme.compression:.3f}x vs f32", flush=True)
    shutil.rmtree(workdir, ignore_errors=True)

    # export, and the serving tree: packed projections, reconstructed
    # embedding, float norms (cloned: the profiled steps below update them)
    reps = state_reps(state, ctx)
    t0 = time.perf_counter()
    packed = export_packed(reps)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    packed_bytes = sum(pw.hbm_bytes() for pw in packed.values())
    bf16_bytes = 2 * sum(total_numel(r) for r in reps.values())
    served = {k: v for k, v in packed.items() if k != "embed"}
    served["embed"] = forward_value(reps["embed"])
    floats = {k: v.clone() for k, v in state["trainable"]["float"].items()}
    params = merge_params(ctx.template, served, floats)
    print(f"[export] export_packed in {export_s:.2f} s: {packed_bytes / 1e6:.1f} MB packed "
          f"against {bf16_bytes / 1e6:.1f} MB in bf16 ({bf16_bytes / packed_bytes:.2f}x); "
          f"bits: " + ", ".join(f"{k.rsplit('/', 1)[-1]}={pw.n_bits}"
                                for k, pw in packed.items()), flush=True)
    del reps, packed

    state, prof = profile_train(state, ctx, dev, card)

    del state, out
    gc.collect()
    torch.cuda.empty_cache()

    # serve the exported weights
    CheckedEngine = checked_engine_cls()
    engine = CheckedEngine(params, cfg, max_len=64, device=dev)
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    n_new, plen = 8, 16
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(50 + i), 1, plen)[0, :plen]
                    .astype(np.int32), max_new=n_new) for i in range(4)]
    for m in (bgl, bsm, pa, fa):
        m.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    toks = np.stack([r.tokens for r in sorted(results, key=lambda r: r.uid)])
    check(toks.shape == (4, n_new), f"served tokens of shape {toks.shape}")
    check(((toks >= 0) & (toks < cfg.vocab_size)).all(), "served token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    expected = n_new * cfg.n_layers * 7
    check(bsm.launches == expected and bgl.launches == bgl.backward_launches == 0
          and fa.launches == cfg.n_layers,
          f"serving launches: bitserial {bsm.launches} (expected {expected}), bgl "
          f"{bgl.launches} + {bgl.backward_launches}, flash {fa.launches} (expected one prefill "
          f"x {cfg.n_layers})")
    print(f"[serve-bsq] 4 requests x {n_new} tokens from the exported packed weights in "
          f"{serve_s:.3f} s: tokens {toks.tolist()}; bitserial launches {bsm.launches} == "
          f"{n_new} x {cfg.n_layers} x 7; flash launches {fa.launches} [{card}]", flush=True)
    return {"train_s": train_s, "ms_per_step": step_ms, "step_dt_s": dts, "peak_bytes": peak,
            "launches": launches, "history": hist, "quantised_params": nq,
            "bits_per_param": scheme.bits_per_param, "compression": scheme.compression,
            "export_s": export_s, "packed_bytes": packed_bytes, "bf16_bytes": bf16_bytes,
            "profile": prof,
            "serve_s": serve_s, "tokens": toks.tolist(), "serve_bitserial_launches": expected}


def _held_to_bound(what, card_ms, terms, card, floor_bytes, floor_what):
    """Check a measured step against the dry run's analysis bound and
    print its share, which term bounds it and the top 5 ops by bytes.
    That bound counts the eager port's own op traffic (every unfused pass
    read and written once), so it shrinks as passes fuse; beside it the
    step's share of a limit that no implementation passes: ``floor_bytes``
    (``floor_what``) over the data sheet's memory rate."""
    bound_ms = 1e3 * terms.step_time_lower_bound_s
    floor_ms = 1e3 * floor_bytes / HBM_BYTES_PER_S
    check(card_ms >= bound_ms, f"{what}: measured {card_ms:.3f} ms under the analysis bound "
          f"{bound_ms:.3f} ms")
    top = ", ".join(f"{name} {b / 1e9:.3f} GB x{n}" for name, b, n in terms.op_byte_profile(5))
    print(f"[dryrun] {what}: measured {card_ms:.3f} ms (median), eager op-traffic bound "
          f"{bound_ms:.4f} ms ({terms.bottleneck}: {terms.flops_per_device / 1e12:.4f} TFLOP, "
          f"{terms.bytes_per_device / 1e9:.3f} GB; computed from the H100 data sheet), "
          f"{100 * bound_ms / card_ms:.2f} % of it (share of the eager op-traffic bound); "
          f"the limit of {floor_what}, {floor_bytes / 1e9:.3f} GB, {floor_ms:.4f} ms, "
          f"{100 * floor_ms / card_ms:.2f} % of it; top 5 ops by bytes: {top} "
          f"[{card}]", flush=True)
    return {"ms": card_ms, "bound_ms": bound_ms, "bound_by": terms.bottleneck,
            "flops": terms.flops_per_device, "bytes": terms.bytes_per_device,
            "floor_ms": floor_ms, "floor_bytes": floor_bytes,
            "launches": terms.launches, "top": terms.op_byte_profile(5)}


def dryrun_phase(dev, card, dry_recs):
    """Phase 6e: the dry run's counter (``roofline.analysis`` on meta
    tensors) held against the card: the data-sheet constants beside the
    card's own figures; phase 4's granite-3-2b decode step and phase 6's
    BSQ train step on the card and on meta (argument bytes and kernel
    launches exactly equal, each measured step at least its analysis
    bound); the counter's FLOPs and bytes of every phase-2 bitserial call
    exactly ``bitserial_work``'s; the dry-run CLI on granite-3-2b x
    decode_32k."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import BSQConfig
    from repro_torch.core.packing import abstract_packed
    from repro_torch.data import MarkovLM, sharded_lm_iterator
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.roofline import analysis, hw
    from repro_torch.serve.engine import serving_params
    from repro_torch.train import abstract_bsq_state, init_bsq_state, make_bsq_train_step

    rep = {}
    props = torch.cuda.get_device_properties(0)
    print(f"[dryrun] roofline.hw (H100 SXM data sheet): HBM {hw.HBM_BYTES / 1e9:.0f} GB at "
          f"{hw.HBM_BW / 1e12:.2f} TB/s, bf16 {hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s, f32 "
          f"{hw.PEAK_FLOPS_F32 / 1e12:.0f}, TF32 {hw.PEAK_FLOPS_TF32 / 1e12:.0f}, {hw.SM_COUNT} "
          f"SMs, {hw.SMEM_BYTES // 1024} KiB shared memory per SM, NVLink "
          f"{hw.LINK_BW / 1e9:.0f} GB/s; the card: total_memory {props.total_memory / 1e9:.2f} "
          f"GB, multi_processor_count {props.multi_processor_count}, "
          f"{torch.cuda.get_device_name(0)}, {card}", flush=True)
    rep["card"] = {"total_memory": props.total_memory,
                   "multi_processor_count": props.multi_processor_count}

    # phase 4's decode step: 40 layers, bf16, 6-bit, 4 lanes, 128 + 32 positions
    cfg = get_config("granite-3-2b")
    B, P, NEW = 4, 128, 32
    params = serving_params(transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev, pack_bits=N_BITS), cfg, dev)
    cache = transformer.init_cache(cfg, B, P + NEW, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    transformer.decode_step(params, cache, tok, P, cfg)  # warm
    times, launches = [], []
    for i in range(5):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transformer.decode_step(params, cache, tok, P + 1 + i, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(bsm.launches)
    mparams = dryrun._serving_tree(cfg, N_BITS)
    mcache = transformer.init_cache(cfg, B, P + NEW, device="meta")
    with analysis.Counter() as counter:
        transformer.decode_step(mparams, mcache, torch.empty_like(tok, device="meta"), P + 1,
                                cfg)
    terms = counter.terms(1)
    card_bytes, meta_bytes = analysis._shape_bytes(params), analysis._shape_bytes(mparams)
    check(meta_bytes == card_bytes, f"decode: the meta tree's argument bytes {meta_bytes} != "
          f"the card's {card_bytes}")
    check(set(launches) == {terms.launches.get("bitserial_matmul")},
          f"decode: bitserial launches per step {launches} on the card, "
          f"{terms.launches} counted on meta")
    print(f"[dryrun] granite-3-2b decode step (40 layers, bf16, {N_BITS}-bit, {B} lanes, "
          f"{P} + {NEW} positions): packed tree {card_bytes / 1e9:.4f} GB on the card == on "
          f"meta; bitserial launches {launches[0]} per step on the card == on meta", flush=True)
    cache_bytes = analysis._shape_bytes(cache)
    rep["decode"] = _held_to_bound("granite-3-2b decode step", float(np.median(times)), terms,
                                   card, card_bytes + cache_bytes,
                                   "the weights and the cache read once")
    rep["decode"]["argument_bytes"] = card_bytes
    del params, cache, mparams, mcache
    gc.collect()
    torch.cuda.empty_cache()

    # a BSQ train step of 2 layers at full width (phase 6 trains
    # TRAIN_LAYERS), bf16 weights, batch 8 x 64
    cfg2 = cfg.scaled(n_layers=2)
    bsq_cfg = BSQConfig(n_init=8, alpha=5e-3, mode="static", compute_dtype=torch.bfloat16)
    opt, lr_fn = SGDM(), step_decay(0.2, [100])
    state, ctx = init_bsq_state(torch.Generator(device=dev).manual_seed(0), cfg2, bsq_cfg, opt,
                                dev)
    mstate, mctx = abstract_bsq_state(cfg2, bsq_cfg, opt)
    card_bytes, meta_bytes = analysis._shape_bytes(state), analysis._shape_bytes(mstate)
    check(meta_bytes == card_bytes, f"train: the meta state's bytes {meta_bytes} != the "
          f"card's {card_bytes}")
    step = make_bsq_train_step(ctx, opt, lr_fn)
    data = sharded_lm_iterator(MarkovLM(vocab=cfg2.vocab_size, seed=13), 8, 64, seed=0,
                               device=dev)
    state, _ = step(state, next(data))  # warm
    times, launches = [], []
    for _ in range(3):
        b = next(data)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append((bgl.launches, bgl.backward_launches))
    mb = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in b.items()}
    with analysis.Counter() as counter:
        make_bsq_train_step(mctx, opt, lr_fn)(mstate, mb)
    terms = counter.terms(1)
    want = (terms.launches.get("bgl_sumsq"), terms.launches.get("bgl_sumsq_backward"))
    check(set(launches) == {want} == {(1, 1)}, f"train: bgl_sumsq launches (forward, backward) "
          f"per step {launches} on the card, {want} counted on meta, expected (1, 1)")
    print(f"[dryrun] BSQ train step (2-layer full-width granite-3-2b, batch 8 x 64): state "
          f"{card_bytes / 1e9:.3f} GB on the card == on meta; bgl_sumsq launches 1 + 1 "
          f"backward per step on the card == on meta", flush=True)
    rep["train"] = _held_to_bound("BSQ train step", float(np.median(times)), terms, card,
                                  2 * card_bytes, "the state read once and written once")
    rep["train"]["state_bytes"] = card_bytes
    del state, ctx, mstate, mctx, step
    gc.collect()
    torch.cuda.empty_cache()

    # every phase-2 bitserial call: the counter's FLOPs and bytes == bitserial_work's
    n = 0
    for M, K, N, groups, dname, _ in bitserial_shapes():
        pw = abstract_packed((K, N), N_BITS)
        if groups:
            pw.scale = torch.empty((1, groups), dtype=torch.float32, device="meta")
        x = torch.empty((M, K), dtype=getattr(torch, dname), device="meta")
        t = analysis.analyze(ops.bitserial_matmul, x, pw)
        want = bitserial_work(M, K, N, dname, groups=groups or 1)
        check((t.flops_per_device, t.bytes_per_device) == want
              and t.launches == {"bitserial_matmul": 1},
              f"bitserial M={M} K={K} N={N} groups={groups} {dname}: counted "
              f"{(t.flops_per_device, t.bytes_per_device)}, bound_ms's {want}")
        n += 1
    print(f"[dryrun] the counter's FLOPs and bytes equal bound_ms's for all {n} phase-2 "
          f"bitserial calls, one launch each", flush=True)
    rep["bitserial_shapes"] = n

    # the dry-run CLI on one card (run beside phases 3-3h with the pod cells)
    recs = dict(dry_recs)
    _, log = recs.pop("one_card")
    ok = [line for line in log.splitlines() if line.startswith("[ok]")]
    check(len(ok) == 1, f"dryrun CLI: {log[-1500:]}")
    print(f"[dryrun] python -m repro_torch.launch.dryrun --arch granite-3-2b --shape "
          f"decode_32k: {ok[0]}", flush=True)
    rep["cli"] = ok[0]
    rep["pod"] = pod_dryrun_cells(recs, card)
    return rep


# phase 6e's dry-run CLI runs, on meta tensors on the host: granite-3-2b x
# decode_32k on one card, then the production meshes, full-width
# granite-3-2b as rank 0 of each mesh sees it (minutes of host time for a
# train cell), and hillclimb's A3 (on 16x16) and A6 (on 2x16x16); started as
# processes of their own as phase 3 starts, waited for before phase 4
# (phases 3-3h time nothing that the script reports: their outputs are
# parity checks) and read in phase 6e
DRYRUNS = {
    "one_card": ["repro_torch.launch.dryrun", "--arch", "granite-3-2b", "--shape",
                 "decode_32k"],
    "decode": ["repro_torch.launch.dryrun", "--arch", "granite-3-2b", "--shape", "decode_32k",
               "--single-pod", "--multi-pod"],
    "train_16x16": ["repro_torch.launch.dryrun", "--arch", "granite-3-2b", "--shape",
                    "train_4k", "--single-pod"],
    "train_2x16x16": ["repro_torch.launch.dryrun", "--arch", "granite-3-2b", "--shape",
                      "train_4k", "--multi-pod"],
    "hillclimb_a3": ["repro_torch.launch.hillclimb", "--cell", "A", "--only", "dots+bf16"],
    "hillclimb_a6": ["repro_torch.launch.hillclimb", "--cell", "A", "--only",
                     "dots_bf16_multipod"],
}
POD_DRYRUN_WAIT_S = 600  # the most the script waits for them after phase 3h
BACKGROUND = []  # the processes this script started; main stops any still running


def start_pod_dryruns():
    """Start DRYRUNS, one process each, their records and logs under
    chiprun_out/pod_dryrun; returns name -> (process, record path, log path)."""
    out = ROOT / "chiprun_out" / "pod_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jobs = {}
    for name, args in DRYRUNS.items():
        path, log = out / f"{name}.json", out / f"{name}.log"
        # at the lowest priority: phase 3's CPU references keep the cores
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, "-m", *args, "--out", str(path)], cwd=ROOT,
                                    env=env, stdout=f, stderr=subprocess.STDOUT,
                                    preexec_fn=lambda: os.nice(19))
        BACKGROUND.append(proc)
        jobs[name] = (proc, path, log)
    return jobs


def wait_pod_dryruns(jobs):
    """Wait for each of start_pod_dryruns's processes (so that no timed
    phase runs beside them); name -> (its records, its log)."""
    recs = {}
    t0 = time.perf_counter()
    for name, (proc, path, log) in jobs.items():
        try:
            rc = proc.wait(timeout=max(1.0, POD_DRYRUN_WAIT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "killed after waiting"
        check(rc == 0 and path.exists(), f"[6e] pod dry run {name}: rc {rc}; "
                                         f"{log.read_text()[-1500:]}")
        recs[name] = json.loads(path.read_text()), log.read_text()
    print(f"[6e] the dry runs (on the host, beside phases 3-3h) done; waited "
          f"{time.perf_counter() - t0:.1f} s for them after phase 3h", flush=True)
    return recs


def pod_dryrun_cells(runs, card):
    """Phase 6e's pod-mesh cells from wait_pod_dryruns's records: check
    every record ``ok`` with JAX's microbatches (16 on 16x16, 8 on 2x16x16
    for train_4k) and non-zero collective bytes, print each record's
    memory, roofline terms and collective bytes by kind (computed: the
    collective term divides by one NVLink direction, 450 GB/s, a floor
    where a 16-wide axis crosses the network), and read A6 against A3."""
    recs = {name: rs for name, (rs, _) in runs.items()}
    rows = {}
    for name, rs in recs.items():
        for r in rs:
            key = r.get("label", f"{r['shape']} {r['mesh']}")
            check(r["status"] == "ok", f"[6e] {name} {key}: {r.get('error')}")
            coll = r["roofline"]["collectives"]
            check(coll["all-gather"] > 0 and coll["all-reduce"] > 0,
                  f"[6e] {name} {key}: collective bytes {coll}")
            if r["kind"] == "train":
                want = {"16x16": 16, "2x16x16": 8}[r["mesh"]]
                check(r["microbatches"] == want, f"[6e] {name} {key}: microbatches "
                                                 f"{r['microbatches']}, JAX's default {want}")
            m, t = r["memory"], r["roofline"]
            print(f"[6e] {r['arch']} x {r['shape']} x {r['mesh']}"
                  + (f" ({r['label']})" if "label" in r else "")
                  + f", microbatches {r['microbatches']}: args {m['argument_bytes'] / 1e9:.3f} + "
                  f"temp {m['temp_bytes'] / 1e9:.3f} GB; compute {t['compute_s'] * 1e3:.2f} ms, "
                  f"memory {t['memory_s'] * 1e3:.2f} ms, collective {t['collective_s'] * 1e3:.2f} "
                  f"ms -> {t['bottleneck']}; collective bytes per device by kind: "
                  + ", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in coll.items() if v)
                  + f"; meta run {r['compile_s']} s (computed: H100 data-sheet figures, the "
                  f"collective term at one NVLink direction, a floor) [{card}]", flush=True)
            rows[f"{name}/{key}"] = r
    a3, a6 = recs["hillclimb_a3"][-1], recs["hillclimb_a6"][-1]
    check(a3["mesh"] == "16x16" and a6["mesh"] == "2x16x16",
          f"[6e] A3 on {a3['mesh']}, A6 on {a6['mesh']}")
    ratio = a6["memory"]["temp_bytes"] / a3["memory"]["temp_bytes"]
    print(f"[6e] hillclimb A6 (2x16x16) against A3 (16x16): temp {ratio:.3f}x, argument bytes "
          f"{a6['memory']['argument_bytes'] / a3['memory']['argument_bytes']:.3f}x, collective "
          f"bytes {a6['roofline']['collective_bytes_per_device'] / a3['roofline']['collective_bytes_per_device']:.3f}x "
          f"(JAX's microbatches give each device one row a microbatch on both meshes) [{card}]",
          flush=True)
    return {"records": rows, "a6_over_a3_temp": ratio}


def _launch_counts():
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    return {"bgl_sumsq": bgl.launches, "bgl_sumsq_backward": bgl.backward_launches,
            "bitserial_matmul": bsm.launches, "paged_attention": pa.launches,
            "flash_attention": fa.launches}


def _reset_launches() -> None:
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    for m in (bgl, bsm, pa, fa):
        m.reset_launches()


def resnet_parity(dev, card):
    """Phase 6b: full-width ResNet-20 (width 16), f32, one batch of 64
    gaussian_blobs images: two BSQ steps of the paper pipeline from one
    state on the card and on the CPU, then a requant.

    A 4-bit activation is a step function of its input, and its STE
    derivative (1 inside ReLU6's [0, 6], 0 outside) another: where the
    card's and the CPU's f32 sums put an input on either side of a level
    boundary, the two activations differ by a whole level (0.4), and where
    they put it on either side of 0 or 6, the gradient through it differs
    by the whole upstream gradient; both changes spread.  So the CPU side
    is fed the card's activation values and derivatives: each activation's
    input is held against the card's within RESNET_ACT_TOL of the layer's
    max, and the activations and derivatives the CPU would have taken
    otherwise (their inputs then lie within that tolerance of a boundary)
    are counted.  Then the losses agree within 1e-5 relative, every plane
    gradient within 1e-4 of its max |CPU grad|, and the masks after
    requant are equal.  The free-running loss gap is printed beside it."""
    import numpy as np
    import torch

    from repro_torch.data import gaussian_blobs
    from repro_torch.examples import resnet20_bsq_paper as paper
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.models import resnet
    from repro_torch.tree import tree_map

    cpu = torch.device("cpu")
    p_cpu = resnet.init_resnet20(torch.Generator().manual_seed(0), width=RESNET_WIDTH,
                                 device=cpu)
    runs = {"cuda": paper.PaperBSQ(tree_map(lambda x: x.to(dev, copy=True), p_cpu),
                                   RESNET_WIDTH),
            "cpu": paper.PaperBSQ(p_cpu, RESNET_WIDTH)}
    b = gaussian_blobs(np.random.default_rng(0), RESNET_BATCH)
    data = {n: (torch.from_numpy(b["images"]).to(d), torch.from_numpy(b["labels"]).long().to(d))
            for n, d in (("cuda", dev), ("cpu", cpu))}
    _reset_launches()
    with torch.no_grad():
        free = {n: float(runs[n].loss(runs[n].trainable, *data[n])[0]) for n in runs}

    orig_act = resnet._act
    recorded = []
    forced = {"flips": 0, "derivative_flips": 0, "acts": 0, "max_rel_err": 0.0, "calls": 0}

    def derivative(x, act_bits):
        """d act / dx, elementwise (the STE's)."""
        xd = x.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(orig_act(xd, act_bits).sum(), xd)[0]

    def record(x, act_bits):
        y = orig_act(x, act_bits)
        recorded.append((x.detach().cpu(), y.detach().cpu(), derivative(x, act_bits).cpu()))
        return y

    def replay(x, act_bits):
        x_card, y_card, d_card = recorded.pop(0)
        scale = x_card.abs().max().item()
        rel = (x.detach() - x_card).abs().max().item() / max(scale, 1e-30)
        forced["max_rel_err"] = max(forced["max_rel_err"], rel)
        # the STE's value and derivative differ by an ulp between the devices
        # anyway: count what moved by half a level, or from 0 to 1
        half_level = 3.0 / (2**act_bits - 1)
        forced["flips"] += int(((orig_act(x.detach(), act_bits) - y_card).abs()
                                > half_level).sum())
        forced["derivative_flips"] += int(((derivative(x, act_bits) - d_card).abs()
                                           > 0.5).sum())
        forced["acts"] += x.numel()
        forced["calls"] += 1
        return y_card + (x - x.detach()) * d_card  # the card's value and derivative

    steps = []
    try:
        for i in range(2):
            got = {}
            for name, act in (("cuda", record), ("cpu", replay)):
                resnet._act = act
                got[name] = runs[name].grads(*data[name])
            resnet._act = orig_act
            check(not recorded, f"step {i}: {len(recorded)} card activations not replayed")
            (lc, mc, gc_), (lp, mp, gp) = got["cuda"], got["cpu"]
            rec = {"loss": (float(lc), float(lp)), "ce": (float(mc["ce"]), float(mp["ce"]))}
            check(abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp)),
                  f"step {i}: loss card {float(lc)} vs cpu {float(lp)}")
            worst = 0.0
            for name in gp:
                for k in ("wp", "wn"):
                    want = gp[name][k]
                    d = (gc_[name][k].cpu() - want).abs().max().item()
                    rel = d / max(want.abs().max().item(), 1e-30)
                    worst = max(worst, rel)
                    check(rel <= 1e-4, f"step {i}: {name} {k} gradient differs by {rel:.3e} of "
                                       "its max |CPU grad|")
            rec["max_plane_grad_rel_err"] = worst
            steps.append(rec)
            for name in runs:
                runs[name].apply(got[name][2])
    finally:
        resnet._act = orig_act
    check(forced["max_rel_err"] <= RESNET_ACT_TOL,
          f"activation inputs differ by {forced['max_rel_err']:.3e} of the layer's max")
    for r in runs.values():
        r.requant()
    masks = {n: {k: r.mask for k, r in runs[n].reps.items()} for n in runs}
    for name in masks["cpu"]:
        check(torch.equal(masks["cuda"][name].cpu(), masks["cpu"][name]),
              f"masks after requant differ for {name}")
    launches = _launch_counts()
    # one grouped launch each for the free-running loss and two steps; a
    # backward launch for each step
    check((launches["bgl_sumsq"], launches["bgl_sumsq_backward"]) == (3, 2),
          f"{launches['bgl_sumsq']} bgl_sumsq launches and {launches['bgl_sumsq_backward']} "
          "backward launches on the card, expected 3 and 2")
    print(f"[resnet-parity] ResNet-20 width {RESNET_WIDTH}, f32, batch {RESNET_BATCH}, 2 BSQ "
          f"steps card vs cpu: losses {[r['loss'] for r in steps]} within 1e-5 relative; plane "
          f"gradients within {max(r['max_plane_grad_rel_err'] for r in steps):.3e} of max "
          f"(limit 1e-4); masks after requant equal; activations forced from the card: "
          f"{forced['calls']} calls, inputs within {forced['max_rel_err']:.3e} of the layer max "
          f"(limit {RESNET_ACT_TOL}), {forced['flips']} of {forced['acts']:,} rounded to the "
          f"other level, {forced['derivative_flips']} took the other derivative; free-running "
          f"first loss card {free['cuda']:.7f} cpu {free['cpu']:.7f} "
          f"(gap {abs(free['cuda'] - free['cpu']) / free['cpu']:.3e} relative); "
          f"{bgl.launches} + {bgl.backward_launches} bgl_sumsq launches (forward + backward, "
          f"each over {2 * len(RESNET_TENSOR_C)} views) [{card}]", flush=True)
    return {"steps": steps, "forced": forced, "free_loss": free, "launches": launches}


def resnet_step_bound_ms(width, batch, n_quantised, planes=9, img=32, classes=10):
    """The least time of one BSQ step of ResNet-20: its convs' and fc's
    operations, forward and backward (twice the forward: the input's and
    the kernel's gradients), at the f32 rate (TF32 is off), against the
    plane state's bytes (wp and wn read and written by the update, their
    gradients written and read, the momentum read and written)."""
    def conv(k, cin, cout, size):
        return 2.0 * batch * size * size * k * k * cin * cout

    flops, cin, size = conv(3, 3, width, img), width, img
    for stage in range(3):
        cout = width * 2**stage
        for blk in range(3):
            stride = 2 if stage > 0 and blk == 0 else 1
            size //= stride
            flops += conv(3, cin, cout, size) + conv(3, cout, cout, size)
            if stride != 1 or cin != cout:
                flops += conv(1, cin, cout, size)
            cin = cout
    flops = 3 * (flops + 2.0 * batch * cin * classes)
    nbytes = 6 * 2 * planes * 4 * n_quantised
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def profile_resnet(dev, card, steps=3):
    """torch.profiler over BSQ steps of a fresh ResNet-20 pipeline state
    (after one unprofiled step): device busy time and idle share, device
    kernels per step, bgl_sumsq's share, the top device ops."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import gaussian_blobs
    from repro_torch.examples import resnet20_bsq_paper as paper
    from repro_torch.models import resnet

    run = paper.PaperBSQ(resnet.init_resnet20(torch.Generator(device=dev).manual_seed(1),
                                              width=RESNET_WIDTH, device=dev), RESNET_WIDTH)
    b = gaussian_blobs(np.random.default_rng(1), RESNET_BATCH)
    images, labels = torch.from_numpy(b["images"]).to(dev), torch.from_numpy(b["labels"]).to(dev)
    run.step(images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run.step(images, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = device_ms_by_name(prof)
    if not by_name:
        print(f"[profile] ResNet-20 BSQ step: wall {wall_ms:.2f} ms under the profiler; device "
              f"time not measured (the profiler saw no device events) [{card}]")
        return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": None}
    busy = sum(t for t, _ in by_name.values()) / steps
    kernels = sum(n for _, n in by_name.values()) / steps
    bgl_ms = sum(t for k, (t, _) in by_name.items() if "bgl_" in k) / steps
    bgl_bwd_ms = sum(t for k, (t, _) in by_name.items() if "bgl_grad" in k) / steps
    bgl_n = sum(n for k, (_, n) in by_name.items() if "bgl_" in k) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[profile] ResNet-20 BSQ step (width {RESNET_WIDTH}, batch {RESNET_BATCH}): wall "
          f"{wall_ms:.2f} ms under the profiler, device busy {busy:.3f} ms (idle "
          f"{1 - busy / wall_ms:.1%}), {kernels:.0f} device kernels per step; bgl_sumsq "
          f"{bgl_ms:.3f} ms per step in {bgl_n:.0f} kernels (the backward {bgl_bwd_ms:.3f} ms) "
          f"[{card}]", flush=True)
    for name, (t, n) in top:
        print(f"[profile]   {t / steps:9.3f} ms/step {n / steps:6.0f}x  {name[:90]}")
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
            "kernels_per_step": kernels, "bgl_ms_per_step": bgl_ms,
            "bgl_backward_ms_per_step": bgl_bwd_ms, "bgl_kernels_per_step": bgl_n,
            "top": [{"name": k, "ms_per_step": t / steps, "count_per_step": n / steps}
                    for k, (t, n) in top]}


def paper_slice(dev, card):
    """Phase 6c: the paper's pipeline on the card at its defaults (ResNet-20
    width 16, batch 64, 60 BSQ steps, requant at 20/40/60), then the
    DoReFa finetune under the found scheme; the bgl_sumsq launches checked
    exactly (two per quantised tensor per BSQ step, none while
    finetuning) and no serving kernel launched."""
    import numpy as np
    import torch

    from repro_torch.examples import resnet20_bsq_paper as paper

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    out = paper.main(steps=RESNET_STEPS, width=RESNET_WIDTH, batch=RESNET_BATCH)
    torch.cuda.synchronize()
    bsq_s = time.perf_counter() - t0
    bsq_launches = _launch_counts()
    bsq_peak = torch.cuda.max_memory_allocated()
    scheme, hist = out["scheme"], out["history"]
    sizes = sorted(scheme.group_numel[k] * scheme.bits[k].size for k in scheme.bits)
    check(sizes == sorted(RESNET_TENSOR_C), f"quantised tensor sizes {sizes}")
    expected = RESNET_STEPS  # one grouped launch over the 44 views per step, one backward
    check(bsq_launches["bgl_sumsq"] == bsq_launches["bgl_sumsq_backward"] == expected,
          f"{bsq_launches['bgl_sumsq']} bgl_sumsq launches and "
          f"{bsq_launches['bgl_sumsq_backward']} backward launches, expected {expected} each "
          f"(one per BSQ step over 2 x {len(scheme.bits)} views)")
    check(bsq_launches["bitserial_matmul"] == bsq_launches["paged_attention"]
          == bsq_launches["flash_attention"] == 0,
          f"the BSQ pipeline launched serving kernels: {bsq_launches}")
    check([h["step"] for h in hist] == list(range(1, RESNET_STEPS + 1)), "history steps")
    for h in hist:
        check(all(np.isfinite(h[k]) for k in ("loss", "ce", "acc")),
              f"non-finite metrics at BSQ step {h['step']}: {h}")
    step_ms = 1e3 * float(np.median([h["dt"] for h in hist[1:]]))
    bound_ms, bound_by, flops = resnet_step_bound_ms(RESNET_WIDTH, RESNET_BATCH,
                                                     sum(RESNET_TENSOR_C))
    prof = profile_resnet(dev, card)

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    ft = paper.finetune(scheme, out["params"], steps=RESNET_FT_STEPS, width=RESNET_WIDTH,
                        batch=RESNET_BATCH)
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    ft_launches = _launch_counts()
    ft_peak = torch.cuda.max_memory_allocated()
    check(all(v == 0 for v in ft_launches.values()),
          f"the finetune launched kernels: {ft_launches}")
    for h in ft["history"]:
        check(np.isfinite(h["ce"]) and np.isfinite(h["acc"]),
              f"non-finite metrics at finetune step {h['step']}: {h}")
    ft_ms = 1e3 * float(np.median([h["dt"] for h in ft["history"][1:]]))
    bits = scheme.layer_bits()
    print(f"[paper] ResNet-20 width {RESNET_WIDTH} (16/32/64, 3x3 basic blocks), BSQ from 8 "
          f"bits, one group per tensor, 4-bit ReLU6 activations, SGDM 0.9 / wd 1e-4, lr "
          f"{paper.LR}, alpha {paper.ALPHA}, batch {RESNET_BATCH} gaussian_blobs, requant every "
          f"{paper.REQUANT_INTERVAL}: {RESNET_STEPS} steps in {bsq_s:.2f} s, {step_ms:.2f} ms per "
          f"step (median of steps 2-{RESNET_STEPS}; step 1 {1e3 * hist[0]['dt']:.1f}; bound "
          f"{bound_ms:.4f} ms, {bound_by}: {flops / 1e9:.2f} GFLOP at the f32 rate), peak "
          f"{bsq_peak / 1e6:.1f} MB; bgl_sumsq launches {bsq_launches['bgl_sumsq']} + "
          f"{bsq_launches['bgl_sumsq_backward']} backward == {expected} + {expected} [{card}]",
          flush=True)
    for h in hist:
        if "bits_per_param" in h:
            print(f"[paper]   step {h['step']}: loss {h['loss']:.4f} ce {h['ce']:.4f} acc "
                  f"{h['acc']:.3f} bits/param {h['bits_per_param']:.4f} comp "
                  f"{h['compression']:.4f}x")
    print(f"[paper] scheme: {scheme.bits_per_param:.4f} bits/param, compression "
          f"{scheme.compression:.4f}x vs f32; per layer: "
          + ", ".join(f"{k}={v:.0f}" for k, v in bits.items()), flush=True)
    print(f"[paper] DoReFa finetune under the scheme (lr {paper.FT_LR}, BN on batch "
          f"statistics): {RESNET_FT_STEPS} steps in {ft_s:.2f} s, "
          f"{ft_ms:.2f} ms per step, peak {ft_peak / 1e6:.1f} MB, ce {ft['history'][0]['ce']:.4f}"
          f" -> {ft['history'][-1]['ce']:.4f}; held-out top-1 (256 images): after BSQ "
          f"{out['eval_acc']:.4f}, after finetune {ft['eval_acc']:.4f} [{card}]", flush=True)
    return {"bsq_s": bsq_s, "ms_per_step": step_ms, "bound_ms_per_step": bound_ms,
            "bound_by": bound_by, "flops_per_step": flops, "profile": prof,
            "step_dt_s": [h["dt"] for h in hist],
            "peak_bytes": bsq_peak, "launches": bsq_launches, "history": hist,
            "bits_per_param": scheme.bits_per_param, "compression": scheme.compression,
            "layer_bits": bits, "eval_acc": out["eval_acc"], "ft_s": ft_s,
            "ft_ms_per_step": ft_ms, "ft_peak_bytes": ft_peak, "ft_launches": ft_launches,
            "ft_history": ft["history"], "ft_eval_acc": ft["eval_acc"]}


def lm_examples(dev, card):
    """Phase 6d: the LM examples on the card at their defaults, each
    with its kernels' launches counted exactly: quickstart (200 BSQ steps
    of reduced granite-3-2b), serve_quantized (120 steps, then 8 requests x
    32 tokens served from the packed export: bitserial and flash),
    fault_tolerance (20 steps, host 2 dies, resume to 30), train_lm_bsq
    (the 12 x 512 LM, cut to 40 steps with requant at 20 and no workdir:
    its 12 GB checkpoint would add to phase 6's 16 GB on the card
    machine's disk)."""
    import numpy as np
    import torch

    from repro_torch.examples import fault_tolerance, quickstart, serve_quantized, train_lm_bsq

    report = {}

    def run(name, fn, want):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t0, "launches": _launch_counts(),
               "peak_bytes": torch.cuda.max_memory_allocated()}
        expected = {k: 0 for k in rec["launches"]}
        expected.update(want(out))
        check(rec["launches"] == expected,
              f"{name}: kernel launches {rec['launches']}, expected {expected}")
        report[name] = rec
        print(f"[examples] {name}: {rec['s']:.2f} s, peak {rec['peak_bytes'] / 1e9:.3f} GB, "
              f"launches {rec['launches']} as counted [{card}]", flush=True)
        return out

    def bgl(steps):  # one grouped launch and one backward per BSQ step
        return {"bgl_sumsq": steps, "bgl_sumsq_backward": steps}

    q = run("quickstart", lambda: quickstart.main([]), lambda o: bgl(200))
    check(all(np.isfinite([h["ce"], h["reg"]]).all() for h in q["history"]),
          f"quickstart: non-finite history {q['history']}")
    report["quickstart"]["bits_per_param"] = q["scheme"].bits_per_param
    del q

    def served(o):
        n_layers, n_new = o["cfg"].n_layers, 32
        return {**bgl(120),
                "bitserial_matmul": n_new * n_layers * 7,  # each model call, 7 projections
                "flash_attention": n_layers}  # one prefill of the single bucket

    s = run("serve_quantized", lambda: serve_quantized.main([]), served)
    toks = np.stack([r.tokens for r in sorted(s["results"], key=lambda r: r.uid)])
    check(toks.shape == (8, 32) and ((toks >= 0) & (toks < s["cfg"].vocab_size)).all(),
          f"serve_quantized tokens {toks.shape}")
    report["serve_quantized"].update(tokens=toks.tolist(),
                                     bits_per_param=s["scheme"].bits_per_param,
                                     packed_route_bytes=serve_quantized.tree_bytes(s["params"]),
                                     float_route_bytes=serve_quantized.tree_bytes(
                                         s["float_params"]))
    print(f"[examples] serve_quantized greedy tokens (packed route): {toks.tolist()}", flush=True)
    del s

    f = run("fault_tolerance", lambda: fault_tolerance.main([]),
            lambda o: bgl(30))  # 20 + 10 steps
    check((f["phase1_step"], f["resumed_from"], f["phase2_step"]) == (20, 20, 30)
          and 2 not in f["survivors"], f"fault_tolerance: {f}")
    report["fault_tolerance"].update(resumed_from=f["resumed_from"], status=f["status"])
    del f

    t = run("train_lm_bsq",
            lambda: train_lm_bsq.main(["--steps", "40", "--requant-interval", "20",
                                       "--workdir", ""]),
            lambda o: bgl(40))
    check([h["step"] for h in t["history"]] == [20, 40]
          and all(np.isfinite(h["total"]) for h in t["history"]),
          f"train_lm_bsq history {t['history']}")
    report["train_lm_bsq"].update(history=t["history"],
                                  bits_per_param=t["scheme"].bits_per_param)
    print(f"[examples] train_lm_bsq (12 x 512, 81M quantised parameters, batch 8 x 128): step "
          f"20 {1e3 * t['history'][0]['dt']:.1f} ms, step 40 {1e3 * t['history'][1]['dt']:.1f} "
          f"ms; ce {t['history'][0]['ce']:.4f} -> {t['history'][1]['ce']:.4f}", flush=True)
    del t
    return report


def bitserial_case(dev, gen, card, time_ms, M, K, N, groups, dt, profile=False, timed=True):
    """One shape of phase 2: the kernel against its plain version,
    ``active=a`` bitwise against ``truncate_packed`` for every a, and the
    kernel, its ``active`` path, the plain version and ``torch.matmul`` on
    the dequantised weight timed (``timed=False``: the checks alone).
    ``profile`` also names the device kernels of one call from the
    profiler."""
    import torch

    from repro_torch.core.packing import pack_from_float, truncate_packed, unpack_to_float
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import ops, ref

    dname = str(dt).split(".")[-1]
    w = torch.randn((K, N), generator=gen, device=dev) / K**0.5
    pw = pack_from_float(w, N_BITS, group_cols=groups)
    del w
    x = torch.randn((M, K), generator=gen, device=dev).to(dt)
    got = ops.bitserial_matmul(x, pw)
    want = ref.bitserial_matmul_ref(x, pw.planes, pw.sign, pw.scale, N_BITS)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale_ = want.float().abs().max().item()
    del want
    what = f"M={M} K={K} N={N} groups={groups} {dname}"
    # f32: the two differ only by the order of the sums and the epilogue's
    # rounding; bf16: the plain version rounds x @ w to bf16 before the
    # scale, the kernel scales the f32 sum
    check(bool(torch.isfinite(got).all()) and err <= TOL[dname] * scale_,
          f"kernel vs plain at {what}: max err {err} > {TOL[dname]} x {scale_}")
    check(torch.equal(got, ops.bitserial_matmul(x, pw)), f"{what}: a second call differs")
    iview = torch.int32 if dt == torch.float32 else torch.int16
    for a in range(1, N_BITS + 1):
        dyn = ops.bitserial_matmul(x, pw, active_planes=torch.tensor([a], dtype=torch.int32,
                                                                     device=dev))
        static = ops.bitserial_matmul(x, truncate_packed(pw, a))
        check(torch.equal(dyn.view(iview), static.view(iview)),
              f"active={a} != truncate_packed at {what}")
    del got, dyn, static
    path = bsm.kernel_path(x, pw.planes, pw.sign)
    check(path == ("splitk" if M <= bsm.DECODE_MAX_M else
                   "wgmma" if dt == torch.bfloat16 else "tiled"),
          f"{what}: the {path} kernel, not the one the main path wants")
    if not timed:
        return {"M": M, "K": K, "N": N, "dtype": dname, "path": path, "max_abs_err": err,
                "max_abs_plain": scale_,
                "scale": "per-tensor" if groups is None else f"{groups} groups"}
    wl = unpack_to_float(pw).to(dt)
    a_dev = torch.tensor([N_BITS - 2], dtype=torch.int32, device=dev)
    row = {
        "M": M, "K": K, "N": N, "dtype": dname,
        "scale": "per-tensor" if groups is None else f"{groups} groups", "path": path,
        "max_abs_err": err, "max_abs_plain": scale_,
        "ms": time_ms(lambda: ops.bitserial_matmul(x, pw)),
        # the same kernel reading its active-plane count from the device
        # (the dyn Pallas kernel's path)
        "active_ms": time_ms(lambda: ops.bitserial_matmul(x, pw, active_planes=a_dev)),
        "plain_ms": time_ms(lambda: ref.bitserial_matmul_ref(
            x, pw.planes, pw.sign, pw.scale, N_BITS), iters=3),
        "active_plain_ms": time_ms(lambda: ref.bitserial_matmul_ref(
            x, pw.planes, pw.sign, pw.scale, N_BITS, active_planes=a_dev), iters=3),
        "library_ms": time_ms(lambda: torch.matmul(x, wl)),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(M, K, N, dname, groups=groups or 1)
    row["vs_library"] = row["ms"] / row["library_ms"]
    row["of_bound"] = row["bound_ms"] / row["ms"]
    row["tflops"] = 2.0 * M * K * N / (row["ms"] * 1e-3) / 1e12
    if profile:
        row["device_kernels"], row["profiler_sessions"] = profiled_kernel_names(
            lambda: ops.bitserial_matmul(x, pw))
        check(any(f"{path}_kernel" in n for n in row["device_kernels"]),
              f"{what}: the profiler saw {row['device_kernels']} in "
              f"{row['profiler_sessions']} sessions, no {path}_kernel")
    rate = (f"{row['tflops']:.1f} TFLOP/s, {100 * row['tflops'] * 1e12 / PEAK_FLOPS[dname]:.1f} % "
            f"of the {dname} peak" if M > bsm.DECODE_MAX_M else
            f"{(N_BITS + 1) * (K // 8) * N / (row['ms'] * 1e-3) / 1e9:.0f} GB/s of packed weight")
    print(f"[kernel] {what} ({path}): max_err={err:.3e} (max|plain|={scale_:.3e}) "
          f"kernel {row['ms']:.4f} ms ({rate}; active={N_BITS - 2} from the device "
          f"{row['active_ms']:.4f} ms), bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
          f"{100 * row['of_bound']:.1f} %), plain {row['plain_ms']:.4f} ms, "
          f"torch.matmul(dequantised) {row['library_ms']:.4f} ms (kernel/library "
          f"{row['vs_library']:.2f}) [{card}]", flush=True)
    return row


def active_case(dev, gen, card, time_ms, M, K, N, dt):
    """One shape of phase 2's runtime-plane rows, at an M the policies'
    serving path launches: for every a in 1..6 the kernel reading ``a``
    from a device tensor, bitwise against the static kernel over
    ``truncate_packed(pw, a)`` at the same M; then the ``active`` call at
    a = 3 (the draft) and 6 (a full lane of a tiered step) timed beside
    the static calls, the plain version and ``torch.matmul``."""
    import torch

    from repro_torch.core.packing import pack_from_float, truncate_packed, unpack_to_float
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import ops, ref

    dname = str(dt).split(".")[-1]
    w = torch.randn((K, N), generator=gen, device=dev) / K**0.5
    pw = pack_from_float(w, N_BITS)
    del w
    x = torch.randn((M, K), generator=gen, device=dev).to(dt)
    iview = torch.int32 if dt == torch.float32 else torch.int16
    act = {a: torch.tensor([a], dtype=torch.int32, device=dev) for a in range(1, N_BITS + 1)}
    what = f"M={M} K={K} N={N} {dname}"
    err = 0.0
    for a in range(1, N_BITS + 1):
        bsm.reset_launches()
        dyn = ops.bitserial_matmul(x, pw, active_planes=act[a])
        check(bsm.active_launches == 1, f"{what}: active={a} was not a runtime-plane launch")
        static = ops.bitserial_matmul(x, truncate_packed(pw, a))
        check(torch.equal(dyn.view(iview), static.view(iview)),
              f"active={a} (device tensor) != truncate_packed at {what}")
        if a == N_BITS:
            want = ref.bitserial_matmul_ref(x, pw.planes, pw.sign, pw.scale, N_BITS)
            err = (dyn.float() - want.float()).abs().max().item()
            check(err <= TOL[dname] * want.float().abs().max().item(),
                  f"{what}: active={a} vs plain, max err {err}")
    wl = unpack_to_float(pw).to(dt)
    t3 = truncate_packed(pw, 3)
    row = {
        "M": M, "K": K, "N": N, "dtype": dname, "path": bsm.kernel_path(x, pw.planes, pw.sign),
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.bitserial_matmul(x, pw)),
        "active_ms": time_ms(lambda: ops.bitserial_matmul(x, pw, active_planes=act[N_BITS])),
        "active3_ms": time_ms(lambda: ops.bitserial_matmul(x, pw, active_planes=act[3])),
        "static3_ms": time_ms(lambda: ops.bitserial_matmul(x, t3)),
        "plain_ms": time_ms(lambda: ref.bitserial_matmul_ref(
            x, pw.planes, pw.sign, pw.scale, N_BITS, active_planes=act[N_BITS]), iters=3),
        "library_ms": time_ms(lambda: torch.matmul(x, wl)),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(M, K, N, dname)
    print(f"[kernel-active] {what} ({row['path']}): active=a bitwise == truncate_packed for a "
          f"in 1..{N_BITS}; static {row['ms']:.4f} ms, active=6 {row['active_ms']:.4f} ms, "
          f"active=3 {row['active3_ms']:.4f} ms (static over 3 planes {row['static3_ms']:.4f}), "
          f"bound {row['bound_ms']:.4f} ms, torch.matmul(dequantised) {row['library_ms']:.4f} "
          f"ms, plain {row['plain_ms']:.4f} ms [{card}]", flush=True)
    return row


def active_kernel_phase(dev, card, time_ms, report):
    """Phase 2's runtime-plane rows: granite-3-2b's four projection shapes
    at M 8 (a grouped decode or a draft step at 8 lanes), 32 (the verify
    chunk, 8 lanes x gamma 4) and 40, f32 and bf16; then one layer's 7
    projections summed at each M in bf16."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    rows = report.setdefault("active", [])
    for M in ACTIVE_M:
        for K, N in MATMUL_SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                rows.append(active_case(dev, gen, card, time_ms, M, K, N, dt))
    by = {(r["M"], r["K"], r["N"], r["dtype"]): r for r in rows}
    for M in ACTIVE_M:
        layer = [by[(M, K, N, "bfloat16")] for K, N in LAYER_PROJ]
        sums = {k: sum(r[k] for r in layer) for k in ("ms", "active_ms", "active3_ms",
                                                       "static3_ms", "plain_ms", "library_ms",
                                                       "bound_ms")}
        sums["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in layer)
                            else "operations")
        report.setdefault("active_layers", {})[M] = sums
        print(f"[kernel-active] one granite-3-2b layer (7 projections, M={M}, bf16): static "
              f"{sums['ms']:.4f} ms, active=6 {sums['active_ms']:.4f} ms, active=3 "
              f"{sums['active3_ms']:.4f} ms (static 3 planes {sums['static3_ms']:.4f}), bound "
              f"{sums['bound_ms']:.4f} ms, torch.matmul(dequantised) {sums['library_ms']:.4f} "
              f"ms [{card}]", flush=True)


def bitserial_shapes():
    """Phase 2's static bitserial calls, as (M, K, N, groups, dtype name,
    profile): granite-3-2b's projections at M 4 and 512, f32 and bf16,
    per-tensor and per-group scales; gemma3-12b's 7 projections at M 2 and
    8192 (the profiler names the kernel of its gate row); the MoE,
    recurrent and frontend rows in bf16."""
    for M in (4, 512):
        for K, N in MATMUL_SHAPES:
            for groups in (None, 16):
                for dname in ("float32", "bfloat16"):
                    yield M, K, N, groups, dname, False
    for M in GEMMA3_M:
        for i, (K, N) in enumerate(GEMMA3_PROJ):
            yield M, K, N, None, "bfloat16", i == 4
    for (K, N), ms in MOE_ROWS + RG_ROWS + FRONTEND_ROWS:
        for M in ms:
            yield M, K, N, None, "bfloat16", False


def bitserial_kernel_phase(dev, card, time_ms, report):
    """Phase 2: the bitserial kernel against its plain version at the main
    path's shapes: granite-3-2b's projections at decode (M 4) and prefill
    (M 512), f32 and bf16, per-tensor and per-group scales; gemma3-12b's 7
    projections in bf16 at decode (M 2) and at its 2 x 4096-token prefill
    (M 8192); the MoE slices' projections and heads in bf16 at the M
    their paths run (``MOE_ROWS``).  Each shape through :func:`bitserial_case`; the decode and
    prefill kernels named once each by the profiler.  Returns the largest
    error."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    for M, K, N, groups, dname, profile in bitserial_shapes():
        report["matmul"].append(bitserial_case(dev, gen, card, time_ms, M, K, N, groups,
                                               getattr(torch, dname), profile=profile))
        torch.cuda.empty_cache()
    # one layer's 7 projections at each main-path shape, in bf16
    for name, M, proj in (("granite-3-2b decode", 4, LAYER_PROJ),
                          ("gemma3-12b decode", 2, GEMMA3_PROJ),
                          ("gemma3-12b prefill", 8192, GEMMA3_PROJ),
                          ("recurrentgemma-9b local decode", 8, RG_PROJ),
                          ("llama-3.2-vision-11b decode", 4, VISION_PROJ),
                          ("musicgen-large decode", 4, MUSICGEN_PROJ)):
        rows = layer_rows(report, M, proj)
        ms, lib = sum(r["ms"] for r in rows), sum(r["library_ms"] for r in rows)
        flop = sum(2.0 * r["M"] * r["K"] * r["N"] for r in rows)
        report.setdefault("layers", {})[name] = {
            "ms": ms, "library_ms": lib, "bound_ms": sum(r["bound_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows), "tflops": flop / (ms * 1e-3) / 1e12}
        print(f"[kernel] one {name} layer ({len(proj)} projections, M={M}, bf16): kernel "
              f"{ms:.4f} ms, "
              f"bound {report['layers'][name]['bound_ms']:.4f} ms, torch.matmul(dequantised) "
              f"{lib:.4f} ms (kernel/library {ms / lib:.2f}), "
              f"{report['layers'][name]['tflops']:.1f} TFLOP/s [{card}]", flush=True)
    max_err = max(r["max_abs_err"] for r in report["matmul"])
    print(f"[kernel] all {len(report['matmul'])} shapes agree; second calls bitwise equal; "
          f"active=a bitwise equal to truncate_packed for a in 1..{N_BITS}", flush=True)
    return max_err


def layer_rows(report, M, proj):
    """Phase 2's bf16 per-tensor rows of one layer's projections at M."""
    rows = {(r["M"], r["K"], r["N"], r["dtype"], r["scale"]): r for r in report["matmul"]}
    return [rows[(M, K, N, "bfloat16", "per-tensor")] for K, N in proj]


def granite_parity(dev, card, report):
    """Phase 3: full-width granite-3-2b cut to 1 layer, f32, 6-bit packed:
    the card (kernels) against the CPU (plain path) on the same params.
    Returns both param trees for phase 3b."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.packing import tree_to
    from repro_torch.data import MarkovLM
    from repro_torch.models import transformer
    from repro_torch.serve import Request, ServeEngine

    cfg2 = get_config("granite-3-2b").scaled(n_layers=1, dtype="float32",
                                             kv_cache_dtype="float32")
    p_gpu = transformer.init_params(cfg2, torch.Generator(device=dev).manual_seed(1), dev,
                                    pack_bits=N_BITS)
    p_cpu = tree_to(p_gpu, "cpu")
    prompt = MarkovLM(vocab=cfg2.vocab_size, seed=3).sample(
        np.random.default_rng(0), 1, 16)[0, :16].astype(np.int32)
    first = {}
    toks = {}
    for name, params, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, torch.device("cpu"))):
        with torch.inference_mode():
            first[name], _ = transformer.prefill(
                params, {"tokens": torch.from_numpy(prompt[None]).long().to(d)}, cfg2, 64)
        eng = ServeEngine(params, cfg2, max_len=64, device=d)
        toks[name] = eng.generate([Request(uid=0, tokens=prompt, max_new=2)])[0].tokens
    dlog = (first["cuda"].cpu() - first["cpu"]).abs().max().item()
    lmax = first["cpu"].abs().max().item()
    print(f"[parity] {cfg2.n_layers}-layer full-width f32: greedy cuda {toks['cuda'].tolist()} "
          f"cpu {toks['cpu'].tolist()}; first-step max|dlogit|={dlog:.3e} "
          f"(max|logit|={lmax:.3e})", flush=True)
    check(np.array_equal(toks["cuda"], toks["cpu"]), "greedy tokens differ cuda vs cpu")
    # f32 end to end: sums in another order (kernel, cuBLAS vs the CPU)
    check(dlog <= 1e-4 * max(1.0, lmax), f"first-step logits differ by {dlog}")
    report["parity"] = {"tokens": toks["cuda"].tolist(), "max_abs_dlogit": dlog,
                        "max_abs_logit": lmax}

    return cfg2, p_gpu, p_cpu


def granite_slice(dev, card, report, engine_cls):
    """Phase 4: full-width granite-3-2b cut to SLICE_LAYERS, bf16, 6-bit packed, served
    by the bucketed engine (8 requests, two buckets, 32 tokens each), the
    bitserial and flash launch counts checked exactly; then a profiled
    decode step.  Returns the params for phase 4b."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.packing import packed_leaves
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.serve import Request

    cfg = get_config("granite-3-2b").scaled(n_layers=SLICE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                     pack_bits=N_BITS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    packed_bytes = sum(pw.hbm_bytes() for pw in packed_leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    print(f"[slice] granite-3-2b {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size}->"
          f"{cfg.padded_vocab} {cfg.dtype}: init+pack {init_s:.1f} s, packed weights "
          f"{packed_bytes / 1e9:.4f} GB, init peak {init_peak / 1e9:.3f} GB [{card}]",
          flush=True)

    engine = engine_cls(params, cfg, max_len=512, device=dev)
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    lens = [64] * 4 + [128] * 4
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(i), 1, 128)[0, :n]
                    .astype(np.int32), max_new=32) for i, n in enumerate(lens)]
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:16], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    bsm.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bsm.launches
    expected = 2 * 32 * cfg.n_layers * 7
    peak = torch.cuda.max_memory_allocated()
    gen_toks = np.stack([r.tokens for r in sorted(results, key=lambda r: r.uid)])
    check(gen_toks.shape == (8, 32), f"generated tokens of shape {gen_toks.shape}")
    check(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all(), "token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    check(launches == expected, f"{launches} bitserial launches, expected {expected}")
    # one prefill call per bucket, each layer's attention through the flash kernel
    check(fa.launches == 2 * cfg.n_layers and fa.windowed_launches == 0,
          f"{fa.launches} flash launches ({fa.windowed_launches} windowed), expected "
          f"2 x {cfg.n_layers}")
    buckets = {}
    for r in results:
        buckets.setdefault(len(reqs[r.uid].tokens), []).append(r)
    slice_rep = {"packed_weight_bytes": packed_bytes, "serve_peak_bytes": peak,
                 "wall_s": wall, "tokens": int(gen_toks.size),
                 "tokens_per_s": gen_toks.size / wall, "launches": launches,
                 "active_launches": bsm.active_launches, "flash_launches": fa.launches,
                 "buckets": {}}
    for plen, rs in sorted(buckets.items()):
        ttft = float(np.mean([r.prefill_ms for r in rs]))
        dms = float(np.mean([r.decode_ms_per_tok for r in rs]))
        slice_rep["buckets"][plen] = {"ttft_ms": ttft, "decode_ms_per_step": dms}
        print(f"[slice] bucket prompt={plen} x{len(rs)}: TTFT {ttft:.2f} ms, "
              f"decode {dms:.3f} ms per step (= per token per request) [{card}]")
    print(f"[slice] 8 requests, {gen_toks.size} tokens in {wall:.3f} s = "
          f"{gen_toks.size / wall:.1f} tok/s; serve peak memory {peak / 1e9:.3f} GB; "
          f"bitserial launches {launches} == 2 x 32 x {cfg.n_layers} x 7; flash launches "
          f"{fa.launches} == 2 x {cfg.n_layers} [{card}]",
          flush=True)
    report["slice"] = slice_rep
    report["profile"] = profile_decode(engine, reqs[:4], cfg, card)
    return cfg, params


class CardRouting:
    """Phase 3f: the card's MoE routing, recorded call by call
    (``record``), then imposed on the CPU side's calls in the same order
    (``replay``), as phase 6b imposes the card's activations.  Routing is
    a step function of the gates, and the card and the CPU sum the gates
    in other orders: where a token's k-th and (k+1)-th gates lie that
    close, the two would pick other experts and the outputs jump.  The
    replay counts the tokens whose own routing would have differed."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.orig = moe, moe._route
        self.calls = []
        self.tokens = self.differ = 0

    def record(self):
        def route(gates, top_k):
            w, e = self.orig(gates, top_k)
            self.calls.append(e.detach().cpu())
            return w, e

        return mock.patch.object(self.moe, "_route", route)

    def replay(self):
        calls = iter(self.calls)

        def route(gates, top_k):
            e = next(calls, None)
            check(e is not None and tuple(e.shape) == tuple(gates.shape[:-1]) + (top_k,),
                  f"the CPU routes a call the card did not (gates {tuple(gates.shape)})")
            own = self.orig(gates, top_k)[1]
            self.differ += int((own.sort(-1).values != e.sort(-1).values).any(-1).sum())
            self.tokens += e.shape[0] * e.shape[1]
            return gates.gather(-1, e), e

        return mock.patch.object(self.moe, "_route", route)


class RouteLog:
    """Records the experts of every MoE call while it is entered, without
    a host sync (device tensors kept), which of each call's tokens are
    real (a chunk's first ``n_valid`` positions of each lane, a decode
    step's active lanes: the rest ride along; JAX routes them too), and
    for each decode step its calls, its cache (a bucket's own, or the
    pool's), its position where all lanes share one, and the K/V rows its
    live lanes read.  :meth:`dropped` and :meth:`decode_reads` read them
    after the run."""

    def __init__(self):
        from repro_torch.models import moe, transformer

        self.moe, self.tf = moe, transformer
        self.calls, self.valid, self.steps, self.step = [], None, [], None

    def __enter__(self):
        import torch

        moe, tf = self.moe, self.tf
        self.saved = route, chunk, step = moe._route, tf.prefill_chunk, tf.decode_step

        def routed(gates, top_k):
            w, e = route(gates, top_k)
            self.calls.append((e, self.valid))
            if self.step is not None:
                self.step["calls"].append((e, self.valid))
            return w, e

        def prefill_chunk(params, cache, tokens, start, n_valid, cfg, **kw):
            pos = torch.arange(tokens.shape[1], device=tokens.device)
            self.valid = pos[None, :] < n_valid.to(tokens.device, copy=True)[:, None]
            try:
                return chunk(params, cache, tokens, start, n_valid, cfg, **kw)
            finally:
                self.valid = None

        def decode_step(params, cache, tokens, pos, cfg, active=None, **kw):
            # a copy: the pool updates its active mask in place as lanes finish
            self.valid = None if active is None else \
                active.to(tokens.device, copy=True)[None, :]
            # a live lane at position p reads p + 1 K/V rows of every layer
            if torch.is_tensor(pos):
                rows = (pos.to(tokens.device) + 1).clamp(min=0)
                rows = (rows if active is None else rows * self.valid[0].long()).sum()
            else:
                rows = tokens.shape[0] * (pos + 1)
            self.step = {"cache": id(cache), "pos": None if torch.is_tensor(pos) else pos,
                         "kv_rows": rows, "calls": []}
            self.steps.append(self.step)
            try:
                return step(params, cache, tokens, pos, cfg, active=active, **kw)
            finally:
                self.valid, self.step = None, None

        moe._route, tf.prefill_chunk, tf.decode_step = routed, prefill_chunk, decode_step
        return self

    def __exit__(self, *exc):
        self.moe._route, self.tf.prefill_chunk, self.tf.decode_step = self.saved

    def dropped(self, cfg):
        """(dropped, routed) assignments of real tokens: an assignment is
        dropped where its rank among its group's picks of that expert (in
        token order, riding tokens included, as the dispatch ranks them)
        reaches the call's capacity."""
        import torch

        dropped = total = 0
        for e, valid in self.calls:
            kept, real = self._kept(e, valid, cfg)
            dropped += int((real & ~kept).sum())
            total += int(real.sum())
        return dropped, total

    def _kept(self, e, valid, cfg):
        """(kept, real) of a call's assignments, (G, T*k) token-major."""
        import torch

        moe = self.moe
        G, T, k = e.shape
        rank = moe._ranks(e, cfg.n_experts)[3]
        real = (torch.ones_like(rank, dtype=torch.bool) if valid is None else
                valid.expand(G, T).repeat_interleave(k, dim=1))
        C = moe.moe_capacity(T, k, cfg.n_experts, cfg.capacity_factor)
        return (rank < C) & real, real

    def buckets(self):
        """The decode steps grouped by cache, in the order they began:
        a bucketed run's buckets (each decodes its own cache), or the one
        pool of a continuous run."""
        groups = {}
        for st in self.steps:
            groups.setdefault(st["cache"], []).append(st)
        return list(groups.values())

    def decode_reads(self, cfg, steps):
        """(experts, calls, kv_rows) of decode ``steps``: summed over
        their MoE calls, the experts that hold a kept assignment of a real
        token (the only experts whose weights the step's output needs: an
        expert without one contributes nothing to the combine); the number
        of those calls; and the K/V rows their live lanes read."""
        import torch

        E = cfg.n_experts
        used, calls = 0, 0
        for e, valid in (c for st in steps for c in st["calls"]):
            kept, _ = self._kept(e, valid, cfg)
            flat = torch.where(kept, e.reshape(kept.shape), E).reshape(-1)
            hit = torch.zeros(E + 1, dtype=torch.bool, device=e.device).scatter_(0, flat, True)
            used = used + hit[:E].sum()
            calls += 1
        return int(used), calls, int(sum(st["kv_rows"] for st in steps))


def moe_weight_bytes(params):
    """(routed expert bytes, shared expert bytes, router bytes, packed
    bytes) of a param tree, as served."""
    from repro_torch.core.packing import packed_leaves
    from repro_torch.tree import flatten_with_path

    routed = shared = router = 0
    for name, x in flatten_with_path(params):
        if "/moe/" in name and hasattr(x, "element_size"):
            n = x.numel() * x.element_size()
            if name.endswith("router"):
                router += n
            elif "/shared/" in name:
                shared += n
            else:
                routed += n
    return routed, shared, router, sum(pw.hbm_bytes() for pw in packed_leaves(params))


def moe_decode_bounds(log, cfg, weights, steps):
    """The byte bounds (ms) of the mean decode step of ``steps``, decode
    steps recorded in ``log`` (:class:`RouteLog`), ``weights`` as
    :func:`moe_weight_bytes` gives them.  ``routed``: what the step's output needs, read once: the
    weights of the experts that hold a kept assignment of a real token,
    the shared experts, the routers, the packed projections and head, and
    the K/V rows the live lanes read.  ``dense``: the same with every
    expert's weights, which the dense (E, C) dispatch reads whatever the
    routing (JAX's design, kept): the cost of that design."""
    import torch

    routed, shared, router, packed = weights
    used, calls, kv_rows = log.decode_reads(cfg, steps)
    check(calls == len(steps) * cfg.n_layers,
          f"{calls} routed decode calls in {len(steps)} steps of {cfg.n_layers} layers")
    steps = len(steps)
    per_expert = routed / (cfg.n_layers * cfg.n_experts)
    kv = kv_rows / steps * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim \
        * torch.empty((), dtype=cfg.cache_dtype).element_size()
    fixed = shared + router + packed + kv
    return {"routed_ms": 1e3 * (used / steps * per_expert + fixed) / HBM_BYTES_PER_S,
            "dense_ms": 1e3 * (routed + fixed) / HBM_BYTES_PER_S,
            "experts_per_layer": used / calls, "kv_bytes_per_step": kv, "steps": steps}


def moe_prefill_bound_ms(cfg, B, S):
    """The least time the card could take for a bucketed MoE prefill of
    ``B`` prompts of ``S`` tokens: its operations at the bf16 rate.  Every
    slot of the (B, E, C) expert buffer runs an expert FFN (the dense
    dispatch computes the empty slots too); then the shared experts, the
    router, the q, k, v and o projections, causal attention, and the head
    at each prompt's last token."""
    from repro_torch.models.moe import moe_capacity

    d, f, E, hd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.resolved_head_dim
    C = moe_capacity(S, cfg.top_k, E, cfg.capacity_factor)
    tokens = B * S
    per_layer = (B * E * C * 2 * 3 * d * f
                 + tokens * 2 * 3 * d * cfg.n_shared_experts * f
                 + tokens * 2 * d * E
                 + tokens * 2 * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                 + B * cfg.n_heads * 4 * hd * S * (S + 1) // 2)
    flops = cfg.n_layers * per_layer + B * 2 * d * cfg.padded_vocab
    return 1e3 * flops / PEAK_FLOPS["bfloat16"]


def moe_parity(dev, card):
    """Phase 3f: full-width qwen2-moe-a2.7b cut to 2 layers, f32, 6-bit
    packed, the card (kernels) against the CPU (plain versions, the same
    weights unpacked once to f32): the bucketed engine (prompts of 64 and
    200 tokens, 8 new each) and the chunked paged-kernel engine (chunks of
    64, 4 lanes), every logit row within the phase-3 tolerance and
    identical greedy tokens, the CPU routing as the card did; then two BSQ
    train steps of reduced qwen2-moe (phase 3c's check)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.packing import PackedWeight, tree_map_with_path, unpack_to_float
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.scheduler import SchedulerPolicy

    cfg = get_config("qwen2-moe-a2.7b").scaled(n_layers=2, dtype="float32",
                                               kv_cache_dtype="float32")
    t0 = time.perf_counter()
    p_gpu = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev,
                                    pack_bits=N_BITS)
    p_cpu = tree_map_with_path(
        lambda _, w: (unpack_to_float(w) if isinstance(w, PackedWeight) else w).cpu(), p_gpu)
    init_s = time.perf_counter() - t0
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(80 + i), 1, n)[0, :n]
                    .astype(np.int32), max_new=8) for i, n in enumerate((64, 200))]
    n_proj = 4 * cfg.n_layers + 1  # q, k, v, o of each layer and the untied head
    runs = {
        "bucketed": {},
        "chunked-paged": dict(continuous=True, policy=SchedulerPolicy(
            n_slots=4, chunked_prefill=True, chunk_sizes=(64,), paged=True, block_size=BLOCK,
            paged_kernel=True)),
    }
    rep = {"init_s": init_s}
    for name, kw in runs.items():
        routing = CardRouting()
        out, taps, secs = {}, {}, {}
        for side, params, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, torch.device("cpu"))):
            eng = ServeEngine(params, cfg, max_len=208, device=d, **kw)
            for m in (bsm, fa, pa):
                m.reset_launches()
            t0 = time.perf_counter()
            log = RouteLog()
            with LogitTap() as tap, (routing.record() if side == "cuda" else routing.replay()), \
                    log:
                res = eng.generate(reqs, arrival_steps=[0, 0] if eng.scheduler else None)
            if side == "cuda":
                torch.cuda.synchronize()
                launches = (bsm.launches, fa.launches, pa.launches)
                dropped, total = log.dropped(cfg)
                steps = (eng.scheduler.decode_steps, eng.scheduler.prefill_chunks) \
                    if eng.scheduler else None
            secs[side] = time.perf_counter() - t0
            out[side] = {r.uid: r.tokens.tolist() for r in res}
            taps[side] = tap.rows
            if eng.scheduler is not None:
                pool = eng.scheduler.pool
                check(pool.allocator.free_count == pool.n_blocks,
                      f"3f {name} {side}: the pool did not drain")
        check(routing.tokens > 0 and routing.tokens == sum(e.shape[0] * e.shape[1]
                                                           for e in routing.calls),
              f"3f {name}: the CPU replayed {routing.tokens} routed tokens of the card's "
              f"{sum(e.shape[0] * e.shape[1] for e in routing.calls)}")
        check(routing.differ <= ROUTE_DIFFER_SHARE * routing.tokens,
              f"3f {name}: {routing.differ} of {routing.tokens} tokens would have routed "
              f"otherwise on the CPU: more than {ROUTE_DIFFER_SHARE:.0%}")
        check(len(taps["cuda"]) == len(taps["cpu"]),
              f"3f {name}: {len(taps['cuda'])} logit calls on the card, {len(taps['cpu'])} on "
              "the CPU")
        dlog = max((a - b).abs().max().item() for a, b in zip(taps["cuda"], taps["cpu"]))
        lmax = max(b.abs().max().item() for b in taps["cpu"])
        if steps is None:  # bucketed: one prefill call and 7 decode steps per request
            want = (len(reqs) * 8 * n_proj, len(reqs) * cfg.n_layers, 0)
        else:
            want = ((steps[0] + steps[1]) * n_proj, 0, steps[0] * cfg.n_layers)
        check(launches == want, f"3f {name}: launches (bitserial, flash, paged) {launches}, "
                                f"expected {want}")
        print(f"[parity-moe] 2-layer full-width qwen2-moe f32 {name}: card {secs['cuda']:.1f} "
              f"s, cpu {secs['cpu']:.1f} s; {len(taps['cpu'])} logit calls, max|dlogit| "
              f"{dlog:.3e} (max|logit| {lmax:.3e}); {len(routing.calls)} routed calls, "
              f"{routing.differ} of {routing.tokens} tokens would have routed otherwise on the "
              f"CPU; dropped {dropped} of {total} assignments of real tokens "
              f"({dropped / total:.2%}); launches "
              f"(bitserial, flash, paged) {launches}; tokens {out['cuda']} [{card}]", flush=True)
        check(out["cuda"] == out["cpu"], f"3f {name}: greedy tokens differ card vs cpu: {out}")
        check(dlog <= 1e-4 * max(1.0, lmax), f"3f {name}: logits differ by {dlog}")
        rep[name] = {"tokens": out["cuda"], "max_abs_dlogit": dlog, "max_abs_logit": lmax,
                     "logit_calls": len(taps["cpu"]), "card_s": secs["cuda"],
                     "cpu_s": secs["cpu"], "near_ties": routing.differ,
                     "routed_tokens": routing.tokens, "dropped": dropped, "assignments": total,
                     "launches": list(launches)}
    del p_gpu, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    rep["train"] = train_parity(dev, card, arch="qwen2-moe-a2.7b")
    print("[parity-moe] card == cpu: greedy tokens identical, logits within 1e-4 of "
          "max(1, max|logit|) with the CPU routed as the card; BSQ steps within 1e-5",
          flush=True)
    return rep


def moe_slice(dev, card, engine_cls):
    """Phase 4e: full-width, full-depth qwen2-moe-a2.7b (24 layers, 60
    routed experts top-4 and 4 shared, MHA, untied head), bf16, 6-bit
    packed attention and head, bf16 experts: bucketed (two buckets of 4,
    prompts of 128 and 1024 tokens, 32 new each) and continuous (chunked,
    paged, the paged kernel; 8 lanes, 256 blocks of 32 rows, chunks of
    256, 16 requests with prompts uniform in [64, 1024] (seed 0) on
    Poisson arrivals at 0.5 per step, 32 new each), then a profiled
    decode step with the expert products' device time."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import poisson_arrivals
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.obs.metrics import percentile
    from repro_torch.serve import Request
    from repro_torch.serve.scheduler import SchedulerPolicy

    cfg = get_config("qwen2-moe-a2.7b")
    n_proj = 4 * cfg.n_layers + 1  # q, k, v, o of each layer and the untied head
    resident = torch.cuda.memory_allocated()  # what earlier phases left allocated
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                     pack_bits=N_BITS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = moe_weight_bytes(params)
    routed_bytes, shared_bytes, router_bytes, packed_bytes = weights
    expert_bytes = routed_bytes + shared_bytes
    embed_bytes = params["embed"].numel() * 2  # served in bf16
    init_peak = torch.cuda.max_memory_allocated()
    print(f"[moe] qwen2-moe-a2.7b {cfg.n_layers} layers d_model={cfg.d_model} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, {cfg.n_experts} experts "
          f"top-{cfg.top_k} of d_ff={cfg.d_ff} + {cfg.n_shared_experts} shared, cf "
          f"{cfg.capacity_factor}, vocab {cfg.vocab_size}->{cfg.padded_vocab} {cfg.dtype}: "
          f"init+pack {init_s:.1f} s; float experts {expert_bytes / 1e9:.4f} GB (routed "
          f"{routed_bytes / 1e9:.4f}, shared {shared_bytes / 1e9:.4f}), router {router_bytes / 1e6:.2f} MB f32, packed {packed_bytes / 1e9:.4f} GB, "
          f"embedding {embed_bytes / 1e9:.4f} GB served; init peak {init_peak / 1e9:.3f} GB "
          f"({resident / 1e9:.3f} GB allocated before it) [{card}]", flush=True)
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    rep = {"init_s": init_s, "expert_bytes": expert_bytes, "routed_expert_bytes": routed_bytes,
           "shared_expert_bytes": shared_bytes, "router_bytes": router_bytes,
           "packed_weight_bytes": packed_bytes, "embed_bytes": embed_bytes,
           "init_peak_bytes": init_peak, "resident_before_bytes": resident}

    # ---- bucketed
    lens = [128] * 4 + [1024] * 4
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(90 + i), 1, n)[0, :n]
                    .astype(np.int32), max_new=Q_MAX_NEW) for i, n in enumerate(lens)]
    engine = engine_cls(params, cfg, max_len=Q_MAX_LEN, device=dev)
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:64], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    for m in (bsm, fa, pa):
        m.reset_launches()
    log = RouteLog()
    t0 = time.perf_counter()
    with log:
        results = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    dropped, total = log.dropped(cfg)
    # each bucket's decode byte bounds, keyed by its first decode position
    # (its prompt length)
    d_bounds = {g[0]["pos"]: moe_decode_bounds(log, cfg, weights, g) for g in log.buckets()}
    del log
    gen_toks = np.stack([r.tokens for r in sorted(results, key=lambda r: r.uid)])
    check(gen_toks.shape == (8, Q_MAX_NEW), f"qwen2-moe bucketed tokens {gen_toks.shape}")
    check(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all(), "token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    calls = 2  # one prefill call per bucket
    check(fa.launches == calls * cfg.n_layers and fa.windowed_launches == 0,
          f"flash launches {fa.launches}, expected {calls} x {cfg.n_layers}")
    check(bsm.launches == calls * Q_MAX_NEW * n_proj and pa.launches == 0,
          f"bitserial launches {bsm.launches} (expected {calls} x {Q_MAX_NEW} x {n_proj}), "
          f"paged {pa.launches}")
    b = {"wall_s": wall, "tokens": int(gen_toks.size), "tokens_per_s": gen_toks.size / wall,
         "serve_peak_bytes": peak, "flash_launches": fa.launches,
         "bitserial_launches": bsm.launches, "dropped": dropped, "assignments": total,
         "buckets": {}}
    buckets = {}
    for r in results:
        buckets.setdefault(len(reqs[r.uid].tokens), []).append(r)
    check(sorted(d_bounds) == sorted(buckets),
          f"decode steps began at {sorted(d_bounds)}, the buckets' prompts are {sorted(buckets)}")
    for plen, rs in sorted(buckets.items()):
        ttft = float(np.mean([r.prefill_ms for r in rs]))
        dms = float(np.mean([r.decode_ms_per_tok for r in rs]))
        bound, db = moe_prefill_bound_ms(cfg, len(rs), plen), d_bounds[plen]
        b["buckets"][plen] = {"ttft_ms": ttft, "ttft_bound_ms": bound, "decode_ms_per_step": dms,
                              "decode_bound_ms": db["routed_ms"],
                              "decode_dense_bound_ms": db["dense_ms"],
                              "experts_per_layer_step": db["experts_per_layer"]}
        print(f"[moe] bucket prompt={plen} x{len(rs)}: TTFT {ttft:.2f} ms (operation bound "
              f"{bound:.3f}), decode {dms:.3f} ms per step (byte bound {db['routed_ms']:.3f}: "
              f"{db['experts_per_layer']:.2f} of {cfg.n_experts} experts routed per layer; "
              f"{db['dense_ms']:.3f} with every expert, the dense dispatch's reads) [{card}]",
              flush=True)
    print(f"[moe] bucketed: 8 requests, {gen_toks.size} tokens in {wall:.3f} s = "
          f"{gen_toks.size / wall:.2f} tok/s; serve peak memory {peak / 1e9:.3f} GB; dropped "
          f"{dropped} of {total} assignments ({dropped / total:.2%}); flash launches "
          f"{fa.launches} == {calls} x {cfg.n_layers}; bitserial {bsm.launches} == {calls} x "
          f"{Q_MAX_NEW} x {n_proj} [{card}]", flush=True)
    rep["bucketed"] = b
    rep["profile"] = profile_decode(engine, reqs[4:], cfg, card, steps=2,
                                    n_experts=cfg.n_experts)
    # one layer's expert products at a decode step of 8 lanes (C 8), by CUDA
    # events: every expert's weights read once bound them
    ein = torch.randn((1, cfg.n_experts, 8, cfg.d_model), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(6)).to(cfg.compute_dtype)
    lp = transformer.layer_slice(engine.params["blocks"], 0)["p0"]["moe"]
    for _ in range(3):
        moe_mod._experts(lp, ein, cfg.mlp_type)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(10):
        moe_mod._experts(lp, ein, cfg.mlp_type)
    ev1.record()
    ev1.synchronize()
    e_ms = ev0.elapsed_time(ev1) / 10
    e_bytes = sum(lp[k].numel() * lp[k].element_size() for k in ("w_gate", "w_up", "w_down"))
    rep["experts_layer"] = {"ms": e_ms, "bound_ms": 1e3 * e_bytes / HBM_BYTES_PER_S,
                            "bytes": e_bytes}
    print(f"[moe] one layer's expert products at 8 lanes (G 1, E {cfg.n_experts}, C 8, bf16): "
          f"{e_ms:.4f} ms by CUDA events, bound {1e3 * e_bytes / HBM_BYTES_PER_S:.4f} ms "
          f"({e_bytes / 1e9:.3f} GB of weights, {e_bytes / (e_ms * 1e-3) / 1e12:.2f} TB/s) "
          f"[{card}]", flush=True)
    del ein, lp
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # ---- continuous
    n_req = 16
    lens = np.random.default_rng(0).integers(64, 1025, size=n_req)
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(i), 1, 1024)[0, :n]
                    .astype(np.int32), max_new=Q_MAX_NEW) for i, n in enumerate(lens)]
    arrivals = poisson_arrivals(n_req, 0.5, seed=0)
    policy = SchedulerPolicy(n_slots=SLOTS, chunked_prefill=True, chunk_sizes=(Q_CHUNK,),
                             paged=True, block_size=BLOCK, n_blocks=Q_N_BLOCKS,
                             paged_kernel=True)
    engine = engine_cls(params, cfg, max_len=Q_MAX_LEN, device=dev, continuous=True,
                        policy=policy)
    sched, pool = engine.scheduler, engine.scheduler.pool
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:64], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    sched.reset_telemetry()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    for m in (bsm, fa, pa):
        m.reset_launches()
    log = RouteLog()
    t0 = time.perf_counter()
    with log:
        results = engine.generate(reqs, arrival_steps=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    dropped, total = log.dropped(cfg)
    check(len(log.buckets()) == 1, f"{len(log.buckets())} decode caches in a continuous run")
    db = moe_decode_bounds(log, cfg, weights, log.steps)
    del log
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    check(db["steps"] == steps, f"{db['steps']} decode steps routed, the scheduler ran {steps}")
    got = {r.uid: r for r in results}
    check(sorted(got) == list(range(n_req)), f"qwen2-moe continuous results for {sorted(got)}")
    for r in results:
        check(len(r.tokens) == Q_MAX_NEW
              and ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all(),
              f"uid {r.uid}: {len(r.tokens)} tokens, or a token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    check(pa.launches == steps * cfg.n_layers,
          f"{pa.launches} paged launches, expected {steps} steps x {cfg.n_layers}")
    check(bsm.launches == (steps + chunks) * n_proj and fa.launches == 0,
          f"{bsm.launches} bitserial launches (expected ({steps} + {chunks}) x {n_proj}), "
          f"{fa.launches} flash (chunked prefill reads the cache)")
    check(pool.allocator.free_count == pool.n_blocks and pool.allocator.committed == 0,
          f"blocks leaked: free {pool.allocator.free_count}/{pool.n_blocks}, committed "
          f"{pool.allocator.committed}")
    check(engine.obs.recorder.leaked == [], f"leaked spans {engine.obs.recorder.leaked}")
    ttft = [got[i].prefill_ms for i in range(n_req)]
    c = {
        "requests": n_req, "max_new": Q_MAX_NEW, "prompt_lens": lens.tolist(),
        "arrivals": arrivals, "chunk_sizes": list(policy.chunk_sizes), "wall_s": wall,
        "tokens": n_req * Q_MAX_NEW, "tokens_per_s": n_req * Q_MAX_NEW / wall,
        "ttft_ms_p50": percentile(ttft, 50), "ttft_ms_p90": percentile(ttft, 90),
        "decode_steps": steps, "prefill_chunks": chunks,
        "decode_ms_per_step": sched.decode_ms_total / max(steps, 1),
        "mean_occupancy": sched.mean_occupancy(),
        "mean_block_occupancy": sched.mean_block_occupancy(),
        "admit_blocked_total": sched._c_blocked.value,
        "serve_peak_bytes": peak, "cache_bytes": pool.cache_bytes(),
        "paged_launches": pa.launches, "bitserial_launches": bsm.launches,
        "dropped": dropped, "assignments": total, "decode_bound_ms": db["routed_ms"],
        "decode_dense_bound_ms": db["dense_ms"],
        "experts_per_layer_step": db["experts_per_layer"],
    }
    rep["continuous"] = c
    print(f"[moe] continuous: {n_req} requests x {Q_MAX_NEW} tokens, prompts {lens.min()}-"
          f"{lens.max()} ({lens.sum()} tokens), Poisson arrivals at 0.5/step over "
          f"{arrivals[-1]} steps, chunks of {Q_CHUNK}: {c['tokens']} tokens in {wall:.3f} s = "
          f"{c['tokens_per_s']:.2f} tok/s; TTFT p50 {c['ttft_ms_p50']:.1f} ms, p90 "
          f"{c['ttft_ms_p90']:.1f} ms; decode {c['decode_ms_per_step']:.3f} ms per step (byte "
          f"bound {db['routed_ms']:.3f}: {db['experts_per_layer']:.2f} of {cfg.n_experts} "
          f"experts routed per layer; {db['dense_ms']:.3f} with every expert; {steps} steps, "
          f"mean occupancy {c['mean_occupancy']:.2f}), {chunks} prefill chunks, admission blocked "
          f"{c['admit_blocked_total']:.0f} steps [{card}]", flush=True)
    print(f"[moe] continuous: serve peak memory {peak / 1e9:.3f} GB; KV pool "
          f"{c['cache_bytes'] / 1e9:.3f} GB ({Q_N_BLOCKS} + 1 blocks x {BLOCK} rows); mean "
          f"block occupancy {c['mean_block_occupancy']:.2f}; dropped {dropped} of {total} "
          f"assignments ({dropped / total:.2%}); paged launches {pa.launches} == {steps} x "
          f"{cfg.n_layers}; bitserial {bsm.launches} == ({steps} + {chunks}) x {n_proj}; pool "
          f"drained [{card}]", flush=True)
    del engine, sched, pool, params
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def phi_slice(dev, card, engine_cls):
    """Phase 4f: phi3.5-moe-42b-a6.6b at its full width (d_model 4096, 32
    query heads over 8 K/V of 128, 16 experts top-2 of d_ff 6400, vocab
    32064) cut to 4 of its 32 layers (its 40.3 B expert parameters, never
    packed, take 80.5 GB in bf16), bf16, 6-bit packed attention and head:
    the bucketed engine, 4 requests of 256 prompt tokens and 16 new."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer
    from repro_torch.serve import Request

    full = get_config("phi3.5-moe-42b-a6.6b")
    cfg = full.scaled(n_layers=4)
    n_proj = 4 * cfg.n_layers + 1
    max_new, plen = 16, 256
    resident = torch.cuda.memory_allocated()  # what earlier phases left allocated
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                     pack_bits=N_BITS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weights = moe_weight_bytes(params)
    expert_bytes, packed_bytes = weights[0] + weights[1], weights[3]
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(95 + i), 1, plen)[0, :plen]
                    .astype(np.int32), max_new=max_new) for i in range(4)]
    engine = engine_cls(params, cfg, max_len=plen + max_new, device=dev)
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:64], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    for m in (bsm, fa, pa):
        m.reset_launches()
    log = RouteLog()
    t0 = time.perf_counter()
    with log:
        results = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    dropped, total = log.dropped(cfg)
    check(len(log.buckets()) == 1, f"{len(log.buckets())} buckets decoded, expected 1")
    db = moe_decode_bounds(log, cfg, weights, log.steps)
    del log
    gen_toks = np.stack([r.tokens for r in sorted(results, key=lambda r: r.uid)])
    check(gen_toks.shape == (4, max_new), f"phi3.5-moe tokens of shape {gen_toks.shape}")
    check(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all(), "token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    check(fa.launches == cfg.n_layers and bsm.launches == max_new * n_proj
          and pa.launches == 0,
          f"launches: flash {fa.launches} (expected {cfg.n_layers}), bitserial {bsm.launches} "
          f"(expected {max_new} x {n_proj}), paged {pa.launches}")
    ttft = float(np.mean([r.prefill_ms for r in results]))
    dms = float(np.mean([r.decode_ms_per_tok for r in results]))
    bound = db["routed_ms"]
    ttft_bound = moe_prefill_bound_ms(cfg, len(reqs), plen)
    rep = {"n_layers": cfg.n_layers, "init_s": init_s, "expert_bytes": expert_bytes,
           "packed_weight_bytes": packed_bytes, "wall_s": wall, "ttft_ms": ttft,
           "ttft_bound_ms": ttft_bound,
           "decode_ms_per_step": dms, "decode_bound_ms": bound,
           "decode_dense_bound_ms": db["dense_ms"],
           "experts_per_layer_step": db["experts_per_layer"],
           "tokens_per_s": gen_toks.size / wall, "serve_peak_bytes": peak,
           "init_peak_bytes": init_peak, "resident_before_bytes": resident,
           "flash_launches": fa.launches, "bitserial_launches": bsm.launches,
           "dropped": dropped, "assignments": total}
    print(f"[phi] phi3.5-moe-42b-a6.6b at its width (d_model={cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, {cfg.n_experts} experts "
          f"top-{cfg.top_k} of d_ff={cfg.d_ff}, vocab {cfg.vocab_size}->{cfg.padded_vocab}), "
          f"{full.n_layers} -> {cfg.n_layers} layers, {cfg.dtype}: init+pack {init_s:.1f} s, "
          f"float experts {expert_bytes / 1e9:.3f} GB, packed {packed_bytes / 1e9:.4f} GB, init "
          f"peak {init_peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB allocated before it); 4 x "
          f"{plen} prompt tokens, {max_new} new: TTFT {ttft:.2f} ms (operation bound "
          f"{ttft_bound:.3f}), decode {dms:.3f} ms per "
          f"step (byte bound {bound:.3f}: {db['experts_per_layer']:.2f} of {cfg.n_experts} "
          f"experts routed per layer; {db['dense_ms']:.3f} with every expert), "
          f"{gen_toks.size / wall:.2f} tok/s, serve peak "
          f"{peak / 1e9:.3f} GB; dropped {dropped} of {total} assignments "
          f"({dropped / total:.2%}); flash {fa.launches} == {cfg.n_layers}, bitserial "
          f"{bsm.launches} == {max_new} x {n_proj} [{card}]", flush=True)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def layer_counts(cfg):
    """How many layers of each kind the config's depth holds."""
    kinds = list(cfg.layer_pattern) * cfg.n_superblocks \
        + list(cfg.layer_pattern[:cfg.n_tail_layers])
    return {k: kinds.count(k) for k in set(kinds)}


def recurrent_weight_bytes(params):
    """(packed bytes, recurrent matrices' bytes, embedding (the tied head)
    bytes, other float bytes, matrix parameters) of a param tree as it is
    held; the matrix parameters count every packed projection's K x N
    and every recurrent matrix, the operands of a token's products."""
    from repro_torch.core.packing import RECURRENT_MATRICES, PackedWeight
    from repro_torch.tree import flatten_with_path

    packed = recurrent = embed = other = mparams = 0
    for name, x in flatten_with_path(params):
        if isinstance(x, PackedWeight):
            packed += x.hbm_bytes()
            mparams += x.planes.numel() // (x.n_bits * x.planes.shape[-2]) * x.k
            continue
        n = x.numel() * x.element_size()
        if name.rsplit("/", 1)[-1] in RECURRENT_MATRICES:
            recurrent += n
            mparams += x.numel()
        elif name == "embed":
            embed += n
        else:
            other += n
    return packed, recurrent, embed, other, mparams


def recurrent_state_bytes(cfg, elt):
    """Bytes of one lane's recurrent state (f32) and conv tails (``elt``
    bytes each) over the whole depth."""
    from repro_torch.models.ssm import ssm_dims

    n = layer_counts(cfg)
    _, H, conv_dim = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_state)
    state = n.get("ssm", 0) * H * cfg.ssm_head_dim * cfg.ssm_state * 4 \
        + n.get("rglru", 0) * cfg.d_model * 4
    conv = n.get("ssm", 0) * (cfg.ssm_conv - 1) * conv_dim * elt + n.get("rglru", 0) * 3 \
        * cfg.d_model * elt
    return state, conv


def recurrent_decode_bound(weights, cfg, lanes, ring_rows):
    """The byte bound (ms) of one decode step of ``lanes`` lanes: every
    weight held read once (packed planes, the recurrent matrices, the tied
    head, the vectors and norms), each lane's recurrent state and conv
    tails read and written, and ``ring_rows`` K/V rows of each local layer
    read per lane.  Returns (ms, bytes by part)."""
    packed, recurrent, embed, other, _ = weights
    elt = 2  # bf16 caches
    state, conv = recurrent_state_bytes(cfg, elt)
    ring = layer_counts(cfg).get("local", 0) * ring_rows * 2 * cfg.n_kv_heads \
        * cfg.resolved_head_dim * elt
    parts = {"packed": packed, "recurrent_matrices": recurrent, "head": embed, "other": other,
             "state_rw": 2 * lanes * (state + conv), "ring_read": lanes * ring}
    return 1e3 * sum(parts.values()) / HBM_BYTES_PER_S, parts


def recurrent_prefill_bound_ms(cfg, mparams, B, S):
    """The operation bound (ms) of a bucketed prefill of ``B`` prompts of
    ``S`` tokens at the bf16 rate: every matrix product of every token
    (``mparams`` multiply-adds each), the windowed attention's live
    (query, key) pairs, and the head on each prompt's last token; the
    scans' elementwise work is left out (a looser bound)."""
    live = sum(min(i + 1, cfg.window) for i in range(S))
    attn = layer_counts(cfg).get("local", 0) * 4.0 * cfg.resolved_head_dim * cfg.n_heads * live
    flop = B * (2.0 * mparams * S + attn + 2.0 * cfg.padded_vocab * cfg.d_model)
    return 1e3 * flop / PEAK_FLOPS["bfloat16"]


def recurrent_parity(dev, card):
    """Phase 3g: the recurrent mixers card against CPU, f32: mamba2-130m at
    full width cut to 12 of its 24 layers (d_model 768, 24 heads of 64, state
    128; nothing packable) and recurrentgemma-9b at full width cut to one
    superblock (rglru, rglru, local; 6-bit packed, the CPU holding the
    same weights unpacked to f32) with its full 256000-row tied head.
    Each: ``forward`` over 2 prompts, the bucketed engine (prefill and 8
    decode steps) and the chunked paged-kernel engine (4 lanes, chunks of
    64); every logit row within the phase-3 tolerance, identical greedy
    tokens, launches exact (mamba2 none; recurrentgemma the flash kernel
    once per prefill call on its local layer, the bitserial kernel on its
    13 packed projections per model call, the paged kernel never)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.packing import PackedWeight, tree_map_with_path, unpack_to_float
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.scheduler import SchedulerPolicy

    f32 = dict(dtype="float32", kv_cache_dtype="float32")
    archs = {  # arch: (config, pack bits, forward tokens, bucketed prompt, chunked prompts)
        "mamba2-130m": (get_config("mamba2-130m").scaled(**f32), None, 256, 200,
                        (100, 256, 150, 64)),
        "recurrentgemma-9b": (get_config("recurrentgemma-9b").scaled(n_layers=3, **f32), N_BITS,
                              128, 300, (100, 256, 150, 64)),
    }
    rep = {}
    for arch, (cfg, bits, s_fwd, plen, lens) in archs.items():
        t0 = time.perf_counter()
        p_gpu = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(2), dev,
                                        pack_bits=bits)
        p_cpu = tree_map_with_path(
            lambda _, w: (unpack_to_float(w) if isinstance(w, PackedWeight) else w).cpu(), p_gpu)
        init_s = time.perf_counter() - t0
        task = MarkovLM(vocab=cfg.vocab_size, seed=3)

        def req(uid, n, max_new):
            return Request(uid=uid, tokens=task.sample(np.random.default_rng(40 + uid), 1, n)[
                0, :n].astype(np.int32), max_new=max_new)

        n_local = layer_counts(cfg).get("local", 0)
        # packed projections per model call: q, k, v, o of each local layer
        # and the GeGLU MLP of every layer (the head is the float embedding)
        n_proj = 4 * n_local + 3 * cfg.n_layers if bits else 0
        toks = task.sample(np.random.default_rng(39), 2, s_fwd)[:, :s_fwd].astype(np.int64)
        # the CPU run again with every embedding value (the input and the
        # tied head) moved one f32 step up or down at random: how far
        # rounding alone moves this model's logits at this depth
        sign = torch.rand(p_cpu["embed"].shape, generator=torch.Generator().manual_seed(4)) < 0.5
        nudged = dict(p_cpu, embed=torch.nextafter(
            p_cpu["embed"], torch.where(sign, torch.tensor(float("inf")),
                                        torch.tensor(float("-inf")))))
        sides = {}
        for side, params, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, torch.device("cpu")),
                                ("nudged", nudged, torch.device("cpu"))):
            bsm.reset_launches()
            with torch.inference_mode():
                logits, _ = transformer.forward(params, {"tokens": torch.from_numpy(toks).to(d)},
                                                cfg)
            sides[side] = logits.float().cpu()
            if d is dev:
                check(bsm.launches == n_proj, f"3g {arch} forward: {bsm.launches} bitserial "
                      f"launches, expected {n_proj}")
        del nudged
        dlog = (sides["cuda"] - sides["cpu"]).abs().max().item()
        lmax = sides["cpu"].abs().max().item()
        noise = (sides["nudged"] - sides["cpu"]).abs().max().item()
        # phase 3's tolerance, or ROUNDING_FACTOR x the rounding noise where
        # the model amplifies rounding past it (mamba2's SSD turns a change
        # of dt into one of exp(sum of dt a) over the chunk)
        tol = max(TOL["float32"] * max(1.0, lmax), ROUNDING_FACTOR * noise)
        print(f"[parity-recurrent] {arch} forward over 2 x {s_fwd} tokens: max|dlogit| card vs "
              f"cpu {dlog:.3e} (max|logit| {lmax:.3e}); one-step embedding nudge on the cpu moves "
              f"the logits {noise:.3e}; tolerance {tol:.3e} [{card}]", flush=True)
        check(dlog <= tol, f"3g {arch} forward: logits differ by {dlog} > {tol}")
        rep[arch] = {"init_s": init_s, "tolerance": tol, "rounding_noise": noise,
                     "forward": {"max_abs_dlogit": dlog, "max_abs_logit": lmax,
                                 "tokens": int(toks.size)}}
        del sides
        runs = {
            "bucketed": ([req(0, plen, 9), req(1, plen, 9)], None, {}, 1),
            "chunked-paged": ([req(2 + i, n, 8) for i, n in enumerate(lens)], [0, 0, 1, 2],
                              dict(continuous=True, policy=SchedulerPolicy(
                                  n_slots=4, chunked_prefill=True, chunk_sizes=(64,),
                                  paged=True, block_size=BLOCK, paged_kernel=True)), 0),
        }
        for name, (reqs, arrivals, kw, prefill_calls) in runs.items():
            out, taps, secs = {}, {}, {}
            for side, params, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, torch.device("cpu"))):
                eng = ServeEngine(params, cfg, max_len=512, device=d, **kw)
                for m in (bsm, fa, pa):
                    m.reset_launches()
                t0 = time.perf_counter()
                with LogitTap() as tap:
                    res = eng.generate(reqs, arrival_steps=arrivals)
                if d is dev:
                    torch.cuda.synchronize()
                    launches = (bsm.launches, fa.launches, fa.windowed_launches, pa.launches)
                    calls = len(tap.rows)  # one logit row set per model call
                secs[side] = time.perf_counter() - t0
                out[side] = {r.uid: r.tokens.tolist() for r in res}
                taps[side] = tap.rows
                if eng.scheduler is not None:
                    pool = eng.scheduler.pool
                    check(pool.allocator.free_count == pool.n_blocks,
                          f"3g {arch} {name} {side}: the pool did not drain")
            check(len(taps["cuda"]) == len(taps["cpu"]),
                  f"3g {arch} {name}: {len(taps['cuda'])} logit calls on the card, "
                  f"{len(taps['cpu'])} on the CPU")
            dlog = max((a - b).abs().max().item() for a, b in zip(taps["cuda"], taps["cpu"]))
            lmax = max(b.abs().max().item() for b in taps["cpu"])
            want = (calls * n_proj, prefill_calls * n_local, prefill_calls * n_local, 0)
            check(launches == want, f"3g {arch} {name}: launches (bitserial, flash, windowed, "
                  f"paged) {launches}, expected {want}")
            print(f"[parity-recurrent] {arch} {cfg.n_layers} layers full width f32 {name}: card "
                  f"{secs['cuda']:.1f} s, cpu {secs['cpu']:.1f} s; {len(taps['cpu'])} logit "
                  f"calls, max|dlogit| {dlog:.3e} (max|logit| {lmax:.3e}); launches (bitserial, "
                  f"flash, windowed, paged) {launches}; tokens {out['cuda']} [{card}]",
                  flush=True)
            check(out["cuda"] == out["cpu"],
                  f"3g {arch} {name}: greedy tokens differ card vs cpu: {out}")
            check(dlog <= max(tol, TOL["float32"] * max(1.0, lmax)),
                  f"3g {arch} {name}: logits differ by {dlog} > {tol}")
            rep[arch][name] = {"tokens": out["cuda"], "max_abs_dlogit": dlog,
                               "max_abs_logit": lmax, "logit_calls": len(taps["cpu"]),
                               "card_s": secs["cuda"], "cpu_s": secs["cpu"],
                               "launches": list(launches)}
        del p_gpu, p_cpu
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[parity-recurrent] card == cpu: forward, bucketed and chunked logits within 1e-4 "
          f"of max(1, max|logit|) or {ROUNDING_FACTOR} x the rounding noise, greedy tokens "
          f"identical", flush=True)
    return rep


def recurrent_slice(dev, card, engine_cls, arch):
    """Phase 4g (recurrentgemma-9b) or 4h (mamba2-130m): the model at full
    width and depth, bf16, drawn with ``init_params(pack_bits=6)`` on the
    card (recurrentgemma's attention and GeGLU MLP packed; mamba2 has
    nothing packable), served bucketed (recurrentgemma 2 x 4096 and 2 x
    1024 prompt tokens, the 4096 ones wrapping its 2048-slot rings in
    prefill; mamba2 4 x 256 and 4 x 1024, multiples of its ssm_chunk; 32
    new each) and continuous (chunks of 256, the paged policy with the
    paged kernel asked for; 8 lanes, 16 requests with prompts uniform in
    [512, 3072] or [64, 1024] (seed 0) on Poisson arrivals at 0.5 per
    step, 32 new each), then a profiled decode step.  Launches exact:
    the bitserial kernel on every packed projection of every model call,
    the flash kernel once per prefill call and local layer (windowed),
    the paged kernel never (rings and recurrent state bypass paging);
    mamba2 launches no kernel at all.  The engine must hold the recurrent
    matrices in bf16."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.packing import RECURRENT_MATRICES
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import poisson_arrivals
    from repro_torch.models import transformer
    from repro_torch.obs.metrics import percentile
    from repro_torch.serve import Request
    from repro_torch.serve.scheduler import SchedulerPolicy
    from repro_torch.tree import flatten_with_path

    tag = {"recurrentgemma-9b": "rgemma", "mamba2-130m": "mamba2"}[arch]
    bucket_lens, (lo, hi) = {"recurrentgemma-9b": ([4096, 4096, 1024, 1024], (512, 3072)),
                             "mamba2-130m": ([256] * 4 + [1024] * 4, (64, 1024))}[arch]
    max_new = R_MAX_NEW
    cfg = get_config(arch)
    n_local = layer_counts(cfg).get("local", 0)
    # packed projections per model call: q, k, v, o of each local layer and
    # the GeGLU MLP of every layer (the tied head is the float embedding)
    n_proj = 4 * n_local + (3 * cfg.n_layers if cfg.d_ff else 0)
    resident = torch.cuda.memory_allocated()  # what earlier phases left allocated
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                     pack_bits=N_BITS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)

    # ---- bucketed
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(110 + i), 1, n)[0, :n]
                    .astype(np.int32), max_new=max_new) for i, n in enumerate(bucket_lens)]
    engine = engine_cls(params, cfg, max_len=max(bucket_lens) + max_new, device=dev)
    held = {}
    for name, x in flatten_with_path(engine.params):
        if name.rsplit("/", 1)[-1] in RECURRENT_MATRICES:
            held.setdefault(name.rsplit("/", 1)[-1], set()).add(x.dtype)
    check(held and all(d == {torch.bfloat16} for d in held.values()),
          f"{arch}: the engine holds the recurrent matrices as {held}, not bf16")
    weights = recurrent_weight_bytes(engine.params)
    packed_bytes, rec_bytes, embed_bytes, other_bytes, mparams = weights
    print(f"[{tag}] {arch} {cfg.n_layers} layers {dict(sorted(layer_counts(cfg).items()))} "
          f"d_model={cfg.d_model} vocab {cfg.vocab_size}->{cfg.padded_vocab} {cfg.dtype}: "
          f"init+pack {init_s:.1f} s, init peak {init_peak / 1e9:.3f} GB ({resident / 1e9:.3f} "
          f"GB allocated before it); served: packed {packed_bytes / 1e9:.4f} GB, recurrent "
          f"matrices {rec_bytes / 1e9:.4f} GB in bf16 ({', '.join(sorted(held))}), tied head "
          f"{embed_bytes / 1e9:.4f} GB, other float {other_bytes / 1e9:.4f} GB; "
          f"{mparams / 1e9:.3f} B matrix parameters [{card}]", flush=True)
    rep = {"init_s": init_s, "init_peak_bytes": init_peak, "resident_before_bytes": resident,
           "packed_weight_bytes": packed_bytes, "recurrent_matrix_bytes": rec_bytes,
           "embed_bytes": embed_bytes, "other_float_bytes": other_bytes,
           "matrix_params": mparams, "recurrent_matrices_bf16": sorted(held)}
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:64], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    for m in (bsm, fa, pa):
        m.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen_toks = np.stack([r.tokens for r in sorted(results, key=lambda r: r.uid)])
    check(gen_toks.shape == (len(reqs), max_new), f"{arch} bucketed tokens {gen_toks.shape}")
    check(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all(), "token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    calls = len(set(bucket_lens))  # prefill calls: one per bucket
    want = (calls * max_new * n_proj, calls * n_proj, calls * n_local, calls * n_local, 0)
    got = (bsm.launches, bsm.prefill_launches, fa.launches, fa.windowed_launches, pa.launches)
    check(got == want, f"{arch} bucketed launches (bitserial, its prefill, flash, windowed, "
          f"paged) {got}, expected {want}")
    rep["bucketed"] = {"wall_s": wall, "tokens": int(gen_toks.size),
                       "tokens_per_s": gen_toks.size / wall, "serve_peak_bytes": peak,
                       "bitserial_launches": bsm.launches,
                       "bitserial_prefill_launches": bsm.prefill_launches,
                       "flash_launches": fa.launches, "flash_windowed": fa.windowed_launches,
                       "paged_launches": pa.launches, "buckets": {}}
    for plen in sorted(set(bucket_lens)):
        rs = [r for r in results if len(reqs[r.uid].tokens) == plen]
        ttft = float(np.mean([r.prefill_ms for r in rs]))
        dms = float(np.mean([r.decode_ms_per_tok for r in rs]))
        bound, parts = recurrent_decode_bound(weights, cfg, len(rs),
                                              min(plen + max_new // 2, cfg.window))
        tb = recurrent_prefill_bound_ms(cfg, mparams, len(rs), plen)
        rep["bucketed"]["buckets"][plen] = {
            "requests": len(rs), "ttft_ms": ttft, "ttft_bound_ms": tb,
            "decode_ms_per_step": dms, "decode_bound_ms": bound, "decode_bound_bytes": parts}
        print(f"[{tag}] bucket prompt={plen} x{len(rs)}: TTFT {ttft:.2f} ms (operation bound "
              f"{tb:.3f}), decode {dms:.3f} ms per step (byte bound {bound:.4f}: "
              + ", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in parts.items()) + f") [{card}]",
              flush=True)
    print(f"[{tag}] bucketed: {len(reqs)} requests, {gen_toks.size} tokens in {wall:.3f} s = "
          f"{gen_toks.size / wall:.2f} tok/s; serve peak memory {peak / 1e9:.3f} GB; launches "
          f"bitserial {bsm.launches} == {calls} x {max_new} x {n_proj} ({bsm.prefill_launches} "
          f"prefill), flash {fa.launches} == {calls} x {n_local} ({fa.windowed_launches} "
          f"windowed), paged {pa.launches} [{card}]", flush=True)
    short = min(bucket_lens)  # the shorter bucket's prefill, then 2 profiled steps
    rep["profile"] = profile_decode(engine, [r for r in reqs if len(r.tokens) == short], cfg,
                                    card, steps=2)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # ---- continuous
    n_req = 16
    lens = np.random.default_rng(0).integers(lo, hi + 1, size=n_req)
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(i), 1, hi)[0, :n]
                    .astype(np.int32), max_new=max_new) for i, n in enumerate(lens)]
    arrivals = poisson_arrivals(n_req, 0.5, seed=0)
    policy = SchedulerPolicy(n_slots=SLOTS, chunked_prefill=True, chunk_sizes=(R_CHUNK,),
                             paged=True, block_size=BLOCK, paged_kernel=True)
    engine = engine_cls(params, cfg, max_len=hi + max_new, device=dev, continuous=True,
                        policy=policy)
    sched, pool = engine.scheduler, engine.scheduler.pool
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:64], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    sched.reset_telemetry()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    for m in (bsm, fa, pa):
        m.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(reqs, arrival_steps=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    got = {r.uid: r for r in results}
    check(sorted(got) == list(range(n_req)), f"{arch} continuous results for {sorted(got)}")
    for r in results:
        check(len(r.tokens) == max_new and ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all(),
              f"uid {r.uid}: {len(r.tokens)} tokens, or a token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    want = ((steps + chunks) * n_proj, 0, 0)
    check((bsm.launches, fa.launches, pa.launches) == want,
          f"{arch} continuous launches (bitserial, flash, paged) "
          f"{(bsm.launches, fa.launches, pa.launches)}, expected {want} ({steps} steps + "
          f"{chunks} chunks) x {n_proj}; chunked prefill reads the cache, no layer pages")
    check(pool.allocator.free_count == pool.n_blocks and pool.allocator.committed == 0,
          f"blocks leaked: free {pool.allocator.free_count}/{pool.n_blocks}, committed "
          f"{pool.allocator.committed}")
    check(engine.obs.recorder.leaked == [], f"leaked spans {engine.obs.recorder.leaked}")
    ttft = [got[i].prefill_ms for i in range(n_req)]
    occ = sched.mean_occupancy()  # the mean share of the lanes live per step
    ring_rows = float(np.mean([min(n + max_new // 2, cfg.window) for n in lens]))
    bound, parts = recurrent_decode_bound(weights, cfg, occ * pool.n_slots, ring_rows)
    rep["continuous"] = {
        "requests": n_req, "max_new": max_new, "prompt_lens": lens.tolist(),
        "arrivals": arrivals, "chunk_sizes": list(policy.chunk_sizes), "wall_s": wall,
        "tokens": n_req * max_new, "tokens_per_s": n_req * max_new / wall,
        "ttft_ms_p50": percentile(ttft, 50), "ttft_ms_p90": percentile(ttft, 90),
        "decode_steps": steps, "prefill_chunks": chunks,
        "decode_ms_per_step": sched.decode_ms_total / max(steps, 1),
        "decode_bound_ms": bound, "decode_bound_bytes": parts, "mean_occupancy": occ,
        "admit_blocked_total": sched._c_blocked.value, "serve_peak_bytes": peak,
        "cache_bytes": pool.cache_bytes(), "ring_bytes": pool.ring_bytes(),
        "bitserial_launches": bsm.launches, "flash_launches": fa.launches,
        "paged_launches": pa.launches,
    }
    c = rep["continuous"]
    print(f"[{tag}] continuous: {n_req} requests x {max_new} tokens, prompts {lens.min()}-"
          f"{lens.max()} ({lens.sum()} tokens), Poisson arrivals at 0.5/step over "
          f"{arrivals[-1]} steps, chunks of {R_CHUNK}: {c['tokens']} tokens in {wall:.3f} s = "
          f"{c['tokens_per_s']:.2f} tok/s; TTFT p50 {c['ttft_ms_p50']:.1f} ms, p90 "
          f"{c['ttft_ms_p90']:.1f} ms; decode {c['decode_ms_per_step']:.3f} ms per step (byte "
          f"bound {bound:.4f} at the mean occupancy {occ:.2f} of {pool.n_slots} lanes; {steps} "
          f"steps), {chunks} prefill "
          f"chunks; serve peak memory {peak / 1e9:.3f} GB, cache {c['cache_bytes'] / 1e9:.4f} "
          f"GB ({c['ring_bytes'] / 1e9:.4f} GB rings); launches bitserial {bsm.launches} == "
          f"({steps} + {chunks}) x {n_proj}, flash {fa.launches}, paged {pa.launches}; pool "
          f"drained [{card}]", flush=True)
    if not n_proj and not n_local:
        print(f"[{tag}] {arch} has no kernel on its path: nothing packable (in_proj and "
              f"out_proj are outside the packable projections, the head is the float tied "
              f"embedding) and no attention layer; every launch count is 0 [{card}]",
              flush=True)
    del engine, params, sched, pool  # the scheduler and engine refer to each other
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def frontend_proj(cfg, cross):
    """Packed projections per model call of a frontend config: q, k, v, o
    and the MLP's (SwiGLU 3, GELU 2) of every layer, the cross sublayer's
    four on each "+cross" layer when ``cross`` (cross embeds given), and
    the untied head."""
    n_cross = sum(c for k, c in layer_counts(cfg).items() if "+cross" in k)
    mlp = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return cfg.n_layers * (4 + mlp) + (4 * n_cross if cross else 0) \
        + (0 if cfg.tie_embeddings else 1)


def frontend_bounds(cfg, weights, B, S, T, pos=None):
    """The least time (ms) of one model call of ``B`` lanes at the bf16 rate
    and 3.35 TB/s: a prefill of ``S`` tokens (``pos`` None) or a decode
    step at position ``pos``, ``T`` cross tokens per lane (0: none).
    Operations: every projection of every token, the cross K/V projections
    of every cross token (every call: they keep no cache), 4 d flops per
    live (query, key) pair and head of the causal and the cross attention,
    the head on each lane's last token.  Bytes: the packed weights read
    once (with the cross sublayers' only when ``T``), the head, the cross
    embeds, the prompt's embeddings or the step's K/V rows, the logits.
    Returns (ms, bound_by, flop, bytes)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mlp = (3 if cfg.mlp_type in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    self_mm = cfg.n_layers * (2 * d * H * hd + 2 * d * KV * hd + mlp)
    n_cross = sum(c for k, c in layer_counts(cfg).items() if "+cross" in k) if T else 0
    cross_qo, cross_kv = 2 * d * H * hd, 2 * d * KV * hd
    packed, cross_packed = weights
    elt = 2
    if pos is None:
        live = S * (S + 1) // 2
        flop = B * (2.0 * S * (self_mm + n_cross * cross_qo) + 2.0 * T * n_cross * cross_kv
                    + 4.0 * hd * H * (cfg.n_layers * live + n_cross * S * T)
                    + 2.0 * d * cfg.padded_vocab)
        rows = B * S * d * elt  # the prompt's embeddings (or embeds) read once
    else:
        flop = B * (2.0 * (self_mm + n_cross * cross_qo) + 2.0 * T * n_cross * cross_kv
                    + 4.0 * hd * H * (cfg.n_layers * (pos + 1) + n_cross * T)
                    + 2.0 * d * cfg.padded_vocab)
        rows = B * (d + cfg.n_layers * 2 * (pos + 1) * KV * hd) * elt  # input and K/V rows
    nbytes = packed - (0 if T else cross_packed) + rows + B * T * d * elt \
        + B * cfg.padded_vocab * 4
    t_ops, t_bytes = flop / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flop, \
        nbytes


def frontend_weight_bytes(params):
    """(packed bytes with the head, the cross sublayers' packed bytes) of a
    param tree: what a model call reads besides activations (norm scales
    and the embedding rows it gathers are left out)."""
    from repro_torch.core.packing import PackedWeight
    from repro_torch.tree import flatten_with_path

    packed = cross = 0
    for name, x in flatten_with_path(params):
        if isinstance(x, PackedWeight):
            packed += x.hbm_bytes()
            cross += x.hbm_bytes() if "/cross/" in name else 0
    return packed, cross


def frontend_parity(dev, card):
    """Phase 3h: the frontends, f32, card against CPU on the same params
    (6-bit packed on the card, unpacked to f32 on the CPU, as phase 3f):
    llama-3.2-vision-11b at full width cut to one superblock (4 "attn"
    layers and 1 "attn+cross") with 1600 random cross tokens per lane:
    ``forward``; ``prefill`` and 8 ``decode_step`` calls with the cross
    embeds; ``prefill_chunk`` (chunks of 64 into a paged pool) and
    paged-kernel ``decode_step`` with them; one decode step with a
    device-tensor ``active_planes`` bitwise equal to the same step on
    ``truncate_packed`` weights.  Then musicgen-large at full width cut to
    2 layers, ``embeds`` through ``prefill`` and ``decode_step``.  Every
    logit row within phase 3's tolerance, greedy tokens identical, launches
    exact."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.packing import PackedWeight, tree_map_with_path, unpack_to_float
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer
    from repro_torch.obs.quality import truncate_model_planes
    from repro_torch.tree import tree_map

    cpu = torch.device("cpu")
    f32 = dict(dtype="float32", kv_cache_dtype="float32")
    rep = {}

    def counts():
        return (bsm.launches, fa.launches, pa.launches)

    def reset():
        for m in (bsm, fa, pa):
            m.reset_launches()

    def compare(name, rows, want_launches, greedy=True):
        """rows: {"cuda": [...], "cpu": [...]}, the logit rows of each call;
        ``greedy``: each call's argmax (the token a serving path samples)
        must agree too."""
        dlog = max((a - b).abs().max().item() for a, b in zip(rows["cuda"], rows["cpu"]))
        lmax = max(b.abs().max().item() for b in rows["cpu"])
        tol = TOL["float32"] * max(1.0, lmax)
        toks = [r.argmax(-1).tolist() for r in rows["cuda"]] if greedy else None
        check(not greedy or toks == [r.argmax(-1).tolist() for r in rows["cpu"]],
              f"3h {name}: greedy tokens differ card vs cpu")
        print(f"[parity-frontend] {name}: {len(rows['cpu'])} calls, max|dlogit| {dlog:.3e} "
              f"(max|logit| {lmax:.3e}, tolerance {tol:.3e}); launches (bitserial, flash, "
              f"paged) {want_launches[0]}" + ("; greedy tokens identical" if greedy else "")
              + f" [{card}]", flush=True)
        check(dlog <= tol, f"3h {name}: logits differ by {dlog} > {tol}")
        check(want_launches[0] == want_launches[1],
              f"3h {name}: launches (bitserial, flash, paged) {want_launches[0]}, expected "
              f"{want_launches[1]}")
        return {"max_abs_dlogit": dlog, "max_abs_logit": lmax, "calls": len(rows["cpu"]),
                "launches": list(want_launches[0]), "tokens": toks}

    # ---- llama-3.2-vision-11b, one superblock
    t0 = time.perf_counter()
    cfg = get_config(VISION).scaled(n_layers=5, **f32)
    p_gpu = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(2), dev,
                                    pack_bits=N_BITS)
    p_cpu = tree_map_with_path(
        lambda _, w: (unpack_to_float(w) if isinstance(w, PackedWeight) else w).cpu(), p_gpu)
    n_full, n_self = frontend_proj(cfg, True), frontend_proj(cfg, False)
    n_att = cfg.n_layers
    T = cfg.frontend_tokens
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    cross = torch.randn((2, T, cfg.d_model), generator=torch.Generator().manual_seed(5))
    sides = {"cuda": (p_gpu, dev), "cpu": (p_cpu, cpu)}
    r = {"init_s": time.perf_counter() - t0, "cross_tokens": T, "projections": n_full}

    toks = torch.from_numpy(task.sample(np.random.default_rng(39), 2, 128)[:, :128]
                            .astype(np.int64))
    rows, got = {}, None
    for side, (params, d) in sides.items():
        reset()
        with torch.inference_mode():
            logits, _ = transformer.forward(params, {"tokens": toks.to(d),
                                                     "cross_embeds": cross.to(d)}, cfg)
        rows[side] = [logits.float().cpu().reshape(-1, logits.shape[-1])]
        if d is dev:
            got = counts()
    r["forward"] = compare(f"llama-vision forward 2 x 128 tokens, {T} cross tokens", rows,
                           (got, (n_full, 0, 0)), greedy=False)

    # prefill and 8 decode steps, the card's greedy tokens fed to both
    plen, steps = 200, 8
    toks = torch.from_numpy(task.sample(np.random.default_rng(40), 2, plen)[:, :plen]
                            .astype(np.int64))
    rows, fed, caches = {"cuda": [], "cpu": []}, [], {}
    for side, (params, d) in sides.items():
        reset()
        with torch.inference_mode():
            logits, cache = transformer.prefill(params, {"tokens": toks.to(d),
                                                         "cross_embeds": cross.to(d)}, cfg, 512)
            rows[side].append(logits.float().cpu())
            for t in range(steps):
                if side == "cuda":
                    fed.append(logits.argmax(-1, keepdim=True).cpu())
                logits, cache = transformer.decode_step(params, cache, fed[t].to(d), plen + t,
                                                        cfg, cross_embeds=cross.to(d))
                rows[side].append(logits.float().cpu())
        if d is dev:
            got = counts()
        caches[side] = cache
    r["prefill_decode"] = compare(f"llama-vision prefill 2 x {plen} + {steps} decode steps",
                                  rows, (got, ((steps + 1) * n_full, n_att, 0)))

    # one more step with a device-tensor plane count, bitwise the same step
    # on truncate_packed weights (each on its own copy of the cache)
    a = N_BITS - 2
    tok = fed[-1].to(dev)
    with torch.inference_mode():
        reset()
        dyn, _ = transformer.decode_step(
            p_gpu, tree_map(torch.clone, caches["cuda"]), tok, plen + steps, cfg,
            cross_embeds=cross.to(dev),
            active_planes=torch.tensor([a], dtype=torch.int32, device=dev))
        got_active = (bsm.active_launches, bsm.launches)
        static, _ = transformer.decode_step(
            truncate_model_planes(p_gpu, a), tree_map(torch.clone, caches["cuda"]), tok,
            plen + steps, cfg, cross_embeds=cross.to(dev))
    check(torch.equal(dyn.view(torch.int32), static.view(torch.int32)),
          f"3h llama-vision decode step at active_planes={a} (device tensor) != the step on "
          "truncate_packed weights")
    check(got_active == (n_full, n_full), f"3h active step: (runtime-plane, all) bitserial "
          f"launches {got_active}, expected ({n_full}, {n_full})")
    print(f"[parity-frontend] llama-vision decode step at active_planes={a} from a device "
          f"tensor: bitwise equal to the step on truncate_packed weights; {n_full} runtime-plane "
          f"launches, the cross sublayer's four among them [{card}]", flush=True)
    r["active_planes"] = {"a": a, "bitwise": True, "active_launches": got_active[0]}
    del caches, dyn, static

    # chunked prefill into a paged pool, then paged-kernel decode steps
    lens, C, max_len = [100, 150], 64, 512
    nb_lane = max_len // BLOCK
    table = torch.arange(2 * nb_lane, dtype=torch.int32).reshape(2, nb_lane)
    prompts = task.sample(np.random.default_rng(41), 2, max(lens))[:, :max(lens)]
    rows, fed = {"cuda": [], "cpu": []}, []
    for side, (params, d) in sides.items():
        reset()
        cache = transformer.init_cache(cfg, 2, max_len, torch.float32, d,
                                       paged_blocks=2 * nb_lane, block_size=BLOCK)
        tb, cr = table.to(d), cross.to(d)
        done = [False, False]
        last = [None, None]
        with torch.inference_mode():
            for start in range(0, max(lens), C):
                nv = [max(0, min(C, n - start)) for n in lens]
                chunk = np.zeros((2, C), np.int64)
                for b in range(2):
                    chunk[b, :nv[b]] = prompts[b, start:start + nv[b]]
                st = [start if nv[b] else max_len for b in range(2)]
                logits, _ = transformer.prefill_chunk(
                    params, cache, torch.from_numpy(chunk).to(d),
                    torch.tensor(st, dtype=torch.int32, device=d),
                    torch.tensor(nv, dtype=torch.int32, device=d), cfg, block_table=tb,
                    cross_embeds=cr)
                for b in range(2):
                    if nv[b] and start + nv[b] == lens[b] and not done[b]:
                        done[b], last[b] = True, logits[b].float().cpu()
            rows[side].append(torch.stack(last))
            pos = torch.tensor(lens, dtype=torch.int32, device=d)
            for t in range(steps):
                if side == "cuda":
                    fed.append(rows[side][-1].argmax(-1, keepdim=True))
                logits, _ = transformer.decode_step(params, cache, fed[t].to(d), pos, cfg,
                                                    block_table=tb, paged_kernel=True,
                                                    cross_embeds=cr)
                rows[side].append(logits.float().cpu())
                pos = pos + 1
        if d is dev:
            got = counts()
    n_chunks = -(-max(lens) // C)
    r["chunked_paged"] = compare(
        f"llama-vision chunked prefill ({lens}, chunks of {C}) + {steps} paged-kernel decode "
        "steps", rows, (got, ((n_chunks + steps) * n_full, 0, steps * n_att)))
    rep["llama-vision"] = r
    del p_gpu, p_cpu, sides
    gc.collect()
    torch.cuda.empty_cache()

    # ---- musicgen-large, 2 layers, embeds in place of tokens
    cfg = get_config(AUDIO).scaled(n_layers=2, **f32)
    p_gpu = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(3), dev,
                                    pack_bits=N_BITS)
    p_cpu = tree_map_with_path(
        lambda _, w: (unpack_to_float(w) if isinstance(w, PackedWeight) else w).cpu(), p_gpu)
    n_proj = frontend_proj(cfg, False)
    g = torch.Generator().manual_seed(6)
    frames = torch.randn((2, 128 + steps, cfg.d_model), generator=g)
    rows = {"cuda": [], "cpu": []}
    for side, params, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, cpu)):
        reset()
        with torch.inference_mode():
            logits, cache = transformer.prefill(params, {"embeds": frames[:, :128].to(d)}, cfg,
                                                512)
            rows[side].append(logits.float().cpu())
            for t in range(steps):
                logits, cache = transformer.decode_step(
                    params, cache, frames[:, 128 + t:129 + t].to(d), 128 + t, cfg)
                rows[side].append(logits.float().cpu())
        if d is dev:
            got = counts()
    rep["musicgen"] = {"projections": n_proj, "embeds": compare(
        f"musicgen 2 layers, embeds: prefill 2 x 128 frames + {steps} decode steps", rows,
        (got, ((steps + 1) * n_proj, cfg.n_layers, 0)))}
    del p_gpu, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def frontend_slice(dev, card, engine_cls, arch):
    """Phase 4i (llama-3.2-vision-11b) or 4j (musicgen-large): the model at
    full width and depth, bf16, 6-bit packed, drawn on the card.  First
    through the model API with the frontend's inputs live:
    llama-vision buckets of 4 x 128 and 4 x 1024 prompt tokens with 1600
    random cross tokens per request, ``prefill`` and 31 ``decode_step``
    calls with ``cross_embeds`` (32 new tokens); musicgen ``prefill`` of 4
    x 1024 embed frames and 32 ``decode_step`` calls fed (4, 1, 2048)
    embeds.  Then the engines, which serve tokens and skip the cross
    sublayers, as JAX's do: musicgen bucketed (4 x 256 and 4 x 1024, 32
    new); both continuous (chunks of 256, paged, the paged kernel; 8 lanes,
    16 requests with prompts uniform in [128, 1024] or [64, 1024] (seed 0)
    on Poisson arrivals at 0.5 per step).  Launches exact; TTFT beside its
    operation bound, decode ms per step beside its bound, tokens/s, peak
    memory, weight bytes and a profiled decode step (llama-vision: the
    device time of the cross K/V products, the step's only wgmma launches)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import poisson_arrivals
    from repro_torch.models import transformer
    from repro_torch.obs.metrics import percentile
    from repro_torch.serve import Request
    from repro_torch.serve.engine import serving_params
    from repro_torch.serve.scheduler import SchedulerPolicy

    vision = arch == VISION
    tag = "vision" if vision else "musicgen"
    cfg = get_config(arch)
    T = cfg.frontend_tokens
    n_full, n_self = frontend_proj(cfg, True), frontend_proj(cfg, False)
    n_cross = sum(c for k, c in layer_counts(cfg).items() if "+cross" in k)
    L = cfg.n_layers
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serving_params(transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev, pack_bits=N_BITS), cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weights = frontend_weight_bytes(params)
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    print(f"[{tag}] {arch} {L} layers {dict(sorted(layer_counts(cfg).items()))} d_model="
          f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, "
          f"{cfg.mlp_type} {cfg.d_ff}, vocab {cfg.vocab_size}->{cfg.padded_vocab}, frontend "
          f"{cfg.frontend} ({T} cross tokens) {cfg.dtype}: init+pack {init_s:.1f} s, init peak "
          f"{init_peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB allocated before it); packed "
          f"{weights[0] / 1e9:.4f} GB (head included; cross sublayers {weights[1] / 1e9:.4f}), "
          f"embedding {embed_bytes / 1e9:.4f} GB bf16 [{card}]", flush=True)
    rep = {"init_s": init_s, "init_peak_bytes": init_peak, "resident_before_bytes": resident,
           "packed_weight_bytes": weights[0], "cross_packed_bytes": weights[1],
           "embed_bytes": embed_bytes, "projections_per_call": n_full if vision else n_self,
           "projections_per_call_text": n_self}
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    gen = torch.Generator(device=dev).manual_seed(7)

    def batch_for(B, S, seed):
        """The model API's inputs: tokens and cross embeds, or embeds."""
        if vision:
            toks = task.sample(np.random.default_rng(seed), B, S)[:, :S].astype(np.int64)
            return {"tokens": torch.from_numpy(toks).to(dev),
                    "cross_embeds": torch.randn((B, T, cfg.d_model), generator=gen,
                                                device=dev).to(torch.bfloat16)}
        return {"embeds": torch.randn((B, S + F_MAX_NEW, cfg.d_model), generator=gen,
                                      device=dev).to(torch.bfloat16)}

    def model_api(B, S, seed, steps):
        """prefill, then ``steps`` decode steps; returns the timings, the
        launches of each part and the tokens."""
        batch = batch_for(B, S, seed)
        pre = dict(batch, embeds=batch["embeds"][:, :S]) if not vision else batch
        cross = batch.get("cross_embeds")
        torch.cuda.synchronize()
        for m in (bsm, fa, pa):
            m.reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, cache = transformer.prefill(params, pre, cfg, S + F_MAX_NEW)
            tok = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            ttft = (time.perf_counter() - t0) * 1e3
            pre_l = (bsm.launches, bsm.prefill_launches, fa.launches, pa.launches)
            for m in (bsm, fa, pa):
                m.reset_launches()
            out, bad = [tok], (~torch.isfinite(logits)).sum()
            t0 = time.perf_counter()
            for t in range(steps):
                x = tok if vision else batch["embeds"][:, S + t:S + t + 1]
                logits, cache = transformer.decode_step(params, cache, x, S + t, cfg,
                                                        cross_embeds=cross)
                tok = logits.argmax(-1, keepdim=True)
                out.append(tok)
                bad = bad + (~torch.isfinite(logits)).sum()
            torch.cuda.synchronize()
            dms = (time.perf_counter() - t0) * 1e3 / steps
        dec_l = (bsm.launches, bsm.prefill_launches, fa.launches, pa.launches)
        toks = torch.cat(out, 1).cpu().numpy()
        check(int(bad.item()) == 0, f"{arch} model API {B} x {S}: non-finite logits")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token outside the vocab")
        return ttft, dms, pre_l, dec_l, toks, batch, cache

    # ---- the model API with the frontend's inputs
    model_api(4, 16, 100, 2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    rep["model_api"] = {}
    steps = F_MAX_NEW - 1 if vision else F_MAX_NEW
    for S in ((128, 1024) if vision else (1024,)):
        ttft, dms, pre_l, dec_l, toks, batch, cache = model_api(4, S, 120 + S, steps)
        peak = torch.cuda.max_memory_allocated()
        n_call = n_full if vision else n_self
        # the prefill tiles: every projection but the head (its last token, M 4)
        want_pre = (n_call, n_call - 1, L, 0)
        # decode: the cross K/V products over 4 x 1600 rows are the step's
        # only prefill-tile launches
        want_dec = (steps * n_call, steps * 2 * n_cross, 0, 0)
        check(pre_l == want_pre and dec_l == want_dec,
              f"{arch} model API 4 x {S}: launches (bitserial, its prefill tile, flash, paged) "
              f"prefill {pre_l}, expected {want_pre}; decode {dec_l}, expected {want_dec}")
        tb = frontend_bounds(cfg, weights, 4, S, T)
        db = frontend_bounds(cfg, weights, 4, S, T, pos=S + steps // 2)
        rep["model_api"][S] = {
            "requests": 4, "prompt": S, "cross_tokens": T, "new_tokens": steps + 1,
            "ttft_ms": ttft, "ttft_bound_ms": tb[0], "ttft_bound_by": tb[1],
            "ttft_flop": tb[2], "decode_ms_per_step": dms, "decode_bound_ms": db[0],
            "decode_bound_by": db[1], "decode_flop": db[2], "decode_bytes": db[3],
            "tokens_per_s": 4 * (steps + 1) / ((ttft + steps * dms) * 1e-3),
            "peak_bytes": peak, "launches_prefill": list(pre_l), "launches_decode": list(dec_l)}
        m = rep["model_api"][S]
        print(f"[{tag}] model API, 4 x {S} " + (f"prompt tokens + {T} cross tokens each"
                                               if vision else "embed frames")
              + f": TTFT {ttft:.2f} ms (bound {tb[0]:.3f}, {tb[1]}: {tb[2] / 1e12:.2f} TFLOP), "
              f"decode {dms:.3f} ms per step (bound {db[0]:.4f}, {db[1]}: {db[2] / 1e12:.3f} "
              f"TFLOP, {db[3] / 1e9:.3f} GB), {m['tokens_per_s']:.2f} tok/s, {steps + 1} new "
              f"tokens; peak memory {peak / 1e9:.3f} GB; launches prefill {pre_l}, decode "
              f"{dec_l} (bitserial, its prefill tile, flash, paged) as predicted [{card}]",
              flush=True)

    # a profiled decode step (the last bucket's cache, two steps)
    S = 1024
    cross = batch.get("cross_embeds")
    with torch.inference_mode():
        tok = torch.from_numpy(toks[:, -1:]).to(dev)
        torch.cuda.synchronize()
        by_name, wall = {}, None
        for session in range(1, 5):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for t in range(2):
                    x = tok if vision else batch["embeds"][:, S + steps - 1:S + steps]
                    logits, _ = transformer.decode_step(params, cache, x, S + steps - 1, cfg,
                                                        cross_embeds=cross)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / 2
            by_name = device_ms_by_name(prof)
            if by_name:
                break
    if by_name:
        busy = sum(t for t, _ in by_name.values()) / 2
        ops = sum(n for _, n in by_name.values()) / 2
        wg = sum(t for n, (t, _) in by_name.items() if "wgmma_kernel" in n) / 2
        wg_n = sum(c for n, (_, c) in by_name.items() if "wgmma_kernel" in n) / 2
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        rep["profile"] = {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
                          "device_ops_per_step": ops, "cross_kv_ms_per_step": wg,
                          "cross_kv_launches_per_step": wg_n, "sessions": session,
                          "top": [{"name": k, "ms_per_step": t / 2, "count_per_step": n / 2}
                                  for k, (t, n) in top]}
        print(f"[{tag}] profiled decode step, 4 lanes at {S + steps}: wall {wall:.2f} ms under "
              f"the profiler, device busy {busy:.3f} ms (idle {1 - busy / wall:.1%}), {ops:.0f} "
              f"device ops" + (f"; cross K/V products (wgmma, {wg_n:.0f} launches) {wg:.3f} ms"
                               if vision else "") + f" [{card}]", flush=True)
        for name, (t, n) in top:
            print(f"[{tag}]   {t / 2:8.3f} ms/step {n / 2:6.0f}x  {name[:90]}")
    else:
        rep["profile"] = {"wall_ms_per_step": wall, "device_busy_ms_per_step": None}
        print(f"[{tag}] profiled decode step: device time not measured (the profiler saw no "
              f"device events in 4 sessions) [{card}]", flush=True)
    del cache, batch, logits
    gc.collect()
    torch.cuda.empty_cache()

    # ---- musicgen's bucketed engine (tokens through its embedding table)
    if not vision:
        lens = [256] * 4 + [1024] * 4
        reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(130 + i), 1, n)[0, :n]
                        .astype(np.int32), max_new=F_MAX_NEW) for i, n in enumerate(lens)]
        engine = engine_cls(params, cfg, max_len=F_MAX_LEN, device=dev)
        engine.generate([Request(uid=100, tokens=reqs[0].tokens[:64], max_new=2)])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine.bad = None
        for m in (bsm, fa, pa):
            m.reset_launches()
        t0 = time.perf_counter()
        results = engine.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gen_toks = np.stack([r.tokens for r in sorted(results, key=lambda r: r.uid)])
        check(gen_toks.shape == (len(reqs), F_MAX_NEW), f"{arch} bucketed {gen_toks.shape}")
        check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
        want = (2 * F_MAX_NEW * n_self, 2 * L, 0)
        got = (bsm.launches, fa.launches, pa.launches)
        check(got == want, f"{arch} bucketed launches (bitserial, flash, paged) {got}, "
              f"expected {want}")
        rep["bucketed"] = {"wall_s": wall, "tokens_per_s": gen_toks.size / wall,
                           "serve_peak_bytes": torch.cuda.max_memory_allocated(),
                           "bitserial_launches": got[0], "flash_launches": got[1],
                           "paged_launches": got[2], "buckets": {}}
        for plen in (256, 1024):
            rs = [r for r in results if len(reqs[r.uid].tokens) == plen]
            b = {"ttft_ms": float(np.mean([r.prefill_ms for r in rs])),
                 "decode_ms_per_step": float(np.mean([r.decode_ms_per_tok for r in rs])),
                 "ttft_bound_ms": frontend_bounds(cfg, weights, 4, plen, 0)[0],
                 "decode_bound_ms": frontend_bounds(cfg, weights, 4, plen, 0,
                                                    pos=plen + F_MAX_NEW // 2)[0]}
            rep["bucketed"]["buckets"][plen] = b
            print(f"[{tag}] bucketed engine, 4 x {plen} prompt tokens: TTFT {b['ttft_ms']:.2f} "
                  f"ms (bound {b['ttft_bound_ms']:.3f}), decode {b['decode_ms_per_step']:.3f} "
                  f"ms per step (bound {b['decode_bound_ms']:.4f}) [{card}]", flush=True)
        print(f"[{tag}] bucketed engine: {gen_toks.size} tokens in {wall:.3f} s = "
              f"{gen_toks.size / wall:.2f} tok/s; launches bitserial {got[0]} == 2 x {F_MAX_NEW} "
              f"x {n_self}, flash {got[1]} == 2 x {L}, paged 0 [{card}]", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    # ---- continuous (text only, as JAX's engine serves it)
    n_req = 16
    lo, hi = (128, 1024) if vision else (64, 1024)
    lens = np.random.default_rng(0).integers(lo, hi + 1, size=n_req)
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(i), 1, hi)[0, :n]
                    .astype(np.int32), max_new=F_MAX_NEW) for i, n in enumerate(lens)]
    arrivals = poisson_arrivals(n_req, 0.5, seed=0)
    policy = SchedulerPolicy(n_slots=SLOTS, chunked_prefill=True, chunk_sizes=(R_CHUNK,),
                             paged=True, block_size=BLOCK, n_blocks=F_N_BLOCKS,
                             paged_kernel=True)
    engine = engine_cls(params, cfg, max_len=F_MAX_LEN, device=dev, continuous=True,
                        policy=policy)
    sched, pool = engine.scheduler, engine.scheduler.pool
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:64], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    sched.reset_telemetry()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    for m in (bsm, fa, pa):
        m.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(reqs, arrival_steps=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps_c, chunks = sched.decode_steps, sched.prefill_chunks
    got = {r.uid: r for r in results}
    check(sorted(got) == list(range(n_req)), f"{arch} continuous results for {sorted(got)}")
    for r in results:
        check(len(r.tokens) == F_MAX_NEW and ((r.tokens >= 0) & (r.tokens < cfg.vocab_size))
              .all(), f"uid {r.uid}: {len(r.tokens)} tokens, or a token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    want = ((steps_c + chunks) * n_self, 0, steps_c * L)
    launches = (bsm.launches, fa.launches, pa.launches)
    check(launches == want, f"{arch} continuous launches (bitserial, flash, paged) {launches}, "
          f"expected {want} (({steps_c} steps + {chunks} chunks) x {n_self}, {steps_c} x {L})")
    check(pool.allocator.free_count == pool.n_blocks and pool.allocator.committed == 0,
          f"blocks leaked: free {pool.allocator.free_count}/{pool.n_blocks}")
    check(engine.obs.recorder.leaked == [], f"leaked spans {engine.obs.recorder.leaked}")
    ttft = [got[i].prefill_ms for i in range(n_req)]
    occ = sched.mean_occupancy()
    bound = frontend_bounds(cfg, weights, max(1, round(occ * pool.n_slots)),
                            int(np.mean(lens)), 0, pos=int(np.mean(lens)) + F_MAX_NEW // 2)
    rep["continuous"] = {
        "requests": n_req, "prompt_lens": lens.tolist(), "arrivals": arrivals, "wall_s": wall,
        "tokens_per_s": n_req * F_MAX_NEW / wall, "ttft_ms_p50": percentile(ttft, 50),
        "ttft_ms_p90": percentile(ttft, 90), "decode_steps": steps_c, "prefill_chunks": chunks,
        "decode_ms_per_step": sched.decode_ms_total / max(steps_c, 1),
        "decode_bound_ms": bound[0], "mean_occupancy": occ, "serve_peak_bytes": peak,
        "cache_bytes": pool.cache_bytes(), "bitserial_launches": launches[0],
        "flash_launches": launches[1], "paged_launches": launches[2]}
    c = rep["continuous"]
    print(f"[{tag}] continuous (paged kernel, text only): {n_req} requests x {F_MAX_NEW} tokens, "
          f"prompts {lens.min()}-{lens.max()}, Poisson arrivals at 0.5/step, chunks of "
          f"{R_CHUNK}: {c['tokens_per_s']:.2f} tok/s; TTFT p50 {c['ttft_ms_p50']:.1f} ms, p90 "
          f"{c['ttft_ms_p90']:.1f} ms; decode {c['decode_ms_per_step']:.3f} ms per step (bound "
          f"{bound[0]:.4f} at the mean occupancy {occ:.2f}; {steps_c} steps), {chunks} chunks; "
          f"serve peak {peak / 1e9:.3f} GB, cache {c['cache_bytes'] / 1e9:.4f} GB; launches "
          f"bitserial {launches[0]} == ({steps_c} + {chunks}) x {n_self}, flash 0, paged "
          f"{launches[2]} == {steps_c} x {L}; pool drained [{card}]", flush=True)
    del engine, params, sched, pool
    gc.collect()
    torch.cuda.empty_cache()
    return rep


# the mesh phase (4k): a 2x2 ("data", "model") mesh of 4 ranks sharing the
# card through gloo; the 2-layer f32 parity model's requests and decode
# steps, and the deep bf16 runs' traffic
MESH_SHAPE = (2, 2)
# the deep runs' depth: 6 of granite-3-2b's 40 layers, cut to keep the
# script well inside its time limit beside phases 4l and 6g
MESH_LAYERS = 6
MESH_PARITY_STEPS = 4
MESH_MAX_LEN, MESH_SLOTS, MESH_BLOCKS, MESH_NEW = 512, 8, 64, 8
MESH_BUCKET = (4, 128)  # requests x prompt tokens
# the mesh's spec run drafts with 5 of the 6 planes, whose greedy tokens on
# random weights mostly agree with the full weights', so drafts are accepted
# and the accept path runs on the card (with 3 planes the mesh accepted 0 of 3)
MESH_DRAFT_PLANES, MESH_SPEC_NEW = N_BITS - 1, 8
MESH_CHUNK = 128  # the continuous runs' prefill chunk: a dispatch is M = lanes x 128


def _mesh_requests(cfg, n, plen, max_new, seed):
    import numpy as np

    from repro_torch.data import MarkovLM
    from repro_torch.serve import Request

    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    lens = [plen] * n if isinstance(plen, int) else plen
    return [Request(uid=i, tokens=task.sample(np.random.default_rng(seed + i), 1, lens[i])[
        0, :lens[i]].astype(np.int32), max_new=max_new) for i in range(n)]


def _mesh_parity_model(params, cfg, prompts):
    """Prefill of ``prompts`` and MESH_PARITY_STEPS greedy decode steps
    through the model API: the stacked f32 logits on the host."""
    import torch

    from repro_torch.models import transformer

    with torch.inference_mode():
        logits, cache = transformer.prefill(params, {"tokens": prompts}, cfg, 64)
        out = [logits]
        for t in range(MESH_PARITY_STEPS):
            logits, cache = transformer.decode_step(params, cache, logits.argmax(-1)[:, None],
                                                    prompts.shape[1] + t, cfg)
            out.append(logits)
    return torch.stack(out).cpu()


def _mesh_parity_setup(dev, dtype="float32"):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg2 = get_config("granite-3-2b").scaled(n_layers=2, dtype=dtype, kv_cache_dtype=dtype)
    params = transformer.init_params(cfg2, torch.Generator(device=dev).manual_seed(1), dev,
                                     pack_bits=N_BITS)
    reqs = _mesh_requests(cfg2, 4, 16, 8, 40)
    prompts = torch.from_numpy(np.stack([r.tokens for r in reqs]).astype(np.int64)).to(dev)
    return cfg2, params, reqs, prompts


def _mesh_deep_logits(params, cfg, dev):
    """The last-token logits of prefill over the bucketed run's prompts."""
    import numpy as np
    import torch

    from repro_torch.models import transformer

    reqs = _mesh_requests(cfg, *MESH_BUCKET, MESH_NEW, 0)
    toks = torch.from_numpy(np.stack([r.tokens for r in reqs]).astype(np.int64)).to(dev)
    with torch.inference_mode():
        logits, _ = transformer.prefill(params, {"tokens": toks}, cfg, MESH_MAX_LEN)
    return logits.cpu()


def _mesh_launches():
    from repro_torch.kernels import bitserial_matmul as bsm

    c = _launch_counts()
    return {"bitserial_matmul": c["bitserial_matmul"], "bitserial_active": bsm.active_launches,
            "paged_attention": c["paged_attention"], "flash_attention": c["flash_attention"]}


def _k_halves_logits(params, cfg, dev):
    """:func:`_mesh_deep_logits` in one process computing as the 2x2 mesh's
    ranks do: each product whose K the mesh splits (the packed weights'
    ``kn_spec`` under the rules, the tied head's d_model) as two K halves,
    each rounded to the activations' dtype, added in float32 and rounded
    once, as ``HostMesh.all_reduce`` sums a rank pair's partial products
    (the N split changes no column's arithmetic).  Phase 4k's witness of
    where its bf16 tokens part from one process's."""
    import torch

    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import common

    mesh = AbstractMesh(dict(zip(("data", "model"), MESH_SHAPE)))
    check(set(MESH_SHAPE) == {2}, "[4k] the K-halves witness is for a 2x2 mesh")
    annotated = sharding.annotate_packed_specs(params, mesh)
    head_k = cfg.tie_embeddings and sharding.param_spec(
        "embed", tuple(params["embed"].shape), mesh)[1] is not None
    plain_bsm, plain_dense = ops.bitserial_matmul, common.dense_apply

    def add(parts, dtype):
        return (parts[0].float() + parts[1].float()).to(dtype)

    def bsm_halves(x, pw, active_planes=None):
        if pw.kn_spec is None or pw.kn_spec[0] is None:
            return plain_bsm(x, pw, active_planes)
        h = pw.sign.shape[-2] // 2
        check(pw.k == 16 * h, f"[4k] K halves of a padded weight (k {pw.k})")
        return add([plain_bsm(x[..., 8 * h * i:8 * h * (i + 1)].contiguous(),
                              dataclasses.replace(
                                  pw, planes=pw.planes[..., h * i:h * (i + 1), :].contiguous(),
                                  sign=pw.sign[h * i:h * (i + 1)].contiguous(), k=8 * h,
                                  kn_spec=None), active_planes) for i in (0, 1)], x.dtype)

    def dense_halves(x, w, active_planes=None, k_local=False):
        if not (head_k and isinstance(w, torch.Tensor)):
            return plain_dense(x, w, active_planes, k_local)
        h = w.shape[-2] // 2
        return add([x[..., h * i:h * (i + 1)] @ w[h * i:h * (i + 1)].to(x.dtype)
                    for i in (0, 1)], x.dtype)

    ops.bitserial_matmul, common.dense_apply = bsm_halves, dense_halves
    try:
        return _mesh_deep_logits(annotated, cfg, dev)
    finally:
        ops.bitserial_matmul, common.dense_apply = plain_bsm, plain_dense


def _gloo_cuda_probe(mesh):
    """Which collectives gloo takes on CUDA tensors as they are (the
    port's HostMesh hands it all_reduce and all_gather so): "ok", or the
    error it raises.  A probe, not a path of the port."""
    import torch
    import torch.distributed as dist

    t = torch.full((4,), float(mesh.rank), device=mesh.device)
    probes = {
        "all_reduce_sum": lambda: dist.all_reduce(t.clone()),
        "all_reduce_max": lambda: dist.all_reduce(t.clone(), op=dist.ReduceOp.MAX),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(4)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(16, device=mesh.device), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(1, device=mesh.device), t),
    }
    # bf16 sums: the port reduces 16-bit tensors in float32 all the same
    b = torch.tensor([1.5, -2.25, 100.0, 0.0078125], device=mesh.device) * (mesh.rank + 1)
    bsum = b.to(torch.bfloat16)
    probes["all_reduce_bf16_exact"] = lambda: (
        dist.all_reduce(bsum), None if torch.equal(bsum.float(), b / (mesh.rank + 1) * 10)
        else (_ for _ in ()).throw(ValueError(f"bf16 sum {bsum.tolist()}")))
    g16 = [torch.empty_like(bsum) for _ in range(4)]
    want16 = [(b / (mesh.rank + 1) * (r + 1)).to(torch.bfloat16) for r in range(4)]
    probes["all_gather_bf16_exact"] = lambda: (
        dist.all_gather(g16, b.to(torch.bfloat16)),
        None if all(torch.equal(x, y) for x, y in zip(g16, want16))
        else (_ for _ in ()).throw(ValueError(f"bf16 gather {[x.tolist() for x in g16]}")))
    out = {}
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize(mesh.device)
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the probe records what gloo refuses
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
        dist.barrier()
    return out


def mesh_rank(mesh):
    """Phase 4k on one rank of the 2x2 mesh: the f32 parity model, then
    bf16 granite-3-2b cut to MESH_LAYERS layers bucketed, continuous
    (paged kernel) and spec decode, with this rank's kernel launches and
    packed bytes."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import elastic, sharding
    from repro_torch.kernels import _build
    from repro_torch.models import transformer
    from repro_torch.models.common import packed_shard_mesh
    from repro_torch.serve import SchedulerPolicy, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = mesh.device
    out = {"rank": mesh.rank, "device": str(dev), "gloo_cuda": _gloo_cuda_probe(mesh)}
    shapes, unrecord = _record_kernel_shapes()
    # parity: the same draws as the single-process run, this rank's blocks
    cfg2, p2, reqs2, prompts = _mesh_parity_setup(dev)
    eng = ServeEngine(p2, cfg2, max_len=64, mesh=mesh)
    out["parity_tokens"] = {r.uid: r.tokens.tolist() for r in eng.generate(reqs2)}
    local = elastic.reshard_tree(sharding.annotate_packed_specs(p2, mesh), mesh)
    with packed_shard_mesh(mesh):
        out["parity_logits"] = _mesh_parity_model(local, cfg2, prompts)
    del eng, local, p2
    # MESH_LAYERS deep, f32: the model API's prefill logits of the bucketed
    # prompts (the bf16 runs below are held to one process by agreement)
    cfg32 = get_config("granite-3-2b").scaled(n_layers=MESH_LAYERS, dtype="float32",
                                              kv_cache_dtype="float32")
    p32 = transformer.init_params(cfg32, torch.Generator(device=dev).manual_seed(0), dev,
                                  pack_bits=N_BITS)
    local = elastic.reshard_tree(sharding.annotate_packed_specs(p32, mesh), mesh)
    del p32
    with packed_shard_mesh(mesh):
        out["deep_f32_logits"] = _mesh_deep_logits(local, cfg32, dev)
    del local
    # MESH_LAYERS deep, bf16: every rank draws the same weights, keeps its blocks
    cfg = get_config("granite-3-2b").scaled(n_layers=MESH_LAYERS)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                     pack_bits=N_BITS)
    engine_cls = checked_engine_cls()
    bucketed = engine_cls(params, cfg, max_len=MESH_MAX_LEN, mesh=mesh)
    # one 128-token chunk per prompt: every chunk dispatch costs the mesh
    # a model call's collectives
    policy = SchedulerPolicy(n_slots=MESH_SLOTS, chunked_prefill=True,
                             chunk_sizes=(MESH_CHUNK,),
                             paged=True, block_size=BLOCK, n_blocks=MESH_BLOCKS,
                             paged_kernel=True)
    continuous = engine_cls(params, cfg, max_len=MESH_MAX_LEN, mesh=mesh, continuous=True,
                            policy=policy)
    spec = engine_cls(params, cfg, max_len=MESH_MAX_LEN, mesh=mesh, continuous=True,
                      policy=dataclasses.replace(policy, spec_decode=True,
                                                 draft_planes=MESH_DRAFT_PLANES, gamma=GAMMA))
    del params
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    out["init_s"] = time.perf_counter() - t0
    out["packed_bytes"] = (bucketed.packed_bytes_local, bucketed.packed_bytes_global)
    wq = bucketed.params["blocks"]["p0"]["mixer"]["wq"]
    out["wq_block"] = (wq.kn_spec, tuple(wq.planes.shape))
    out["memory_allocated"] = torch.cuda.memory_allocated(dev)
    # the warm-up (kernel loads, allocator) before the counted runs
    bucketed.generate(_mesh_requests(cfg, 1, 16, 2, 90))
    # the bucketed prompts' prefill logits (the first tokens), for the
    # witness of the bf16 agreement
    with packed_shard_mesh(mesh):
        out["deep_bf16_logits"] = _mesh_deep_logits(bucketed.params, cfg, dev)
    # the main path: counts from 0, the three runs, counts read after
    _reset_launches()
    mesh.collectives = 0
    t0 = time.perf_counter()
    b_res = bucketed.generate(_mesh_requests(cfg, *MESH_BUCKET, MESH_NEW, 0))
    torch.cuda.synchronize(dev)
    out["bucketed"] = {"wall_s": time.perf_counter() - t0,
                       "ttft_ms": float(np.mean([r.prefill_ms for r in b_res])),
                       "decode_ms_per_step": float(np.mean([r.decode_ms_per_tok
                                                            for r in b_res])),
                       "tokens": {r.uid: r.tokens.tolist() for r in b_res},
                       "launches": _mesh_launches()}
    rng = np.random.default_rng(7)
    lens = [int(n) for n in rng.integers(32, 128, size=MESH_SLOTS)]
    arrivals = [int(a) for a in np.floor(np.cumsum(rng.exponential(1.0, MESH_SLOTS)))]
    for name, eng, n, new in (("continuous", continuous, 4, MESH_NEW),
                              ("spec", spec, 1, MESH_SPEC_NEW)):
        before = _mesh_launches()
        t0 = time.perf_counter()
        res = eng.generate(_mesh_requests(cfg, n, lens[:n], new, 20),
                           arrival_steps=arrivals[:n])
        torch.cuda.synchronize(dev)
        sched, pool = eng.scheduler, eng.scheduler.pool
        after = _mesh_launches()
        out[name] = {"wall_s": time.perf_counter() - t0, "decode_steps": sched.decode_steps,
                     "decode_ms_per_step": sched.decode_ms_total / max(sched.decode_steps, 1),
                     "ttft_ms": sorted(r.prefill_ms for r in res),
                     "tokens": {r.uid: r.tokens.tolist() for r in res},
                     "drained": pool.allocator.free_count == pool.n_blocks,
                     "table_shards": pool.table_shards,
                     "pool_k_shape": tuple(pool.cache["blocks"]["p0"]["k"].shape),
                     "launches": {k: after[k] - before[k] for k in after}}
        if name == "spec":
            out[name].update(rounds=sched.spec_rounds, accepted=sched.spec_accepted,
                             drafted=sched.spec_drafted)
    out["launches"] = _mesh_launches()
    out["collectives"] = mesh.collectives
    out["nonfinite"] = sum(int(e.bad.item()) for e in (bucketed, continuous, spec)
                           if e.bad is not None)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["build_s"] = {n: _build.build_log.get(n, {}).get("seconds")
                      for n in ("bitserial_matmul", "paged_attention", "flash_attention")}
    unrecord()
    out["bitserial_shapes"] = sorted(shapes["bitserial"], key=str)
    return out


def _mesh_flash_case(dev, card, time_ms, dt, BH, BHkv, S, d):
    """The flash kernel against its plain version at a rank's prefill
    shape, timed beside them and one SDPA call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(11)
    dname = str(dt).split(".")[-1]
    q = torch.randn((BH, S, d), generator=gen, device=dev).to(dt)
    k = torch.randn((BHkv, S, d), generator=gen, device=dev).to(dt)
    v = torch.randn((BHkv, S, d), generator=gen, device=dev).to(dt)
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    scale_ = want.float().abs().max().item()
    check(bool(torch.isfinite(got).all()) and err <= PAGED_TOL[dname] * scale_,
          f"[4k] flash at the rank's shape {dname}: max err {err} > {PAGED_TOL[dname]} x {scale_}")
    b_ms, b_by, _ = flash_bound(BH, BHkv, S, d, None, True, dname)
    row = {"case": "mesh-rank-prefill", "dtype": dname, "BH": BH, "BHkv": BHkv, "S": S, "d": d,
           "max_abs_err": err, "ms": time_ms(lambda: ops.flash_attention(q, k, v)),
           "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v), iters=3),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q[None], k[None], v[None], is_causal=True, enable_gqa=True)),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"[4k] flash at a rank's prefill shape BH={BH}/{BHkv} S={S} d={d} {dname}: max_err "
          f"{err:.3e} (max|plain| {scale_:.3e}), kernel {row['ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
          f"[{card}]", flush=True)
    return row


def mesh_phase(dev, card, time_ms, median_ms):
    """Phase 4k: serving on a 2x2 ("data", "model") mesh of 4 ranks on the
    one card.  Paged and flash at a rank's shapes against their plain
    versions; then the ranks (``launch.mesh.run_on_mesh``, backend gloo):
    the 2-layer f32 parity model's greedy tokens and logits against the
    same model in this process on the card, and bf16 granite-3-2b cut to
    MESH_LAYERS layers bucketed, continuous (paged kernel) and spec
    decode, each rank's packed bytes, kernel launches, decode ms per step
    and TTFT; a rank's failure fails the run.  Then bitserial against its
    plain version at every shape the ranks gave it; last, MESH_LAYERS
    deep against one process: f32 prefill logits, and in bf16 the prefill
    logits beside the K-halves witness and the bucketed tokens
    (printed)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.serve import ServeEngine

    d_ax, m_ax = MESH_SHAPE
    world = d_ax * m_ax
    print(f"[4k] a {d_ax}x{m_ax} (data, model) mesh: {world} ranks on cuda:0, backend gloo "
          f"(NCCL refuses two ranks on one GPU, and this machine has one card; gloo takes "
          f"the ranks' CUDA tensors for all_reduce and all_gather) [{card}]", flush=True)
    rep = {"mesh": list(MESH_SHAPE), "backend": "gloo", "kernels_at_shard_shapes": {}}
    cfg = get_config("granite-3-2b").scaled(n_layers=MESH_LAYERS)
    # paged and flash at the shapes a rank gives them (bitserial after the
    # ranks, at every shape they gave it)
    kv_l, G = cfg.n_kv_heads // m_ax, cfg.n_heads // cfg.n_kv_heads
    rep["kernels_at_shard_shapes"]["paged"] = [
        paged_case(dev, card, time_ms, median_ms, dt, None, KV=kv_l, G=G,
                   d=cfg.resolved_head_dim, nb_lane=MESH_MAX_LEN // BLOCK,
                   n_blocks=MESH_BLOCKS // d_ax, pos=[-1, 40, 200, 255])
        for dt in (torch.float32, torch.bfloat16)]
    B_l = MESH_BUCKET[0] // d_ax
    rep["kernels_at_shard_shapes"]["flash"] = [
        _mesh_flash_case(dev, card, time_ms, dt, B_l * kv_l * G, B_l * kv_l, MESH_BUCKET[1],
                         cfg.resolved_head_dim) for dt in (torch.float32, torch.bfloat16)]
    # the single-process twin of the ranks' parity model
    cfg2, p2, reqs2, prompts = _mesh_parity_setup(dev)
    want_tokens = {r.uid: r.tokens.tolist()
                   for r in ServeEngine(p2, cfg2, max_len=64, device=dev).generate(reqs2)}
    want_logits = _mesh_parity_model(p2, cfg2, prompts)
    del p2
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_on_mesh(mesh_rank, d_ax, m_ax, backend="gloo", device=dev)
    rep["ranks_wall_s"] = time.perf_counter() - t0
    # the bitserial kernel against its plain version at every (M, K, N,
    # dtype, groups) the ranks gave it, and at least at a rank's four
    # blocks (q, o 1024 x 1024; k, v 1024 x 256; gate, up 1024 x 4096;
    # down 4096 x 1024) for bucketed decode (M 4) and prefill (M 512),
    # continuous decode (M 8) and its chunk dispatches (8 lanes x 128
    # rows, M 1024), in bf16, and M 4 and 512 in f32; timed at M 4 and
    # 512 in bf16
    D, F_, KVD = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.resolved_head_dim
    shard = [(D // d_ax, D // m_ax), (D // d_ax, KVD // m_ax), (D // d_ax, F_ // m_ax),
             (F_ // m_ax, D // d_ax)]
    prefill_m = MESH_BUCKET[0] * MESH_BUCKET[1]
    seen = {tuple(x) for r in ranks for x in r.pop("bitserial_shapes")}
    wanted = {(M, K, N, dt, None) for K, N in shard
              for M, dt in ((MESH_BUCKET[0], "bfloat16"), (prefill_m, "bfloat16"),
                            (MESH_SLOTS, "bfloat16"), (MESH_SLOTS * MESH_CHUNK, "bfloat16"),
                            (MESH_BUCKET[0], "float32"), (prefill_m, "float32"))}
    check(wanted - seen == set(), f"[4k] the ranks never gave the kernel {wanted - seen}")
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = [bitserial_case(dev, gen, card, time_ms, M, K, N, g, getattr(torch, dt),
                           timed=dt == "bfloat16" and M in (MESH_BUCKET[0], prefill_m))
            for M, K, N, dt, g in sorted(seen | wanted, key=str)]
    rep["kernels_at_shard_shapes"]["bitserial"] = rows
    worst = max(rows, key=lambda r: r["max_abs_err"] / max(r["max_abs_plain"], 1e-30))
    print(f"[4k] bitserial against its plain version at {len(rows)} (M, K, N, dtype, groups) "
          f"of the ranks' blocks, M {sorted({r['M'] for r in rows})}: every one within "
          f"tolerance, active=a bitwise truncate_packed; the worst relative error "
          f"{worst['max_abs_err'] / worst['max_abs_plain']:.3e} at M {worst['M']} K "
          f"{worst['K']} N {worst['N']} {worst['dtype']} ({worst['path']}) [{card}]", flush=True)
    lmax = want_logits.abs().max().item()
    logits0 = ranks[0]["parity_logits"]
    for r in ranks:
        tag = f"[4k] rank {r['rank']}"
        check(all(s == 0.0 for s in r["build_s"].values()),
              f"{tag} built a kernel library ({r['build_s']}): the parent builds each once")
        check(r["parity_tokens"] == want_tokens,
              f"{tag}: f32 tokens {r['parity_tokens']} != one process's {want_tokens}")
        err = (r["parity_logits"] - want_logits).abs().max().item()
        check(err <= TOL["float32"] * lmax, f"{tag}: f32 logits differ by {err} (max {lmax})")
        check(torch.equal(r["parity_logits"], logits0),
              f"{tag}: logits differ from rank 0's")
        r["parity_max_abs_dlogit"] = err
        del r["parity_logits"]
        local, whole = r["packed_bytes"]
        check(0.25 <= local / whole < 0.26, f"{tag}: holds {local} of {whole} packed bytes")
        for k, n in r["launches"].items():
            check(n > 0, f"{tag}: no {k} launch on the main path ({r['launches']})")
        for run in ("continuous", "spec"):
            check(r[run]["drained"] and r[run]["table_shards"] == d_ax,
                  f"{tag} {run}: pool not drained or table_shards {r[run]['table_shards']}")
        check(r["nonfinite"] == 0, f"{tag}: {r['nonfinite']} non-finite logits")
        for run in ("bucketed", "continuous", "spec"):
            check(r[run]["tokens"] == ranks[0][run]["tokens"], f"{tag} {run}: tokens differ")
        print(f"{tag}: f32 parity tokens == one process, max|dlogit| {err:.3e} (max|logit| "
              f"{lmax:.3e}); packed {local / 1e6:.1f} of {whole / 1e6:.1f} MB "
              f"({local / whole:.4f}); wq block {r['wq_block']}; init {r['init_s']:.1f} s; "
              f"launches {r['launches']}; {r['collectives']} collectives; peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB [{card}]", flush=True)
    r0 = ranks[0]
    print(f"[4k] gloo on CUDA tensors: {r0['gloo_cuda']} [{card}]", flush=True)
    b, c, s = r0["bucketed"], r0["continuous"], r0["spec"]
    check(s["accepted"] > 0, f"[4k] spec decode on the mesh accepted {s['accepted']} of "
                             f"{s['drafted']} drafts ({MESH_DRAFT_PLANES} draft planes): the "
                             "accept path did not run on the card")
    print(f"[4k] decode ms per step at {MESH_LAYERS} layers, rank 0: bucketed "
          f"{b['decode_ms_per_step']:.2f}, continuous {c['decode_ms_per_step']:.2f} [{card}]",
          flush=True)
    print(f"[4k] {MESH_LAYERS}-layer granite-3-2b bf16 6-bit on the 2x2 mesh: bucketed "
          f"{MESH_BUCKET[0]} x {MESH_BUCKET[1]} tokens: TTFT {b['ttft_ms']:.1f} ms, decode "
          f"{b['decode_ms_per_step']:.2f} ms per step; continuous (paged kernel, {MESH_SLOTS} "
          f"lanes): decode {c['decode_ms_per_step']:.2f} ms per step over {c['decode_steps']} "
          f"steps, TTFT p50 {np.percentile(c['ttft_ms'], 50):.1f} ms p90 "
          f"{np.percentile(c['ttft_ms'], 90):.1f} ms; spec ({MESH_DRAFT_PLANES} draft planes, "
          f"gamma {GAMMA}): {s['rounds']} rounds, "
          f"{s['accepted']}/{s['drafted']} drafts accepted; ranks' wall "
          f"{rep['ranks_wall_s']:.1f} s (bucketed {b['wall_s']:.1f}, continuous "
          f"{c['wall_s']:.1f}, spec {s['wall_s']:.1f}) [{card}]", flush=True)
    # MESH_LAYERS deep in one process: f32 prefill logits (printed beside the
    # 1e-4 of the 2-layer check)
    from repro_torch.models import transformer

    cfg32 = cfg.scaled(dtype="float32", kv_cache_dtype="float32")
    p32 = transformer.init_params(cfg32, torch.Generator(device=dev).manual_seed(0), dev,
                                  pack_bits=N_BITS)
    want32 = _mesh_deep_logits(p32, cfg32, dev)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    m32 = want32.abs().max().item()
    d32 = max((r["deep_f32_logits"] - want32).abs().max().item() for r in ranks)
    same32 = float((r0["deep_f32_logits"].argmax(-1) == want32.argmax(-1)).float().mean())
    check(all(bool(torch.isfinite(r["deep_f32_logits"]).all()) for r in ranks),
          f"[4k] non-finite {MESH_LAYERS}-layer f32 logits")
    for r in ranks:
        del r["deep_f32_logits"]
    rep["deep_f32"] = {"max_abs_dlogit": d32, "max_abs_logit": m32,
                       "first_token_agreement": same32}
    print(f"[4k] {MESH_LAYERS}-layer f32 prefill logits, mesh against one process: max|dlogit| "
          f"{d32:.3e} of max|logit| {m32:.3e} ({d32 / m32:.3e}), first tokens agree "
          f"{100 * same32:.0f} % "
          f"[{card}]", flush=True)

    # bf16 MESH_LAYERS deep: the ranks' prefill logits (the first tokens)
    # against one process's, plain and computing as the ranks do (K halves
    # rounded to bf16 and added in f32, _k_halves_logits); the top-2 gap of one
    # process's logits says how far a change may move them before an
    # argmax flips
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                     pack_bits=N_BITS)
    plain16 = _mesh_deep_logits(params, cfg, dev).float()
    halves16 = _k_halves_logits(params, cfg, dev).float()
    one = ServeEngine(params, cfg, max_len=MESH_MAX_LEN, device=dev)
    del params
    one_toks = {r.uid: r.tokens.tolist()
                for r in one.generate(_mesh_requests(cfg, *MESH_BUCKET, MESH_NEW, 0))}
    mesh16 = [r.pop("deep_bf16_logits").float() for r in ranks]
    check(all(torch.equal(m, mesh16[0]) for m in mesh16), "[4k] ranks' bf16 logits differ")
    check(bool(torch.isfinite(mesh16[0]).all() and torch.isfinite(halves16).all()),
          f"[4k] non-finite {MESH_LAYERS}-layer bf16 logits")
    top2 = plain16.topk(2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).median())

    def versus(x, y):
        return {"max_abs_dlogit": (x - y).abs().max().item(),
                "first_token_agreement": float((x.argmax(-1) == y.argmax(-1)).float().mean())}

    witness = {"mesh_vs_one": versus(mesh16[0], plain16),
               "halves_vs_one": versus(halves16, plain16),
               "mesh_vs_halves": versus(mesh16[0], halves16),
               "max_abs_logit": plain16.abs().max().item(), "median_top2_gap": gap}
    print(f"[4k] {MESH_LAYERS}-layer bf16 prefill logits (max|logit| "
          f"{witness['max_abs_logit']:.3e}, median top-2 gap {gap:.3e}): " + "; ".join(
              f"{k.replace('_vs_', ' against ')} max|dlogit| {v['max_abs_dlogit']:.3e}, first "
              f"tokens agree {100 * v['first_token_agreement']:.0f} %"
              for k, v in witness.items() if isinstance(v, dict)) + f" [{card}]", flush=True)

    def agreement(x, y):
        return (float(np.mean([a == c_ for u in x for a, c_ in zip(x[u], y[u])])),
                float(np.mean([x[u][0] == y[u][0] for u in x])))

    agree, first = agreement(one_toks, b["tokens"])
    print(f"[4k] bf16 {MESH_LAYERS}-layer bucketed tokens: mesh against one process "
          f"{100 * agree:.1f} % of positions agree (first tokens {100 * first:.0f} %) [{card}]",
          flush=True)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    rep.update(ranks=ranks, bf16_token_agreement=agree, bf16_first_token_agreement=first,
               bf16_prefill_witness=witness,
               launches={k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]})
    return rep


# the kinds' mesh phase (4l): every other layer kind and the MoE FFN on
# the 2x2 mesh of phase 4k, each model at its published widths cut to the
# smallest depth that holds each of its kinds
# (mamba2-130m 6 of its 24 layers since phase 6g took the time; 24 before)
MESH_KINDS = [("gemma3-12b", 6), ("recurrentgemma-9b", 3), ("mamba2-130m", 6),
              (VISION, 5), ("qwen2-moe-a2.7b", 2)]
KM_PARITY = (4, 32, 4)  # f32 parity: requests x prompt tokens, new tokens
KM_BUCKET = (4, 256)  # bf16 bucketed: requests x prompt tokens
KM_REQUESTS = 4  # bf16 continuous: requests on MESH_SLOTS lanes
KM_NEW = 4  # bf16 new tokens a request (a decode step costs 24-124 collectives)
KM_CROSS_STEPS = 2  # bf16 decode steps of the vision model with its cross tokens


def _record_kernel_shapes():
    """Wrap the three kernels' entry points (``ops.bitserial_matmul``, the
    call through which every product of a rank's block reaches its
    kernel, ``ops.flash_attention`` and ``ops.paged_attention``) so that
    each records the shapes it is given: bitserial (M, K, N, dtype, scale
    groups), flash (BH, BH of K/V, S, d, window, dtype), paged (lanes,
    K/V heads, group, d, pool blocks, block rows, table width, dtype).
    The wrappers launch nothing themselves.  Returns the sets by kernel
    and the undo."""
    from repro_torch.kernels import ops

    shapes = {"bitserial": set(), "flash": set(), "paged": set()}
    plain = ops.bitserial_matmul, ops.flash_attention, ops.paged_attention

    def bitserial(x, pw, active_planes=None):
        groups = pw.scale.shape[-1] if pw.scale.numel() > 1 else None
        shapes["bitserial"].add((x.numel() // x.shape[-1], pw.sign.shape[-2] * 8,
                                 pw.sign.shape[-1], str(x.dtype).split(".")[-1], groups))
        return plain[0](x, pw, active_planes)

    def flash(q, k, v, **kw):
        shapes["flash"].add((q.shape[0], k.shape[0], q.shape[1], q.shape[2], kw.get("window"),
                             str(q.dtype).split(".")[-1]))
        return plain[1](q, k, v, **kw)

    def paged(q, k_pool, v_pool, table, pos, **kw):
        B, KV, G, d = q.shape
        shapes["paged"].add((B, KV, G, d, k_pool.shape[0], k_pool.shape[1], table.shape[1],
                             str(q.dtype).split(".")[-1]))
        return plain[2](q, k_pool, v_pool, table, pos, **kw)

    ops.bitserial_matmul, ops.flash_attention, ops.paged_attention = bitserial, flash, paged

    def undo():
        ops.bitserial_matmul, ops.flash_attention, ops.paged_attention = plain

    return shapes, undo


def _kinds_inputs(cfg, dev, B, S):
    """The model API's inputs of phase 4l: prompts, and the vision model's
    cross tokens (``cfg.frontend_tokens`` per lane), from fixed seeds."""
    import numpy as np
    import torch

    reqs = _mesh_requests(cfg, B, S, 1, 60)
    batch = {"tokens": torch.from_numpy(np.stack([r.tokens for r in reqs]).astype(np.int64))
             .to(dev)}
    if cfg.frontend == "vision":
        gen = torch.Generator(device=dev).manual_seed(5)
        batch["cross_embeds"] = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                                            generator=gen, device=dev).to(cfg.compute_dtype)
    return batch


def _kinds_logits(params, cfg, dev, steps):
    """Prefill of KM_PARITY's prompts (and cross tokens) and ``steps``
    greedy decode steps through the model API: the stacked f32 logits on
    the host."""
    import torch

    from repro_torch.models import transformer

    B, S, _ = KM_PARITY
    batch = _kinds_inputs(cfg, dev, B, S)
    with torch.inference_mode():
        logits, cache = transformer.prefill(params, batch, cfg, 64)
        out = [logits]
        for t in range(steps):
            logits, cache = transformer.decode_step(
                params, cache, logits.argmax(-1)[:, None], S + t, cfg,
                cross_embeds=batch.get("cross_embeds"))
            out.append(logits)
    return torch.stack(out).float().cpu()


class _Routes:
    """Phase 4l's MoE routing: one process's gates and experts, recorded
    call by call (``record``), then on a rank (``impose``) each call's own
    routing kept where it picks the same experts, and the recorded one
    taken for the tokens where it does not: there the top-k margin must be
    under 100 x the largest difference of the two sides' gates (a
    near-tie that another order of the stitched router sum decides),
    else the rank fails.  Counts the near-ties taken."""

    def __init__(self, calls=None):
        self.calls = [] if calls is None else calls
        self.taken = self.tokens = 0

    def record(self):
        from repro_torch.models import moe

        orig = moe._route

        def route(gates, top_k):
            w, e = orig(gates, top_k)
            self.calls.append((gates.detach().cpu(), e.detach().cpu()))
            return w, e

        return mock.patch.object(moe, "_route", route)

    def impose(self):
        import torch

        from repro_torch.models import moe

        orig, calls = moe._route, iter(self.calls)

        def route(gates, top_k):
            ref_g, ref_e = next(calls)
            w, e = orig(gates, top_k)
            ref_e = ref_e.to(e.device)
            differ = (e.sort(-1).values != ref_e.sort(-1).values).any(-1)
            self.tokens += differ.numel()
            if not bool(differ.any()):
                return w, e
            srt = gates.sort(-1, descending=True).values
            margin = (srt[..., top_k - 1] - srt[..., top_k]).cpu()
            gap = (gates.cpu() - ref_g).abs().max()
            d = differ.cpu()
            check(bool((margin[d] < 100 * gap).all()),
                  f"[4l] a routing differs from one process's away from a near-tie "
                  f"(margins {margin[d].tolist()[:4]}, gates differ by {float(gap)})")
            self.taken += int(d.sum())
            e = torch.where(differ[..., None], ref_e, e)
            return gates.gather(-1, e), e

        return mock.patch.object(moe, "_route", route)


def _kinds_reference(arch, layers, dev):
    """Phase 4l's one-process side of a model's f32 parity: the bucketed
    engine's greedy tokens and the model API's logits on the card, and
    the MoE routing of both runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    B, S, new = KM_PARITY
    cfg = get_config(arch).scaled(n_layers=layers, dtype="float32", kv_cache_dtype="float32")
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                     pack_bits=N_BITS)
    routes = _Routes()
    with routes.record():
        tokens = {r.uid: r.tokens.tolist() for r in ServeEngine(
            params, cfg, max_len=64, device=dev).generate(_mesh_requests(cfg, B, S, new, 50))}
        logits = _kinds_logits(params, cfg, dev, MESH_PARITY_STEPS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens": tokens, "logits": logits, "routes": routes.calls}


def _float_bytes(tree, cfg=None) -> int:
    """Bytes of the float leaves of a param tree (FloatBlock and RowsBlock
    blocks included, PackedWeights not); with ``cfg`` each as serving
    holds it (``core.packing.serving_cast``'s dtype), without allocating."""
    import torch

    from repro_torch.core.packing import (SERVED_IN_COMPUTE_DTYPE, FloatBlock, PackedWeight,
                                          RowsBlock)

    def walk(t, name=""):
        if isinstance(t, dict):
            return sum(walk(v, k) for k, v in t.items())
        if isinstance(t, (list, tuple)):
            return sum(walk(v, name) for v in t)
        if isinstance(t, PackedWeight) or t is None:
            return 0
        if isinstance(t, (FloatBlock, RowsBlock)):
            t = t.w
            if t is None:
                return 0
        elt = t.element_size()
        if cfg is not None and name in SERVED_IN_COMPUTE_DTYPE:
            elt = torch.empty((), dtype=cfg.compute_dtype).element_size()
        return t.numel() * elt

    return walk(tree)


def _kinds_launches():
    from repro_torch.kernels import flash_attention as fa

    c = _mesh_launches()
    c["flash_windowed"] = fa.windowed_launches
    return c


def _placed_params(mesh, cfg, dev):
    """This rank's blocks of the params drawn from seed 0 (the one-process
    run's draws), and the whole model's packed and float bytes as serving
    holds them.
    The ranks draw one after another (a barrier between): a full-width
    draw and its packing peak at several times the model's bytes, and
    four at once do not fit the card."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.packing import packed_leaves
    from repro_torch.dist import elastic, sharding
    from repro_torch.models import transformer

    local = whole = None
    for turn in range(mesh.size()):
        if turn == mesh.rank:
            params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                             dev, pack_bits=N_BITS)
            whole = (sum(pw.hbm_bytes() for pw in packed_leaves(params)),
                     _float_bytes(params, cfg))
            local = elastic.reshard_tree(sharding.annotate_packed_specs(params, mesh), mesh)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return local, whole


def kinds_rank(mesh, refs):
    """Phase 4l on one rank of the 2x2 mesh, model by model: the f32
    parity model (its routing imposed where a near-tie differs), then
    bf16 bucketed and continuous (paged kernel), each rank's packed and
    float bytes, launches, decode ms per step, TTFT, collectives per
    decode step; the shapes its kernels were given."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import packed_shard_mesh
    from repro_torch.serve import SchedulerPolicy, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = mesh.device
    shapes, unrecord = _record_kernel_shapes()
    engine_cls = checked_engine_cls()
    out = {"rank": mesh.rank}
    for arch, layers in MESH_KINDS:
        r = out[arch] = {}
        B, S, new = KM_PARITY
        # parity: the same draws as the one-process run, this rank's blocks
        cfg32 = get_config(arch).scaled(n_layers=layers, dtype="float32",
                                        kv_cache_dtype="float32")
        local, _ = _placed_params(mesh, cfg32, dev)
        routes = _Routes(refs[arch]["routes"])
        with routes.impose():
            eng = ServeEngine(local, cfg32, max_len=64, mesh=mesh, placed=True)
            r["parity_tokens"] = {x.uid: x.tokens.tolist() for x in eng.generate(
                _mesh_requests(cfg32, B, S, new, 50))}
            with packed_shard_mesh(mesh):
                r["parity_logits"] = _kinds_logits(eng.params, cfg32, dev, MESH_PARITY_STEPS)
        r["near_ties"] = (routes.taken, routes.tokens)
        del eng, local
        gc.collect()
        torch.cuda.empty_cache()
        # bf16: the same draws, this rank's blocks
        cfg = get_config(arch).scaled(n_layers=layers)
        t0 = time.perf_counter()
        params, (packed_whole, float_whole) = _placed_params(mesh, cfg, dev)
        bucketed = engine_cls(params, cfg, max_len=MESH_MAX_LEN, mesh=mesh, placed=True)
        policy = SchedulerPolicy(n_slots=MESH_SLOTS, chunked_prefill=True,
                                 chunk_sizes=(MESH_CHUNK,), paged=True, block_size=BLOCK,
                                 n_blocks=MESH_BLOCKS, paged_kernel=True)
        continuous = engine_cls(params, cfg, max_len=MESH_MAX_LEN, mesh=mesh, continuous=True,
                                policy=policy, placed=True)
        del params
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        r["init_s"] = time.perf_counter() - t0
        r["packed_bytes"] = (bucketed.packed_bytes_local, packed_whole)
        r["float_bytes"] = (_float_bytes(bucketed.params), float_whole)
        bucketed.generate(_mesh_requests(cfg, 1, 16, 2, 90))  # warm-up
        # the main path: counts from 0, the runs, counts read after
        _reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        mesh.collectives = 0
        t0 = time.perf_counter()
        b_res = bucketed.generate(_mesh_requests(cfg, *KM_BUCKET, KM_NEW, 0))
        torch.cuda.synchronize(dev)
        r["bucketed"] = {"wall_s": time.perf_counter() - t0,
                         "ttft_ms": float(np.mean([x.prefill_ms for x in b_res])),
                         "decode_ms_per_step": float(np.mean([x.decode_ms_per_tok
                                                              for x in b_res])),
                         "tokens": {x.uid: x.tokens.tolist() for x in b_res}}
        rng = np.random.default_rng(7)
        lens = [int(n) for n in rng.integers(32, 128, size=KM_REQUESTS)]
        arrivals = [int(a) for a in np.floor(np.cumsum(rng.exponential(1.0, KM_REQUESTS)))]
        continuous.scheduler.digests = []
        t0 = time.perf_counter()
        c_res = continuous.generate(_mesh_requests(cfg, KM_REQUESTS, lens, KM_NEW, 20),
                                    arrival_steps=arrivals)
        torch.cuda.synchronize(dev)
        sched, pool = continuous.scheduler, continuous.scheduler.pool
        r["continuous"] = {"wall_s": time.perf_counter() - t0,
                           "decode_steps": sched.decode_steps,
                           "decode_ms_per_step": sched.decode_ms_total
                           / max(sched.decode_steps, 1),
                           "ttft_ms": sorted(x.prefill_ms for x in c_res),
                           "tokens": {x.uid: x.tokens.tolist() for x in c_res},
                           "digests": sched.digests,
                           "drained": pool.allocator.free_count == pool.n_blocks}
        if cfg.frontend == "vision":
            # the model API with the cross tokens: their K/V at M = lanes x
            # cfg.frontend_tokens on this rank's N block, every step
            batch = _kinds_inputs(cfg, dev, KM_BUCKET[0], 64)
            with torch.inference_mode(), packed_shard_mesh(mesh):
                logits, cache = transformer.prefill(bucketed.params, batch, cfg, MESH_MAX_LEN)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for t in range(KM_CROSS_STEPS):
                    logits, cache = transformer.decode_step(
                        bucketed.params, cache, logits.argmax(-1)[:, None], 64 + t, cfg,
                        cross_embeds=batch["cross_embeds"])
                torch.cuda.synchronize(dev)
            r["cross_decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / KM_CROSS_STEPS
            r["cross_finite"] = bool(torch.isfinite(logits).all())
            del batch, logits, cache
        r["launches"] = _kinds_launches()
        r["collectives"] = mesh.collectives
        r["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        # collectives of one bucketed decode step, counted alone
        batch = _kinds_inputs(cfg, dev, KM_BUCKET[0], 16)
        batch.pop("cross_embeds", None)
        with torch.inference_mode(), packed_shard_mesh(mesh):
            logits, cache = transformer.prefill(bucketed.params, batch, cfg, 64)
            mesh.collectives = 0
            transformer.decode_step(bucketed.params, cache, logits.argmax(-1)[:, None], 16, cfg)
        r["collectives_per_decode_step"] = mesh.collectives
        r["nonfinite"] = sum(int(e.bad.item()) for e in (bucketed, continuous)
                             if e.bad is not None)
        del bucketed, continuous, sched, pool, batch, logits, cache
        gc.collect()
        torch.cuda.empty_cache()
    unrecord()
    out["shapes"] = {k: sorted(v, key=str) for k, v in shapes.items()}
    return out


def _kinds_flash_case(dev, BH, BHkv, S, d, window, dname):
    """The flash kernel against its plain version at one shape a rank gave it."""
    import torch

    from repro_torch.kernels import ops, ref

    dt = getattr(torch, dname)
    gen = torch.Generator(device=dev).manual_seed(S + d)
    q = torch.randn((BH, S, d), generator=gen, device=dev).to(dt)
    k = torch.randn((BHkv, S, d), generator=gen, device=dev).to(dt)
    v = torch.randn((BHkv, S, d), generator=gen, device=dev).to(dt)
    got = ops.flash_attention(q, k, v, window=window)
    want = ref.flash_attention_ref(q, k, v, window=window)
    err = (got.float() - want.float()).abs().max().item()
    scale_ = want.float().abs().max().item()
    what = f"[4l] flash at BH={BH}/{BHkv} S={S} d={d} window={window} {dname}"
    check(bool(torch.isfinite(got).all()) and err <= PAGED_TOL[dname] * scale_,
          f"{what}: max err {err} > {PAGED_TOL[dname]} x {scale_}")
    check(torch.equal(got, ops.flash_attention(q, k, v, window=window)),
          f"{what}: a second call differs")
    return {"BH": BH, "BHkv": BHkv, "S": S, "d": d, "window": window, "dtype": dname,
            "max_abs_err": err, "max_abs_plain": scale_}


def _kinds_paged_case(dev, B, KV, G, d, n_pool, bs, nb_lane, dname):
    """The paged kernel against its plain version at one shape a rank gave
    it: a random table over the rank's pool slice, positions from an
    inactive lane to the table's last row."""
    import torch

    from repro_torch.kernels import ops, ref

    dt = getattr(torch, dname)
    gen = torch.Generator(device=dev).manual_seed(B + d + nb_lane)
    q = torch.randn((B, KV, G, d), generator=gen, device=dev).to(dt)
    k = torch.randn((n_pool, bs, KV, d), generator=gen, device=dev).to(dt)
    v = torch.randn((n_pool, bs, KV, d), generator=gen, device=dev).to(dt)
    table = torch.randint(0, n_pool, (B, nb_lane), generator=gen, device=dev).to(torch.int32)
    last = nb_lane * bs - 1
    pos = torch.tensor([[-1, 0, last, last // 2][i % 4] for i in range(B)], dtype=torch.int32,
                       device=dev)
    got = ops.paged_attention(q, k, v, table, pos)
    want = ref.paged_attention_ref(q, k, v, table, pos)
    err = (got.float() - want.float()).abs().max().item()
    scale_ = want.float().abs().max().item()
    what = f"[4l] paged at B={B} KV={KV} G={G} d={d} pool {n_pool}x{bs} table {nb_lane} {dname}"
    check(bool(torch.isfinite(got).all()) and err <= PAGED_TOL[dname] * scale_,
          f"{what}: max err {err} > {PAGED_TOL[dname]} x {scale_}")
    check(torch.equal(got, ops.paged_attention(q, k, v, table, pos)),
          f"{what}: a second call differs")
    return {"B": B, "KV": KV, "G": G, "d": d, "pool_blocks": n_pool, "block_rows": bs,
            "table": nb_lane, "dtype": dname, "max_abs_err": err, "max_abs_plain": scale_}


def kinds_mesh_phase(dev, card, time_ms):
    """Phase 4l: every other layer kind and the MoE FFN served on the 2x2
    mesh of 4 gloo ranks on the one card, each model (MESH_KINDS) at its
    published widths cut in depth.  One process's f32 references first;
    then the ranks (``kinds_rank``, one spawn for every model); then each
    kernel against its plain version at every shape the ranks gave it."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_on_mesh

    d_ax, m_ax = MESH_SHAPE
    print(f"[4l] the other layer kinds on the {d_ax}x{m_ax} mesh, {d_ax * m_ax} gloo ranks on "
          f"cuda:0: " + ", ".join(f"{a} cut to {n} layers" for a, n in MESH_KINDS)
          + f" [{card}]", flush=True)
    t0 = time.perf_counter()
    refs = {arch: _kinds_reference(arch, layers, dev) for arch, layers in MESH_KINDS}
    rep = {"reference_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ranks = run_on_mesh(kinds_rank, d_ax, m_ax, backend="gloo", device=dev,
                        args=({a: {"routes": refs[a]["routes"]} for a in refs},))
    rep["ranks_wall_s"] = time.perf_counter() - t0
    rep["models"] = {}
    for arch, layers in MESH_KINDS:
        ref = refs[arch]
        lmax = ref["logits"].abs().max().item()
        tol = TOL["float32"] * max(1.0, lmax)
        r0 = ranks[0][arch]
        kinds = {k.split("+")[0] for k in get_config(arch).layer_pattern}
        cross = arch == VISION
        for r in ranks:
            m, tag = r[arch], f"[4l] {arch} rank {r['rank']}"
            check(m["parity_tokens"] == ref["tokens"],
                  f"{tag}: f32 tokens {m['parity_tokens']} != one process's {ref['tokens']}")
            err = (m["parity_logits"] - ref["logits"]).abs().max().item()
            m["parity_max_abs_dlogit"] = err
            check(err <= tol, f"{tag}: f32 logits differ by {err} > {tol} (max {lmax})")
            check(torch.equal(m["parity_logits"], r0["parity_logits"]),
                  f"{tag}: logits differ from rank 0's")
            for run in ("bucketed", "continuous"):
                check(m[run]["tokens"] == r0[run]["tokens"], f"{tag} {run}: tokens differ")
            check(m["continuous"]["digests"] == r0["continuous"]["digests"]
                  and len(m["continuous"]["digests"]) > 0, f"{tag}: scheduler digests differ")
            check(m["continuous"]["drained"], f"{tag}: the pool is not drained")
            check(m["nonfinite"] == 0 and m.get("cross_finite", True),
                  f"{tag}: {m['nonfinite']} non-finite logits")
            la = m["launches"]
            must = {"bitserial_matmul": arch != "mamba2-130m",
                    "flash_attention": bool(kinds & {"attn", "local"}),
                    "flash_windowed": "local" in kinds, "paged_attention": "attn" in kinds}
            for k, need in must.items():
                check((la[k] > 0) == need, f"{tag}: {la[k]} {k} launches on the main path "
                      f"({'must run' if need else 'runs none'})")
            local, whole = m["packed_bytes"]
            if whole:
                check(local / whole < 0.3, f"{tag}: holds {local} of {whole} packed bytes")
            flocal, fwhole = m["float_bytes"]
            check(flocal / fwhole < 0.3, f"{tag}: holds {flocal} of {fwhole} float bytes")
        for r in ranks:
            del r[arch]["parity_logits"]
        b, c = r0["bucketed"], r0["continuous"]
        worst = max(r[arch]["parity_max_abs_dlogit"] for r in ranks)
        print(f"[4l] {arch} ({layers} layers) f32 on the mesh: tokens == one process, "
              f"max|dlogit| {worst:.3e} (max|logit| {lmax:.3e}; tolerance {tol:.3e}); "
              f"routing near-ties taken from one process (taken, tokens routed) "
              f"{[r[arch]['near_ties'] for r in ranks]} [{card}]", flush=True)
        for r in ranks:
            m = r[arch]
            print(f"[4l] {arch} rank {r['rank']}: packed {m['packed_bytes'][0] / 1e6:.1f} of "
                  f"{m['packed_bytes'][1] / 1e6:.1f} MB, float {m['float_bytes'][0] / 1e6:.1f} "
                  f"of {m['float_bytes'][1] / 1e6:.1f} MB; launches {m['launches']}; peak "
                  f"{m['peak_bytes'] / 1e9:.2f} GB; init {m['init_s']:.1f} s [{card}]",
                  flush=True)
        line = (f"[4l] {arch} bf16 6-bit on the mesh: decode {b['decode_ms_per_step']:.2f} ms "
                f"per step bucketed ({KM_BUCKET[0]} x {KM_BUCKET[1]} tokens), "
                f"{c['decode_ms_per_step']:.2f} continuous (paged kernel, {c['decode_steps']} "
                f"steps); TTFT {b['ttft_ms']:.1f} ms bucketed, p50 "
                f"{np.percentile(c['ttft_ms'], 50):.1f} continuous; "
                f"{r0['collectives_per_decode_step']} collectives per decode step, "
                f"{r0['collectives']} in the runs")
        if cross:
            line += (f"; with {KM_BUCKET[0]} x 1600 cross tokens "
                     f"{r0['cross_decode_ms_per_step']:.2f} ms per decode step")
        print(line + f" [{card}]", flush=True)
        rep["models"][arch] = {
            "layers": layers, "tolerance": tol, "max_abs_logit": lmax,
            "ranks": [r[arch] for r in ranks]}
    # every kernel against its plain version at every shape the ranks gave it
    seen = {k: {tuple(x) for r in ranks for x in r["shapes"][k]} for k in
            ("bitserial", "flash", "paged")}
    rg, g3 = get_config("recurrentgemma-9b"), get_config("gemma3-12b")
    vis = get_config(VISION)
    B_l = KM_BUCKET[0] // d_ax
    wanted = {
        # recurrentgemma's windowed prefill: a rank's lanes and half of the
        # query heads of its one K/V head
        "flash": {(B_l * rg.n_heads // m_ax, B_l, KM_BUCKET[1], rg.resolved_head_dim,
                   rg.window, "bfloat16")},
        # gemma3's global layer: 4 of 8 K/V heads on a rank's lanes
        "paged": {(MESH_SLOTS // d_ax, g3.n_kv_heads // m_ax,
                   g3.n_heads // g3.n_kv_heads, g3.resolved_head_dim,
                   MESH_BLOCKS // d_ax + 1, BLOCK, MESH_MAX_LEN // BLOCK, "bfloat16")},
        # the cross K/V products on a rank's block, every lane's 1600 tokens
        "bitserial": {(KM_BUCKET[0] * vis.frontend_tokens, vis.d_model // d_ax,
                       vis.n_kv_heads * vis.resolved_head_dim // m_ax, "bfloat16", None)},
    }
    for k, w in wanted.items():
        check(w <= seen[k], f"[4l] the ranks never gave the {k} kernel {w - seen[k]}")
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = {"bitserial": [bitserial_case(dev, gen, card, time_ms, M, K, N, g, getattr(torch, dt),
                                         timed=False)
                          for M, K, N, dt, g in sorted(seen["bitserial"], key=str)],
            "flash": [_kinds_flash_case(dev, *s) for s in sorted(seen["flash"], key=str)],
            "paged": [_kinds_paged_case(dev, *s) for s in sorted(seen["paged"], key=str)]}
    for k, rs in rows.items():
        worst = max(rs, key=lambda x: x["max_abs_err"] / max(x["max_abs_plain"], 1e-30))
        print(f"[4l] {k} against its plain version at the {len(rs)} shapes the ranks gave it: "
              f"every one within tolerance" + (", active=a bitwise truncate_packed"
                                              if k == "bitserial" else "")
              + f"; the worst relative error "
              f"{worst['max_abs_err'] / max(worst['max_abs_plain'], 1e-30):.3e} at "
              f"{ {x: y for x, y in worst.items() if x not in ('max_abs_err', 'max_abs_plain')} } "
              f"[{card}]", flush=True)
    rep["kernels_at_shard_shapes"] = rows
    rep["launches"] = {k: sum(r[a]["launches"][k] for r in ranks for a, _ in MESH_KINDS)
                       for k in ranks[0][MESH_KINDS[0][0]]["launches"]}
    rep["collectives_per_decode_step"] = {a: ranks[0][a]["collectives_per_decode_step"]
                                          for a, _ in MESH_KINDS}
    return rep


# the training mesh phase (6f): full-width granite-3-2b cut to MT_LAYERS
# layers, BSQ in f32 on a 2x2 mesh of 4 gloo ranks on the card, MT_STEPS
# steps of MT_BATCH x MT_SEQ; then the reduced config's checkpoint on 2x2
# resumed on 4x1 and a 4x1 compressed step
MT_LAYERS, MT_STEPS, MT_BATCH, MT_SEQ = 1, 2, 4, 64  # 2 layers until phase 6g
MT_SAMPLES = 1 << 16  # state elements sampled per leaf block
MT_LOSS_TOL = 1e-5  # ce, reg, total: relative, f32 sums over ranks
# grad_norm: relative.  The first step's norm (about 330) is clipped to 1,
# so the next step's (about 0.37) carries the first step's f32 rounding
# some 900 times over: 1e-7 x 900
MT_GRAD_NORM_TOL = 1e-4
MT_STATE_TOL = 1e-4  # sampled state elements: of the leaf block's largest |x|
MT_RESUME_TOL = 1e-5  # the reduced resume against one process: absolute


def _mt_cfg():
    """Full-width granite-3-2b cut to MT_LAYERS layers, f32 activations and
    cache (the published config computes in bf16)."""
    from repro_torch.configs import get_config

    return get_config("granite-3-2b").scaled(n_layers=MT_LAYERS, dtype="float32",
                                             kv_cache_dtype="float32")


def _mt_bsq_cfg():
    import torch

    from repro_torch.core import BSQConfig

    return BSQConfig(n_init=8, alpha=5e-3, mode="static", compute_dtype=torch.float32)


def _mt_fingerprint(x):
    """A leaf block's f64 sum, its largest |x| and MT_SAMPLES of its
    elements at positions drawn from its size (the same on both sides)."""
    import torch

    flat = x.reshape(-1)
    gen = torch.Generator(device=flat.device).manual_seed(flat.numel())
    idx = torch.randint(0, flat.numel(), (min(MT_SAMPLES, flat.numel()),), generator=gen,
                        device=flat.device)
    return (float(flat.double().sum()), float(flat.abs().max()) if flat.numel() else 0.0,
            flat[idx].float().cpu().numpy())


def _mt_export_hashes(packed):
    """Per packed weight: the sha256 of its planes and of its sign bytes, its
    bit count and its f32 scales (trained values: held to a tolerance)."""
    import hashlib

    return {k: tuple(hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()
                     for t in (pw.planes, pw.sign)) + (pw.n_bits, pw.scale.cpu().numpy())
            for k, pw in packed.items()}


def _mt_same_export(got, want):
    """(planes, sign and bit counts equal, the largest relative scale
    difference)."""
    import numpy as np

    same = sorted(got) == sorted(want) and all(got[k][:3] == want[k][:3] for k in want)
    err = max(float(np.max(np.abs(got[k][3] - want[k][3]) / np.abs(want[k][3])))
              for k in want) if same else float("inf")
    return same, err


def _mt_served(packed, reps, state, ctx):
    from repro_torch.core import merge_params
    from repro_torch.core.requant import forward_value

    served = {k: v for k, v in packed.items() if k != "embed"}
    served["embed"] = forward_value(reps["embed"])
    return merge_params(ctx.template, served, state["trainable"]["float"])


def _mt_requests(cfg):
    import numpy as np

    from repro_torch.data import MarkovLM
    from repro_torch.serve import Request

    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    return [Request(uid=i, tokens=task.sample(np.random.default_rng(50 + i), 1, 16)[0, :16]
                    .astype(np.int32), max_new=8) for i in range(4)]


def _mt_reduced_train(mesh, workdir, total, skip, dev=None):
    """train_bsq of reduced granite-3-2b (f32) on ``mesh`` (or in one process
    on ``dev``) from the seed-0 draw, checkpoints every 2 steps; ``skip``
    batches passed over first."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.data import MarkovLM, sharded_lm_iterator
    from repro_torch.dist import elastic
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train import (TrainerConfig, init_bsq_state, make_bsq_train_step,
                                   make_requant_step, train_bsq)

    cfg = reduced_config("granite-3-2b")
    dev = mesh.device if mesh is not None else dev
    state, ctx = init_bsq_state(torch.Generator(device=dev).manual_seed(0), cfg, _mt_bsq_cfg(),
                                SGDM(), dev, mesh=mesh)
    data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), 4, 16, device=dev,
                               sharding=mesh)
    for _ in range(skip):
        next(data)
    tcfg = TrainerConfig(total_steps=total, requant_interval=100, ckpt_interval=2,
                         log_interval=1, workdir=workdir)
    out = train_bsq(state, ctx, make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [2]),
                                                     mesh=mesh),
                    make_requant_step(ctx, mesh), data, tcfg, mesh=mesh)
    state = out["state"]
    if mesh is not None:
        state = elastic.gather_tree(state, mesh, elastic.train_state_specs(state, mesh,
                                                                           ctx.template))
    from repro_torch.tree import flatten_with_path

    return {n: x.cpu().numpy() for n, x in flatten_with_path(state)}, \
        [h["step"] for h in out["history"]]


def mesh_train_rank(mesh, workdir):
    """Phase 6f on one rank of the 2x2 mesh: MT_STEPS BSQ steps of
    full-width granite-3-2b (MT_LAYERS layers, f32) on its blocks and one
    at microbatches 2, hoisted, their
    launches, its bgl_sumsq launch against the plain version on its own
    plane rows, its state's fingerprints, its export of the trained
    blocks and one bucketed decode served from them; then the reduced
    config's checkpoint at step 2."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core.bsq import export_packed_blocks
    from repro_torch.data import MarkovLM, sharded_lm_iterator
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import ref
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train import init_bsq_state, make_bsq_train_step, state_reps
    from repro_torch.tree import flatten_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    regularizer = importlib.import_module("repro_torch.core.regularizer")
    dev = mesh.device
    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    cfg = _mt_cfg()
    t0 = time.perf_counter()
    state, ctx = init_bsq_state(torch.Generator(device=dev).manual_seed(0), cfg, _mt_bsq_cfg(),
                                SGDM(), mesh=mesh)
    torch.cuda.synchronize(dev)
    out["init_s"] = time.perf_counter() - t0
    step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [MT_STEPS]), mesh=mesh)
    data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), MT_BATCH, MT_SEQ,
                               sharding=mesh)
    batches = [next(data) for _ in range(MT_STEPS)]
    _reset_launches()
    before = mesh.collectives
    metrics, dts = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize(dev)
        dts.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    out["collectives_per_step"] = (mesh.collectives - before) / MT_STEPS
    # one more step at microbatches 2, hoisted: this rank's rows are its block
    # of each of the batch's two microbatches (the iterator lays them out so)
    mb_data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), MT_BATCH, MT_SEQ,
                                  sharding=mesh, microbatches=2)
    mb_batch = [next(mb_data) for _ in range(MT_STEPS + 1)][-1]
    mb_step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [MT_STEPS]), mesh=mesh,
                                  microbatches=2)
    t0 = time.perf_counter()
    state, m = mb_step(state, mb_batch)
    torch.cuda.synchronize(dev)
    dts.append(time.perf_counter() - t0)
    metrics.append({k: float(v) for k, v in m.items()})
    out["launches"] = _launch_counts()
    out["metrics"], out["step_s"] = metrics, dts
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    # the kernel on this rank's own plane rows, against its plain version
    reps = state_reps(state, ctx)
    xs = [regularizer._rows(getattr(r, k), r.group_axes) for k in ("wp", "wn")
          for r in reps.values()]
    got, want = bgl.bgl_sumsq_grouped_cuda(xs), ref.bgl_sumsq_grouped_ref(xs)
    g = torch.rand(got.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    grads = bgl.bgl_sumsq_grouped_backward_cuda(xs, g)
    gs = torch.split(g, [x.shape[0] for x in xs])
    out["bgl"] = {"shapes": [tuple(x.shape) for x in xs],
                  "max_rel_err": float(((got - want).abs() / want.clamp_min(1e-30)).max()),
                  "max_abs_err": float((got - want).abs().max()),
                  "backward_bitwise": all(torch.equal(a, ref.bgl_sumsq_grad_ref(x, gi))
                                          for a, x, gi in zip(grads, xs, gs))}
    del xs, got, want, g, grads, gs
    out["fingerprints"] = {n: _mt_fingerprint(x) for n, x in flatten_with_path(state)}
    # export the trained blocks and serve one bucketed decode from them
    t0 = time.perf_counter()
    shapes = {k: tuple(x.shape) for k, x in flatten_with_path(ctx.template)}
    packed = export_packed_blocks(reps, mesh, shapes)
    torch.cuda.synchronize(dev)
    out["export_s"] = time.perf_counter() - t0
    out["export"] = _mt_export_hashes(packed)
    served = _mt_served(packed, reps, state, ctx)
    del reps, state, step
    gc.collect()
    torch.cuda.empty_cache()
    _reset_launches()
    engine = checked_engine_cls()(served, cfg, max_len=64, mesh=mesh, placed=True)
    with contextlib.redirect_stdout(io.StringIO()):
        res = engine.generate(_mt_requests(cfg))
    out["serve_launches"] = _launch_counts()
    out["tokens"] = np.stack([r.tokens for r in sorted(res, key=lambda r: r.uid)]).tolist()
    out["bad"] = int(engine.bad.item())
    del engine, served, packed
    gc.collect()
    torch.cuda.empty_cache()
    # the reduced config's checkpoint at step 2, written by rank 0
    with contextlib.redirect_stdout(io.StringIO()):
        _mt_reduced_train(mesh, workdir, 2, 0)
    return out


def mesh_train_4x1_rank(mesh, workdir):
    """Phase 6f on one rank of the 4x1 mesh: a compressed BSQ step of the
    reduced config (params whole on every rank) with its launches, then
    the 2x2 checkpoint resumed here to step 4 and gathered."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.data import MarkovLM, sharded_lm_iterator
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train import init_bsq_state, make_compressed_bsq_dp_step
    from repro_torch.tree import flatten_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    cfg = reduced_config("granite-3-2b")
    state, ctx = init_bsq_state(torch.Generator(device=dev).manual_seed(0), cfg, _mt_bsq_cfg(),
                                SGDM(), dev)
    add, step = make_compressed_bsq_dp_step(ctx, SGDM(), step_decay(0.2, [2]), mesh)
    state = add(state)
    data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), 8, 16, sharding=mesh)
    _reset_launches()
    state, m = step(state, next(data))
    torch.cuda.synchronize(dev)
    out = {"rank": mesh.rank, "compressed_launches": _launch_counts(),
           "compressed_metrics": {k: float(v) for k, v in m.items()},
           "compressed_params": {n: float(x.double().sum()) for n, x in
                                 flatten_with_path(state["trainable"])}}
    out["compressed_finite"] = all(bool(torch.isfinite(x).all())
                                   for _, x in flatten_with_path(state))
    del state
    with contextlib.redirect_stdout(io.StringIO()) as text:
        out["resumed"], out["resumed_steps"] = _mt_reduced_train(mesh, workdir, 4, 2)
    out["resumed_text"] = text.getvalue()
    return out


def mesh_train_phase(dev, card, time_ms):
    """Phase 6f: BSQ training on a ("data", "model") mesh, 4 gloo ranks on
    the card.  On 2x2: full-width granite-3-2b cut to MT_LAYERS layers,
    f32, MT_STEPS steps and one at microbatches 2, hoisted (each rank its
    blocks of the state and of the
    batch), one grouped bgl_sumsq launch and one backward per rank per
    step, each rank's kernel against its plain version on its own plane
    rows, its export of the trained blocks served through one bucketed
    decode; then one process (after the ranks exit) trains the same model
    on the whole batches: losses within MT_LOSS_TOL (gradient norms within
    MT_GRAD_NORM_TOL), each rank's state
    fingerprints within MT_STATE_TOL, the export bytes of each rank equal
    to the block of the one process's export, the served tokens equal.
    The reduced config's checkpoint written at step 2 on 2x2 resumes on
    4x1 to step 4, equal to one process's 4 steps within MT_RESUME_TOL; a
    compressed BSQ step on 4x1.  The kernel at a rank's row shapes is
    timed beside its bound, plain version and library call."""
    import numpy as np
    import torch

    from types import SimpleNamespace

    from repro_torch.core import export_packed
    from repro_torch.data import MarkovLM, sharded_lm_iterator
    from repro_torch.dist import sharding
    from repro_torch.dist.elastic import local_scale, train_state_specs
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train import init_bsq_state, make_bsq_train_step, state_reps
    from repro_torch.tree import flatten_with_path

    rep = {"mesh": [2, 2], "layers": MT_LAYERS, "steps": MT_STEPS,
           "batch": [MT_BATCH, MT_SEQ]}
    cfg = _mt_cfg()
    workdir = ROOT / "build" / "chip_smoke_mesh_train"
    shutil.rmtree(workdir, ignore_errors=True)
    print(f"[6f] BSQ training of granite-3-2b at its published width cut to {MT_LAYERS} "
          f"layers, f32, on a 2x2 (data, model) mesh: 4 gloo ranks on cuda:0, {MT_STEPS} steps "
          f"of {MT_BATCH} x {MT_SEQ} [{card}]", flush=True)
    t0 = time.perf_counter()
    ranks = run_on_mesh(mesh_train_rank, 2, 2, backend="gloo", device=dev,
                        args=(str(workdir),))
    rep["ranks_wall_s"] = time.perf_counter() - t0
    for r in ranks:
        tag = f"[6f] rank {r['rank']} {r['coords']}"
        la, n = r["launches"], MT_STEPS + 1  # the microbatched step's hoisted 1 + 1 among them
        check(la["bgl_sumsq"] == n and la["bgl_sumsq_backward"] == n
              and la["bitserial_matmul"] == la["flash_attention"] == la["paged_attention"] == 0,
              f"{tag}: launches {la}, expected {n} + {n} bgl_sumsq and no other")
        check(r["bgl"]["max_rel_err"] <= BGL_TOL and r["bgl"]["backward_bitwise"],
              f"{tag}: bgl_sumsq on its rows vs plain {r['bgl']}")
        check(r["bad"] == 0 and r["serve_launches"]["bitserial_matmul"] > 0,
              f"{tag}: serving the export: bad {r['bad']}, launches {r['serve_launches']}")
        check(r["tokens"] == ranks[0]["tokens"], f"{tag}: tokens differ from rank 0's")
    # one process on the whole batches, after the ranks exit
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, ctx = init_bsq_state(torch.Generator(device=dev).manual_seed(0), cfg, _mt_bsq_cfg(),
                                SGDM(), dev)
    step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [MT_STEPS]))
    data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), MT_BATCH, MT_SEQ,
                               device=dev)
    want, t_one = [], []
    for i in range(MT_STEPS + 1):
        if i == MT_STEPS:  # the microbatched step, on the whole batch
            step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [MT_STEPS]),
                                       microbatches=2)
        t0 = time.perf_counter()
        state, m = step(state, next(data))
        torch.cuda.synchronize()
        t_one.append(time.perf_counter() - t0)
        want.append({k: float(v) for k, v in m.items()})
    rep["one_process_step_s"], rep["one_process_peak_bytes"] = t_one, \
        torch.cuda.max_memory_allocated()
    print(f"[6f] losses per step, ranks / one process: "
          f"{[{k: m[k] for k in ('ce', 'reg', 'grad_norm')} for m in ranks[0]['metrics']]} / "
          f"{[{k: m[k] for k in ('ce', 'reg', 'grad_norm')} for m in want]}", flush=True)
    worst = 0.0
    for r in ranks:
        for i, (m, w) in enumerate(zip(r["metrics"], want)):
            for k in ("ce", "reg", "total", "grad_norm"):
                e = abs(m[k] - w[k]) / abs(w[k])
                worst = max(worst, e)
                tol = MT_GRAD_NORM_TOL if k == "grad_norm" else MT_LOSS_TOL
                check(e <= tol, f"[6f] rank {r['rank']} step {i} {k}: {m[k]} vs one process "
                                f"{w[k]}")
    rep["loss_max_rel_err"] = worst
    specs = dict(sharding.flatten_specs(train_state_specs(
        state, SimpleNamespace(shape={"data": 2, "model": 2}, coords={}))))
    leaves = dict(flatten_with_path(state))
    worst_state = 0.0
    for r in ranks:
        view = SimpleNamespace(shape={"data": 2, "model": 2}, coords=r["coords"])
        for name, (tot, amax, sample) in r["fingerprints"].items():
            block = sharding.local_block(leaves[name], specs[name], view)
            w_tot, w_amax, w_sample = _mt_fingerprint(block)
            err = float(np.abs(sample - w_sample).max()) / max(w_amax, 1e-30) \
                if sample.size else 0.0
            worst_state = max(worst_state, err)
            check(sample.shape == w_sample.shape and err <= MT_STATE_TOL,
                  f"[6f] rank {r['rank']} {name}: sampled elements differ by {err} of the "
                  f"block's max |x| (sum {tot} vs {w_tot})")
    rep["state_max_err_of_max"] = worst_state
    # the one process's export, cut to each rank's blocks; its served tokens
    reps = state_reps(state, ctx)
    packed = export_packed(reps)
    for r in ranks:
        view = SimpleNamespace(shape={"data": 2, "model": 2}, coords=r["coords"])
        blocks = {}
        for name, pw in packed.items():
            sspec = sharding.param_spec(f"{name}/sign", tuple(pw.sign.shape), view)
            pspec = sharding.param_spec(f"{name}/planes", tuple(pw.planes.shape), view)
            scspec = sharding.param_spec(f"{name}/scale", tuple(pw.scale.shape), view)
            n_ax = tuple(sspec)[-1] if len(sspec) else None
            blocks[name] = dataclasses.replace(
                pw, planes=sharding.local_block(pw.planes, pspec, view),
                sign=sharding.local_block(pw.sign, sspec, view),
                scale=local_scale(pw.scale, scspec, n_ax, pw.sign.shape[-1], view))
        same, scale_err = _mt_same_export(r["export"], _mt_export_hashes(blocks))
        check(same and scale_err <= MT_LOSS_TOL,
              f"[6f] rank {r['rank']}: its export differs from the block of one process's "
              f"export (planes, sign, bits equal: {same}; scales within {scale_err})")
        rep["export_scale_max_rel_err"] = max(rep.get("export_scale_max_rel_err", 0.0),
                                              scale_err)
    served = _mt_served(packed, reps, state, ctx)
    del state, step, reps
    gc.collect()
    engine = checked_engine_cls()(served, cfg, max_len=64, device=dev)
    res = engine.generate(_mt_requests(cfg))
    one_tokens = np.stack([x.tokens for x in sorted(res, key=lambda x: x.uid)]).tolist()
    check(ranks[0]["tokens"] == one_tokens, f"[6f] tokens served on the mesh "
                                            f"{ranks[0]['tokens']} vs one process {one_tokens}")
    del engine, served, packed
    gc.collect()
    torch.cuda.empty_cache()
    # 4x1: a compressed step, and the 2x2 checkpoint resumed
    t0 = time.perf_counter()
    r41 = run_on_mesh(mesh_train_4x1_rank, 4, 1, backend="gloo", device=dev,
                      args=(str(workdir),))
    rep["ranks_4x1_wall_s"] = time.perf_counter() - t0
    for r in r41:
        la = r["compressed_launches"]
        check(r["compressed_finite"] and la["bgl_sumsq"] == 1 and la["bgl_sumsq_backward"] == 1,
              f"[6f] 4x1 rank {r['rank']} compressed step: finite {r['compressed_finite']}, "
              f"launches {la}")
        check(r["compressed_params"] == r41[0]["compressed_params"]
              and r["compressed_metrics"] == r41[0]["compressed_metrics"],
              f"[6f] 4x1 rank {r['rank']}: the compressed step's params or metrics differ "
              "from rank 0's")
        check(r["resumed_steps"] == [3, 4], f"[6f] 4x1 rank {r['rank']} resumed steps "
                                            f"{r['resumed_steps']}")
    check("resumed from step 2" in r41[0]["resumed_text"], "[6f] the 4x1 run did not resume")
    whole, _ = _mt_reduced_train(None, None, 4, 0, dev)
    resume_err = max(float(np.abs(r41[0]["resumed"][n] - x).max()) if x.size else 0.0
                     for n, x in whole.items())
    check(resume_err <= MT_RESUME_TOL, f"[6f] resumed on 4x1 vs one process: {resume_err}")
    rep["resume_max_abs_err"] = resume_err
    shutil.rmtree(workdir, ignore_errors=True)
    # the kernel at a rank's row shapes, timed
    shapes = ranks[0]["bgl"]["shapes"]
    gen = torch.Generator(device=dev).manual_seed(6)
    xs = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    g = torch.rand((sum(x.shape[0] for x in xs),), generator=gen, device=dev)
    g2 = [t[:, None] for t in torch.split(2 * g, [x.shape[0] for x in xs])]
    gs = torch.split(g, [x.shape[0] for x in xs])
    row_views = [x[i] for x in xs for i in range(x.shape[0])]
    spin = 4_000_000
    fwd = {"ms": time_ms(lambda: ops.bgl_sumsq_grouped(xs), spin=spin),
           "plain_ms": time_ms(lambda: ref.bgl_sumsq_grouped_ref(xs), iters=5, spin=spin),
           "library_ms": time_ms(lambda: torch._foreach_norm(row_views), spin=spin)}
    fwd["bound_ms"], fwd["bound_by"] = bgl_bound(xs)
    bwd = {"ms": time_ms(lambda: bgl.bgl_sumsq_grouped_backward_cuda(xs, g), spin=spin),
           "plain_ms": time_ms(lambda: [ref.bgl_sumsq_grad_ref(x, gi) for x, gi in zip(xs, gs)],
                               iters=5, spin=spin),
           "library_ms": time_ms(lambda: torch._foreach_mul(xs, g2), spin=spin)}
    bwd["bound_ms"], bwd["bound_by"] = bgl_bound(xs, backward=True)
    rep["bgl_rank"] = {"forward": fwd, "backward": bwd, "views": len(xs),
                       "bytes": sum(x.numel() * 4 for x in xs),
                       "max_rel_err": max(r["bgl"]["max_rel_err"] for r in ranks),
                       "max_abs_err": max(r["bgl"]["max_abs_err"] for r in ranks)}
    del xs, g, g2, gs, row_views
    rep["launches_per_rank"] = {r["rank"]: r["launches"] for r in ranks}
    rep.update({k: [r[k] for r in ranks] for k in ("step_s", "peak_bytes", "init_s",
                                                   "export_s", "collectives_per_step")})
    rep["metrics"], rep["one_process_metrics"] = ranks[0]["metrics"], want
    print(f"[6f] 2x2, {MT_LAYERS} full-width layers, f32: ranks' step s {rep['step_s'][0]}, "
          f"one process {t_one}; peak per rank {[b / 1e9 for b in rep['peak_bytes']]} GB, one "
          f"process {rep['one_process_peak_bytes'] / 1e9:.1f} GB; collectives per step "
          f"{rep['collectives_per_step'][0]}; losses within {worst:.2e} relative of one "
          f"process (ce {want[-1]['ce']:.6f}, reg {want[-1]['reg']:.3f}); sampled state within "
          f"{worst_state:.2e} of each block's max; export planes and sign bytes equal on every rank, scales within {rep['export_scale_max_rel_err']:.2e}; tokens "
          f"{ranks[0]['tokens'][0]} equal; bgl_sumsq {MT_STEPS + 1} + {MT_STEPS + 1} launches "
          f"per rank (the last step at microbatches 2, hoisted: 1 + 1), on its rows within "
          f"{rep['bgl_rank']['max_rel_err']:.2e}, backward bitwise [{card}]", flush=True)
    print(f"[6f] bgl_sumsq at a rank's {len(shapes)} views ({rep['bgl_rank']['bytes'] / 1e9:.2f}"
          f" GB f32): forward {fwd['ms']:.4f} ms (bound {fwd['bound_ms']:.4f}, plain "
          f"{fwd['plain_ms']:.4f}, _foreach_norm {fwd['library_ms']:.4f}); backward "
          f"{bwd['ms']:.4f} ms (bound {bwd['bound_ms']:.4f}, plain {bwd['plain_ms']:.4f}, "
          f"_foreach_mul {bwd['library_ms']:.4f}) [{card}]", flush=True)
    print(f"[6f] reduced: the 2x2 checkpoint of step 2 resumed on 4x1 to step 4 within "
          f"{resume_err:.2e} of one process; a compressed BSQ step on 4x1: params alike on "
          f"every rank, 1 + 1 bgl_sumsq launches per rank; walls 2x2 "
          f"{rep['ranks_wall_s']:.1f} s, 4x1 {rep['ranks_4x1_wall_s']:.1f} s [{card}]",
          flush=True)
    return rep


# the training kinds' mesh phase (6g): BSQ in f32 on a 2x2 mesh of 4 gloo
# ranks on the card, MK_STEPS steps of MK_BATCH x MK_SEQ; mamba2-130m at
# its published width and depth, the other kinds at their reduced configs
MK_STEPS, MK_BATCH, MK_SEQ = 2, 4, 64
MK_FULL = "mamba2-130m"
MK_REDUCED = ["qwen2-moe-a2.7b", "recurrentgemma-9b", "gemma3-12b", VISION]
# bgl_sumsq at a full-width qwen2-moe-a2.7b rank's expert rows of one layer
# on the 2x2 mesh: 30 of its 60 experts, half of d_ff 1408; 8 planes, f32
MK_EXPERT_BLOCKS = [(1, 30, 2048, 704), (1, 30, 2048, 704), (1, 30, 704, 2048)]
MK_EXPERT_PLANES = 8
MK_NEAR_TIE_ULPS = 100  # a top-k margin under this many f32 ulps of the largest gate
# A rep's scale gradient sums its group's terms g_w * w / s (a layer's
# 768 x 3352 for mamba2's in_proj), which largely cancel: f32 sums in
# another order move it up to 7e-4 of its leaf's max on an H100 (this
# phase prints the worst leaves), and the mesh and one f32 process both lie within about 2 unit
# roundoffs of the terms' magnitudes of the float64 value
# (tests/test_torch_mesh_train_kinds.py holds the mesh to 16).  So the
# reps' scales and their SGD moments are held to MK_SCALE_TOL of each
# block's max |x| (1.6e-3 measured), and the gradient norm after the first,
# clipped, step to MK_GRAD_NORM_TOL (2.3e-4 measured); every other bar is
# phase 6f's.  Planted faults (the router loss counted once per data rank;
# the scales' gradients not summed over the axes that split their weights)
# fail these bars (PERF.md §6).
MK_SCALE_TOL = 5e-3
MK_GRAD_NORM_TOL = 1e-3


def _mk_cfg(arch):
    """6g's config of ``arch``: mamba2-130m at its published width and
    depth, the others reduced; f32 activations (BSQ in f32)."""
    from repro_torch.configs import get_config, reduced_config

    cfg = get_config(arch) if arch == MK_FULL else reduced_config(arch)
    return cfg.scaled(dtype="float32", kv_cache_dtype="float32")


def _mk_batches(cfg, dev, mesh=None):
    """MK_STEPS batches of MarkovLM tokens (the seed-13 chain, the seed-0
    stream), with random ``cross_embeds`` for the vision model; this rank's
    rows of each on ``mesh``."""
    import torch

    from repro_torch.data import MarkovLM, sharded_lm_iterator
    from repro_torch.dist import sharding

    data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), MK_BATCH, MK_SEQ,
                               device=dev, sharding=mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    out = []
    for _ in range(MK_STEPS):
        b = next(data)
        if cfg.frontend == "vision":
            x = torch.randn((MK_BATCH, cfg.frontend_tokens, cfg.d_model), generator=gen,
                            device=dev)
            if mesh is not None:
                x = sharding.local_block(x, sharding.data_batch_spec(mesh, MK_BATCH, 3),
                                         mesh).contiguous()
            b["cross_embeds"] = x
        out.append(b)
    return out


def _mk_sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mk_near_ties():
    """Wrap ``moe._route`` to count the routing near-ties: picks whose top-k
    margin is under MK_NEAR_TIE_ULPS f32 ulps of the largest gate, where
    another order of the stitched router sum could pick another expert."""
    import torch

    from repro_torch.models import moe

    seen, orig = {"near": 0, "picks": 0}, moe._route

    def route(gates, top_k):
        srt = gates.detach().sort(-1, descending=True).values
        margin = srt[..., top_k - 1] - srt[..., top_k]
        ulp = torch.finfo(torch.float32).eps * srt.abs().amax()
        seen["near"] += int((margin < MK_NEAR_TIE_ULPS * ulp).sum())
        seen["picks"] += margin.numel()
        return orig(gates, top_k)

    return seen, mock.patch.object(moe, "_route", route)


def _mk_last_grads(holder):
    """Keep a copy of the gradients of the last loss evaluation in
    ``holder["grads"]`` (the step clips its own in place)."""
    from repro_torch.train import step as train_step
    from repro_torch.tree import tree_map

    orig = train_step.value_and_grad

    def grad(fn, tree):
        out = orig(fn, tree)
        holder["grads"] = tree_map(lambda x: x.clone(), out[2])
        return out

    return mock.patch.object(train_step, "value_and_grad", grad)


def _mk_grad_rows(got, want):
    """Per leaf of the last step's gradients: (max |diff| over the leaf's max
    |x|, name), worst first."""
    import numpy as np

    return sorted(((float(np.abs(got[n] - w).max()) / max(float(np.abs(w).max()), 1e-30), n)
                   for n, w in want.items() if w.size), reverse=True)


def mesh_kinds_train_rank(mesh):
    """Phase 6g on one rank of the 2x2 mesh, model by model: MK_STEPS BSQ
    steps on its blocks (launches, collectives, step times, peak), the
    state's fingerprints, its bgl_sumsq launch against the plain version on
    its own plane rows (the experts' (layer, expert) rows among them), the
    routing near-ties."""
    import torch

    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import ref
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train import init_bsq_state, make_bsq_train_step, state_reps
    from repro_torch.tree import flatten_with_path

    if mesh.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    regularizer = importlib.import_module("repro_torch.core.regularizer")
    dev = mesh.device
    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    for arch in [MK_FULL] + MK_REDUCED:
        cfg = _mk_cfg(arch)
        r = {}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, ctx = init_bsq_state(torch.Generator(device=dev).manual_seed(0), cfg,
                                    _mt_bsq_cfg(), SGDM(), mesh=mesh)
        _mk_sync(dev)
        r["init_s"] = time.perf_counter() - t0
        step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [MK_STEPS]), mesh=mesh)
        batches = _mk_batches(cfg, dev, mesh)
        seen, routes = _mk_near_ties()
        last = {}
        _reset_launches()
        before = mesh.collectives
        r["metrics"], r["step_s"] = [], []
        with routes, _mk_last_grads(last):
            for b in batches:
                t0 = time.perf_counter()
                state, m = step(state, b)
                _mk_sync(dev)
                r["step_s"].append(time.perf_counter() - t0)
                r["metrics"].append({k: float(v) for k, v in m.items()})
        r["launches"] = _launch_counts()
        r["collectives_per_step"] = (mesh.collectives - before) / MK_STEPS
        r["route"] = seen
        r["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if arch != MK_FULL:  # the last step's gradients, gathered (a reduced model's)
            from repro_torch.dist.elastic import gather_tree, train_state_specs

            specs = train_state_specs(state, mesh, ctx.template)["trainable"]
            r["last_grads"] = {n: x.cpu().numpy() for n, x in flatten_with_path(
                gather_tree(last["grads"], mesh, specs))}
        del last
        reps = state_reps(state, ctx)
        xs = [regularizer._rows(getattr(rp, k), rp.group_axes) for k in ("wp", "wn")
              for rp in reps.values()]
        if dev.type == "cuda":
            got = bgl.bgl_sumsq_grouped_cuda(xs)
            want = ref.bgl_sumsq_grouped_ref(xs)
            g = torch.rand(got.shape, generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
            grads = bgl.bgl_sumsq_grouped_backward_cuda(xs, g)
            gs = torch.split(g, [x.shape[0] for x in xs])
            r["bgl"] = {"max_rel_err": float(((got - want).abs()
                                              / want.clamp_min(1e-30)).max()),
                        "max_abs_err": float((got - want).abs().max()),
                        "backward_bitwise": all(torch.equal(a, ref.bgl_sumsq_grad_ref(x, gi))
                                                for a, x, gi in zip(grads, xs, gs))}
            del got, want, g, grads, gs
        r["bgl_rows"] = sum(x.shape[0] for x in xs)
        r["fingerprints"] = {n: _mt_fingerprint(x) for n, x in flatten_with_path(state)}
        del xs, reps, state, step, batches
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[arch] = r
    return out


def _mk_one_process(arch, dev):
    """One process's MK_STEPS steps of ``arch`` on the whole batches: its
    state, metrics, step times, the last step's gradients and the names of
    the state's leaves that start at zero (the SGD moments, zero-initialised
    biases and norm scales: sums of gradients after the steps)."""
    import torch

    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train import init_bsq_state, make_bsq_train_step

    cfg = _mk_cfg(arch)
    state, ctx = init_bsq_state(torch.Generator(device=dev).manual_seed(0), cfg, _mt_bsq_cfg(),
                                SGDM(), dev)
    from repro_torch.tree import flatten_with_path

    zero = {n for n, x in flatten_with_path(state) if not bool(x.any())}
    step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [MK_STEPS]))
    metrics, dts, last = [], [], {}
    with _mk_last_grads(last):
        for b in _mk_batches(cfg, dev):
            t0 = time.perf_counter()
            state, m = step(state, b)
            _mk_sync(dev)
            dts.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
    grads = {n: x.cpu().numpy() for n, x in flatten_with_path(last["grads"])} \
        if arch != MK_FULL else None
    return state, metrics, dts, grads, zero


def _mk_expert_rows(dev, time_ms):
    """bgl_sumsq at a full-width qwen2-moe-a2.7b rank's expert rows of one
    layer (MK_EXPERT_BLOCKS, MK_EXPERT_PLANES planes, wp and wn, f32: the
    rows of its (layer, expert) groups), against its plain version, timed
    beside its bound, the plain version and one ``_foreach_norm`` call
    (forward) and ``_foreach_mul`` (backward)."""
    import torch

    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(8)
    xs = []
    for _ in ("wp", "wn"):
        for shape in MK_EXPERT_BLOCKS:
            n_rows = MK_EXPERT_PLANES * shape[0] * shape[1]
            xs.append(torch.rand((n_rows, shape[2] * shape[3]), generator=gen, device=dev) * 2.0)
    got, want = ops.bgl_sumsq_grouped(xs), ref.bgl_sumsq_grouped_ref(xs)
    err = {"max_rel_err": float(((got - want).abs() / want.clamp_min(1e-30)).max()),
           "max_abs_err": float((got - want).abs().max())}
    check(err["max_rel_err"] <= BGL_TOL,
          f"[6g] bgl_sumsq at the expert rows vs plain: {err} (tolerance {BGL_TOL})")
    g = torch.rand(got.shape, generator=gen, device=dev)
    gs = torch.split(g, [x.shape[0] for x in xs])
    back = bgl.bgl_sumsq_grouped_backward_cuda(xs, g)
    err["backward_max_abs_err"] = max(float((a - ref.bgl_sumsq_grad_ref(x, gi)).abs().max())
                                      for a, x, gi in zip(back, xs, gs))
    check(err["backward_max_abs_err"] == 0.0,
          "[6g] bgl_sumsq backward at the expert rows is not bitwise its plain version")
    del got, want, back
    g2 = [t[:, None] for t in torch.split(2 * g, [x.shape[0] for x in xs])]
    row_views = [x[i] for x in xs for i in range(x.shape[0])]
    spin = 4_000_000
    fwd = {"ms": time_ms(lambda: ops.bgl_sumsq_grouped(xs), spin=spin),
           "plain_ms": time_ms(lambda: ref.bgl_sumsq_grouped_ref(xs), iters=5, spin=spin),
           "library_ms": time_ms(lambda: torch._foreach_norm(row_views), spin=spin)}
    fwd["bound_ms"], fwd["bound_by"] = bgl_bound(xs)
    bwd = {"ms": time_ms(lambda: bgl.bgl_sumsq_grouped_backward_cuda(xs, g), spin=spin),
           "plain_ms": time_ms(lambda: [ref.bgl_sumsq_grad_ref(x, gi) for x, gi in zip(xs, gs)],
                               iters=5, spin=spin),
           "library_ms": time_ms(lambda: torch._foreach_mul(xs, g2), spin=spin)}
    bwd["bound_ms"], bwd["bound_by"] = bgl_bound(xs, backward=True)
    out = dict(err, forward=fwd, backward=bwd, views=len(xs), rows=sum(x.shape[0] for x in xs),
               bytes=sum(x.numel() * x.element_size() for x in xs))
    del xs, g, g2, gs, row_views
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mk_held(tag, ranks, arch, want, state, zero, shape, soft):
    """Each rank's metrics and sampled state of ``arch`` against one
    process's (``want``, ``state``; ``zero`` the leaves that start at zero)
    on a mesh of ``shape``, by 6g's bars; a failure goes to ``soft``.
    Returns (the worst relative loss error, the sampled leaves nearest
    their bars, the worst state and moment errors of each block's max)."""
    import numpy as np

    from types import SimpleNamespace

    from repro_torch.dist import sharding
    from repro_torch.dist.elastic import train_state_specs
    from repro_torch.tree import flatten_with_path

    def view(coords):
        return SimpleNamespace(shape=shape, coords=coords)

    worst = 0.0
    for r in ranks:
        for i, (m, w) in enumerate(zip(r[arch]["metrics"], want)):
            for k in ("ce", "aux", "reg", "total", "grad_norm"):
                e = abs(m[k] - w[k]) / max(abs(w[k]), 1e-30)
                worst = max(worst, e)
                tol = MT_LOSS_TOL if k != "grad_norm" else \
                    MT_GRAD_NORM_TOL if i == 0 else MK_GRAD_NORM_TOL
                soft(e <= tol or m[k] == w[k],
                     f"{tag} rank {r['rank']} step {i} {k}: {m[k]} vs one process {w[k]}")
    specs = dict(sharding.flatten_specs(train_state_specs(state, view({}))))
    leaves = dict(flatten_with_path(state))
    # each sampled leaf block: its largest difference over the block's max
    # |x| against its tolerance (MK_SCALE_TOL for a rep's scale and its
    # moment, else MT_STATE_TOL); a leaf that starts at zero (an SGD
    # moment, a zero bias or norm scale: a sum of gradients) may instead
    # meet the gradient bar, 1e-5 + 2e-4 |x|, element by element: the
    # nearer of its two; 1 at the bar
    rows = []
    for r in ranks:
        v = view(r["coords"])
        for name, (tot, amax, sample) in r[arch]["fingerprints"].items():
            block = sharding.local_block(leaves[name], specs[name], v)
            _, w_amax, w_sample = _mt_fingerprint(block)
            check(sample.shape == w_sample.shape, f"{tag} rank {r['rank']} {name}: "
                                                  f"block shapes differ")
            if not sample.size:
                continue
            diff = np.abs(sample - w_sample)
            tol = MK_SCALE_TOL if "/reps/" in f"/{name}" and name.endswith("/scale") \
                else MT_STATE_TOL
            of_max = float(diff.max()) / max(w_amax, 1e-30)
            of_bar = float((diff / (1e-5 + 2e-4 * np.abs(w_sample))).max())
            near = min(of_max / tol, of_bar) if name in zero else of_max / tol
            rows.append((near, name, r["rank"], of_max, of_bar, w_amax))
    rows.sort(reverse=True)
    worst_state = max((x[3] for x in rows if not x[1].startswith("opt/")), default=0.0)
    worst_moment = max((x[3] for x in rows if x[1].startswith("opt/")), default=0.0)
    bad = [x for x in rows if x[0] > 1.0]
    soft(not bad, f"{tag}: sampled state beyond its bars (nearer bar, leaf, rank, of the "
                   f"block's max, of 1e-5 + 2e-4 |x|, block max): {bad[:5]}")
    return worst, rows, worst_state, worst_moment


def mesh_kinds_train_phase(dev, card, time_ms, flush=None):
    """Phase 6g: BSQ training of every other layer kind on the 2x2 mesh, 4
    gloo ranks on the card.  mamba2-130m at its published width and all 24
    layers, and reduced qwen2-moe-a2.7b (experts over "model", their
    (layer, expert) groups split), recurrentgemma-9b (rglru + local, one
    K/V head), gemma3-12b (local) and llama-3.2-vision-11b (attn+cross,
    cross embeds), f32, MK_STEPS steps of MK_BATCH x MK_SEQ each: per rank
    and step one grouped bgl_sumsq launch and one backward and no serving
    kernel, each rank's kernel against its plain version on its own rows;
    then one process trains each model on the whole batches (after the
    ranks exit): losses within MT_LOSS_TOL (the first gradient norm within
    MT_GRAD_NORM_TOL, the next MK_GRAD_NORM_TOL),
    sampled state within MT_STATE_TOL of each block's max |x|
    (MK_SCALE_TOL for the reps' scales and their SGD moments); a leaf that
    starts at zero (an SGD moment, a zero bias or norm scale: a sum of
    gradients) passes too within 1e-5 plus 2e-4 of each element, the
    gradient bar.
    Last, bgl_sumsq at a full-width qwen2-moe rank's expert rows."""
    import torch

    from repro_torch.launch.mesh import run_on_mesh

    archs = [MK_FULL] + MK_REDUCED
    print(f"[6g] BSQ training on a 2x2 (data, model) mesh, 4 gloo ranks on {dev}: {MK_FULL} at "
          f"its published width and depth, {', '.join(MK_REDUCED)} reduced; f32, {MK_STEPS} "
          f"steps of {MK_BATCH} x {MK_SEQ} [{card}]", flush=True)
    rep = {"mesh": [2, 2], "steps": MK_STEPS, "batch": [MK_BATCH, MK_SEQ],
           "configs": {a: {k: getattr(_mk_cfg(a), k) for k in
                           ("n_layers", "d_model", "d_ff", "n_experts", "vocab_size")}
                       for a in archs}}
    if dev.type == "cuda":
        rep["parent_reserved_bytes"] = torch.cuda.memory_reserved(dev)
        print(f"[6g] this process holds {rep['parent_reserved_bytes'] / 1e9:.2f} GB of the card "
              "as the ranks start", flush=True)
    t0 = time.perf_counter()
    ranks = run_on_mesh(mesh_kinds_train_rank, 2, 2, backend="gloo", device=dev)
    rep["ranks_wall_s"] = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rep["models"] = {}
    fails = []  # every model runs and prints before the phase fails

    def soft(ok, what):
        if not ok:
            print(f"chip_smoke: {what}", flush=True)
            fails.append(what)

    for arch in archs:
        tag = f"[6g] {arch}"
        for r in ranks:
            la = r[arch]["launches"]
            check(la["bgl_sumsq"] == MK_STEPS and la["bgl_sumsq_backward"] == MK_STEPS
                  and la["bitserial_matmul"] == la["flash_attention"]
                  == la["paged_attention"] == 0 or dev.type != "cuda",
                  f"{tag} rank {r['rank']}: launches {la}, expected {MK_STEPS} + {MK_STEPS} "
                  "bgl_sumsq and no other")
            if dev.type == "cuda":
                b = r[arch]["bgl"]
                check(b["max_rel_err"] <= BGL_TOL and b["backward_bitwise"],
                      f"{tag} rank {r['rank']}: bgl_sumsq on its rows vs plain {b}")
        t0 = time.perf_counter()
        state, want, t_one, grads, zero = _mk_one_process(arch, dev)
        one_s = time.perf_counter() - t0
        grad_rows = _mk_grad_rows(ranks[0][arch]["last_grads"], grads) if grads else []
        print(f"{tag}: the last step's gradients, rank 0 gathered against one process, worst "
              f"leaves (max |diff| of the leaf's max |x|): {grad_rows[:4]}", flush=True)
        worst, rows, worst_state, worst_moment = _mk_held(tag, ranks, arch, want, state, zero,
                                                          {"data": 2, "model": 2}, soft)
        del state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        r0 = ranks[0][arch]
        near = sum(r[arch]["route"]["near"] for r in ranks)
        picks = sum(r[arch]["route"]["picks"] for r in ranks)
        m = {"loss_max_rel_err": worst, "state_max_err_of_max": worst_state,
             "moment_max_err_of_max": worst_moment, "state_worst_leaves": rows[:3],
             "last_grad_worst_leaves": grad_rows[:4],
             "step_s": [r[arch]["step_s"] for r in ranks], "one_process_step_s": t_one,
             "one_process_s": one_s, "init_s": [r[arch]["init_s"] for r in ranks],
             "peak_bytes": [r[arch]["peak_bytes"] for r in ranks],
             "collectives_per_step": r0["collectives_per_step"],
             "launches_per_rank": {r["rank"]: r[arch]["launches"] for r in ranks},
             "bgl_rows_per_rank": r0["bgl_rows"], "near_ties": near, "routed_picks": picks,
             "metrics": r0["metrics"], "one_process_metrics": want}
        if dev.type == "cuda":
            m["bgl_max_rel_err"] = max(r[arch]["bgl"]["max_rel_err"] for r in ranks)
            m["bgl_max_abs_err"] = max(r[arch]["bgl"]["max_abs_err"] for r in ranks)
        rep["models"][arch] = m
        print(f"{tag} ({_mk_cfg(arch).n_layers} layers, d_model {_mk_cfg(arch).d_model}): "
              f"step s per rank {[round(x, 3) for x in r0['step_s']]}, one process "
              f"{[round(x, 3) for x in t_one]}; collectives per step "
              f"{r0['collectives_per_step']:.0f}; peak per rank "
              f"{max(m['peak_bytes']) / 1e9:.2f} GB; losses within {worst:.2e} of one process "
              f"(ce {want[-1]['ce']:.5f}, aux {want[-1]['aux']:.5f}); sampled state within "
              f"{worst_state:.2e} and moments {worst_moment:.2e} of each block's max (nearest "
              f"their bars: {rows[:2]}); bgl_sumsq {MK_STEPS} + {MK_STEPS} launches per rank on its "
              f"{r0['bgl_rows']} rows; routing near-ties {near} of {picks} picks [{card}]",
              flush=True)
    check(not fails, f"[6g] {len(fails)} checks failed: {fails[:6]}")
    rep["launches"] = {k: sum(r[a]["launches"][k] for r in ranks for a in archs)
                       for k in ("bgl_sumsq", "bgl_sumsq_backward")}
    if dev.type == "cuda":
        flush.append(torch.empty(256 * 2**20, dtype=torch.uint8, device=dev))  # time_ms's
        rep["expert_rows"] = e = _mk_expert_rows(dev, time_ms)
        flush.clear()
        f, b = e["forward"], e["backward"]
        print(f"[6g] bgl_sumsq at a full-width qwen2-moe-a2.7b rank's expert rows of one layer "
              f"(w_gate, w_up {MK_EXPERT_BLOCKS[0]}, w_down {MK_EXPERT_BLOCKS[2]}, "
              f"{MK_EXPERT_PLANES} planes, wp and wn: {e['rows']} rows, {e['bytes'] / 1e9:.2f} "
              f"GB f32): within {e['max_rel_err']:.2e} of plain, backward bitwise; forward "
              f"{f['ms']:.4f} ms (bound {f['bound_ms']:.4f} {f['bound_by']}, plain "
              f"{f['plain_ms']:.4f}, _foreach_norm {f['library_ms']:.4f}); backward "
              f"{b['ms']:.4f} ms (bound {b['bound_ms']:.4f}, plain {b['plain_ms']:.4f}, "
              f"_foreach_mul {b['library_ms']:.4f}) [{card}]", flush=True)
    print(f"[6g] bgl_sumsq launches on the ranks: {rep['launches']['bgl_sumsq']} + "
          f"{rep['launches']['bgl_sumsq_backward']} ({MK_STEPS} + {MK_STEPS} per rank per "
          f"model); ranks' wall {rep['ranks_wall_s']:.1f} s [{card}]", flush=True)
    return rep

# the pod mesh phase (6h): BSQ training in f32 on a 2x2x2 ("pod", "data",
# "model") mesh of 8 gloo ranks sharing the card: PH_STEPS steps, then one
# step at PH_MB microbatches hoisted and one not, of PH_BATCH x PH_SEQ;
# mamba2-130m at its published width cut to the depth ph_depth reckons,
# reduced granite-3-2b and qwen2-moe-a2.7b (whose router loss spans pods)
PH_SHAPE = {"pod": 2, "data": 2, "model": 2}
PH_STEPS, PH_MB, PH_BATCH, PH_SEQ = 2, 2, 8, 64
PH_FULL, PH_REDUCED = "mamba2-130m", ["granite-3-2b", "qwen2-moe-a2.7b"]
# the reckoning of mamba2's depth: a rank's blocks of the BSQ state at 216
# bytes per quantised parameter (9 planes of wp and wn in f32, their SGD
# moments and their gradients; a pod holds a copy of every block), times the
# peak the caching allocator reserved over that state on 6h's own ranks
# (9.852 GB a rank against 5.335 GB of state at 16 layers on an H100 80GB
# HBM3, whose 8 ranks and this process then used 82.26 GB of the card),
# plus a CUDA context a rank; the 8 ranks within PH_CARD_SHARE of the
# card's free bytes as 6h starts, the rest (4 GB) kept for the spread of
# the allocator's reserve from run to run
PH_BYTES_PER_PARAM = 216
PH_PEAK_OVER_STATE = 9_852_420_096 / 5_334_958_080
PH_CONTEXT_BYTES = 0.6e9
PH_CARD_SHARE = 0.95


def ph_depth(free_bytes):
    """The reckoning of mamba2-130m's depth on the pod mesh: (layers, a
    dict of its terms).  The greatest depth whose 8 ranks' predicted peak
    fits PH_CARD_SHARE of ``free_bytes``."""
    import math

    import torch

    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.core import bsq as bsq_mod
    from repro_torch.dist import sharding
    from repro_torch.models import transformer

    cfg = get_config(PH_FULL)
    view = SimpleNamespace(shape=PH_SHAPE, coords={ax: 0 for ax in PH_SHAPE})

    def rank_params(n_layers):  # quantised params of a rank's blocks, and of the whole
        params = transformer.init_params(cfg.scaled(n_layers=n_layers), torch.Generator(),
                                         "meta")
        qp, _ = bsq_mod.partition_params(params, bsq_mod.default_quant_predicate)
        local = sum(math.prod(sharding.local_shape(x.shape, sharding.param_spec(
            k, tuple(x.shape), view), view)) for k, x in qp.items())
        return local, sum(x.numel() for x in qp.values())

    (one, one_whole), (two, _) = rank_params(1), rank_params(2)
    per_layer, fixed = two - one, one - (two - one)

    def ranks_bytes(n_layers):
        state = PH_BYTES_PER_PARAM * (fixed + n_layers * per_layer)
        return 8 * (PH_PEAK_OVER_STATE * state + PH_CONTEXT_BYTES), state

    budget = PH_CARD_SHARE * free_bytes
    layers = max([n for n in range(1, cfg.n_layers + 1) if ranks_bytes(n)[0] <= budget],
                 default=1)
    full_total, full_state = ranks_bytes(cfg.n_layers)
    return layers, {
        "quantised_params_per_rank_fixed": fixed, "per_layer": per_layer,
        "state_per_rank_bytes": ranks_bytes(layers)[1], "predicted_total_bytes":
        ranks_bytes(layers)[0], "budget_bytes": budget,
        "full_depth_state_per_rank_bytes": full_state, "full_depth_total_bytes": full_total,
        "full_depth_state_all_ranks_bytes": 8 * full_state, "layers": layers,
        "published_layers": cfg.n_layers}


def _ph_cfg(arch, depth):
    from repro_torch.configs import get_config, reduced_config

    cfg = get_config(arch).scaled(n_layers=depth) if arch == PH_FULL else reduced_config(arch)
    return cfg.scaled(dtype="float32", kv_cache_dtype="float32")


def _ph_batches(cfg, dev, mesh=None):
    """PH_STEPS batches, then the two microbatched ones: MarkovLM tokens of
    the seed-13 chain, this rank's rows on ``mesh`` (in microbatch order for
    the last two)."""
    from repro_torch.data import MarkovLM, sharded_lm_iterator

    def rows(microbatches):
        return sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), PH_BATCH, PH_SEQ,
                                   device=dev, sharding=mesh, microbatches=microbatches)

    one, split = rows(1), rows(PH_MB)
    out = [next(one) for _ in range(PH_STEPS)]
    return out + [next(split) for _ in range(PH_STEPS + 2)][PH_STEPS:]


def _ph_steps(state, ctx, batches, mesh=None, on_step=None):
    """PH_STEPS steps, then one at PH_MB microbatches hoisted and one not;
    (state, metrics, step seconds); ``on_step(i)`` after step i."""
    import torch

    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train import make_bsq_train_step

    lr = step_decay(0.2, [PH_STEPS])
    steps = [make_bsq_train_step(ctx, SGDM(), lr, mesh=mesh)] * PH_STEPS + [
        make_bsq_train_step(ctx, SGDM(), lr, mesh=mesh, microbatches=PH_MB,
                            hoist_reconstruct=hoist) for hoist in (True, False)]
    metrics, dts = [], []
    for i, (step, b) in enumerate(zip(steps, batches)):
        t0 = time.perf_counter()
        state, m = step(state, b)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if on_step is not None:
            on_step(i)
    return state, metrics, dts


def _ph_dry_config_collectives(mesh):
    """One step of the dry run's train config (launch.dryrun.build_train_cell)
    of reduced granite-3-2b at PH_BATCH x PH_SEQ on this rank's blocks,
    under the counter: its collective bytes by kind."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.core import BSQConfig
    from repro_torch.data import MarkovLM, sharded_lm_iterator
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.roofline import analysis
    from repro_torch.train import init_bsq_state, make_bsq_train_step

    cfg = reduced_config("granite-3-2b")
    state, ctx = init_bsq_state(torch.Generator(device=mesh.device).manual_seed(0), cfg,
                                BSQConfig(n_init=8, alpha=5e-3, mode="static"), SGDM(),
                                mesh=mesh)
    step = make_bsq_train_step(ctx, SGDM(), step_decay(0.1, [10_000, 20_000]), mesh=mesh)
    b = next(sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), PH_BATCH, PH_SEQ,
                                 sharding=mesh))
    with analysis.Counter() as counter:
        step(state, b)
    torch.cuda.synchronize(mesh.device)
    return dict(counter.collectives)


def pod_train_rank(mesh, depth):
    """Phase 6h on one rank of the 2x2x2 mesh, model by model: the steps on
    its blocks (launches, collectives and seconds per step, peak), its
    bgl_sumsq launch against the plain version on its own rows, the state's
    fingerprints; for granite its export served through one bucketed
    decode (the kernels' shapes recorded); last the dry-run config's
    collective bytes of one step."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core.bsq import export_packed_blocks
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import ref
    from repro_torch.optim import SGDM
    from repro_torch.train import init_bsq_state, state_reps
    from repro_torch.tree import flatten_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    regularizer = importlib.import_module("repro_torch.core.regularizer")
    dev = mesh.device
    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    for arch in [PH_FULL] + PH_REDUCED:
        cfg = _ph_cfg(arch, depth)
        r = {}
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, ctx = init_bsq_state(torch.Generator(device=dev).manual_seed(0), cfg,
                                    _mt_bsq_cfg(), SGDM(), mesh=mesh)
        torch.cuda.synchronize(dev)
        r["init_s"] = time.perf_counter() - t0
        batches = _ph_batches(cfg, dev, mesh)
        _reset_launches()
        mesh.collectives = 0
        counts = []
        state, r["metrics"], r["step_s"] = _ph_steps(
            state, ctx, batches, mesh, lambda i: counts.append(mesh.collectives))
        r["launches"] = _launch_counts()
        r["collectives_per_step"] = [b - a for a, b in zip([0] + counts, counts)]
        r["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        r["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(dev)
        free, total = torch.cuda.mem_get_info(dev)  # the whole card: every rank, the parent
        r["card_used_bytes"] = total - free
        reps = state_reps(state, ctx)
        xs = [regularizer._rows(getattr(rp, k), rp.group_axes) for k in ("wp", "wn")
              for rp in reps.values()]
        got, want = bgl.bgl_sumsq_grouped_cuda(xs), ref.bgl_sumsq_grouped_ref(xs)
        g = torch.rand(got.shape, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
        grads = bgl.bgl_sumsq_grouped_backward_cuda(xs, g)
        gs = torch.split(g, [x.shape[0] for x in xs])
        r["bgl"] = {"rows": sum(x.shape[0] for x in xs),
                    "max_rel_err": float(((got - want).abs() / want.clamp_min(1e-30)).max()),
                    "max_abs_err": float((got - want).abs().max()),
                    "backward_bitwise": all(torch.equal(a, ref.bgl_sumsq_grad_ref(x, gi))
                                            for a, x, gi in zip(grads, xs, gs))}
        del xs, got, want, g, grads, gs
        r["fingerprints"] = {n: _mt_fingerprint(x) for n, x in flatten_with_path(state)}
        if arch == "granite-3-2b":  # its export, served on the 8 ranks
            shapes = {k: tuple(x.shape) for k, x in flatten_with_path(ctx.template)}
            packed = export_packed_blocks(reps, mesh, shapes)
            served = _mt_served(packed, reps, state, ctx)
            kernel_shapes, unrecord = _record_kernel_shapes()
            _reset_launches()
            try:
                engine = checked_engine_cls()(served, cfg, max_len=64, mesh=mesh, placed=True)
                with contextlib.redirect_stdout(io.StringIO()):
                    res = engine.generate(_mt_requests(cfg))
            finally:
                unrecord()
            r["serve_launches"] = _launch_counts()
            r["tokens"] = np.stack([x.tokens for x in sorted(res, key=lambda x: x.uid)]).tolist()
            r["bad"] = int(engine.bad.item())
            r["kernel_shapes"] = {k: sorted(v, key=str) for k, v in kernel_shapes.items()}
            del engine, served, packed
        del reps, state, batches
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = r
    out["dry_config_collectives"] = _ph_dry_config_collectives(mesh)
    return out


def pod_train_phase(dev, card, time_ms):
    """Phase 6h: BSQ training on a 2x2x2 ("pod", "data", "model") mesh, 8
    gloo ranks sharing the card, f32: mamba2-130m at its published width
    cut to ph_depth's reckoning (printed), reduced granite-3-2b and
    qwen2-moe-a2.7b; PH_STEPS steps, then one at PH_MB microbatches
    hoisted and one not.  Per rank and model exactly PH_STEPS + 1 + PH_MB
    bgl_sumsq launches and as many backward (the hoisted step's regulariser
    once, the other's once a microbatch) and no serving kernel, the kernel
    on its own rows against its plain version; after the ranks exit one
    process runs the same steps on the whole batches: losses and sampled
    state by 6g's bars (_mk_held).  granite's export served on the 8 ranks
    gives one process's tokens; bitserial and flash against their plain
    versions at every shape the ranks gave them.  Each rank's collective
    bytes of one step of the dry run's train config equal the dry run's
    meta count of rank 0 on 2x2x2 exactly."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, reduced_config
    from repro_torch.core import export_packed
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.optim import SGDM
    from repro_torch.train import init_bsq_state, state_reps
    from repro_torch.tree import flatten_with_path

    gc.collect()
    torch.cuda.empty_cache()
    depth, reck = ph_depth(torch.cuda.mem_get_info(dev)[0])
    print(f"[6h] the reckoning of {PH_FULL}'s depth on 2x2x2: {reck['per_layer']:,} quantised "
          f"params a layer and {reck['quantised_params_per_rank_fixed']:,} beside the layers "
          f"on a rank, x {PH_BYTES_PER_PARAM} B (planes, moments, gradients); at its "
          f"{reck['published_layers']} layers "
          f"{reck['full_depth_state_per_rank_bytes'] / 1e9:.2f} GB of state a rank, "
          f"{reck['full_depth_state_all_ranks_bytes'] / 1e9:.1f} GB on the 8 ranks (the pod axis "
          f"holds a second copy), {reck['full_depth_total_bytes'] / 1e9:.1f} GB with the "
          f"allocator's reserved peak over state ({PH_PEAK_OVER_STATE:.3f}) and "
          f"{PH_CONTEXT_BYTES / 1e9:.1f} GB of CUDA context a rank; the greatest depth within "
          f"{PH_CARD_SHARE:.0%} of the card's free bytes ({reck['budget_bytes'] / 1e9:.1f} GB): "
          f"{depth} layers, predicted "
          f"{reck['predicted_total_bytes'] / 1e9:.1f} GB [{card}]", flush=True)
    archs = [PH_FULL] + PH_REDUCED
    rep = {"mesh": [2, 2, 2], "steps": PH_STEPS, "microbatches": PH_MB,
           "batch": [PH_BATCH, PH_SEQ], "depth": depth, "reckoning": reck,
           "parent_reserved_bytes": torch.cuda.memory_reserved(dev)}
    t0 = time.perf_counter()
    ranks = run_on_mesh(pod_train_rank, 2, 2, pod=2, backend="gloo", device=dev,
                        args=(depth,))
    rep["ranks_wall_s"] = time.perf_counter() - t0
    check([tuple(r["coords"].values()) for r in ranks]
          == [(p, d, m) for p in range(2) for d in range(2) for m in range(2)],
          f"[6h] rank coordinates {[r['coords'] for r in ranks]}")
    n = PH_STEPS + 1 + PH_MB
    fails = []

    def soft(ok, what):
        if not ok:
            print(f"chip_smoke: {what}", flush=True)
            fails.append(what)

    rep["models"] = {}
    for arch in archs:
        tag = f"[6h] {arch}"
        for r in ranks:
            la, b = r[arch]["launches"], r[arch]["bgl"]
            check(la["bgl_sumsq"] == la["bgl_sumsq_backward"] == n
                  and la["bitserial_matmul"] == la["flash_attention"] == la["paged_attention"] == 0,
                  f"{tag} rank {r['rank']}: launches {la}, expected {n} + {n} bgl_sumsq "
                  f"({PH_STEPS} steps, the hoisted step's 1, the other's {PH_MB}) and no other")
            check(b["max_rel_err"] <= BGL_TOL and b["backward_bitwise"],
                  f"{tag} rank {r['rank']}: bgl_sumsq on its rows vs plain {b}")
        cfg = _ph_cfg(arch, depth)
        state, ctx = init_bsq_state(torch.Generator(device=dev).manual_seed(0), cfg,
                                    _mt_bsq_cfg(), SGDM(), dev)
        zero = {name for name, x in flatten_with_path(state) if not bool(x.any())}
        state, want, t_one = _ph_steps(state, ctx, _ph_batches(cfg, dev))
        worst, rows, worst_state, worst_moment = _mk_held(tag, ranks, arch, want, state, zero,
                                                          PH_SHAPE, soft)
        r0 = ranks[0][arch]
        m = {"loss_max_rel_err": worst, "state_max_err_of_max": worst_state,
             "moment_max_err_of_max": worst_moment, "state_worst_leaves": rows[:3],
             "step_s": [r[arch]["step_s"] for r in ranks], "one_process_step_s": t_one,
             "collectives_per_step": r0["collectives_per_step"],
             "peak_bytes": [r[arch]["peak_bytes"] for r in ranks],
             "peak_reserved_bytes": [r[arch]["peak_reserved_bytes"] for r in ranks],
             "card_used_bytes": max(r[arch]["card_used_bytes"] for r in ranks),
             "init_s": [r[arch]["init_s"] for r in ranks],
             "launches_per_rank": {r["rank"]: r[arch]["launches"] for r in ranks},
             "bgl_rows_per_rank": r0["bgl"]["rows"],
             "bgl_max_rel_err": max(r[arch]["bgl"]["max_rel_err"] for r in ranks),
             "bgl_max_abs_err": max(r[arch]["bgl"]["max_abs_err"] for r in ranks),
             "metrics": r0["metrics"], "one_process_metrics": want}
        if arch == "granite-3-2b":  # the export served: tokens against one process's
            served = _mt_served(export_packed(state_reps(state, ctx)), state_reps(state, ctx),
                                state, ctx)
            res = checked_engine_cls()(served, cfg, max_len=64, device=dev).generate(
                _mt_requests(cfg))
            one_tokens = np.stack([x.tokens for x in sorted(res, key=lambda x: x.uid)]).tolist()
            for r in ranks:
                g = r[arch]
                check(g["bad"] == 0 and g["tokens"] == one_tokens
                      and g["serve_launches"]["bitserial_matmul"] > 0
                      and g["serve_launches"]["flash_attention"] > 0,
                      f"{tag} rank {r['rank']}: served tokens {g['tokens']} vs one process "
                      f"{one_tokens}, bad {g['bad']}, launches {g['serve_launches']}")
            m["tokens"], m["serve_launches"] = one_tokens, r0["serve_launches"]
            del served, res
        del state, ctx
        gc.collect()
        torch.cuda.empty_cache()
        rep["models"][arch] = m
        print(f"{tag} ({cfg.n_layers} layers, d_model {cfg.d_model}): s per step per rank "
              f"(rank 0; {PH_STEPS} steps, then microbatches {PH_MB} hoisted and not) "
              f"{[round(x, 3) for x in r0['step_s']]}, one process "
              f"{[round(x, 3) for x in t_one]}; collectives per step "
              f"{r0['collectives_per_step']}; peak per rank {max(m['peak_bytes']) / 1e9:.2f} "
              f"GB allocated, {max(m['peak_reserved_bytes']) / 1e9:.2f} GB reserved, the card "
              f"{m['card_used_bytes'] / 1e9:.1f} GB used after the steps; losses within {worst:.2e} of one process (ce {want[-1]['ce']:.5f}, aux "
              f"{want[-1]['aux']:.5f}); sampled state within {worst_state:.2e} and moments "
              f"{worst_moment:.2e} of each block's max; bgl_sumsq {n} + {n} launches per rank "
              f"on its {r0['bgl']['rows']} rows, within {m['bgl_max_rel_err']:.2e} of plain, "
              f"backward bitwise [{card}]", flush=True)
    check(not fails, f"[6h] {len(fails)} checks failed: {fails[:6]}")
    g0 = rep["models"]["granite-3-2b"]
    print(f"[6h] granite-3-2b's export served on the 8 ranks: tokens {g0['tokens'][0]} equal "
          f"one process's on every rank; launches per rank {g0['serve_launches']} [{card}]",
          flush=True)
    # bitserial and flash at every shape the ranks gave them
    seen = {k: {tuple(x) for r in ranks for x in r["granite-3-2b"]["kernel_shapes"][k]}
            for k in ("bitserial", "flash")}
    check(seen["bitserial"] and seen["flash"], f"[6h] kernel shapes seen: {seen}")
    gen = torch.Generator(device=dev).manual_seed(23)
    held = {"bitserial": [bitserial_case(dev, gen, card, time_ms, M, K, N, g, getattr(torch, dt),
                                         timed=False)
                          for M, K, N, dt, g in sorted(seen["bitserial"], key=str)],
            "flash": [_kinds_flash_case(dev, *sh) for sh in sorted(seen["flash"], key=str)]}
    for k, rs in held.items():
        worst = max(x["max_abs_err"] / max(x["max_abs_plain"], 1e-30) for x in rs)
        print(f"[6h] {k} against its plain version at the {len(rs)} shapes the 2x2x2 ranks gave "
              f"it ({sorted(seen[k], key=str)[:4]}...): every one within tolerance; the worst "
              f"relative error {worst:.3e} [{card}]", flush=True)
    rep["kernels_at_rank_shapes"] = held
    # the live collective bytes against the dry run's meta count
    meta = dict(dryrun.run_meta(reduced_config("granite-3-2b"),
                                ShapeConfig("pod_smoke", PH_SEQ, PH_BATCH, "train"), "bsq", 1,
                                mesh_shape=PH_SHAPE)[0].collectives)
    for r in ranks:
        check(r["dry_config_collectives"] == meta,
              f"[6h] rank {r['rank']}: live collective bytes {r['dry_config_collectives']} != "
              f"the dry run's meta count {meta}")
    rep["collective_bytes_one_step"] = meta
    print(f"[6h] one step of the dry run's train config (reduced granite-3-2b, {PH_BATCH} x "
          f"{PH_SEQ}) on each of the 8 ranks: collective bytes by kind "
          f"{ {k: v for k, v in meta.items() if v} } == the dry run's meta count of rank 0 on "
          f"2x2x2, exactly; ranks' wall {rep['ranks_wall_s']:.1f} s [{card}]", flush=True)
    rep["launches"] = {k: sum(r[a]["launches"][k] for r in ranks for a in archs)
                       for k in ("bgl_sumsq", "bgl_sumsq_backward")}
    rep["serve_launches"] = {k: sum(r["granite-3-2b"]["serve_launches"][k] for r in ranks)
                             for k in ("bitserial_matmul", "flash_attention")}
    return rep


def kernel_entries(report, max_err):
    """The {"kernels": [...]} entries: each kernel's time at its main
    path's shapes (phases 2-2d) beside its bound, its plain version and
    the library call, and its launches on the main path (phases 4-6)."""
    # one decode layer's 7 projections at the decode shape (M = 4 lanes, bf16)
    layer = layer_rows(report, 4, LAYER_PROJ)
    lb = sum(r["bound_ms"] for r in layer)
    entry = {
        "name": "bitserial_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
        "replaces": "src/repro/kernels/bitserial_matmul.py:139",
        "launches": report["slice"]["launches"], "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in layer), "plain_ms": sum(r["plain_ms"] for r in layer),
        "active_ms": sum(r["active_ms"] for r in layer),
        "bound_ms": lb, "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in layer)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in layer),
        "work": "one decode layer of granite-3-2b: its 7 projections at M=4, bf16, 6 bits",
    }
    entry["vs_library"] = entry["ms"] / entry["library_ms"]
    # the runtime plane-count path (bitserial_matmul_pallas_dyn): the same
    # kernel reading `active` from device memory, launched on phase 4d's
    # tiered decode dispatches and draft steps; timed per layer at the M
    # of those calls (8 lanes) in bf16, beside the static kernel, and at
    # the verify chunk's M 32 and at M 40
    al = report["active_layers"]
    m8 = al[SLOTS]
    d_entry = {
        "name": "bitserial_matmul_dyn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
        "replaces": "src/repro/kernels/bitserial_matmul.py:183",
        "launches": report["policies"]["tiers"]["active_launches"]
        + report["policies"]["spec"]["active_launches"],
        "launches_tiers": report["policies"]["tiers"]["active_launches"],
        "launches_spec": report["policies"]["spec"]["active_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in report["active"]),
        "ms": m8["active_ms"], "static_ms": m8["ms"], "active3_ms": m8["active3_ms"],
        "static3_ms": m8["static3_ms"], "plain_ms": m8["plain_ms"],
        "bound_ms": m8["bound_ms"], "bound_by": m8["bound_by"], "library_ms": m8["library_ms"],
        "vs_library": m8["active_ms"] / m8["library_ms"],
        "by_M": {str(M): al[M] for M in ACTIVE_M},
        "work": f"one granite-3-2b layer's 7 projections at M={SLOTS} (8 lanes), bf16, 6 bits, "
                f"active={N_BITS} read from the device (static: the same calls without it)",
    }

    # the prefill tile (wgmma) at gemma3-12b's 2 x 4096-token bucket; its
    # launches are the bucketed run's prefill calls (phase 4c)
    pre = layer_rows(report, 8192, GEMMA3_PROJ)
    pre_ms = sum(r["ms"] for r in pre)
    pre_entry = {
        "name": "bitserial_matmul_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
        "replaces": "src/repro/kernels/bitserial_matmul.py:139",
        "launches": report["gemma3"]["bucketed"]["bitserial_prefill_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in pre),
        "ms": pre_ms, "plain_ms": sum(r["plain_ms"] for r in pre),
        "bound_ms": sum(r["bound_ms"] for r in pre),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in pre)
        else "bytes",
        "library_ms": sum(r["library_ms"] for r in pre),
        "vs_library": pre_ms / sum(r["library_ms"] for r in pre),
        "tflops": sum(2.0 * r["M"] * r["K"] * r["N"] for r in pre) / (pre_ms * 1e-3) / 1e12,
        "work": "one gemma3-12b layer's 7 projections at its 2 x 4096-token prefill: M=8192, "
                "bf16, 6 bits, the wgmma tile",
    }
    p_row = next(r for r in report["paged"] if r["dtype"] == "bfloat16" and r["window"] is None
                 and r["d"] == 64)
    p_entry = {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:97",
        "launches": report["continuous"]["paged_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in report["paged"]),
        "ms": p_row["ms"], "plain_ms": p_row["plain_ms"], "bound_ms": p_row["bound_ms"],
        "bound_by": p_row["bound_by"], "library_ms": p_row["library_ms"],
        "vs_library": p_row["ms"] / p_row["library_ms"],
        "work": "one paged decode layer of the continuous slice: 8 lanes (2 inactive), 8 KV "
                "heads x 4 query heads, d=64, bf16, blocks of 32 rows, 16 table entries per "
                f"lane, {p_row['live_rows']} live rows",
    }
    # gemma3-12b's global layer (phase 4c's paged launches), beside it
    g_row = next(r for r in report["paged"] if r["dtype"] == "bfloat16" and r["d"] == 256)
    p_entry.update({"ms_gemma3": g_row["ms"], "bound_ms_gemma3": g_row["bound_ms"],
                    "library_ms_gemma3": g_row["library_ms"],
                    "vs_library_gemma3": g_row["ms"] / g_row["library_ms"]})
    entry["launches_continuous"] = report["continuous"]["bitserial_launches"]

    entry["launches_bsq_serve"] = report["bsq"]["serve_bitserial_launches"]
    entry["launches_gemma3"] = report["gemma3"]["bucketed"]["bitserial_launches"]
    p_entry["launches_gemma3"] = report["gemma3"]["continuous"]["paged_launches"]
    # the grouped kernels (phase 2c) at one BSQ step's regulariser call of
    # the training slice (phase 6's launches), of the paper pipeline (6c),
    # of reduced qwen2-moe (3f) and of train_lm_bsq (6d)
    grp = {r["group"]: r for r in report["bgl_grouped"]}
    lm, rn, qm = grp["granite-step"], grp["resnet20-step"], grp["qwen2-moe-reduced"]
    lm100 = grp["lm-100m-step"]
    b_entry = {
        "name": "bgl_sumsq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bgl_sumsq.cu",
        "replaces": "src/repro/kernels/bgl_norm.py:40",
        "launches": report["bsq"]["launches"]["bgl_sumsq"],
        "backward_launches": report["bsq"]["launches"]["bgl_sumsq_backward"],
        "max_abs_err": max(r["max_abs_err"] for r in report["bgl"] + report["bgl_grouped"]),
        "max_rel_err": max(r["max_rel_err"] for r in report["bgl"] + report["bgl_grouped"]),
        **{k: lm["forward"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "per_view_ms")},
        "work": f"one grouped launch: the 16 plane views (wp and wn of 8 tensors) of one "
                f"BSQ train step of phase 6's {TRAIN_LAYERS}-layer full-width granite-3-2b, f32, "
                f"{4 * sum(r * c for r, c in BGL_STEP) / 1e9:.2f} GB; per_view_ms sums 16 "
                f"one-view calls; library_ms is one torch._foreach_norm over the "
                f"{sum(r for r, _ in BGL_STEP)} rows",
        "launches_resnet": report["paper"]["launches"]["bgl_sumsq"],
        **{f"{k}_resnet_step": rn["forward"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                          "library_ms", "per_view_ms")},
        "work_resnet": "one grouped launch: the 44 views of one BSQ step of ResNet-20 (width "
                       "16), wp and wn of its 22 tensors, (9, numel) each, f32, 19.5 MB",
        "launches_qwen2_moe_train": report["parity_moe"]["train"]["bgl_launches"],
        **{f"{k}_qwen2_moe_reduced": qm["forward"][k] for k in ("ms", "bound_ms",
                                                                "per_view_ms")},
        **{f"{k}_lm_100m_step": lm100["forward"][k] for k in ("ms", "bound_ms", "library_ms",
                                                              "per_view_ms")},
    }
    bb_entry = {
        "name": "bgl_sumsq_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bgl_sumsq.cu",
        "replaces": "src/repro/kernels/bgl_norm.py:40",
        "launches": report["bsq"]["launches"]["bgl_sumsq_backward"],
        "max_abs_err": max(r["backward_max_abs_err"] for r in report["bgl_grouped"]),
        **{k: lm["backward"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
        "work": f"the gradient 2 x g[row] of the 16 granite-3-2b views in one launch, f32, "
                f"{4 * sum(r * c for r, c in BGL_STEP) / 1e9:.2f} GB read and written; the "
                "gradient of kernel 4's function, which the JAX package leaves to "
                "autodiff; plain_ms is the per-view elementwise ops it "
                "replaces; library_ms is one torch._foreach_mul by (2 g)[:, None] per view",
        "launches_resnet": report["paper"]["launches"]["bgl_sumsq_backward"],
        **{f"{k}_resnet_step": rn["backward"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                           "library_ms")},
        **{f"{k}_lm_100m_step": lm100["backward"][k] for k in ("ms", "bound_ms", "library_ms")},
        "launches_qwen2_moe_train": report["parity_moe"]["train"]["bgl_backward_launches"],
    }
    # the training mesh (6f): each rank's grouped launches over its own
    # plane rows (a quarter of each tensor's), summed over the 4 ranks, and
    # the kernel at a rank's row shapes
    mt = report["mesh_train"]
    for e, key, way in ((b_entry, "bgl_sumsq", "forward"),
                        (bb_entry, "bgl_sumsq_backward", "backward")):
        e["launches_mesh_train"] = sum(la[key] for la in mt["launches_per_rank"].values())
        e["launches_mesh_train_per_rank"] = [la[key] for la in
                                             mt["launches_per_rank"].values()]
        for k in ("ms", "bound_ms", "library_ms", "plain_ms"):
            e[f"{k}_mesh_train_rank"] = mt["bgl_rank"][way][k]
        e["work_mesh_train"] = (f"a rank's {mt['bgl_rank']['views']} views on the 2x2 training "
                                f"mesh (its blocks of {MT_LAYERS}-layer full-width "
                                f"granite-3-2b's planes, "
                                f"f32, {mt['bgl_rank']['bytes'] / 1e9:.2f} GB), one launch per "
                                "regulariser call on each rank")
    # the other kinds' training mesh (6g): each rank's launches over its own
    # rows (the experts' (layer, expert) groups split over "model"), summed
    # over the 4 ranks and 5 models, and the kernel at a full-width
    # qwen2-moe rank's expert rows of one layer
    mk = report["mesh_kinds_train"]
    er = mk["expert_rows"]
    for e, key, way in ((b_entry, "bgl_sumsq", "forward"),
                        (bb_entry, "bgl_sumsq_backward", "backward")):
        e["launches_mesh_kinds_train"] = mk["launches"][key]
        for k in ("ms", "bound_ms", "library_ms", "plain_ms"):
            e[f"{k}_expert_rows"] = er[way][k]
        e["max_abs_err_expert_rows"] = er["max_abs_err" if way == "forward"
                                          else "backward_max_abs_err"]
        e["work_expert_rows"] = (f"a full-width qwen2-moe-a2.7b rank's expert rows of one "
                                 f"layer on the 2x2 mesh ({MK_EXPERT_BLOCKS}, 30 of 60 "
                                 f"experts, {MK_EXPERT_PLANES} planes, wp and wn: "
                                 f"{er['rows']} rows, f32, {er['bytes'] / 1e9:.2f} GB)")
    # one gemma3-12b prefill call's attention (phase 4c's layers: 5 windowed
    # launches to 1 causal) at B = 2, S = 4096 (bf16), the bucketed run's main path
    f_rows = {(r["case"], r["dtype"]): r for r in report["flash"]}
    glob, loc = f_rows[("gemma3-global", "bfloat16")], f_rows[("gemma3-local", "bfloat16")]
    gcfg = report["gemma3"]["bucketed"]
    n_win = gcfg["flash_windowed"] // 2
    n_glob = gcfg["flash_launches"] // 2 - n_win

    def per_prefill(key):
        return n_win * loc[key] + n_glob * glob[key]

    f_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": gcfg["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in report["flash"]),
        "ms": per_prefill("ms"), "plain_ms": per_prefill("plain_ms"),
        "bound_ms": per_prefill("bound_ms"),
        "bound_by": "operations" if glob["bound_by"] == loc["bound_by"] == "operations"
        else "bytes",
        "library_ms": per_prefill("library_ms"),
        "vs_library": per_prefill("ms") / per_prefill("library_ms"),
        "tflops_causal": glob["tflops"],
        "work": f"one gemma3-12b prefill call's attention: {n_win} windowed (1024) and "
                f"{n_glob} causal launches over 2 x 16 query heads / 2 x 8 K/V rows, S=4096, "
                "d=256, bf16",
        "launches_windowed": gcfg["flash_windowed"],
        "launches_granite": report["slice"]["flash_launches"],
    }
    # the MoE slices (phases 3f, 4e, 4f): their launches, and the kernels at
    # their shapes beside the bound and the library call
    moe, phi = report["qwen2_moe"], report["phi35_moe"]
    rows = {(r["M"], r["K"], r["N"]): r for r in report["matmul"]
            if r["dtype"] == "bfloat16" and r["scale"] == "per-tensor"}

    def moe_sum(M, proj, key):  # q, k, v and o of one layer at M
        return sum(rows[(M,) + kn][key] for kn in proj)
    q_proj, phi_proj = [QWEN2_PROJ] * 4, [PHI_PROJ[0], PHI_PROJ[1], PHI_PROJ[1], PHI_PROJ[0]]
    entry.update({
        "launches_qwen2_moe": moe["bucketed"]["bitserial_launches"]
        + moe["continuous"]["bitserial_launches"],
        "launches_phi35_moe": phi["bitserial_launches"],
        "work_moe": "q, k, v and o of one layer, and the head, at the decode M of the MoE "
                    "paths: qwen2-moe at 8 lanes, its head also at a bucket of 4; phi3.5-moe "
                    "at a bucket of 4",
    })
    for tag, M, proj, head in (("qwen2", SLOTS, q_proj, QWEN2_HEAD),
                               ("qwen2", 4, None, QWEN2_HEAD),
                               ("phi35", 4, phi_proj, PHI_HEAD)):
        for key in ("ms", "bound_ms", "library_ms"):
            if proj:
                entry[f"{key}_{tag}_layer_M{M}"] = moe_sum(M, proj, key)
            entry[f"{key}_{tag}_head_M{M}"] = rows[(M,) + head][key]
    for tag, M, proj in (("qwen2", 4096, q_proj), ("qwen2", 2048, q_proj),
                         ("phi35", 1024, phi_proj)):
        for key in ("ms", "bound_ms", "library_ms"):
            pre_entry[f"{key}_{tag}_layer_M{M}"] = moe_sum(M, proj, key)
    q_paged = next(r for r in report["paged"] if r["dtype"] == "bfloat16" and r["d"] == 128
                   and r["G"] == 1)
    p_entry.update({"launches_qwen2_moe": moe["continuous"]["paged_launches"],
                    "ms_qwen2": q_paged["ms"], "bound_ms_qwen2": q_paged["bound_ms"],
                    "library_ms_qwen2": q_paged["library_ms"]})
    q_flash = f_rows[("qwen2-moe-prefill", "bfloat16")]
    f_entry.update({"launches_qwen2_moe": moe["bucketed"]["flash_launches"],
                    "launches_phi35_moe": phi["flash_launches"],
                    "ms_qwen2": q_flash["ms"], "bound_ms_qwen2": q_flash["bound_ms"],
                    "library_ms_qwen2": q_flash["library_ms"]})
    # the recurrent slices (phases 3g, 4g, 4h): recurrentgemma-9b's launches,
    # a local layer's 7 projections at its decode M 8, and its windowed
    # flash launch (G 16, d 256) at the 2 x 4096-token bucket; mamba2-130m's
    # (none: 4h checks every count is 0)
    rg = report["recurrentgemma"]
    entry["launches_recurrentgemma"] = rg["bucketed"]["bitserial_launches"] \
        + rg["continuous"]["bitserial_launches"]
    entry["launches_recurrentgemma_parity"] = sum(
        r["launches"][0] for r in report["parity_recurrent"]["recurrentgemma-9b"].values()
        if isinstance(r, dict) and "launches" in r)
    for key in ("ms", "bound_ms", "library_ms", "plain_ms"):
        entry[f"{key}_recurrentgemma_local_layer_M8"] = sum(r[key] for r in
                                                            layer_rows(report, 8, RG_PROJ))
    entry["work_recurrentgemma"] = ("q, k, v, o and the GeGLU gate, up and down of one "
                                    "recurrentgemma-9b local layer at M 8 (8 lanes), bf16; "
                                    "k and v are 4096 x 256")
    r_flash = f_rows[("recurrentgemma-local", "bfloat16")]
    f_entry.update({"launches_recurrentgemma": rg["bucketed"]["flash_launches"],
                    "launches_recurrentgemma_windowed": rg["bucketed"]["flash_windowed"],
                    "ms_recurrentgemma": r_flash["ms"],
                    "bound_ms_recurrentgemma": r_flash["bound_ms"],
                    "library_ms_recurrentgemma": r_flash["library_ms"],
                    "plain_ms_recurrentgemma": r_flash["plain_ms"]})
    p_entry["launches_recurrentgemma"] = rg["continuous"]["paged_launches"]
    mb = report["mamba2"]
    for e, key in ((entry, "bitserial_launches"), (p_entry, "paged_launches"),
                   (f_entry, "flash_launches")):
        e["launches_mamba2"] = mb["bucketed"][key] + mb["continuous"][key]
    # the frontends (phases 3h, 4i, 4j): launches of the model API and the
    # engines; a decode layer's projections and the head at M 4 (a bucket of
    # 4); the cross K/V products on the prefill tile at M 1600 and 6400; the
    # paged kernel at musicgen's d 64 MHA; flash at both 4 x 1024 prefills
    lv, mg = report["llama_vision"], report["musicgen"]

    def api_launches(rep, i):
        return sum(m["launches_prefill"][i] + m["launches_decode"][i]
                   for m in rep["model_api"].values())
    entry["launches_llama_vision"] = api_launches(lv, 0) + lv["continuous"]["bitserial_launches"]
    entry["launches_musicgen"] = api_launches(mg, 0) + mg["bucketed"]["bitserial_launches"] \
        + mg["continuous"]["bitserial_launches"]
    entry["launches_frontend_parity"] = sum(
        r["launches"][0] for part in report["parity_frontend"].values()
        for r in part.values() if isinstance(r, dict) and "launches" in r)
    for tag, proj, head in (("llama_vision", VISION_PROJ, VISION_HEAD),
                            ("musicgen", MUSICGEN_PROJ, MUSICGEN_HEAD)):
        for key in ("ms", "bound_ms", "library_ms", "plain_ms"):
            entry[f"{key}_{tag}_layer_M4"] = sum(r[key] for r in layer_rows(report, 4, proj))
            entry[f"{key}_{tag}_head_M4"] = rows[(4,) + head][key]
    entry["work_frontends"] = ("one decode layer at M 4 (a bucket of 4), bf16: llama-3.2-vision"
                               "-11b's q, k, v, o and SwiGLU (7), musicgen-large's q, k, v, o "
                               "and GELU up and down (6); each head at M 4")
    pre_entry["launches_llama_vision"] = api_launches(lv, 1)
    for M in VISION_CROSS_M:
        r = rows[(M,) + VISION_CROSS_KV]
        for key in ("ms", "bound_ms", "library_ms", "plain_ms", "max_abs_err"):
            pre_entry[f"{key}_llama_vision_cross_kv_M{M}"] = r[key]
    pre_entry["work_llama_vision"] = ("one cross K or V projection of llama-3.2-vision-11b, "
                                      "4096 x 1024 over every cross token: M 1600 (a request) "
                                      "and 6400 (4 lanes), bf16; in prefill and at every "
                                      "decode step")
    m_paged = next(r for r in report["paged"] if r["dtype"] == "bfloat16" and r["d"] == 64
                   and r["G"] == 1)
    p_entry.update({"launches_llama_vision": lv["continuous"]["paged_launches"],
                    "launches_musicgen": mg["continuous"]["paged_launches"],
                    "ms_musicgen": m_paged["ms"], "bound_ms_musicgen": m_paged["bound_ms"],
                    "library_ms_musicgen": m_paged["library_ms"]})
    for tag, case in (("llama_vision", "llama-vision-prefill"), ("musicgen", "musicgen-prefill")):
        fr = f_rows[(case, "bfloat16")]
        f_entry.update({f"ms_{tag}": fr["ms"], f"bound_ms_{tag}": fr["bound_ms"],
                        f"library_ms_{tag}": fr["library_ms"], f"plain_ms_{tag}": fr["plain_ms"]})
    f_entry["launches_llama_vision"] = api_launches(lv, 2)
    f_entry["launches_musicgen"] = api_launches(mg, 2) + mg["bucketed"]["flash_launches"]
    # the mesh phase (4k): launches summed over its 4 ranks; the kernels at
    # a rank's per-shard shapes (one granite-3-2b layer's 7 projections at
    # M 4, bf16: q and o 1024 x 1024, k and v 1024 x 256, gate and up 1024
    # x 4096, down 4096 x 1024; paged over 4 lanes x 4 K/V heads; flash
    # over 2 lanes x 4 K/V heads of 4 queries, 128 tokens)
    mesh = report["mesh"]
    ml = mesh["launches"]
    shard_rows = {(r["M"], r["K"], r["N"], r["dtype"]): r
                  for r in mesh["kernels_at_shard_shapes"]["bitserial"] if "ms" in r}
    D, F_, KV = 2048, 8192, 512
    layer = [(D // 2, D // 2), (D // 2, KV // 2), (D // 2, KV // 2), (D // 2, D // 2),
             (D // 2, F_ // 2), (D // 2, F_ // 2), (F_ // 2, D // 2)]
    for key in ("ms", "bound_ms", "library_ms", "plain_ms"):
        for M in (MESH_BUCKET[0], MESH_BUCKET[0] * MESH_BUCKET[1]):
            entry[f"{key}_mesh_rank_layer_M{M}"] = sum(
                shard_rows[(M,) + kn + ("bfloat16",)][key] for kn in layer)
    entry["mesh_shapes_held_to_plain"] = len(mesh["kernels_at_shard_shapes"]["bitserial"])
    entry["launches_mesh"] = ml["bitserial_matmul"]
    entry["work_mesh"] = ("one rank's block of a granite-3-2b layer on the 2x2 mesh: its 7 "
                          "projections at M 4 (decode) and M 512 (bucketed prefill), bf16 (q, o "
                          "1024 x 1024; k, v 1024 x 256; gate, up 1024 x 4096; down 4096 x "
                          "1024)")
    d_entry["launches_mesh"] = ml["bitserial_active"]
    mp = next(r for r in mesh["kernels_at_shard_shapes"]["paged"] if r["dtype"] == "bfloat16")
    mf = next(r for r in mesh["kernels_at_shard_shapes"]["flash"] if r["dtype"] == "bfloat16")
    p_entry.update({"launches_mesh": ml["paged_attention"], "ms_mesh_rank": mp["ms"],
                    "bound_ms_mesh_rank": mp["bound_ms"], "library_ms_mesh_rank": mp["library_ms"],
                    "plain_ms_mesh_rank": mp["plain_ms"]})
    f_entry.update({"launches_mesh": ml["flash_attention"], "ms_mesh_rank": mf["ms"],
                    "bound_ms_mesh_rank": mf["bound_ms"], "library_ms_mesh_rank": mf["library_ms"],
                    "plain_ms_mesh_rank": mf["plain_ms"]})
    # the kinds' mesh phase (4l): launches summed over its 4 ranks and 5
    # models; the shapes the ranks gave each kernel, each held to its plain
    # version (the worst relative error)
    mk = report["mesh_kinds"]
    for e, key, rows in ((entry, "bitserial_matmul", "bitserial"),
                         (p_entry, "paged_attention", "paged"),
                         (f_entry, "flash_attention", "flash")):
        held = mk["kernels_at_shard_shapes"][rows]
        e["launches_mesh_kinds"] = mk["launches"][key]
        e["mesh_kinds_shapes_held_to_plain"] = len(held)
        e["mesh_kinds_max_rel_err"] = max(r["max_abs_err"] / max(r["max_abs_plain"], 1e-30)
                                          for r in held)
    f_entry["launches_mesh_kinds_windowed"] = mk["launches"]["flash_windowed"]
    # the pod mesh phase (6h): the grouped launches summed over its 8 ranks and
    # 3 models; the served export's bitserial and flash launches, and the
    # shapes the ranks gave them, each held to its plain version
    ph = report["pod_train"]
    b_entry["launches_pod_train"] = ph["launches"]["bgl_sumsq"]
    bb_entry["launches_pod_train"] = ph["launches"]["bgl_sumsq_backward"]
    for e, key, rows in ((entry, "bitserial_matmul", "bitserial"),
                         (f_entry, "flash_attention", "flash")):
        held = ph["kernels_at_rank_shapes"][rows]
        e["launches_pod_serve"] = ph["serve_launches"][key]
        e["pod_shapes_held_to_plain"] = len(held)
        e["pod_max_rel_err"] = max(r["max_abs_err"] / max(r["max_abs_plain"], 1e-30)
                                   for r in held)
    return [entry, d_entry, pre_entry, p_entry, b_entry, bb_entry, f_entry]


def main() -> int:
    try:
        return _main()
    finally:  # stop every process the script started
        for proc in BACKGROUND:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.roofline import hw

    global HBM_BYTES_PER_S, PEAK_FLOPS
    HBM_BYTES_PER_S = hw.HBM_BW
    PEAK_FLOPS = {"float32": hw.PEAK_FLOPS_F32, "bfloat16": hw.PEAK_FLOPS_BF16}

    from repro_torch.kernels import _build
    from repro_torch.kernels import bgl_sumsq as bgl
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    # ``--only 2d,3d`` runs those phases alone and prints no result line
    only = set(sys.argv[sys.argv.index("--only") + 1].split(",")) if "--only" in sys.argv \
        else None

    def want(phase):
        return only is None or phase in only

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    report = {"card": card, "matmul": []}
    t_start = time.perf_counter()

    def phase_done(name):
        at = time.perf_counter() - t_start
        report.setdefault("phase_done_s", {})[name] = at
        print(f"[time] phase {name} done at {at:.1f} s", flush=True)
        # as it goes: the end of a long run's output may not reach the caller
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_times.json").write_text(
            json.dumps(report["phase_done_s"], indent=1))

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    libs = _build.build_all(["bitserial_matmul", "paged_attention", "bgl_sumsq",
                             "flash_attention"])
    for m in (bsm, pa, bgl, fa):
        m._lib()
    print(f"[build] {', '.join(f'{n}.cu -> {p.name}' for n, p in libs.items())} in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel)", flush=True)
    for name in libs:
        for line in _build.build_log[name]["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")
    # the redesigned kernels keep every register array in registers
    for name in ("bitserial_matmul", "flash_attention", "paged_attention"):
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                            _build.build_log[name]["ptxas"])
        check(spills and all(s == ("0", "0") for s in spills),
              f"{name}.cu: ptxas reports spills (or nothing): {spills}")
    print("[build] bitserial_matmul, flash_attention, paged_attention: no spills in any kernel",
          flush=True)
    # ---------------------------------------------------- 2, 2b, 2c, 2d
    # > the 50 MB L2; freed after phase 2d, allocated again for 4k's kernel rows
    flush = [torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)]

    def time_ms(fn, iters=10, spin=500_000):
        """Median device time of fn with the L2 flushed before each call.

        A spin of the card (``spin`` cycles, about 0.25 ms by default)
        after the flush keeps the device busy until the host has queued
        the whole call, so the start event never waits on the host: a
        call of a few microseconds whose Python wrapper takes longer than
        the flush would otherwise time the host.  A call whose host side
        takes longer (a group of tens of views) asks for a longer spin."""
        fn()
        fn()
        times = []
        for _ in range(iters):
            flush[0].zero_()
            torch.cuda._sleep(spin)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    if want("2"):
        max_err = bitserial_kernel_phase(dev, card, time_ms, report)
        active_kernel_phase(dev, card, time_ms, report)
        phase_done("2")

    def median_ms(fn, repeats=PAGED_REPEATS):
        """The median of ``repeats`` time_ms runs, for calls of tens of us."""
        return float(np.median([time_ms(fn) for _ in range(repeats)]))

    if want("2b"):
        report["paged"] = paged_kernel_phase(dev, card, time_ms, median_ms)
        phase_done("2b")
    if want("2c"):
        bgl_kernel_phase(dev, card, time_ms, report)
        phase_done("2c")
    if want("2d"):
        report["flash"] = flash_kernel_phase(dev, card, time_ms)
        phase_done("2d")
    flush.clear()

    # ---------------------------------------------------------- 3, 3b-3h
    # phase 6e's dry runs run on the host beside these parity phases
    dry_jobs = start_pod_dryruns() if want("6e") else None
    if want("3"):
        cfg2, p_gpu, p_cpu = granite_parity(dev, card, report)
        report["parity"]["continuous_tokens"] = continuous_parity(cfg2, p_gpu, p_cpu, dev, card)
        del p_gpu, p_cpu
        phase_done("3, 3b")
    if want("3c"):
        report["train_parity"] = train_parity(dev, card)
        report["remat_parity"] = remat_parity(dev, card)
        phase_done("3c")
    if want("3d"):
        report["parity_gemma3"] = gemma3_parity(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("3d")
    if want("3e"):
        report["policies_parity"] = policies_parity(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("3e")
    if want("3f"):
        report["parity_moe"] = moe_parity(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("3f")
    if want("3g"):
        report["parity_recurrent"] = recurrent_parity(dev, card)
        phase_done("3g")
    if want("3h"):
        report["parity_frontend"] = frontend_parity(dev, card)
        phase_done("3h")
    dry_recs = None
    if dry_jobs:  # nothing timed runs beside them
        dry_recs = wait_pod_dryruns(dry_jobs)
        phase_done("the dry runs")

    # ---------------------------- 4, 4b, 5, 4d, 4c, 4e, 4f, 4g, 4h, 4i, 4j
    CheckedEngine = checked_engine_cls()
    if want("4"):
        cfg, params = granite_slice(dev, card, report, CheckedEngine)
        c_engine, c_reqs, report["continuous"] = continuous_slice(params, cfg, dev, card,
                                                                  CheckedEngine)
        report["profile_continuous"] = profile_continuous(c_engine, c_reqs, card)
        del c_engine, c_reqs
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("4, 4b, 5")
        report["policies"] = policies_slice(params, cfg, dev, card, CheckedEngine,
                                            report["continuous"]["result_tokens"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("4d")
    if want("4c"):
        report["gemma3"] = gemma3_slice(dev, card, CheckedEngine)
        gc.collect()  # its scheduler and engine refer to each other
        torch.cuda.empty_cache()
        phase_done("4c")
    if want("4e"):
        report["qwen2_moe"] = moe_slice(dev, card, CheckedEngine)
        phase_done("4e")
    if want("4f"):
        report["phi35_moe"] = phi_slice(dev, card, CheckedEngine)
        phase_done("4f")
    if want("4g"):
        report["recurrentgemma"] = recurrent_slice(dev, card, CheckedEngine,
                                                   "recurrentgemma-9b")
        phase_done("4g")
    if want("4h"):
        report["mamba2"] = recurrent_slice(dev, card, CheckedEngine, "mamba2-130m")
        phase_done("4h")
    if want("4i"):
        report["llama_vision"] = frontend_slice(dev, card, CheckedEngine, VISION)
        phase_done("4i")
    if want("4j"):
        report["musicgen"] = frontend_slice(dev, card, CheckedEngine, AUDIO)
        phase_done("4j")
    if want("4k"):
        flush.append(torch.empty(256 * 2**20, dtype=torch.uint8, device=dev))
        report["mesh"] = mesh_phase(dev, card, time_ms, median_ms)
        flush.clear()
        phase_done("4k")
    if want("4l"):
        report["mesh_kinds"] = kinds_mesh_phase(dev, card, time_ms)
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("4l")

    # ---------------------------------------------------------------- 6
    if want("6"):
        report["bsq"] = bsq_slice(dev, card)
        report["remat_memory"] = remat_memory(dev, card)
        phase_done("6")
    if want("6b"):
        report["resnet_parity"] = resnet_parity(dev, card)
        phase_done("6b")
    if want("6c"):
        report["paper"] = paper_slice(dev, card)
        phase_done("6c")
    if want("6d"):
        report["lm_examples"] = lm_examples(dev, card)
        phase_done("6d")
    if want("6e"):
        report["dryrun"] = dryrun_phase(dev, card, dry_recs)
        phase_done("6e")
    if want("6f"):
        flush.append(torch.empty(256 * 2**20, dtype=torch.uint8, device=dev))
        report["mesh_train"] = mesh_train_phase(dev, card, time_ms)
        flush.clear()
        phase_done("6f")
    if want("6g"):
        # the ranks need most of the card: nothing of the earlier phases stays
        gc.collect()
        torch.cuda.empty_cache()
        report["mesh_kinds_train"] = mesh_kinds_train_phase(dev, card, time_ms, flush)
        phase_done("6g")
    if want("6h"):
        report["pod_train"] = pod_train_phase(dev, card, time_ms)
        phase_done("6h")

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    if only is not None:
        (out / "chip_smoke_partial.json").write_text(json.dumps(report, indent=1))
        print(f"chip_smoke: partial run of phases {sorted(only)}; no result line")
        return 0

    # ---------------------------------------------------------------- 7
    report["kernels"] = kernel_entries(report, max_err)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print("[time] phases done at (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in report["phase_done_s"].items()), flush=True)
    print(json.dumps({"kernels": report["kernels"]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
