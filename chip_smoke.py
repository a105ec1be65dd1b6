"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives repro_torch only (no jax, nothing of the reference package) on the
card, with no CPU fallback, in thirty-two phases. Phases 29, 30 and 28 (while
emugemm2_planes.cu still compiles), phase 27 (each with nothing else
resident on the card), phase 26's walls and phases 20-23 run first, so
that every wall they take comes before the process's first
torch.profiler session, which is phase 31's (right after them);
phase 24 and phase 26's profiled steps and kernel times follow the
yardsticks, phase 25 follows phase 15 (on its DGEMM and ZGEMM operands),
and the others follow in their order:

1. build: nvcc compiles the port's CUDA kernels from this checkout (five
   sources), one process per source, all started together; phases 29,
   30 and 28, which need EmuGEMM-I alone, run while the longest,
   emugemm2_planes.cu, compiles (nvcc then shares the host's cores with
   their host-bound steps, so their walls are not those of an idle
   host);
2. kernel: every kernel of the serving path is held against its plain
   version bit for bit at the path's shapes (float32 and bfloat16; the
   2-D GEMMs on EmuGEMM-I's plane route at p in {3, 4, 6}, each of their
   encodes against its plain version too, and one GEMM whose top
   diagonal wraps int32; the batched kernel (attn_qk, attn_av), one
   launch a call, at p in {1, 3, 4, 6, 8} at the path's shapes of a mixed
   and a decode step, on ragged shapes, with B read as the key cache's
   transposed view and as the value cache's rows out of a longer buffer
   and A through its transpose, and on one product whose top diagonal
   wraps int32), and timed beside its bound: the 2-D route with its split
   (the encodes, the plane GEMM and its mainloop), the batched kernel at
   both of its tile heights;
3. serve: the continuous-batching engine serves 8 requests (prompt 48,
   16 new tokens, 4 lanes, chunk 16, page 16) on full-width olmo-1b with
   seeded random weights under ozaki1-p4; the kernels' launch counts are
   read around that run (each 2-D call two encodes and one plane GEMM),
   and request 0 served alone must give the same tokens as in the
   cohort;
4. parity: one full-width mixed step on the 'cuda' backend and on the
   'torch' backend (the plain versions) gives bit-identical logits;
5. profile: wall time of a mixed and a decode step under ozaki1-p4 and
   native, with the device-busy share, device time by kernel and host
   time by op from torch.profiler, the launch counts read around them;
6. train kernels: the training path's kernels are held against their
   plain versions bit for bit at the shapes of a train step of 8 x 128
   tokens (float32 and bfloat16, p in {3, 4, 6}): the weights' encodes
   into the 'planes' layout (a prep and its twin also read back through
   stacked() against the pair decomposition's slices), EmuGEMM-I's mixed
   route against the interleaved form's plain version, dB on the 2-D
   route, and the pair and rhs decompositions; each is timed beside its
   bound, the plane routes with their split;
7. train: full-width olmo-1b, AdamW, remat, under ozaki1-p4+cached on
   seeded synthetic batches of 8 x 128 tokens: one warm-up step and
   three timed ones, the launch counts read around them (mixed and 2-D
   calls, encodes and plane GEMMs, no decomposition), then three steps
   traced by torch.profiler (device activity only), then two steps at
   the published context of 2048 tokens (2 sequences);
8. train parity: under deterministic algorithms, one step's loss and
   every gradient leaf at full width are bit-identical on the 'cuda' and
   'torch' backends (at 8 x 128 and at 2 x 2048 tokens), cached and
   uncached, and cached and uncached with bwd_p = 3 (whose twins the
   encode writes at 3 slices);
9. trainer: launch/train.py at smoke size on the card fails at step 2,
   resumes, and ends in the state of an uninterrupted run, bit for bit;
   then a Trainer with handle_sigterm gets SIGTERM from a step hook inside
   step 1: the step finishes, its checkpoint is written, run returns, and
   a resumed Trainer ends in the uninterrupted run's state, bit for bit;
10. Scheme-II kernels: EmuGEMM-II's float-rhs form, 2-D and batched, on
    the plane route (two encodes and one plane GEMM a call) and its
    residue form (K5: a relayout of each operand a tensor map cannot read
    in place and one residue plane GEMM, all in emugemm2_planes.cu) are
    held against their plain versions bit for bit at
    the shapes of olmo-1b-emu's attention scores (serve; train at 8 x 128
    and 2 x 2048 tokens, forward and both backward transposes) and on a
    ragged shape, float32 and bfloat16, m in {4, 6, 8, 16}; at dB's
    shapes in a hoisted step (X^T read through its strides, the head's
    2048 x 50688 among them); in every operand pairing and output type;
    the encodes alone on transposed operands. K6 is timed per serve,
    train and 2 x 2048 step and dB per hoisted step, beside their bounds,
    with the encodes, the plane GEMM's mainloop (its int8 rate) and its
    CRT apart (dB at both tile widths); the library routes of the 2-D and
    residue forms (``dispatch.emulated_matmul`` and
    ``ops.fused_scheme2_matmul`` under ozaki2-m6, on olmo-1b's dense
    shapes at 1024 tokens) are driven with their counts read around them
    and timed with the same split;
11. emu serve: full-width olmo-1b-emu under its shipped gemm_sites
    (ozaki1-p4+cached, attn_qk ozaki2-m6, attn_av ozaki1-p4) serves the
    trace of phase 3; the launch counts of both kernels' modules are read
    around it (each Scheme-II call two encodes and one plane GEMM), and
    request 0 alone must match the cohort;
12. emu parity and profile: one full-width mixed step on 'cuda' and
    'torch' gives bit-identical logits; step walls and device time by
    kernel of a mixed and a decode step;
13. emu train: full-width olmo-1b-emu, one warm-up and three timed steps
    of 8 x 128 tokens, launch counts read around them, three more traced;
14. emu train parity: under deterministic algorithms one step's loss and
    every gradient leaf are bit-identical on 'cuda' and 'torch', and with
    2 microbatches the weights prepared once for the step (the hoist,
    through EmuGEMM-I's pair and mixed forms) give the float32 mean of
    the halves' per-call-cached gradients, bit for bit;
15. scientific GEMMs: the plane route of DGEMM and ZGEMM (the encode
    kernels and the TMA-fed wgmma plane GEMM, real and 3M, 2-D and with a
    batch coordinate, float32 operands to a float64 output among them)
    and the residue forms K7 and K5 (the relayout and the residue plane
    GEMM) are held against their plain versions bit for bit (complex64
    and complex128, m in {4, 8, 12, 16}; float64, m in {8, 12, 16};
    ragged, transposed, complex @ real, rows of tiny magnitude, 1024^3, K
    = 131200 across the plane GEMM's in-kernel reduction; K5 and K7 on
    full-range residues at M, N in {1, 17, 129, 300}, K in {1, 15, 16,
    127, 129, 4096}, moduli from 3 to 256, contiguous, B^T read in place,
    strided and offset, and an int32 sum that wraps); the front doors
    (``api.einsum`` on complex128, float64, a float64 batch and a
    complex128 batch, the residue routes of ``ops``, complex64 under
    ozaki1-p4) run with the launch counts read around them, and the
    float64 batch (8 x 512^3, m = 12) is timed beside cuBLAS's batched
    DGEMM with its encode / mainloop / CRT split; then DGEMM and ZGEMM at
    M = N = K = 4096 (m in {8, 12, 16}) and 8192 (m = 16) are timed
    beside their bounds, the plain versions, torch._int_mm and cuBLAS,
    with the encode, the mainloop (and its int8 rate) and the CRT
    epilogue timed apart, and the effective bits of the route and of
    cuBLAS against a longdouble product of 64 sampled rows on the host;
    K5 and K7 at 4096^3, m = 16, with their relayout / mainloop /
    epilogue split, and the ops routes that drive them;
16. prepared kernel: EmuGEMM-II's prepared form on the plane route (a
    float lhs encoded once, a plane GEMM against the weight's (p, N, Kp)
    int8 planes, which one encode launch wrote when it was prepared) is
    held against its plain version on the reference-layout stack and
    against the float-rhs form (both on the plane route) bit for bit at
    olmo-1b's train shapes
    (forward and dA at 1024 and 512 tokens, ragged M, N and K, the tied
    head), bf16 and float32 at m in {6, 8, 16}, float32 against a bf16
    weight and float64 at m = 16, with each call's launches counted, and
    timed per hoisted step (lhs encode, mainloop and CRT apart, and the
    weights' encodes) beside its bound, its plain version and the
    float-rhs form;
17. hoisted train: full-width olmo-1b under ozaki2-m6+cached with 2
    microbatches of 4 x 128 tokens: one warm-up and three timed steps
    with the launch counts by kernel form (prepared calls, dB and
    attention's float-rhs calls, encodes and plane GEMMs) and the
    prepare_rhs calls read around them (each weight prepared once a
    step), then three steps traced by torch.profiler
    (device activity only: idle share, top kernels);
18. hoisted train parity: under deterministic algorithms, one step's loss
    and float32 gradients with the hoisted preps equal the mean of the
    halves' per-call-cached ones, the uncached ozaki2-m6 ones, and those
    of the 'torch' backend, bit for bit.
19. library: the kernels no model reaches. EmuGEMM-I on interleaved
    operands (K8: a relayout of each operand into planes and one plane
    GEMM) and the decompositions (K11, K2r and K2) are held against their
    plain versions bit for bit at olmo-1b's dense shapes at 1024 tokens
    and a ragged shape (float32 and bfloat16, p in {3, 4, 6}; each
    relayout alone too), and K11 + K2r -> K8 and the 'xla' route of
    ``ops.fused_scheme1_matmul`` against K1; the int8 GEMM (K9: a
    relayout of each operand its tensor map cannot read in place and the
    plane GEMM's int32 instance) bit for bit at 4096^3, 1024 x 2048 x
    8192 and a ragged shape, B as a transposed view (no relayout), A
    misaligned (relaid) and an int32 sum that wraps; then the
    library's entry points run with the counts read around them: the
    'xla' route and the decompositions feeding K8 (K11 with K2r and with
    K2; bf16, p = 4), the naive Fig. 4 structure
    (p(p+1)/2 K9 launches) at 4096^3, which must equal K1, and fused
    attention (K10) at olmo-1b's heads (2 x 16 x 2048 x 128, causal, bf16
    and float32, and a window of 1024),
    granite-3-8b's GQA (32 / 8 heads), recurrentgemma-2b's MQA (10 / 1
    heads of 256 over 4096, window 2048, bf16 and float32) and a
    rectangular non-causal case (128 / 512, D 64), within 2e-5 (float32)
    and 2e-2 (bf16) of its plain version (bf16 on the TMA-fed wgmma
    kernel, float32 on the 3xTF32 wgmma kernel after its pre-pass, which
    is held bit for bit against its plain version, and on the FFMA kernel
    at D = 256); each kernel is timed beside its bound (the float32 ones
    also beside the FFMA bound, with the device kernels a call runs),
    its plain version and, for K9 and K10, torch._int_mm (its device
    kernel named from one profiler pass) and
    scaled_dot_product_attention; K8 with its relayouts, plane GEMM and
    mainloop apart, the relayouts beside one .contiguous() of the
    permuted interleaved views; K9 at 4096^3 and 8192^3 with B's
    relayout, the plane GEMM, its mainloop and both tile heights apart.
20. granite-3-8b serve: full width (40 layers, d 4096, 32 heads over 8 KV
    heads of 128, d_ff 12800, vocab 49155 padded to 49664, bf16, seeded
    random weights) under ozaki1-p4+cached: the continuous engine prepares
    the untied head once (one encode into planes), then serves phase 3's
    trace with one mixed call (K3: an lhs encode + one plane GEMM) a step
    for the logits, 2 encodes + 1 plane GEMM for every other dense GEMM
    and the batched kernel (K4) at 4 query heads a KV head, the launches
    of the run checked against those counts; tokens/s, TTFT p50, peak
    memory, mixed and decode step walls; request 0 alone == in its
    cohort; prepared == unprepared (the logits site's output in float32,
    which the prepared form returns before the cast to bf16) in tokens
    and in a mixed step's logits, bit for bit (against ozaki1-p4's bf16
    head epilogue the logits' difference and the trace's equal tokens are
    reported); one mixed step on the 'cuda' and 'torch' backends (each
    with its own head prep), bit for bit;
21. lockstep: LockstepEngine on granite-3-8b (head prepared) and olmo-1b,
    8 prompts of 48 tokens, 16 new, under ozaki1-p4 on both backends:
    tokens and prefill logits bit for bit, the launches of the prefill
    and of one decode step checked; prefill and decode step walls;
22. olmo-1b's trace served under ozaki1-p3, ozaki1-p6 and native: tok/s,
    each emulated spec's launches checked and request 0 alone == cohort;
23. deepseek-coder-33b at its published widths (d 7168, 56 heads over 8
    KV heads of 128, d_ff 19200, vocab 32256), 2 of its 62 layers: one
    lockstep generate with the head prepared, cuda == torch tokens and
    logits bit for bit;
24. granite kernels (after the first profiler session): a mixed and a
    decode step profiled (device-busy, idle share, top kernels), K3
    against the prepared head, K4 at g = 4 and K1 at granite's dense
    shapes against their plain versions and timed beside their bounds;
25. Scheme I wide: the float64 instances (the encode carving in float64
    with float64 scales, the plane GEMM's float64 output on its (128, 64)
    tile), p = 9..16 and the float16 output, held against their plain
    versions bit for bit (NaN where NaN): phase 15's float64 GEMM of
    4096^3 (paper Eq. 19 inputs) at p in {8, 12, 16}, the same rounded to
    float32 at p = 12, to bf16 at p = 10 and to float16 under ozaki1-p4,
    phase 15's complex128 ZGEMM under ozaki1-p8 (4M), a float64 batch of
    8 x 512^3 at p in {8, 16}
    (K4), the library paths K11 -> K2 -> K8 and K11 -> K2r -> K8 and a
    prepared float64 weight
    (K3, twin included) at olmo-1b's dense shapes at p = 12; each timed by
    CUDA events beside its bound, the route bound (p(p+1)/2 int8 GEMMs
    at the int8 peak plus the encodes' bytes), its plain version and
    cuBLAS (DGEMM, ZGEMM, batched DGEMM; torch.matmul in the narrow
    types), the DGEMM with its encode / plane GEMM / mainloop split, and
    the effective bits of the DGEMM and ZGEMM against phase 15's
    longdouble product of 64 sampled rows, beside cuBLAS's and Scheme
    II's at m = 16 there;
    then the front doors (einsum in each type, the batch, 4M, K11 -> K2 /
    K2r -> K8, prepare_rhs + emulated_dot_prepared with its backward) with
    the launches read around each;
26. qwen2-moe-a2.7b-emu (models/moe.py) at its published widths and depth
    (24 layers, d 2048, 16 heads of 128 with qkv bias, 60 routed experts
    padded to 64, top-4, expert d_ff 1408, 4 gated shared experts of
    5632, vocab 151936 padded to 152064, bf16; seeded random weights)
    under its gemm_sites (ozaki1-p4+cached, the experts ozaki1-p4 on K4,
    the router ozaki2-m6 on K5g, attn_qk ozaki2-m6, attn_av ozaki1-p4):
    the head prepared once, phase 3's trace served with every launch
    checked (a step: 168 2-D EmuGEMM-I calls, 1 K3, 96 K4, 24 K5g, 24
    K6), tokens/s, TTFT p50, step walls, peak memory; request 0 alone ==
    in its cohort; one mixed step on 'cuda' and 'torch' bit for bit;
    LockstepEngine on qwen2-moe-a2.7b under ozaki1-p4+cached (8 x 48, 16
    new: prefill and decode step walls, launches, prefill logits cuda ==
    torch); 2 of the 24 layers trained at full width with the config's
    2 microbatches (a warm-up and 2 timed steps of 8 x 128 tokens, one of
    2 x 2048, where groups of 4 tokens drop slots), and under strict
    deterministic algorithms the loss and every gradient leaf on 'cuda'
    and 'torch' bit for bit at both sizes; after the yardsticks, a mixed
    and a decode step profiled (idle share, device and host time by
    kernel and op), K4 at the expert stacks (64, 4 and 384 rows; dense
    and mostly-zero rows) and K5g at the router's shapes against their
    plain versions bit for bit, each timed with K1, K3 and K6 at a step's
    shapes beside its bound and torch.bmm / torch.matmul in bf16 and
    float32.

27. qwen1.5-32b at its published widths and depth (64 layers, d 5120,
    40 heads over 40 KV heads of 128 with qkv bias, d_ff 27392, vocab
    152064, bf16, 35.2 B parameters drawn on the card; the int8 KV
    cache): phase 3's trace served under ozaki1-p4+cached with the head
    prepared once (every launch checked: 448 2-D EmuGEMM-I calls, 1 K3,
    128 K4 a step) and under native: tok/s, TTFT p50, step walls, peak
    memory; request 0 alone == in its cohort, tokens and int8 pool rows
    bit for bit; LockstepEngine on the head-prepared weights (8 x 48, 16
    new: prefill and decode walls, launches; layer 0's int8 cache rows
    == the continuous engine's pool rows); 2 of its 64 layers at full
    width, one mixed step on 'cuda' and 'torch' (each with its own head
    prep): logits and int8 caches bit for bit; quantize_kv on the card
    == on the CPU; K1, K3, K4 and K10 at its shapes against their plain
    versions, timed beside their bounds and the library calls; then
    Scheme II with float16 operands: K5g (float32 and float16 outputs),
    K6 and the prepared form with a float16 lhs, bit for bit (NaN where
    NaN) at olmo-1b's dense shapes, 4096^3 and two batches under
    ozaki2-m6, the front doors' launches counted, each timed behind a
    spin kernel beside its bound, its plain version and cuBLAS's HGEMM.
28. the rest of the zoo at its published widths and depth, one
    architecture at a time (each freed before the next): recurrentgemma-2b
    (26 layers, (rec, rec, attn) x 8 + (rec, rec), local attention over
    a 2048-row ring) and mamba2-780m (48 SSD layers) in LockstepEngine,
    4 prompts of 2304 and 2048 tokens (recurrentgemma's past its window:
    the prefill rotates the ring, the decode wraps it), 32 new, under
    ozaki1-p4+cached (the 2-D weights prepared once) and native;
    internvl2-1b's make_prefill_step on a pipeline batch of 4 x 2048
    with 256 projected image tokens, 32 make_decode_step steps, and a
    LockstepEngine text run; hubert-xlarge's encoder prefill step (a
    plain forward) on 2 x 2048 frames of 512 under ozaki1-p4+cached and
    native: prefill and decode walls, tok/s, TTFT, peak memory, launches
    by form a step; every EmuGEMM-I call signature of those steps (K1's
    route, K3, K4 at g = 10 and D = 256, at D = 80, and at the SSD
    decode's N = 1) on Eq. 19 operands of its shape, type and layout,
    bit for bit against its plain version and timed beside its bound
    and torch.matmul / torch.bmm; each architecture at full width and
    reduced depth (recurrentgemma-2b: a whole group and a tail block,
    its window shrunk so the ring rotates and wraps), float32 native on
    the card against the CPU port on the same weights, and bf16 under
    ozaki1-p4+cached on the 'cuda' and 'torch' backends, bit for bit.
29. deepseek-v3-671b (models/mla.py: Multi-head Latent Attention over a
    latent KV cache of 512 + 64 a token; 256 routed experts of 2048 by
    sigmoid with a selection-only router_bias, top-8, one shared
    expert; vocab 129280 padded to 129536; bf16) at its published widths,
    2 of its 61 layers and no MTP block (serving never reads it): 24.9 B
    parameters drawn on the card; phase 3's trace served under
    ozaki1-p4+cached with the untied head prepared once (every launch
    checked: a layer's 8 2-D EmuGEMM-I calls (wq_a, wq_b, wkv_a, wo, the
    float32 router, the shared expert's gate, up, down) and 3 K4 on the
    expert stacks, then 1 K3 for the head) and under native: tok/s, TTFT
    p50, step walls, peak memory; request 0 alone == in its cohort;
    LockstepEngine on the same weights (8 x 48, 16 new: prefill, with 2
    mla_latent decompressions a layer on K1, and decode walls and
    launches); every EmuGEMM-I call signature of a mixed step, a decode
    step and a lockstep prefill (K4 at 256 experts and 64, 4 and 384
    rows) on Eq. 19 operands, bit for bit against its plain version,
    timed beside its bound and torch.matmul / torch.bmm in bf16; at 1
    layer and 16 of the 256 experts (every other width published) a
    mixed step and a lockstep prefill in float32 native on the card
    against the CPU port, and in bf16 on the 'cuda' and 'torch' backends,
    logits and latent caches bit for bit; that layer and the MTP block
    trained with Adafactor and the config's 16 microbatches (16 x 128
    tokens, the weights prepared once a step: a warm-up and 2 timed
    steps), the loss with its MTP term and every gradient leaf of a
    microbatch on 'cuda' and 'torch' bit for bit under strict
    deterministic algorithms, and Adafactor on the card against the CPU
    on leaves of ranks 1 to 4 within 1e-6.
30. the guard and the telemetry (right after phase 29): full-width
    olmo-1b serves phase 3's trace under ozaki1-p4 and under
    ozaki1-p4+guard with telemetry on and a JSONL sink: the same tokens
    bit for bit and the same K1 and K4 calls, each call signature then
    held against its plain version bit for bit and timed; every guarded
    call verified without a trip (113 dense calls a step on the eager
    ladder, and attn_qk / attn_av one K4 launch a layer each whose 64
    (lane, head) elements are verified and counted one by one: 2161 a
    step), the telemetry's emulated calls == K1's and K4's launch
    counts, one record a step; tok/s, step walls, host syncs a step and
    peak memory beside the unguarded serve; at olmo-1b's dense shapes,
    NaN/Inf rows and columns through K1 NaN exactly where torch.matmul
    is non-finite (every other entry K1's bits), a guarded call against
    a prepared weight (one K3) verifies, injected faults under '+xla'
    trip and recover in one rung bit for bit (Scheme II at olmo-1b's
    shape; Scheme I at (64, 96) @ (96, 48): at olmo-1b's shapes the
    verifier's bound passes a Scheme-I fault, and an all-zero product,
    whose verdicts are read), an exhausted '+guard:strict' ladder raises
    and '+guard' falls back to the native dot with one warning; the Trainer
    under ozaki1-p4+guard:strict (2 steps of 2 x 128 tokens) gives the
    unguarded run's losses bit for bit, no trip, one record a step. The
    library phase (19) also holds K10 in float16 and at head dims 80
    (hubert-xlarge) and 192 (deepseek-v3), which run on the instances of
    128 and 256.
31. K10's last head dims, the measurement layer and the examples (right
    after phases 20-23, before the yardsticks; perf_probe's profiles are
    the process's first torch.profiler sessions): at
    16 heads and 2048 queries and keys, causal and full, D = 72 in bf16,
    float16 and float32, D = 100 in float32 (a ragged head: zero-padded
    copies at the next multiple of 8) and D = 320 and 512 in bf16 and
    float32 (one block a 256-column slice of the output: bf16 on the
    wgmma-wide kernel, q and k streamed in chunks, float32 on the FFMA
    kernel) against the plain version within its bars, one launch a
    call and no plain version on the card, each timed beside SDPA and
    its bound (the pad copies timed apart and inside the call's time);
    then utils.perf_probe on full-width, full-depth olmo-1b: train_4k at
    batch 1 under ozaki1-p4+cached and decode_32k at batch 4 under
    ozaki1-p4 (the step at position 32767), each step profiled, device
    time per emulation tag and call site beside its bound (the share of
    the bound must not exceed 1.05, and the tagged ranges must cover the
    step's emulation-kernel time within 5 %), model FLOPs and mfu; then
    the four examples/*_torch.py at their default sizes (serve_lm_torch
    on olmo-1b's smoke config, train_emulated_lm_torch --small --steps
    20), each on the kernels (launch counts read around them, no plain
    version on the card).

32. meshes on torch.distributed (right after the last build, before
    phase 27): ranks spawned as processes (a FileStore in a temporary
    directory) that share cuda:0 over gloo (NCCL with a card a rank);
    world 2: full-width, full-depth olmo-1b served tensor-parallel on
    make_host_mesh(model_parallel=2), mesh (1, 2), phase 3's trace under
    ozaki1-p4 and ozaki1-p4+cached, each rank's tokens bit for bit the
    one-rank serve's (this process's, before the ranks start), every
    dense call a column partition with 2 encodes + 1 plane GEMM on the
    rank's tile, each rank's K1 / K4 launch counts, partition events and
    modeled collective bytes printed; sharded_matmul at olmo-1b's dense
    shapes on (1, 2) and (2, 1) (column bit for bit, the row partition
    at N = 2049 bit for bit the sum of the pinned partials, the tied
    head's localized prepared planes one K3 a rank, bit for bit), one
    rank's K1 tile against the plain versions; compressed_psum the same
    bits on every rank and the integer sum's; a 4-layer olmo-1b
    data-parallel train step on (2, 1) (2 x 128, ozaki1-p4+cached,
    AdamW): both ranks' parameters bit for bit equal after 2 steps, the
    losses within 1e-5 of the one-rank full-batch steps; world 4:
    sharded_matmul on (2, 2) and (1, 4) (4 row partials, each the same
    bits on every rank, their sum within 1e-6 of the largest magnitude)
    and compressed_psum. The walls are those of ranks sharing one card.

After phases 20-23, one line names the device kernels that the
library yardsticks (cuBLAS's batched DGEMM, scaled_dot_product_attention
in bf16 and float32) run, and one those of the port's float32 attention,
from one torch.profiler pass each. Any failure
exits non-zero and prints no result. The line before the last is a JSON
object listing each kernel; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import itertools
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# Deterministic cuBLAS for the parity phases; read when CUDA initialises.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import complex3m, scheme1, scheme2  # noqa: E402
from repro_torch.core.precision import default_moduli  # noqa: E402
from repro_torch.data import make_batch_iterator  # noqa: E402
from repro_torch.kernels import (build, decompose, dispatch,  # noqa: E402
                                 flash_attn, matmul_int8, ops, ozaki1, ozaki2,
                                 ozaki3m, prepared)
from repro_torch.launch import steps as S, train as train_cli  # noqa: E402
from repro_torch.launch.serve import build_trace  # noqa: E402
from repro_torch.models import model as M, moe  # noqa: E402
from repro_torch.models.common import GemmPolicy, pad_vocab  # noqa: E402
from repro_torch.runtime import Trainer  # noqa: E402
from repro_torch.serving import (ContinuousEngine, LockstepEngine,  # noqa
                                 Request)
from repro_torch.utils.tree import tree_flatten  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 ops/s,
# bf16 and TF32 tensor-core flop/s and float32 flop/s outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

SOURCE_S1_BATCHED = "src/repro_torch/kernels/csrc/emugemm1_batched.cu"
SOURCE_S1_PLANES = "src/repro_torch/kernels/csrc/emugemm1_planes.cu"
DECOMPOSE_SOURCE = "src/repro_torch/kernels/csrc/decompose.cu"
EMU = "olmo-1b-emu"
M_MAIN = 6                       # olmo-1b-emu's attn_qk is ozaki2-m6
M_CHECK = (4, 6, 8, 16)
SPEC = "ozaki1-p4"
P_MAIN = 4
REQUESTS, PROMPT, GEN, LANES, CHUNK, PAGE = 8, 48, 16, 4, 16, 16
# Training: the train CLI's defaults, 8 sequences of 128 tokens a step,
# and a shorter run at olmo-1b's published context of 2048 tokens.
TRAIN_SPEC = "ozaki1-p4+cached"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 3
TOKENS = TRAIN_BATCH * TRAIN_SEQ
LONG_BATCH, LONG_SEQ, LONG_STEPS = 2, 2048, 2
P_BWD = 3
# The scientific GEMMs: DGEMM- and ZGEMM-grade Scheme II at the sizes the
# paper's users run (M = N = K), bit checks at m in SCI_M_CHECK (complex)
# and F64_M_CHECK (float64), the front doors at SCI_M_FRONT, effective bits
# on EVAL_ROWS sampled rows, bit identity at 8192 on the first SCI_ROWS.
SOURCE_PLANES = "src/repro_torch/kernels/csrc/emugemm2_planes.cu"
SCI_LONG_K = 131200               # past the plane GEMM's in-kernel reduction
SCI_SIZES = ((4096, (8, 12, 16)), (8192, (16,)))
SCI_M_CHECK = (4, 8, 12, 16)
F64_M_CHECK = (8, 12, 16)
SCI_M_FRONT = 12
SCI_BATCHED = (8, 512, 512)
SCI_BIG = SCI_4M_N = 1024
EVAL_ROWS, SCI_ROWS = 64, 256
# The residue forms' checks (K5, K7) on full-range int8 residues: every
# (M, N, K) of these, two moduli sets (256 and moduli below 16 among
# them), four layouts; and an int32 sum that wraps.
RES_MN = (1, 17, 129, 300)
RES_K = (1, 15, 16, 127, 129, 4096)
RES_MODULI = ((3, 5, 7, 11, 13, 256), default_moduli(16))
RES_WRAP = (128, 131200, 128, (255,))
# Training under Scheme II with the once-per-step weight hoist: TOKENS a
# step in HOIST_MICRO microbatches, the prepared form checked at
# HOIST_M_CHECK moduli.
HOIST_SPEC = f"ozaki2-m{M_MAIN}+cached"
HOIST_MICRO = 2
HOIST_M_CHECK = (6, 8, 16)
# The library kernels: EmuGEMM-I on interleaved operands and the lhs
# decomposition at olmo-1b's dense shapes (and LIB_RAGGED) at LIB_P
# slices; the int8 GEMM checked at INT8_CHECK and timed at INT8_TIMED,
# the naive Fig. 4 structure at NAIVE_N^3; attention at ATTN_CASES:
# (label, B, H, KVH, S_q, S_k, D, causal, window, dtype).
SOURCE_FLASH = "src/repro_torch/kernels/csrc/flash_attn.cu"
LIB_P = (3, 4, 6)
LIB_RAGGED = (100, 1000, 77)
INT8_CHECK = ((4096, 4096, 4096), (1024, 2048, 8192), (1000, 3000, 777))
INT8_TIMED = (4096, 8192)
NAIVE_N = 4096
ATTN_CASES = (
    ("olmo-1b causal", 2, 16, 16, 2048, 2048, 128, True, None, "bfloat16"),
    ("olmo-1b causal", 2, 16, 16, 2048, 2048, 128, True, None, "float32"),
    ("granite-3-8b GQA causal", 1, 32, 8, 2048, 2048, 128, True, None,
     "bfloat16"),
    ("olmo-1b window 1024", 2, 16, 16, 2048, 2048, 128, True, 1024,
     "bfloat16"),
    ("recurrentgemma-2b MQA window 2048", 1, 10, 1, 4096, 4096, 256, True,
     2048, "bfloat16"),
    ("rectangular full", 1, 4, 4, 128, 512, 64, False, None, "float32"),
    ("recurrentgemma-2b MQA window 2048", 1, 10, 1, 4096, 4096, 256, True,
     2048, "float32"),
    # float16 and the head dims without an instance of their own (80 on
    # the 128 instance, 192 on the 256 one).
    ("olmo-1b causal", 2, 16, 16, 2048, 2048, 128, True, None, "float16"),
    ("hubert-xlarge full", 1, 16, 16, 2048, 2048, 80, False, None,
     "bfloat16"),
    ("hubert-xlarge full", 1, 16, 16, 2048, 2048, 80, False, None,
     "float32"),
    ("deepseek-v3 causal", 1, 128, 128, 2048, 2048, 192, True, None,
     "bfloat16"),
)
# float16 is held 8x tighter than bf16: its 11 significant bits against
# bf16's 8 make the rounding of P before P V and of the output 8x finer.
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2.5e-3}
ATTN_ERR_KEY = {"float32": "flash_f32", "bfloat16": "flash",
                "float16": "flash_f16"}
# granite-3-8b served at full width with its untied head prepared once
# (GRANITE_SPEC), and on the lockstep path; deepseek-coder-33b at its
# published widths, DEEPSEEK_LAYERS of its 62 layers deep (a second
# backend's run must fit the run's time); olmo-1b's trace also under
# SPEC_SERVES.
GRANITE, GRANITE_SPEC = "granite-3-8b", "ozaki1-p4+cached"
DEEPSEEK, DEEPSEEK_LAYERS = "deepseek-coder-33b", 2
SPEC_SERVES = ("ozaki1-p3", "ozaki1-p6", "native")


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    fn()
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(batch, m, k, n, p, in_bytes, out_bytes):
    """Least time for the work: each input read once (operands and the
    scales), each output written once, against p(p+1)/2 int8 GEMMs at
    the int8 peak. Returns (ms, 'bytes' | 'operations')."""
    moved = batch * (in_bytes * (m * k + k * n) + 4 * (m + n)
                     + out_bytes * m * n)
    ops = batch * p * (p + 1) // 2 * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def conditioned(gen, shape, dtype, device):
    """Paper Eq. 19 matrices, (rand - 0.5) * exp(2 randn); a stack of more
    than 2^28 entries (deepseek-v3's 256 experts) a matrix at a time, so
    that its float32 temporaries stay the size of one."""
    if len(shape) >= 3 and math.prod(shape) > 2 ** 28:
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in out:
            part.copy_(conditioned(gen, shape[1:], dtype, device))
        return out
    x = (torch.rand(shape, generator=gen, device=device) - 0.5) * torch.exp(
        2 * torch.randn(shape, generator=gen, device=device))
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def path_shapes(mcfg, view_tokens, chunk):
    """The emulated GEMMs of one serve step of 4 lanes x ``chunk`` tokens
    (CHUNK: a mixed step, 1: a decode step), with their launch counts:
    (kind, batch, m, k, n, b_transposed, count)."""
    d, f, L = mcfg.d_model, mcfg.d_ff, mcfg.n_layers
    hd = mcfg.resolved_head_dim
    m = LANES * chunk
    bkv = LANES * mcfg.n_kv_heads
    g = mcfg.n_heads // mcfg.n_kv_heads
    vp = pad_vocab(mcfg.vocab)
    return [
        ("2d", 1, m, d, d, False, 4 * L),           # q, k, v, o
        ("2d", 1, m, d, f, False, 2 * L),           # gate, up
        ("2d", 1, m, f, d, False, L),               # down
        ("2d", 1, LANES, d, vp, True, 1),           # logits: x @ emb.T
        ("batched", bkv, chunk * g, hd, view_tokens, False, L),   # attn_qk
        ("batched", bkv, chunk * g, view_tokens, hd, False, L),   # attn_av
    ]


def s1_encode_bound(rows, k, p, in_bytes):
    """EmuGEMM-I's encode: the operand and its row scales read once, the
    p planes (rows, Kp) written once."""
    moved = in_bytes * rows * k + 4 * rows + p * rows * ozaki1.plane_k(k)
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def s1_planes_bound(m, k, n, p, out_bytes):
    """EmuGEMM-I's plane GEMM: both operands' p planes and the scales read
    once, the output written once, against p(p+1)/2 int8 GEMMs at the
    int8 peak."""
    moved = (p * (m + n) * ozaki1.plane_k(k) + 4 * (m + n)
             + out_bytes * m * n)
    ops_ = p * (p + 1) // 2 * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def check_encodes(what, pairs, max_err):
    """Each (operand, row scales, p, beta) encode against its plain version."""
    for x, sc, p, beta in pairs:
        out = ozaki1.encode_planes(x, sc, p, beta)
        check_equal(f"{what} encode {tuple(x.shape)} p={p}", out,
                    ozaki1.encode_planes_plain(x, sc, p, beta), max_err,
                    "encode")


def wrap_phase_case(dev, max_err):
    """A Scheme-I GEMM whose top diagonal wraps int32 (beta = 7, K = 50688,
    every slice near 127): the 2-D route == its plain version, and the
    diagonal's exact sum is past 2^31."""
    m, k, n = 128, 50688, 128
    # 1 - 2^-24 carves to the slices 127, 127, 127, 112: the top diagonal
    # sums 60706 a K step.
    a = torch.full((m, k), 1 - 2 ** -24, device=dev)
    b = torch.full((k, n), 1 - 2 ** -24, device=dev)
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, P_MAIN, 7, torch.float32)
    check_equal("int32-wrap case", out, ozaki1.fused_matmul_plain(
        a, b, mu, nu, P_MAIN, 7, torch.float32), max_err, "2d")
    pa = ozaki1.encode_planes_plain(a, mu, P_MAIN, 7).double()
    pb = ozaki1.encode_planes_plain(b.T, nu.T, P_MAIN, 7).double()
    top = sum(pa[i] @ pb[P_MAIN - 1 - i].T for i in range(P_MAIN))
    if not top.max().item() > 2 ** 31 - 1:
        raise AssertionError("the int32-wrap case did not wrap")
    log(f"[kernel] int32-wrap case {(m, k, n)} p={P_MAIN} beta=7: the top "
        f"diagonal's exact sum {top.max().item():.4g} > 2^31, kernel == "
        "plain version bit for bit")


def batched_operands(gen, dev, dtype, batch, m, k, n, layout):
    """A (batch, m, k) and B (batch, k, n) of the batched form in one of
    its layouts: 'contiguous' (the path's copies: B N-contiguous); 'ck' (B
    the transposed, K-contiguous view of a key cache of n + 16 rows, so
    that its batch stride is not n x k); 'cv' (B the first k rows of a
    value cache of k + 16, N-contiguous); 'at' (A read through its
    transpose, B contiguous)."""
    if layout == "ck":
        b = conditioned(gen, (batch, n + 16, k), dtype, dev)[:, :n].transpose(
            1, 2)
    elif layout == "cv":
        b = conditioned(gen, (batch, k + 16, n), dtype, dev)[:, :k]
    else:
        b = conditioned(gen, (batch, k, n), dtype, dev)
    a = (conditioned(gen, (batch, k, m), dtype, dev).transpose(1, 2)
         if layout == "at" else conditioned(gen, (batch, m, k), dtype, dev))
    return a, b


def batched_checks(gen, dev, mixed, decode, max_err):
    """The batched kernel against fused_matmul_plain, bit for bit, one
    launch a call: every batched path shape of a mixed and a decode step
    in every layout of ``batched_operands``, ragged shapes (batch 3, M 17,
    N 77, K in {1, 129, 1000}), float32 and bf16 operands to both output
    types, p in {1, 3, 4, 6, 8}; then a product whose top diagonal wraps
    int32 at both tile heights. Returns the case count."""
    layouts = ("contiguous", "ck", "cv", "at")
    cases = [(bt, m, k, n) for kind, bt, m, k, n, _, _ in mixed + decode
             if kind == "batched"]
    cases += [(3, 17, k, 77) for k in (1, 129, 1000)]
    checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for p in (1, 3, 4, 6, 8):
            for (bt, m, k, n), layout in itertools.product(cases, layouts):
                a, b = batched_operands(gen, dev, dtype, bt, m, k, n, layout)
                mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
                for out_dtype in (torch.float32, torch.bfloat16):
                    ozaki1.COUNTS.reset()
                    out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, 7,
                                                      out_dtype)
                    c = ozaki1.COUNTS
                    if (c.launches_batched, c.plain_cuda_calls) != (1, 0):
                        raise AssertionError(f"a batched call launched {c}")
                    ref = ozaki1.fused_matmul_plain(a, b, mu, nu, p, 7,
                                                    out_dtype)
                    check_equal(f"batched {(bt, m, k, n)} {layout} {dtype} "
                                f"-> {out_dtype} p={p}", out, ref, max_err,
                                "batched")
                    checks += 1
    # The wrap: 1 - 2^-24 carves to the slices 127, 127, 127, 112, so the
    # top diagonal sums 60706 a K step.
    bt, m, k, n = 2, 40, 50688, 70
    a = torch.full((bt, m, k), 1 - 2 ** -24, device=dev)
    b = torch.full((bt, k, n), 1 - 2 ** -24, device=dev)
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    ref = ozaki1.fused_matmul_plain(a, b, mu, nu, P_MAIN, 7, torch.float32)
    for tile_n in (16, 32):
        check_equal(f"batched int32-wrap case, tile {tile_n}",
                    ozaki1.launch_batched(a, b, mu, nu, P_MAIN, 7,
                                          torch.float32, tile_n=tile_n),
                    ref, max_err, "batched")
    pa = ozaki1.encode_planes_plain(a[0], mu[0], P_MAIN, 7).double()
    pb = ozaki1.encode_planes_plain(b[0].T, nu[0].T, P_MAIN, 7).double()
    top = sum(pa[i] @ pb[P_MAIN - 1 - i].T for i in range(P_MAIN))
    if not top.max().item() > 2 ** 31 - 1:
        raise AssertionError("the batched int32-wrap case did not wrap")
    log(f"[kernel] batched: {checks} shape/layout/type/p cases bit-identical "
        f"to the plain version, one launch each; the int32-wrap case "
        f"{(bt, m, k, n)} (top diagonal {top.max().item():.4g} > 2^31) at "
        "both tile heights")
    return checks + 2


def route_times(gen, dev, m, k, n, tr, p, bf, copies):
    """Device ms of one 2-D EmuGEMM-I call at (m, k, n), bf16, p slices,
    weight copies rotated past the L2: the route (2 encodes + the plane
    GEMM), its lhs and weight encodes, the plane GEMM and its mainloop
    alone, and the plain version."""
    a = conditioned(gen, (m, k), bf, dev)
    bs = [(conditioned(gen, (n, k), bf, dev).T if tr
           else conditioned(gen, (k, n), bf, dev)) for _ in range(copies)]
    mu = scheme1.pow2_scale(a, -1)
    nus = [scheme1.pow2_scale(b, -2) for b in bs]
    pa = ozaki1.encode_planes(a, mu, p, 7)
    pbs = [ozaki1.encode_planes(b.T, nu.T, p, 7) for b, nu in zip(bs, nus)]
    out = torch.empty((m, n), dtype=bf, device=dev)
    it = iter(range(10 ** 9))

    def rot(fn):
        def run():
            i = next(it) % copies
            fn(bs[i], nus[i], pbs[i])
        return run

    t = {
        "ms": time_ms(rot(lambda b, nu, pb: ozaki1.fused_matmul_scheme1(
            a, b, mu, nu, p, 7, bf)), 20),
        "encode_a_ms": time_ms(lambda: ozaki1.encode_planes(a, mu, p, 7), 20),
        "encode_b_ms": time_ms(rot(lambda b, nu, pb: ozaki1.encode_planes(
            b.T, nu.T, p, 7)), 20),
        "planes_ms": time_ms(rot(lambda b, nu, pb: ozaki1.launch_planes(
            pa, pb, mu, nu, p, 7, out)), 20),
        "mainloop_ms": time_ms(rot(lambda b, nu, pb: ozaki1.launch_planes(
            pa, pb, mu, nu, p, 7, out, epilogue=False)), 20),
        "plain_ms": time_ms(rot(lambda b, nu, pb: ozaki1.fused_matmul_plain(
            a, b, mu, nu, p, 7, bf)), 3),
        "encode_plain_ms": time_ms(rot(lambda b, nu, pb: (
            ozaki1.encode_planes_plain(a, mu, p, 7),
            ozaki1.encode_planes_plain(b.T, nu.T, p, 7))), 3),
        "planes_plain_ms": time_ms(rot(lambda b, nu, pb: (
            ozaki1.plane_matmul_plain(pa, pb, mu, nu, p, 7, bf))), 3),
    }
    other = 128 if ozaki1.plane_tile_m(m) == 64 else 64
    t[f"planes_tile{other}_ms"] = time_ms(rot(
        lambda b, nu, pb: ozaki1.launch_planes(pa, pb, mu, nu, p, 7, out,
                                               tile_m=other)), 20)
    t["mainloop_tops"] = (p * (p + 1) * m * n * k / t["mainloop_ms"] / 1e9)
    return t


def kernel_phase(dev, mcfg, view_tokens):
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {"2d": 0.0, "batched": 0.0, "encode": 0.0}
    checks = 0
    mixed = path_shapes(mcfg, view_tokens, CHUNK)
    decode = path_shapes(mcfg, view_tokens, 1)
    # Bit-identity at every 2-D path shape at M = 4 (a decode step) and
    # M = 64 (a mixed step), and on a ragged shape, for both operand types
    # and p in {3, 4, 6}; each case's two encodes too.
    cases = [(kind, bt, mm, k, n, tr) for kind, bt, m, k, n, tr, _ in mixed
             if kind == "2d" for mm in (4, LANES * CHUNK)]
    cases.append(("2d", 1, 37, 1000, 77, True))
    for dtype in (torch.float32, torch.bfloat16):
        for p in (3, 4, 6):
            for kind, bt, m, k, n, tr in cases:
                lead = () if kind == "2d" else (bt,)
                a = conditioned(gen, lead + (m, k), dtype, dev)
                b = (conditioned(gen, lead + (n, k), dtype, dev).transpose(-1, -2)
                     if tr else conditioned(gen, lead + (k, n), dtype, dev))
                mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
                out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, 7, dtype)
                ref = ozaki1.fused_matmul_plain(a, b, mu, nu, p, 7, dtype)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                max_err[kind] = max(max_err[kind], err)
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"kernel != plain version: {kind} {(bt, m, k, n)} "
                        f"transposed={tr} {dtype} p={p}, max |diff| {err}")
                check_encodes("serve", ((a, mu, p, 7), (b.T, nu.T, p, 7)),
                              max_err)
                checks += 1
    wrap_phase_case(dev, max_err)
    checks += batched_checks(gen, dev, mixed, decode, max_err)
    log(f"[kernel] {checks} cases bit-identical to the plain version (the "
        "2-D ones on the plane route, their encodes too; the batched ones "
        "one launch each)")

    # Timing at the main path's configuration (bf16, p = 4), per shape and
    # summed over one mixed and one decode step's launches.
    keys = ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms", "yardstick_ms",
            "encode_ms", "planes_ms", "mainloop_ms", "other_tile_ms",
            "events_ms",
            "encode_plain_ms", "planes_plain_ms", "encode_bound_ms",
            "planes_bound_ms", "planes_ops_bound_ms", "ops")
    totals = {(step, kind): dict.fromkeys(keys, 0.0)
              for step in ("mixed", "decode") for kind in ("2d", "batched")}
    bf = torch.bfloat16
    steps = [("mixed", sh) for sh in mixed] + [("decode", sh) for sh in decode]
    timed = {}
    for step, (kind, bt, m, k, n, tr, count) in steps:
        key = (kind, bt, m, k, n, tr)
        if key in timed:             # the logits GEMM is the same in both
            _add_times(totals[step, kind], count, *timed[key])
            continue
        lead = () if kind == "2d" else (bt,)
        nbytes = 2 * bt * k * n
        # Rotate weight copies past the 50 MB L2, as a serve step finds
        # each weight cold.
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes)) if kind == "2d" else 1
        # Library yardstick, not a kernel of the port: p(p+1)/2 int8 GEMMs
        # through torch._int_mm (which needs more than 16 rows, so M is
        # raised to 32 where smaller).
        my = max(m, 32)
        ai = torch.randint(-127, 128, lead + (my, k), generator=gen,
                           device=dev, dtype=torch.int8)
        bi = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        n_mm = P_MAIN * (P_MAIN + 1) // 2

        def run_yardstick():
            for _ in range(n_mm):
                if kind == "2d":
                    torch._int_mm(ai, bi)
                else:
                    for j in range(bt):
                        torch._int_mm(ai[j], bi)

        yard = time_ms(run_yardstick, 5)
        bms, by = bound_ms(bt, m, k, n, P_MAIN, 2, 2)
        if kind == "2d":
            t = route_times(gen, dev, m, k, n, tr, P_MAIN, bf, copies)
            t["encode_ms"] = t["encode_a_ms"] + t["encode_b_ms"]
            t["encode_bound_ms"] = (s1_encode_bound(m, k, P_MAIN, 2)[0]
                                    + s1_encode_bound(n, k, P_MAIN, 2)[0])
            t["planes_bound_ms"], pby = s1_planes_bound(m, k, n, P_MAIN, 2)
            t["planes_ops_bound_ms"] = (t["planes_bound_ms"]
                                        if pby == "operations" else 0.0)
            t["ops"] = n_mm * 2 * m * n * k
            detail = (f", encodes {t['encode_a_ms']:.4f} + "
                      f"{t['encode_b_ms']:.4f} ms (bound "
                      f"{t['encode_bound_ms']:.4f}), plane GEMM "
                      f"{t['planes_ms']:.4f} ms (mainloop "
                      f"{t['mainloop_ms']:.4f}, {t['mainloop_tops']:.1f} "
                      f"TOPS; bound {t['planes_bound_ms']:.4f}), the other "
                      f"tile {[v for x, v in t.items() if 'tile' in x][0]:.4f}"
                      " ms")
        else:
            a = conditioned(gen, lead + (m, k), bf, dev)
            b = conditioned(gen, lead + (k, n), bf, dev)
            mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
            # Back-to-back calls by CUDA events measure the host's wrapper
            # at these shapes; the kernel's own time is the profiler's.
            other = 32 if ozaki1.batched_tile_n(m) == 16 else 16

            def run(tile_n=None):
                return ozaki1.launch_batched(a, b, mu, nu, P_MAIN, 7, bf,
                                             tile_n=tile_n)
            t = {"events_ms": time_ms(lambda: ozaki1.fused_matmul_scheme1(
                     a, b, mu, nu, P_MAIN, 7, bf), 20),
                 "ms": device_ms(run),
                 "plain_ms": time_ms(lambda: ozaki1.fused_matmul_plain(
                     a, b, mu, nu, P_MAIN, 7, bf), 3),
                 "other_tile_ms": device_ms(lambda: run(other))}
            detail = (f"; route: the kernel's device time (profiler) at "
                      f"{ozaki1.batched_tile_n(m)} rows a tile, at {other} "
                      f"{t['other_tile_ms']:.4f} ms; by CUDA events "
                      f"{t['events_ms']:.4f} ms")
        t.update(yardstick_ms=yard, bound_ms=bms)
        timed[key] = (t, by)
        _add_times(totals[step, kind], count, t, by)
        log(f"[kernel] {kind} B={bt} M={m} K={k} N={n}"
            f"{' (B transposed)' if tr else ''} x{count}/{step} step: "
            f"route {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), yardstick torch._int_mm x{n_mm} "
            f"{yard:.4f} ms" + detail)
    for (step, kind), t in totals.items():
        extra = (f", encodes {t['encode_ms']:.3f} ms (bound "
                 f"{t['encode_bound_ms']:.3f}), plane GEMMs "
                 f"{t['planes_ms']:.3f} ms (mainloop {t['mainloop_ms']:.3f}, "
                 f"{t['ops'] / t['mainloop_ms'] / 1e9:.1f} TOPS; bound "
                 f"{t['planes_bound_ms']:.3f})" if kind == "2d" else
                 f"; route by device time, the other tile height "
                 f"{t['other_tile_ms']:.3f} ms, by CUDA events "
                 f"{t['events_ms']:.3f} ms")
        log(f"[kernel] {kind} per {step} step: route {t['ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms, "
            f"yardstick {t['yardstick_ms']:.3f} ms" + extra)
    return max_err, totals


def _add(t, count, ms, plain, yard, bms, by):
    t["ms"] += count * ms
    t["plain_ms"] += count * plain
    t["bound_ms"] += count * bms
    t["yardstick_ms"] += count * yard
    t["bytes_ms" if by == "bytes" else "ops_ms"] += count * bms


def _add_times(total, count, t, by):
    """Add ``count`` launches of the times ``t`` to ``total``; the bound
    to the bytes or operations share, as ``by`` says."""
    for key, v in t.items():
        if key in total:
            total[key] += count * v
    total["bytes_ms" if by == "bytes" else "ops_ms"] += count * t["bound_ms"]


# ---------------------------------------------------------------------------
# Phases 3 and 4: serve, and backend parity.
# ---------------------------------------------------------------------------

def serve_phase(dev, arch, policy):
    eng = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=policy, seed=0,
                           max_lanes=LANES, chunk=CHUNK, page_size=PAGE,
                           device=dev)
    trace = build_trace(np.random.default_rng(0), arch.model.vocab, REQUESTS,
                        PROMPT, GEN, 0.0)
    torch.cuda.synchronize()
    eng.reset_clock()
    reset_counts()
    t0 = time.perf_counter()
    results = eng.run(trace)
    dt = time.perf_counter() - t0
    counts, _, counts2 = snapshot_counts()
    util = eng.utilization()
    toks = [results[r.rid].tokens for r in trace]
    ttft = float(np.median([results[r.rid].ttft for r in trace]))
    tag = f"[serve {arch.model.name}]"
    log(f"{tag} {util['steps']} steps, {REQUESTS} requests x {GEN} tokens "
        f"in {dt:.3f} s ({REQUESTS * GEN / dt:.1f} tok/s), ttft p50 "
        f"{ttft:.3f} s, launches: emugemm1 2-D {counts.launches_2d} "
        f"(encodes {counts.launches_encode}, plane GEMMs "
        f"{counts.launches_planes}), batched {counts.launches_batched}; "
        f"emugemm2 batched {counts2.launches_batched}, 2-D "
        f"{counts2.launches_2d} (encodes {counts2.launches_encode}, plane "
        f"GEMMs {counts2.launches_planes}); plain versions on CUDA "
        f"{counts.plain_cuda_calls} + {counts2.plain_cuda_calls}")
    if counts.launches_2d == 0 or counts.launches_batched == 0:
        raise AssertionError("the serve path did not launch the kernel")
    # Every 2-D EmuGEMM-I call is the plane route: 2 encodes + 1 plane GEMM.
    if (counts.launches_encode, counts.launches_planes) != (
            2 * counts.launches_2d, counts.launches_2d):
        raise AssertionError("the serve path's 2-D calls did not each launch "
                             "two encodes and one plane GEMM")
    if scheme2_sites(eng.policy) and counts2.launches_batched == 0:
        raise AssertionError("the serve path did not launch emugemm2")
    check_float_rhs(counts2, "the serve path")
    if counts.plain_cuda_calls or counts2.plain_cuda_calls:
        raise AssertionError("the serve path ran a plain version on CUDA")
    if not all(len(t) == GEN and all(0 <= x < arch.model.vocab for x in t)
               for t in toks):
        raise AssertionError(f"malformed tokens {toks}")
    # Request 0 alone gives the tokens it got in the cohort.
    alone = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=policy,
                             params=eng.params, max_lanes=LANES, chunk=CHUNK,
                             page_size=PAGE, device=dev)
    r0 = Request(prompt=trace[0].prompt, max_new_tokens=GEN)
    if alone.run([r0])[r0.rid].tokens != toks[0]:
        raise AssertionError("request 0 alone differs from the cohort")
    log(f"{tag} request 0 alone == in cohort; sample {toks[0][:8]}")
    return eng, (counts, counts2), {
        "steps": util["steps"], "seconds": dt,
        "tok_per_s": REQUESTS * GEN / dt, "ttft_p50_s": ttft}


def scheme2_sites(policy) -> bool:
    return any(c is not None and c.scheme == "ozaki2"
               for c in [policy.default] + [c for _, c in policy.overrides])


def check_float_rhs(c, what):
    """Each float-rhs Scheme-II call (2-D or batched) launched two encodes
    and one plane GEMM, and each prepared call one of each (``c``: the
    counts of a path that prepares no Scheme-II weight)."""
    calls = c.launches_2d + c.launches_batched
    want = (2 * calls + c.launches_prepared, calls + c.launches_prepared)
    if (c.launches_encode, c.launches_planes) != want:
        raise AssertionError(f"{what}: EmuGEMM-II encodes and plane GEMMs "
                             f"{(c.launches_encode, c.launches_planes)}, "
                             f"expected {want}")


def on_backend(policy, backend):
    """``policy`` with every emulated site pinned to ``backend``."""
    def pin(cfg):
        if cfg is None or cfg.scheme == "native":
            return cfg
        return api.precision(cfg, backend=backend)
    return GemmPolicy(default=pin(policy.default),
                      overrides=tuple((s, pin(c)) for s, c in policy.overrides))


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def parity_phase(dev, arch, params, view_tokens, policy, label):
    """One full-width mixed step under ``policy`` on the 'cuda' and 'torch'
    backends (bit for bit), and its distance to a float32 forward."""
    mcfg = arch.model
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, mcfg.vocab, (LANES, CHUNK), generator=gen,
                           device=dev, dtype=torch.int32)
    start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
    n_new = torch.tensor([16, 16, 5, 1], device=dev, dtype=torch.int32)
    cache = M.init_cache(mcfg, LANES, view_tokens, dev)
    for leaf in cache["layers"]["b0"].values():
        leaf.normal_(generator=gen)
    logits = {}
    native = GemmPolicy(default=api.precision("native"))
    runs = (("cuda", params, on_backend(policy, "cuda")),
            ("torch", params, on_backend(policy, "torch")),
            ("native", params, native),
            ("native-f32", tree_map(lambda x: x.float(), params), native))
    with torch.inference_mode():
        for name, prm, pol in runs:
            views = {"layers": {"b0": {
                k: v.clone().to(prm["emb"].dtype)
                for k, v in cache["layers"]["b0"].items()}}}
            logits[name], _ = M.forward_step(prm, mcfg, tokens, start,
                                             n_new, views, pol)
    torch.cuda.synchronize()
    a, b = logits["cuda"], logits["torch"]
    if not torch.equal(a, b):
        raise AssertionError("full-width logits differ between the cuda and "
                             "torch backends: max |diff| "
                             f"{(a.float() - b.float()).abs().max().item()}")
    if not torch.isfinite(a).all() or a.shape != (LANES,
                                                  pad_vocab(mcfg.vocab)):
        raise AssertionError(f"bad logits {a.shape}")
    # Against a float32 reference forward, the emulated bf16 model must be
    # about as close as the native bf16 model (both round every GEMM
    # output to bf16; the emulation rounds up to p more times).
    ref = logits["native-f32"]

    def rel(x):
        return ((x.float() - ref).norm() / ref.norm()).item()

    rel_emu, rel_nat = rel(a), rel(logits["native"])
    log(f"[parity] full-width mixed step: cuda == torch backend logits bit "
        f"for bit; relative distance to a float32 forward: {label} bf16 "
        f"{rel_emu:.3e}, native bf16 {rel_nat:.3e}")
    if not rel_emu <= max(4 * rel_nat, 1e-3):
        raise AssertionError(f"emulated logits far from the float32 "
                             f"reference: {rel_emu} vs native {rel_nat}")
    return {"rel_f32_emulated": rel_emu, "rel_f32_native_bf16": rel_nat}


def kernel_label(name: str) -> str:
    """A kernel's name without its parameter list, e.g.
    emugemm1_kernel<__nv_bfloat16, __nv_bfloat16, 4, true>."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return name.split("(")[0][:90]


def device_summary(prof, prof_wall_ms: float, top_n: int = 4) -> dict:
    """Device-busy time (the union of kernel intervals), idle share of the
    profiled wall time, the device time of the top kernels by name and
    that of EmuGEMM-II (its plane route's kernels: the encode, the plane
    GEMM, and the residue forms' relayout and residue plane GEMM). The
    device spans the profiler draws for user annotations (an emulated
    GEMM's ``gemm_scope``) are no kernels and are left out."""
    from repro_torch.utils.perf_probe import device_kernels
    spans, by_name = [], {}
    for e in device_kernels(list(prof.events())):
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        label = kernel_label(e.name)
        by_name[label] = by_name.get(label, 0.0) + (t - s) / 1e3
    busy, end = 0.0, -math.inf
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    busy_ms = busy / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    return {"profiled_wall_ms": prof_wall_ms,
            "device_busy_ms": busy_ms if spans else None,
            "idle_share": (1 - busy_ms / prof_wall_ms) if spans else None,
            "top_device_ms": dict(top),
            "emugemm2_ms": sum(v for k, v in by_name.items()
                               if k.startswith(("planes_kernel",
                                                "encode_kernel",
                                                "residues_kernel",
                                                "relayout_kernel")))}


@contextlib.contextmanager
def gc_time():
    """The garbage collector's passes inside the block, and their ms on
    the host's clock."""
    out = {"collections": 0, "ms": 0.0}
    start = {}

    def tick(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        elif "t" in start:
            out["collections"] += 1
            out["ms"] += (time.perf_counter() - start.pop("t")) * 1e3

    gc.callbacks.append(tick)
    try:
        yield out
    finally:
        gc.callbacks.remove(tick)


def host_summary(prof, top_n: int = 6) -> dict:
    """Host time by op from a CPU-traced window: the ops with the most
    self CPU time (ms, calls), and the kernel launches the host made."""
    avgs = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    top = sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:top_n]
    launches = sum(e.count for e in avgs if "LaunchKernel" in e.key)
    return {"host_self_ms": sum(e.self_cpu_time_total for e in avgs) / 1e3,
            "top_host_ms": {e.key[:60]: [e.self_cpu_time_total / 1e3, e.count]
                            for e in top},
            "kernel_launch_calls": launches}


def yardstick_kernels(fn, calls: int = 10) -> dict:
    """The device kernels that a library yardstick ran, by name, with
    their mean device ms a call, from one torch.profiler pass over
    ``calls`` calls after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            label = kernel_label(e.name)
            names[label] = (names.get(label, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / calls)
    return names


def device_ms(fn, calls: int = 20) -> float:
    """Mean device ms of the one kernel ``fn`` launches a call, from a
    torch.profiler pass over ``calls`` calls: the mean of the kernel
    events the pass kept (a pass late in a process was seen to drop one
    of 50, and one after many sessions to keep none). A pass that kept
    none is made once more; if that keeps none either, the time is
    ``queued_ms``'s (CUDA events behind a spin kernel) and a line says
    so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        if spans:
            return sum(spans) / 1e3 / len(spans)
    ms = queued_ms(fn)
    log(f"[device_ms] two profiler passes kept no kernel event of {calls} "
        f"calls; {ms:.4f} ms a call by CUDA events behind a spin kernel")
    return ms


def queued_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events,
    with the calls queued behind a spin kernel (``torch.cuda._sleep``,
    about 3 ms) so that the host has enqueued them all before the first
    runs: the wrappers' host work, which back-to-back CUDA events time
    at small shapes, is not measured, and no profiler is needed (late in
    a long process a pass was seen to keep no kernel event)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def yardstick_phase(dev):
    """Which device kernels the library yardsticks run: cuBLAS's batched
    DGEMM at SCI_BATCHED, torch._int_mm at INT8_TIMED[0]^3 and
    scaled_dot_product_attention at the first two ATTN_CASES (bf16 and
    float32), on seeded inputs of those shapes, and the port's float32
    K10 (its pre-pass and 3xTF32 kernel, by device time) at the second;
    returns the last two. It runs early, right after phases 20-23 (whose
    walls come before any profiler session): later in a long process the
    profiler was seen to keep only some, or none, of a short pass's
    kernel events."""
    gen = torch.Generator(device=dev).manual_seed(20)
    ba = torch.randn(SCI_BATCHED, generator=gen, device=dev,
                     dtype=torch.float64)
    n9 = INT8_TIMED[0]
    a8 = torch.randint(-128, 128, (n9, n9), generator=gen, device=dev,
                       dtype=torch.int8)
    int_mm = yardstick_kernels(lambda: torch._int_mm(a8, a8), 3)
    del a8
    out = {f"cuBLAS batched DGEMM (torch.matmul) {SCI_BATCHED} float64":
           yardstick_kernels(lambda: torch.matmul(ba, ba)),
           f"torch._int_mm {n9}^3 int8": int_mm}
    for case in ATTN_CASES[:2]:
        label, _, h, kvh, _, _, d, causal, _, dt = case
        q, k, v = attn_inputs(gen, dev, case)
        out[f"scaled_dot_product_attention {label} {dt} D={d}"] = (
            yardstick_kernels(lambda: torch.nn.functional.
                              scaled_dot_product_attention(
                                  q, k, v, is_causal=causal,
                                  enable_gqa=h != kvh)))
    log("[yardsticks] the device kernels each library call ran, ms a call: "
        + json.dumps(out))
    # The port's float32 K10 in the same pass: its pre-pass and kernel by
    # device time (CUDA events time the call with its host work).
    attn = yardstick_kernels(lambda: flash_attn.flash_attention(
        q, k, v, causal=causal))
    log(f"[yardsticks] the port's K10 {label} {dt} D={d}, device ms a call: "
        + json.dumps(attn))
    return {"k10_f32": attn, "int_mm": int_mm}


def profile_phase(dev, arch, params, view_tokens, runs):
    """Where one serve step's time goes: host wall time of a mixed and a
    decode step under each (label, policy) of ``runs``, and under
    torch.profiler the device-busy share and device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    mcfg = arch.model
    start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
    report = {}
    for step_kind, c, n_new in (("mixed", CHUNK, [16, 16, 5, 1]),
                                ("decode", 1, [1, 1, 1, 1])):
        tokens = torch.ones((LANES, c), device=dev, dtype=torch.int32)
        nn = torch.tensor(n_new, device=dev, dtype=torch.int32)
        cache = M.init_cache(mcfg, LANES, view_tokens, dev)
        for spec, pol in runs:

            def step():
                with torch.inference_mode():
                    M.forward_step(params, mcfg, tokens, start, nn, cache, pol)
                torch.cuda.synchronize()

            reset_counts()
            step()
            with gc_time() as gc_spent:
                t0 = time.perf_counter()
                for _ in range(3):
                    step()
                wall_ms = (time.perf_counter() - t0) * 1e3 / 3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                prof_wall_ms = (time.perf_counter() - t0) * 1e3
            # The 5 steps' launches: each 2-D EmuGEMM-I call and each
            # EmuGEMM-II call on its plane route, no plain version on CUDA.
            k1, _, k3 = snapshot_counts()
            launches = {"emugemm1_2d": k1.launches_2d,
                        "encodes": k1.launches_encode,
                        "plane_gemms": k1.launches_planes,
                        "emugemm2_batched": k3.launches_batched,
                        "emugemm2_encodes": k3.launches_encode,
                        "emugemm2_plane_gemms": k3.launches_planes,
                        "plain_on_cuda": k1.plain_cuda_calls
                        + k3.plain_cuda_calls}
            check_float_rhs(k3, f"{step_kind} step under {spec}")
            if (launches["encodes"], launches["plane_gemms"],
                    launches["plain_on_cuda"]) != (2 * k1.launches_2d,
                                                   k1.launches_2d, 0):
                raise AssertionError(f"{step_kind} step under {spec}: "
                                     f"launches {launches}")
            entry = {"wall_ms": wall_ms,
                     **device_summary(prof, prof_wall_ms),
                     **host_summary(prof), "gc_in_3_steps": gc_spent,
                     "launches_in_5_steps": launches}
            report[f"{step_kind}/{spec}"] = entry
            log(f"[profile] {step_kind} step, {spec}: " + json.dumps(entry))
    return report


# ---------------------------------------------------------------------------
# Phase 6: the prepared-weight kernels of the training path.
# ---------------------------------------------------------------------------

def weight_shapes(mcfg):
    """Each dense weight of the train path: (K, N, read transposed, count
    per step). The tied head is emb.T, a strided view."""
    d, f, L = mcfg.d_model, mcfg.d_ff, mcfg.n_layers
    return [(d, d, False, 4 * L), (d, f, False, 2 * L), (f, d, False, L),
            (d, pad_vocab(mcfg.vocab), True, 1)]


def train_launches(mcfg):
    """Calls per cached train step with remat, by form: each layer's
    weight is prepared (the planes of W^T and of its twin W: two encodes)
    and multiplied in the forward and again in the recompute, and its twin
    multiplies dA once; the head, outside the checkpoints, once each. Each
    mixed call is an lhs encode and a plane GEMM; each dB = A^T dC a 2-D
    call, two encodes and a plane GEMM."""
    n_prep = n_fwd = n_da = n_db = 0
    for _, _, tr, c in weight_shapes(mcfg):
        r = 1 if tr else 2
        n_prep += r * c
        n_fwd += r * c
        n_da += c
        n_db += c
    mixed = n_fwd + n_da
    return {"prep": n_prep, "mixed": mixed, "2d": n_db,
            "encode": 2 * n_prep + mixed + 2 * n_db, "planes": mixed + n_db}


def pair_bound(k, n, p, in_bytes):
    kp, np_ = decompose.round_up(k), decompose.round_up(n)
    moved = in_bytes * k * n + 4 * (k + n) + p * (kp * n + np_ * k)
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def rhs_bound(k, n, p, in_bytes):
    moved = in_bytes * k * n + 4 * n + p * decompose.round_up(k) * n
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def mixed_bound(m, k, n, p, in_bytes, out_bytes):
    """The mixed route: the lhs and the scales read once, the weight's p
    planes read once, the output written once, against p(p+1)/2 int8
    GEMMs at the int8 peak."""
    moved = (in_bytes * m * k + p * ozaki1.plane_k(k) * n + 4 * (m + n)
             + out_bytes * m * n)
    ops = p * (p + 1) // 2 * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def make_weight(gen, k, n, transposed, dtype, dev):
    """A (K, N) weight, or the (K, N) view of an (N, K) table (emb.T)."""
    if transposed:
        return conditioned(gen, (n, k), dtype, dev).T
    return conditioned(gen, (k, n), dtype, dev)


def split_times(kind, lhs, mu, weights, p, out_dtype, rhs=None, nu=None):
    """Device ms of the plane route's pieces, rotating ``weights`` (a list
    of (planes of B^T, nu) per copy): the lhs encode, the plane GEMM and
    its mainloop alone; for a 2-D call (``rhs``, ``nu`` given) both
    encodes, the rhs's as the route runs it."""
    pa = ozaki1.encode_planes(lhs, mu, p, 7)
    out = torch.empty((lhs.shape[0], weights[0][0].shape[1]),
                      dtype=out_dtype, device=lhs.device)
    it = iter(range(10 ** 9))

    def rot(fn):
        def run():
            fn(*weights[next(it) % len(weights)])
        return run

    t = {"encode_ms": time_ms(lambda: ozaki1.encode_planes(lhs, mu, p, 7), 10),
         "planes_ms": time_ms(rot(lambda pb, sc: ozaki1.launch_planes(
             pa, pb, mu, sc, p, 7, out)), 10),
         "mainloop_ms": time_ms(rot(lambda pb, sc: ozaki1.launch_planes(
             pa, pb, mu, sc, p, 7, out, epilogue=False)), 10)}
    if kind == "2d":
        t["encode_ms"] += time_ms(lambda: ozaki1.encode_planes(
            rhs.T, nu.T, p, 7), 10)
    return t


def train_kernel_phase(dev, mcfg):
    gen = torch.Generator(device=dev).manual_seed(2)
    max_err = {"pair": 0.0, "rhs": 0.0, "mixed": 0.0, "encode": 0.0,
               "stacked": 0.0, "2d": 0.0}
    checks = 0
    cases = [(TOKENS, k, n, tr) for k, n, tr, _ in weight_shapes(mcfg)]
    cases.append((100, 1000, 77, True))                    # ragged
    for dtype in (torch.float32, torch.bfloat16):
        for p in (3, 4, 6):
            cfg = api.precision(f"ozaki1-p{p}+cached", backend="cuda")
            for m, k, n, tr in cases:
                b = make_weight(gen, k, n, tr, dtype, dev)
                nu, tau = scheme1.pow2_scale(b, -2), scheme1.pow2_scale(b, -1).T
                fwd, twin = decompose.decompose_interleave_pair(b, nu, tau, p,
                                                                7, 7)
                rhs = decompose.decompose_interleave_rhs(b, nu, p, 7)
                rhs_t = decompose.decompose_interleave_rhs(b.T, tau, p, 7)
                ref_f, ref_t = decompose.decompose_pair_plain(b, nu, tau, p,
                                                              7, 7)
                # The 'planes' prep: the planes of W^T and of its twin W.
                prep = prepared.prepare_rhs(b, cfg, with_twin=True)
                if (prep.layout, prep.beta, prep.twin.beta) != ("planes", 7, 7):
                    raise AssertionError(f"prep {prep.layout} beta "
                                         f"{prep.beta}/{prep.twin.beta}")
                a = conditioned(gen, (m, k), dtype, dev)
                g = conditioned(gen, (m, n), dtype, dev)
                mu, mug = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(g, -1)
                outs = [(ozaki1.fused_matmul_mixed(x, pl, s, sc, p, 7, dtype),
                         ozaki1.fused_matmul_mixed_plain(x, hat, s, sc, p, 7,
                                                         dtype))
                        for x, pl, hat, s, sc in (
                            (a, prep.slices, fwd, mu, nu),
                            (g, prep.twin.slices, twin, mug, tau))]
                # dB = A^T dC on the 2-D route, A^T a strided view.
                mut, nug = scheme1.pow2_scale(a.T, -1), scheme1.pow2_scale(g, -2)
                db = (ozaki1.fused_matmul_scheme1(a.T, g, mut, nug, p, 7, dtype),
                      ozaki1.fused_matmul_plain(a.T, g, mut, nug, p, 7, dtype))
                torch.cuda.synchronize()
                for name, out, ref in (
                        ("pair", fwd, ref_f), ("pair", twin, ref_t),
                        ("rhs", rhs, ref_f), ("rhs", rhs_t, ref_t),
                        ("encode", prep.slices,
                         ozaki1.encode_planes_plain(b.T, nu.T, p, 7)),
                        ("encode", prep.twin.slices,
                         ozaki1.encode_planes_plain(b, tau.T, p, 7)),
                        ("stacked", prep.stacked(),
                         scheme1.deinterleave_k(ref_f, p, "b", decompose.TILE)),
                        ("stacked", prep.twin.stacked(),
                         scheme1.deinterleave_k(ref_t, p, "b", decompose.TILE)),
                        ("mixed", *outs[0]), ("mixed", *outs[1]),
                        ("2d", *db)):
                    err = (out.float() - ref.float()).abs().max().item()
                    max_err[name] = max(max_err[name], err)
                    if not torch.equal(out, ref):
                        raise AssertionError(
                            f"{name} kernel != plain version: {(m, k, n)} "
                            f"transposed={tr} {dtype} p={p}, max |diff| {err}")
                    checks += 1
                del b, fwd, twin, rhs, rhs_t, ref_f, ref_t, prep, outs, db
    log(f"[train-kernel] {checks} shape/type/p cases bit-identical to the "
        "plain versions (K2, K2r; the weights' planes and their twins, also "
        "read back through stacked() against the interleaved slices; the "
        "mixed route against the interleaved form's plain version; dB on "
        "the 2-D route)")

    # Timing at the training configuration (bf16, p = 4; the twin of the
    # bwd_p route at p = 3), per shape and summed over one train step.
    bf = torch.bfloat16
    n_mm = P_MAIN * (P_MAIN + 1) // 2
    keys = ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms",
            "yardstick_ms", "encode_ms", "planes_ms", "mainloop_ms", "ops")
    totals = {name: dict.fromkeys(keys, 0.0)
              for name in ("pair", "rhs", "weights", "mixed", "2d")}
    for k, n, tr, count in weight_shapes(mcfg):
        r = 1 if tr else 2          # the head is not recomputed
        # Rotate weight copies past the 50 MB L2, as a step finds each
        # weight cold.
        copies = max(1, math.ceil(2 * L2_BYTES / (2 * k * n)))
        bs = [make_weight(gen, k, n, tr, bf, dev) for _ in range(copies)]
        nus = [scheme1.pow2_scale(b, -2) for b in bs]
        taus = [scheme1.pow2_scale(b, -1).T for b in bs]
        hats = [decompose.decompose_interleave_pair(b, nu, tau, P_MAIN, 7, 7)
                for b, nu, tau in zip(bs, nus, taus)]
        planes = [(ozaki1.encode_planes(b.T, nu.T, P_MAIN, 7),
                   ozaki1.encode_planes(b, tau.T, P_MAIN, 7))
                  for b, nu, tau in zip(bs, nus, taus)]
        a = conditioned(gen, (TOKENS, k), bf, dev)
        g = conditioned(gen, (TOKENS, n), bf, dev)
        mu, mug = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(g, -1)
        mut, nug = scheme1.pow2_scale(a.T, -1), scheme1.pow2_scale(g, -2)
        it = iter(range(10 ** 9))

        def rot(fn):
            def run():
                i = next(it) % copies
                fn(bs[i], nus[i], taus[i], hats[i], planes[i])
            return run

        def encode_weight(b, nu, tau, encode):
            encode(b.T, nu.T, P_MAIN, 7)
            encode(b, tau.T, P_MAIN, 7)

        runs = {
            "pair": (rot(lambda b, nu, tau, h, pl: decompose.decompose_interleave_pair(
                b, nu, tau, P_MAIN, 7, 7)),
                rot(lambda b, nu, tau, h, pl: decompose.decompose_pair_plain(
                    b, nu, tau, P_MAIN, 7, 7))),
            "rhs": (rot(lambda b, nu, tau, h, pl: decompose.decompose_interleave_rhs(
                b, nu, P_MAIN, 7)),
                rot(lambda b, nu, tau, h, pl: decompose.decompose_rhs_plain(
                    b, nu, P_MAIN, 7))),
            "rhs_twin": (rot(lambda b, nu, tau, h, pl: decompose.decompose_interleave_rhs(
                b.T, tau, P_BWD, 7)),
                rot(lambda b, nu, tau, h, pl: decompose.decompose_rhs_plain(
                    b.T, tau, P_BWD, 7))),
            "weights": (rot(lambda b, nu, tau, h, pl: encode_weight(
                b, nu, tau, ozaki1.encode_planes)),
                rot(lambda b, nu, tau, h, pl: encode_weight(
                    b, nu, tau, ozaki1.encode_planes_plain))),
            "fwd": (rot(lambda b, nu, tau, h, pl: ozaki1.fused_matmul_mixed(
                a, pl[0], mu, nu, P_MAIN, 7, bf)),
                rot(lambda b, nu, tau, h, pl: ozaki1.fused_matmul_mixed_plain(
                    a, h[0], mu, nu, P_MAIN, 7, bf))),
            "da": (rot(lambda b, nu, tau, h, pl: ozaki1.fused_matmul_mixed(
                g, pl[1], mug, tau, P_MAIN, 7, bf)),
                rot(lambda b, nu, tau, h, pl: ozaki1.fused_matmul_mixed_plain(
                    g, h[1], mug, tau, P_MAIN, 7, bf))),
            "db": (lambda: ozaki1.fused_matmul_scheme1(
                a.T, g, mut, nug, P_MAIN, 7, bf),
                lambda: ozaki1.fused_matmul_plain(a.T, g, mut, nug, P_MAIN, 7,
                                                  bf)),
        }
        splits = {
            "fwd": lambda: split_times("mixed", a, mu, [
                (pl[0], nu) for pl, nu in zip(planes, nus)], P_MAIN, bf),
            "da": lambda: split_times("mixed", g, mug, [
                (pl[1], tau) for pl, tau in zip(planes, taus)], P_MAIN, bf),
            "db": lambda: split_times(
                "2d", a.T, mut, [(ozaki1.encode_planes(g.T, nug.T, P_MAIN, 7),
                                  nug)], P_MAIN, bf, rhs=g, nu=nug),
        }
        # Library yardstick, not a kernel of the port: the p(p+1)/2 int8
        # GEMMs of each mixed launch through torch._int_mm.
        ai = torch.randint(-127, 128, (TOKENS, k), generator=gen, device=dev,
                           dtype=torch.int8)
        gi = torch.randint(-127, 128, (TOKENS, n), generator=gen, device=dev,
                           dtype=torch.int8)
        bi = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        bti = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                            dtype=torch.int8)
        yard = {"fwd": lambda: [torch._int_mm(ai, bi) for _ in range(n_mm)],
                "da": lambda: [torch._int_mm(gi, bti) for _ in range(n_mm)]}
        bounds = {"pair": pair_bound(k, n, P_MAIN, 2),
                  "rhs": rhs_bound(k, n, P_MAIN, 2),
                  "rhs_twin": rhs_bound(n, k, P_BWD, 2),
                  "weights": (s1_encode_bound(n, k, P_MAIN, 2)[0]
                              + s1_encode_bound(k, n, P_MAIN, 2)[0], "bytes"),
                  "fwd": mixed_bound(TOKENS, k, n, P_MAIN, 2, 2),
                  "da": mixed_bound(TOKENS, n, k, P_MAIN, 2, 2),
                  "db": bound_ms(1, k, TOKENS, n, P_MAIN, 2, 2)}
        ops_ = {"fwd": n_mm * 2 * TOKENS * k * n, "da": n_mm * 2 * TOKENS * k * n,
                "db": n_mm * 2 * TOKENS * k * n}
        per_step = {"pair": ("pair", r * count), "rhs": ("rhs", r * count),
                    "rhs_twin": ("rhs", r * count),
                    "weights": ("weights", r * count),
                    "fwd": ("mixed", r * count), "da": ("mixed", count),
                    "db": ("2d", count)}
        for key, (run_k, run_p) in runs.items():
            bms, by = bounds[key]
            t = {"ms": time_ms(run_k, 10), "plain_ms": time_ms(run_p, 2),
                 "yardstick_ms": time_ms(yard[key], 3) if key in yard else 0.0,
                 "bound_ms": bms}
            if key in splits:
                t.update(splits[key](), ops=ops_[key])
            name, c = per_step[key]
            _add_times(totals[name], c, t, by)
            log(f"[train-kernel] {key} K={k} N={n}"
                f"{' (B transposed)' if tr else ''} x{c}/step: kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                f"{bms:.4f} ms ({by})"
                + (f", yardstick torch._int_mm x{n_mm} "
                   f"{t['yardstick_ms']:.4f} ms" if key in yard else "")
                + (f"; encodes {t['encode_ms']:.4f}, plane GEMM "
                   f"{t['planes_ms']:.4f} (mainloop {t['mainloop_ms']:.4f}, "
                   f"{t['ops'] / t['mainloop_ms'] / 1e9:.1f} TOPS)"
                   if key in splits else ""))
        del bs, hats, planes
    for name, t in totals.items():
        log(f"[train-kernel] {name} per train step: kernel {t['ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms"
            + (f", yardstick {t['yardstick_ms']:.3f} ms"
               if name == "mixed" else "")
            + (f"; encodes {t['encode_ms']:.3f} ms, plane GEMMs "
               f"{t['planes_ms']:.3f} ms (mainloop {t['mainloop_ms']:.3f}, "
               f"{t['ops'] / t['mainloop_ms'] / 1e9:.1f} TOPS)"
               if t["ops"] else ""))
    return max_err, totals


# ---------------------------------------------------------------------------
# Phases 7-9: train, train parity, trainer.
# ---------------------------------------------------------------------------

def snapshot_counts():
    return (ozaki1.LaunchCounts(**vars(ozaki1.COUNTS)),
            decompose.LaunchCounts(**vars(decompose.COUNTS)),
            ozaki2.LaunchCounts(**vars(ozaki2.COUNTS)))


def reset_counts():
    ozaki1.COUNTS.reset()
    decompose.COUNTS.reset()
    ozaki2.COUNTS.reset()
    ozaki3m.COUNTS.reset()
    matmul_int8.COUNTS.reset()
    flash_attn.COUNTS.reset()


def train_batches(arch, batch=None, seq=None):
    return make_batch_iterator(arch, ShapeSpec(
        "chip", seq or TRAIN_SEQ, batch or TRAIN_BATCH, "train"), seed=0)


def run_steps(step, run, batches, n):
    """``n`` train steps on ``run["state"]``, each synchronised: (losses,
    wall s). Only ``run`` holds the state, so while a step builds the
    new state the old one is the only other alive, as in the Trainer."""
    losses, walls = [], []
    for _ in range(n):
        _, batch = next(batches)
        t0 = time.perf_counter()
        run["state"], metrics = step(run["state"], batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return losses, walls


def train_phase(dev, arch, card: str, policy=None, long_seq: bool = True):
    """Train ``arch`` under ``policy`` (None: the arch's gemm_sites)."""
    from torch.profiler import ProfilerActivity, profile
    label = TRAIN_SPEC if policy is not None else arch.model.name
    tag = f"[train {arch.model.name}]"
    step = S.make_train_step(arch, policy=policy)
    run = {"state": S.init_state(arch, 0, dev)}
    batches = train_batches(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    # One warm-up step, then the timed window; tokens/s is every token of
    # the window over its whole wall time.
    losses, warm = run_steps(step, run, batches, 1)
    with gc_time() as gc_spent:
        timed, walls = run_steps(step, run, batches, TRAIN_STEPS)
    losses += timed
    k1, k2, k3 = snapshot_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    tok_s = TRAIN_STEPS * TOKENS / sum(walls)
    log(f"{tag} 1 + {TRAIN_STEPS} steps of {TOKENS} tokens under "
        f"{label}: losses {losses}, warm-up wall s {warm[0]:.3f}, "
        f"timed step wall s {[round(w, 3) for w in walls]}, {tok_s:.1f} "
        f"tokens/s over the timed steps, peak memory "
        f"{peak / 2 ** 30:.2f} GiB on {card}; launches: mixed "
        f"{k1.launches_mixed}, 2-D {k1.launches_2d} (encodes "
        f"{k1.launches_encode}, plane GEMMs {k1.launches_planes}), batched "
        f"{k1.launches_batched}, pair {k2.launches_pair}, rhs "
        f"{k2.launches_rhs}, emugemm2 batched {k3.launches_batched} "
        f"(encodes {k3.launches_encode}, plane GEMMs {k3.launches_planes}), "
        f"plain "
        f"versions on CUDA "
        f"{k1.plain_cuda_calls + k2.plain_cuda_calls + k3.plain_cuda_calls}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if min(k1.launches_mixed, k1.launches_2d, k1.launches_batched) == 0:
        raise AssertionError("the train path did not launch every kernel")
    # The per-step times of the kernel phase count these launches: every
    # prep is two encodes on the plane route, none a decomposition.
    expect = train_launches(arch.model)
    n_run = 1 + TRAIN_STEPS
    # attn_qk under Scheme II: the forward, the recompute, dA and dB of
    # each chunk pair.
    qk = (4 * chunk_pairs(arch.model, TRAIN_SEQ) * arch.model.n_layers
          if scheme2_sites(policy or arch.gemm_policy()) else 0)
    got = (k1.launches_mixed, k1.launches_2d, k1.launches_encode,
           k1.launches_planes, k2.launches_pair + k2.launches_rhs,
           k3.launches_batched, k3.launches_encode, k3.launches_planes)
    want = (n_run * expect["mixed"], n_run * expect["2d"],
            n_run * expect["encode"], n_run * expect["planes"], 0, n_run * qk,
            2 * n_run * qk, n_run * qk)
    if got != want:
        raise AssertionError(f"launches {got} differ from the per-step "
                             f"accounting {want}: {expect}, attn_qk {qk}")
    if k1.plain_cuda_calls or k2.plain_cuda_calls or k3.plain_cuda_calls:
        raise AssertionError("the train path ran a plain version on CUDA")
    # The same number of steps again, traced: device activity only, so the
    # host runs as it does unprofiled; the idle share is that of the
    # whole window.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_losses, prof_walls = run_steps(step, run, batches, TRAIN_STEPS)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    profiled = device_summary(prof, prof_wall_ms, top_n=6)
    profiled["step_wall_s"] = prof_walls
    log(f"{tag} {TRAIN_STEPS} profiled steps " + json.dumps(profiled))
    # One more step traced on the host too: where the host's time goes.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        host_losses, _ = run_steps(step, run, batches, 1)
    log(f"{tag} 1 step traced on the host " + json.dumps(host_summary(prof)))
    prof_losses += host_losses
    summary = {"losses": losses, "warmup_wall_s": warm[0],
               "step_wall_s": walls, "tokens_per_s": tok_s,
               "peak_memory_bytes": peak, "gc_in_timed_steps": gc_spent,
               "profile": profiled}
    if not all(math.isfinite(x) for x in prof_losses):
        raise AssertionError(f"non-finite training loss {prof_losses}")
    if not long_seq:
        return run["state"]["params"], (k1, k2, k3), summary
    # At the published context: one chunk pair of flash attention is
    # skipped (causal) and one rescaled across chunks.
    torch.cuda.reset_peak_memory_stats(dev)
    long_losses, long_walls = run_steps(
        step, run, train_batches(arch, LONG_BATCH, LONG_SEQ), LONG_STEPS)
    long_peak = torch.cuda.max_memory_allocated(dev)
    log(f"[train] {LONG_STEPS} steps of {LONG_BATCH} x {LONG_SEQ} tokens: "
        f"losses {long_losses}, step wall s "
        f"{[round(w, 3) for w in long_walls]}, peak memory "
        f"{long_peak / 2 ** 30:.2f} GiB")
    if not all(math.isfinite(x) for x in long_losses):
        raise AssertionError(f"non-finite training loss {long_losses}")
    summary["long_seq"] = {"tokens": LONG_BATCH * LONG_SEQ,
                           "losses": long_losses, "step_wall_s": long_walls,
                           "peak_memory_bytes": long_peak}
    return run["state"]["params"], (k1, k2, k3), summary


def grads_equal(name, run_a, run_b):
    (la, ga), (lb, gb) = run_a, run_b
    fa, fb = tree_flatten(ga), tree_flatten(gb)
    bad = [k for k in fa if not torch.equal(fa[k], fb[k])]
    if not torch.equal(la, lb) or bad:
        raise AssertionError(f"train parity {name}: losses {la.item()} vs "
                             f"{lb.item()}, gradient leaves that differ: "
                             f"{bad[:5]}")
    log(f"[train-parity] {name}: loss {la.item()} and all {len(fa)} "
        "gradient leaves bit-identical")


def train_parity_phase(dev, arch, params):
    """One step's loss and gradients at full width, under deterministic
    algorithms (the embedding's gradient accumulates with atomics
    otherwise, and the tied emb also takes the head's dB)."""
    def run(spec, batches=None, **kw):
        _, batch = next(batches or train_batches(arch))
        loss_fn = S.make_loss_fn(arch, GemmPolicy(
            default=api.precision(spec, **kw)))
        return S.value_and_grad(loss_fn, params, S.batch_to(batch, dev))

    cached = run(TRAIN_SPEC + "@cuda")
    grads_equal("(a) cuda == torch backend", cached,
                run(TRAIN_SPEC + "@torch"))
    grads_equal("(b) cached == uncached", cached, run("ozaki1-p4"))
    del cached
    grads_equal(f"(d) at {LONG_BATCH} x {LONG_SEQ} tokens, cuda == torch "
                "backend",
                *(run(TRAIN_SPEC + backend,
                      train_batches(arch, LONG_BATCH, LONG_SEQ))
                  for backend in ("@cuda", "@torch")))
    reset_counts()
    cached_bwd = run(TRAIN_SPEC, bwd_p=P_BWD)
    k1, k2, _ = snapshot_counts()
    grads_equal(f"(c) bwd_p={P_BWD}: cached == uncached", cached_bwd,
                run("ozaki1-p4", bwd_p=P_BWD))
    # The twins are encoded at bwd_p slices: the same encode launches as a
    # step at p, and no decomposition.
    want = train_launches(arch.model)["encode"]
    if (k1.launches_encode, k2.launches_pair + k2.launches_rhs) != (want, 0):
        raise AssertionError(f"the bwd_p step launched {k1.launches_encode} "
                             f"encodes (expected {want}) and "
                             f"{k2.launches_pair + k2.launches_rhs} "
                             "decompositions")
    log(f"[train-parity] the bwd_p={P_BWD} step launched the encode kernel "
        f"{k1.launches_encode} times, the decompositions none")


# ---------------------------------------------------------------------------
# Phase 10: EmuGEMM-II against its plain versions, and its library routes.
# ---------------------------------------------------------------------------

def chunk_pairs(mcfg, seq):
    """The (q chunk, kv chunk) pairs causal flash attention runs at
    ``seq`` tokens (q_chunk == kv_chunk), the later ones skipped."""
    nc = -(-seq // min(mcfg.q_chunk, seq))
    return nc * (nc + 1) // 2


def qk_shapes(mcfg, view_tokens):
    """attn_qk's strided-batched GEMMs under olmo-1b-emu with their
    launches per step: (label, batch, m, k, n, a transposed, b
    transposed, count). A train step runs each chunk pair's forward
    twice (remat) and the backward's dA = g b^T and dB = a^T g on
    transposed views; at 2 x 2048 tokens flash attention runs 3 of the
    2 x 2 chunk pairs."""
    L, hd = mcfg.n_layers, mcfg.resolved_head_dim
    g = mcfg.n_heads // mcfg.n_kv_heads
    kvh = mcfg.n_kv_heads
    out = [("serve mixed", LANES * kvh, CHUNK * g, hd, view_tokens, False,
            False, L),
           ("serve decode", LANES * kvh, g, hd, view_tokens, False, False, L)]
    for name, batch, seq in (("train", TRAIN_BATCH, TRAIN_SEQ),
                             ("long", LONG_BATCH, LONG_SEQ)):
        c, pairs = min(mcfg.q_chunk, seq), chunk_pairs(mcfg, seq)
        bt = batch * kvh
        out += [(f"{name} fwd", bt, c * g, hd, c, False, False,
                 2 * pairs * L),
                (f"{name} dA", bt, c * g, c, hd, False, True, pairs * L),
                (f"{name} dB", bt, hd, c * g, c, True, False, pairs * L)]
    return out


def operand(gen, lead, rows, cols, transposed, dtype, dev):
    """A (..., rows, cols) operand, or the transposed view of a
    (..., cols, rows) tensor."""
    if transposed:
        return conditioned(gen, lead + (cols, rows), dtype, dev).transpose(
            -1, -2)
    return conditioned(gen, lead + (rows, cols), dtype, dev)


def scheme2_bound(batch, m, k, n, p, in_bytes, out_bytes):
    """Least time: the float operands and scales read once, the output
    written once, against p int8 GEMMs at the int8 peak."""
    moved = batch * (in_bytes * (m * k + k * n + m + n) + out_bytes * m * n)
    ops_ = batch * p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def residue_bound(m, k, n, p):
    moved = p * (m * k + k * n + m * n)
    ops_ = p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def int_mm_yardstick(gen, dev, batch, m, k, n, p):
    """p torch._int_mm per batch element at the same shape (which needs
    more than 16 rows, so M is raised to 32 where smaller). A speed
    reference only, used nowhere in the port."""
    ai = torch.randint(-127, 128, (max(m, 32), k), generator=gen, device=dev,
                       dtype=torch.int8)
    bi = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)

    def run():
        for _ in range(p * batch):
            torch._int_mm(ai, bi)
    return run


def check_equal(what, out, ref, max_err, key):
    torch.cuda.synchronize()
    wide = torch.complex128 if out.is_complex() else torch.float64
    err = torch.where(out == ref, 0, out.to(wide) - ref.to(wide)).abs().max(
        ).item() if out.numel() else 0.0
    max_err[key] = max(max_err[key], err)
    if not torch.equal(out, ref):
        raise AssertionError(f"{what}: kernel != plain version, max |diff| "
                             f"{err}")
    return err


def db_shapes(mcfg):
    """dB = X^T dC of each dense weight in one hoisted step of TOKENS
    tokens in HOIST_MICRO microbatches, on the float-rhs form: (label, m,
    k, n, count per step), A = X^T read through its strides (m = the
    weight's K, k = a microbatch's tokens, n = its N), each weight once a
    microbatch (the tied head's N is the padded vocabulary)."""
    tokens = TOKENS // HOIST_MICRO
    return [(f"dB K={k} N={n}", k, tokens, n, HOIST_MICRO * c)
            for k, n, _, c in weight_shapes(mcfg)]


def float_rhs_times(a, b, mu, nu, moduli, out_dtype, iters, tile_n=None):
    """Device ms of one float-rhs call on the plane route (``ms``), and of
    its kernels timed apart: the two encodes, the plane GEMM and its
    mainloop alone (``tile_n``: the plane GEMM's tile width, default the
    route's)."""
    enc, main, gemm, _ = plane_split("dgemm", a, b, mu, nu, moduli, iters,
                                     tile_n, out_dtype)
    return {"ms": time_ms(lambda: ozaki2.fused_matmul_scheme2(
                a, b, mu, nu, moduli, out_dtype), iters),
            "encode_ms": enc, "planes_ms": gemm, "mainloop_ms": main}


def scheme2_checks(dev, mcfg, view_tokens, max_err):
    """The float-rhs form (each call 2 encodes + 1 plane GEMM) and the
    residue form against their plain versions, bit for bit; returns the
    number of cases."""
    gen = torch.Generator(device=dev).manual_seed(3)
    checks = 0
    shapes = qk_shapes(mcfg, view_tokens)

    def check(what, a, b, moduli, out_t, key):
        mu, nu = scheme2.scales(a, b, moduli)
        c = ozaki2.COUNTS
        before = (c.launches_encode, c.launches_planes)
        out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, out_t)
        if (c.launches_encode - before[0], c.launches_planes - before[1]) != (
                2, 1):
            raise AssertionError(f"{what}: not 2 encodes + 1 plane GEMM")
        check_equal(what, out, ozaki2.fused_matmul_scheme2_plain(
            a, b, mu, nu, moduli, out_t), max_err, key)

    for dtype in (torch.float32, torch.bfloat16):
        for p in M_CHECK:
            moduli = default_moduli(p)
            cases = [(lbl, (bt,), m, k, n, ta, tb)
                     for lbl, bt, m, k, n, ta, tb, _ in shapes]
            cases += [("ragged", (), 100, 200, 77, False, False),
                      ("ragged, B transposed", (), 100, 200, 77, False, True)]
            for lbl, lead, m, k, n, ta, tb in cases:
                a = operand(gen, lead, m, k, ta, dtype, dev)
                b = operand(gen, lead, k, n, tb, dtype, dev)
                check(f"emugemm2 {lbl} {lead + (m, k, n)} {dtype} m={p}", a,
                      b, moduli, dtype, "batched" if lead else "2d")
                checks += 1
                del a, b
            for m, k, n in ((100, 200, 77), (1024, 2048, 2048)):
                a_res = torch.randint(-128, 128, (p, m, k), generator=gen,
                                      device=dev, dtype=torch.int8)
                b_res = torch.randint(-128, 128, (p, k, n), generator=gen,
                                      device=dev, dtype=torch.int8)
                check_equal(f"emugemm2 residues {(p, m, k, n)}",
                            ozaki2.fused_residue_matmul(a_res, b_res, moduli),
                            ozaki2.fused_residue_matmul_plain(a_res, b_res,
                                                              moduli),
                            max_err, "residues")
                checks += 1
    # dB's shapes (A = X^T, the head's 2048 x 50688 among them), every
    # operand pairing and output type, and the encodes alone on
    # transposed operands; drawn from a generator of their own.
    gen = torch.Generator(device=dev).manual_seed(21)
    f32, bf = torch.float32, torch.bfloat16
    moduli = default_moduli(M_MAIN)
    for dtype in (bf, f32):
        for i, (lbl, m, k, n, _) in enumerate(db_shapes(mcfg)):
            a = operand(gen, (), m, k, True, dtype, dev)
            b = operand(gen, (), k, n, False, dtype, dev)
            check(f"emugemm2 {lbl} (A = X^T) {(m, k, n)} {dtype} m={M_MAIN}",
                  a, b, moduli, dtype, "2d")
            checks += 1
            if i == 0:
                mu, nu = scheme2.scales(a, b, moduli)
                for x, sc in ((a, mu), (b.T, nu.T)):
                    check_equal(f"emugemm2 encode {tuple(x.shape)} strides "
                                f"{x.stride()} {dtype}",
                                ozaki2.encode_planes(x, sc, moduli),
                                ozaki2.encode_planes_plain(x, sc, moduli),
                                max_err, "encode")
                    checks += 1
            del a, b
        lbl, bt, m, k, n, ta, tb, _ = shapes[-1]        # long dB: a^T g
        a = operand(gen, (bt,), m, k, ta, dtype, dev)
        mu = scheme2.scales(a, a.transpose(-1, -2), moduli)[0]
        check_equal(f"emugemm2 encode {tuple(a.shape)} strides {a.stride()} "
                    f"{dtype}", ozaki2.encode_planes(a, mu, moduli),
                    ozaki2.encode_planes_plain(a, mu, moduli), max_err,
                    "encode")
        checks += 1
        del a
    for p in (M_MAIN, 16):
        moduli = default_moduli(p)
        for ta_t, tb_t in ((f32, f32), (bf, bf), (f32, bf), (bf, f32)):
            for lbl, m, k, n in (("ragged", 100, 200, 77),
                                 ("dB", 2048, TOKENS // HOIST_MICRO, 2048)):
                a = operand(gen, (), m, k, True, ta_t, dev)
                b = operand(gen, (), k, n, False, tb_t, dev)
                for out_t in (f32, bf, torch.float64):
                    check(f"emugemm2 {lbl} (A transposed) {(m, k, n)} "
                          f"{ta_t} @ {tb_t} -> {out_t} m={p}", a, b, moduli,
                          out_t, "2d")
                    checks += 1
                del a, b
    return checks


def scheme2_kernel_phase(dev, mcfg, view_tokens):
    """EmuGEMM-II's float-rhs form on the plane route and its residue form
    against their plain versions (``scheme2_checks``); then, at olmo-1b-emu's
    configuration (bf16, m = 6), K6 timed per serve, train and long step
    and dB (K5g) per hoisted step, each beside its bound with the route's
    split (encodes; plane GEMM: mainloop and CRT), dB at both tile
    widths."""
    max_err = {"2d": 0.0, "batched": 0.0, "residues": 0.0, "encode": 0.0}
    checks = scheme2_checks(dev, mcfg, view_tokens, max_err)
    log(f"[scheme2-kernel] {checks} shape/type/moduli cases bit-identical to "
        "the plain versions (each float-rhs call 2 encodes + 1 plane GEMM)")

    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    moduli = default_moduli(M_MAIN)
    steps = {"serve mixed": "mixed", "serve decode": "decode",
             "train fwd": "train", "train dA": "train", "train dB": "train",
             "long fwd": "long", "long dA": "long", "long dB": "long"}
    keys = ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms",
            "yardstick_ms", "encode_ms", "planes_ms", "mainloop_ms", "ops",
            "encode_bound_ms")
    totals = {s: dict.fromkeys(keys, 0.0)
              for s in ("mixed", "decode", "train", "long", "db")}
    # "db": dB of one hoisted step.

    def add(total, count, t, bms, by, ops_, enc_bound):
        _add(total, count, t["ms"], t["plain_ms"], t.get("yardstick_ms", 0.0),
             bms, by)
        for key in ("encode_ms", "planes_ms", "mainloop_ms"):
            total[key] += count * t[key]
        total["ops"] += count * ops_
        total["encode_bound_ms"] += count * enc_bound

    def describe(t, ops_):
        return (f"route {t['ms']:.4f} ms (encodes {t['encode_ms']:.4f}, "
                f"plane GEMM {t['planes_ms']:.4f}: mainloop "
                f"{t['mainloop_ms']:.4f} at {ops_ / t['mainloop_ms'] / 1e9:.1f}"
                f" int8 TOPS, CRT {t['planes_ms'] - t['mainloop_ms']:.4f})")

    for lbl, bt, m, k, n, ta, tb, count in qk_shapes(mcfg, view_tokens):
        a = operand(gen, (bt,), m, k, ta, bf, dev)
        b = operand(gen, (bt,), k, n, tb, bf, dev)
        mu, nu = scheme2.scales(a, b, moduli)
        t = float_rhs_times(a, b, mu, nu, moduli, bf, 20)
        t["plain_ms"] = time_ms(lambda: ozaki2.fused_matmul_scheme2_plain(
            a, b, mu, nu, moduli, bf), 3)
        t["yardstick_ms"] = time_ms(int_mm_yardstick(gen, dev, bt, m, k, n,
                                                     M_MAIN), 3)
        bms, by = scheme2_bound(bt, m, k, n, M_MAIN, 2, 2)
        ops_ = bt * M_MAIN * 2 * m * n * k
        add(totals[steps[lbl]], count, t, bms, by, ops_,
            encode_bound(m, k, n, M_MAIN, 2, 1, bt)[0])
        log(f"[scheme2-kernel] batched {lbl} B={bt} M={m} K={k} N={n}"
            f"{' (A transposed)' if ta else ''}"
            f"{' (B transposed)' if tb else ''} x{count}/step: "
            f"{describe(t, ops_)}, plain {t['plain_ms']:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), yardstick torch._int_mm x{M_MAIN * bt} "
            f"{t['yardstick_ms']:.4f} ms, tile 128 x "
            f"{ozaki2.plane_tile_n(bt, m, n, dev)}")
        del a, b
    # dB a hoisted step: X^T dC, both tile widths of the plane GEMM.
    tiles = {}
    for lbl, m, k, n, count in db_shapes(mcfg):
        a = operand(gen, (), m, k, True, bf, dev)
        b = operand(gen, (), k, n, False, bf, dev)
        mu, nu = scheme2.scales(a, b, moduli)
        t = float_rhs_times(a, b, mu, nu, moduli, bf, 10)
        t["plain_ms"] = time_ms(lambda: ozaki2.fused_matmul_scheme2_plain(
            a, b, mu, nu, moduli, bf), 2)
        bms, by = scheme2_bound(1, m, k, n, M_MAIN, 2, 2)
        ops_ = M_MAIN * 2 * m * n * k
        add(totals["db"], count, t, bms, by, ops_,
            encode_bound(m, k, n, M_MAIN, 2, 1)[0])
        tile_n = ozaki2.plane_tile_n(1, m, n, dev)
        for width in (ozaki2.PLANE_NARROW_N, ozaki2.PLANE_TILE[1]):
            _, main, gemm, _ = plane_split("dgemm", a, b, mu, nu, moduli, 10,
                                           width, bf)
            tiles.setdefault(width, {"planes_ms": 0.0, "mainloop_ms": 0.0})
            tiles[width]["planes_ms"] += count * gemm
            tiles[width]["mainloop_ms"] += count * main
            log(f"[scheme2-kernel] {lbl} on the 128 x {width} tile: plane "
                f"GEMM {gemm:.4f} ms (mainloop {main:.4f}, CRT "
                f"{gemm - main:.4f})")
        park = (-(-m // ozaki2.PLANE_TILE[0]) * -(-n // tile_n) * M_MAIN
                * ozaki2.PLANE_TILE[0] * tile_n)
        log(f"[scheme2-kernel] {lbl} M={m} (A = X^T) K={k} x{count}/step: "
            f"{describe(t, ops_)}, plain {t['plain_ms']:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), tile 128 x {tile_n}, park "
            f"{park / 2 ** 20:.1f} MiB")
        del a, b
    totals["db"]["tiles"] = tiles
    for s_, t in totals.items():
        log(f"[scheme2-kernel] per {s_} step"
            f"{' (K5g on dB)' if s_ == 'db' else ' (K6)'}: "
            f"{describe(t, t['ops'])}, plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.3f} ms, encodes' bound "
            f"{t['encode_bound_ms']:.3f} ms, yardstick "
            f"{t['yardstick_ms']:.3f} ms"
            + (f"; plane GEMMs by tile width {json.dumps(tiles)}"
               if s_ == "db" else ""))
    return max_err, totals


def dense_shapes(mcfg):
    """olmo-1b's dense GEMMs at 1024 tokens: (m, k, n)."""
    d, f = mcfg.d_model, mcfg.d_ff
    return [(TOKENS, d, d), (TOKENS, d, f), (TOKENS, f, d)]


def scheme2_library_phase(dev, mcfg):
    """The library routes of the 2-D and residue forms under ozaki2-m6 on
    olmo-1b's dense shapes (bf16): ``dispatch.emulated_matmul`` (the 2-D
    form on the plane route) and ``ops.fused_scheme2_matmul`` (the residue
    form: a relayout of B^T and the residue plane GEMM) agree bit for bit;
    their launches are counted around that run. Then each form is timed
    beside its bound with its split (the 2-D form: encodes; plane GEMM:
    mainloop and CRT; the residue form: relayout; residue GEMM: mainloop
    and epilogue)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    spec = f"ozaki2-m{M_MAIN}"
    moduli = default_moduli(M_MAIN)
    shapes = dense_shapes(mcfg)
    xs = [(conditioned(gen, (m, k), bf, dev), conditioned(gen, (k, n), bf, dev))
          for m, k, n in shapes]
    torch.cuda.synchronize()
    reset_counts()
    for a, b in xs:
        fused = dispatch.emulated_matmul(a, b, cfg=spec)
        routed = ops.fused_scheme2_matmul(a, b, spec, out_dtype=bf)
        if not torch.equal(fused, routed):
            raise AssertionError(f"{spec}: the 2-D and residue routes differ "
                                 f"at {tuple(a.shape)} @ {tuple(b.shape)}")
    torch.cuda.synchronize()
    _, _, counts = snapshot_counts()
    log(f"[scheme2-library] {spec} on {len(shapes)} dense shapes: the 2-D "
        f"and residue routes agree bit for bit; launches 2-D "
        f"{counts.launches_2d} (encodes {counts.launches_encode}, plane GEMMs "
        f"{counts.launches_planes}), residues {counts.launches_residues} "
        f"(relayouts {counts.launches_relayout}), plain versions on CUDA "
        f"{counts.plain_cuda_calls}")
    n_ = len(shapes)
    if (counts.launches_2d, counts.launches_encode, counts.launches_planes,
            counts.launches_residues, counts.launches_relayout) != (
                n_, 2 * n_, n_, n_, n_):
        raise AssertionError("the library routes did not launch each form "
                             "once per shape (2 encodes + 1 plane GEMM a 2-D "
                             "call, a relayout of B^T + 1 residue GEMM a "
                             "residue call)")
    if counts.plain_cuda_calls:
        raise AssertionError("the library routes ran a plain version on CUDA")
    totals = {f: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bytes_ms": 0.0, "ops_ms": 0.0, "yardstick_ms": 0.0}
              for f in ("2d", "residues")}
    totals["2d"].update(encode_ms=0.0, planes_ms=0.0, mainloop_ms=0.0,
                        ops=0.0)
    totals["residues"].update(relayout_ms=0.0, residue_gemm_ms=0.0,
                              mainloop_ms=0.0, epilogue_ms=0.0,
                              relayout_bound_ms=0.0, relayouts=0, ops=0.0)
    for (m, k, n), (a, b) in zip(shapes, xs):
        mu, nu = scheme2.scales(a, b, moduli)
        a_res = scheme2.balanced_residues(torch.trunc(a * mu), moduli)
        b_res = scheme2.balanced_residues(torch.trunc(b * nu), moduli)
        yard = time_ms(int_mm_yardstick(gen, dev, 1, m, k, n, M_MAIN), 5)
        for form, run_k, run_p, (bms, by) in (
                ("2d",
                 lambda: ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, bf),
                 lambda: ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu,
                                                           moduli, bf),
                 scheme2_bound(1, m, k, n, M_MAIN, 2, 2)),
                ("residues",
                 lambda: ozaki2.fused_residue_matmul(a_res, b_res, moduli),
                 lambda: ozaki2.fused_residue_matmul_plain(a_res, b_res,
                                                           moduli),
                 residue_bound(m, k, n, M_MAIN))):
            ms = time_ms(run_k, 10)
            plain = time_ms(run_p, 3)
            _add(totals[form], 1, ms, plain, yard, bms, by)
            extra = ""
            if form == "2d":
                enc, main, gemm, _ = plane_split("dgemm", a, b, mu, nu,
                                                 moduli, 10, out_dtype=bf)
                ops_ = M_MAIN * 2 * m * n * k
                for key, v in (("encode_ms", enc), ("planes_ms", gemm),
                               ("mainloop_ms", main), ("ops", ops_)):
                    totals[form][key] += v
                extra = (f" (encodes {enc:.4f}, plane GEMM {gemm:.4f}: "
                         f"mainloop {main:.4f} at {ops_ / main / 1e9:.1f} "
                         f"int8 TOPS, CRT {gemm - main:.4f})")
            else:
                sp = residue_split(a_res, b_res, moduli, 10)
                for key in ("relayout_ms", "residue_gemm_ms", "mainloop_ms",
                            "epilogue_ms", "relayout_bound_ms", "relayouts"):
                    totals[form][key] += sp[key]
                totals[form]["ops"] += M_MAIN * 2 * m * n * k
                extra = (f" (relayouts {sp['relayouts']}: "
                         f"{sp['relayout_ms']:.4f}; residue GEMM "
                         f"{sp['residue_gemm_ms']:.4f}: mainloop "
                         f"{sp['mainloop_ms']:.4f} at "
                         f"{sp['mainloop_tops']:.1f} int8 TOPS, epilogue "
                         f"{sp['epilogue_ms']:.4f})")
            log(f"[scheme2-library] {form} M={m} K={k} N={n}: kernel "
                f"{ms:.4f} ms{extra}, plain {plain:.4f} ms, bound {bms:.4f} "
                f"ms ({by}), yardstick torch._int_mm x{M_MAIN} {yard:.4f} ms")
    return counts, totals


# ---------------------------------------------------------------------------
# Phases 16-18: EmuGEMM-II's prepared form, and training under
# ozaki2-m6+cached with gradient accumulation and the once-per-step hoist.
# ---------------------------------------------------------------------------

def micro_arch(arch):
    """``arch`` accumulating gradients over HOIST_MICRO microbatches."""
    return dataclasses.replace(arch, train=dataclasses.replace(
        arch.train, microbatches=HOIST_MICRO))


@contextlib.contextmanager
def counting_preps():
    """Count every ``prepared.prepare_rhs`` call inside the block."""
    calls = {"n": 0}
    real = prepared.prepare_rhs

    def counted(*args, **kw):
        calls["n"] += 1
        return real(*args, **kw)

    prepared.prepare_rhs = counted
    try:
        yield calls
    finally:
        prepared.prepare_rhs = real


def hoisted_shapes(mcfg):
    """The prepared form's GEMMs in one hoisted train step of TOKENS
    tokens in HOIST_MICRO microbatches: (label, m, k, n, b transposed,
    count per step). Each layer weight's forward runs twice (remat) and
    its dA once per microbatch; the tied head (emb.T, prepared per call)
    once each."""
    m = TOKENS // HOIST_MICRO
    out = []
    for k, n, tr, c in weight_shapes(mcfg):
        r = 1 if tr else 2
        out += [(f"fwd K={k} N={n}", m, k, n, tr, HOIST_MICRO * r * c),
                (f"dA K={n} N={k}", m, n, k, not tr, HOIST_MICRO * c)]
    return out


def hoisted_launches(mcfg):
    """Launches and preps per hoisted step, by kernel form: each prepared
    GEMM is an lhs encode and a plane GEMM, each float-rhs call (dB, 2-D;
    attention, batched) two encodes and a plane GEMM, each prep (with its
    twin) two encodes."""
    w = sum(c for _, _, tr, c in weight_shapes(mcfg) if not tr)
    prepared_ = sum(c for *_, c in hoisted_shapes(mcfg))
    preps = w + HOIST_MICRO                      # the head, per microbatch
    db = HOIST_MICRO * (w + 1)
    batched = (HOIST_MICRO * 2 * 4 * chunk_pairs(mcfg, TRAIN_SEQ)
               * mcfg.n_layers)                  # attn_qk and attn_av
    return {"prepared": prepared_, "planes": prepared_ + db + batched,
            "encode": prepared_ + 2 * preps + 2 * (db + batched),
            "2d": db, "batched": batched, "preps": preps}


def prepared_bound(m, k, n, p, in_bytes, out_bytes):
    """Least time of the prepared form: the lhs and both scales read once,
    the weight's p int8 planes read once, the output written once,
    against p int8 GEMMs at the int8 peak."""
    moved = in_bytes * (m * k + m + n) + p * k * n + out_bytes * m * n
    ops_ = p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def prepared_kernel_phase(dev, mcfg):
    """The prepared form on the plane route (one lhs encode and one plane
    GEMM against the weight's (p, N, Kp) planes, which one encode launch
    wrote) against its plain version on the reference-layout stack and
    against the float-rhs form on the same operands, bit for bit, at
    olmo-1b's train shapes (forward and dA, 1024 tokens and the hoisted
    step's 512), ragged M, N and K, the tied head, bf16 and float32 at m
    in HOIST_M_CHECK, float32 against a bf16 weight, float64 at one shape,
    every CUDA prep in the planes layout and every call's launches
    counted; then timed per hoisted step (the lhs encode, the plane
    GEMM's mainloop and its CRT apart, the weight encodes) beside its
    bound, its plain version and the float-rhs form."""
    gen = torch.Generator(device=dev).manual_seed(15)
    d, f = mcfg.d_model, mcfg.d_ff
    vp = pad_vocab(mcfg.vocab)
    max_err = {"prepared": 0.0}
    checks = 0

    def case(m, k, n, dtype, p, tr=False, w_dtype=None):
        w_dtype = w_dtype or dtype
        moduli = default_moduli(p)
        cfg = api.precision(f"ozaki2-m{p}")
        b = make_weight(gen, k, n, tr, w_dtype, dev)
        a = conditioned(gen, (m, k), dtype, dev)
        what = f"emugemm2 prepared {(m, k, n)} {dtype} @ {w_dtype} m={p}"
        reset_counts()
        prep = prepared.prepare_rhs(b, cfg)
        if (prep.layout != "planes"
                or prep.residues.shape != (p, n, ozaki2.plane_k(k))):
            raise AssertionError(f"{what}: a CUDA weight prepared as "
                                 f"{prep.layout} {tuple(prep.residues.shape)}")
        mu = scheme2._pow2_int_scale(a, -1, min(
            prep.budget_bits, scheme2.MANTISSA[dtype]))
        out = ozaki2.fused_matmul_scheme2_prepared(
            a, prep.residues, mu, prep.scale, moduli, dtype, n)
        c = ozaki2.COUNTS
        got = (c.launches_encode, c.launches_planes, c.launches_prepared,
               c.launches_2d, c.launches_batched, c.plain_cuda_calls)
        if got != (2, 1, 1, 0, 0, 0):
            raise AssertionError(f"{what}: launches (encode, planes, "
                                 f"prepared, 2d, batched, plain) {got}")
        ref = ozaki2.fused_matmul_scheme2_prepared_plain(
            a, prep.stacked(), mu, prep.scale, moduli, dtype, n)
        check_equal(what, out, ref, max_err, "prepared")
        if w_dtype == dtype:
            mu2, nu2 = scheme2.scales(a, b, moduli)
            float_rhs = ozaki2.fused_matmul_scheme2(a, b, mu2, nu2, moduli,
                                                    dtype)
            if not torch.equal(out, float_rhs):
                raise AssertionError(f"{what}: != the float-rhs form")

    cases = [(mm, k, n) for mm in (TOKENS, TOKENS // HOIST_MICRO)
             for k, n in ((d, d), (d, f), (f, d))]
    cases += [(1000, d, d), (TOKENS, d, 1990), (TOKENS, 2040, d)]
    for dtype in (torch.bfloat16, torch.float32):
        for p in HOIST_M_CHECK:
            for m, k, n in cases:
                case(m, k, n, dtype, p)
                checks += 1
    for m, k, n in cases[3:6] + cases[-3:]:
        case(m, k, n, torch.float32, M_MAIN, w_dtype=torch.bfloat16)
        checks += 1
    for m, k, n, tr in ((TOKENS // HOIST_MICRO, d, vp, True),
                        (TOKENS // HOIST_MICRO, vp, d, False)):
        case(m, k, n, torch.bfloat16, M_MAIN, tr)
        checks += 1
    case(TOKENS, d, d, torch.float64, 16)
    checks += 1
    log(f"[prepared-kernel] {checks} shape/type/moduli cases on the plane "
        "route (2 encodes a case, the weight's and the lhs's, and 1 plane "
        "GEMM; every prep in the planes layout) bit-identical to the plain "
        "version on the reference-layout stack and, for one operand type, "
        "to the float-rhs form")

    # Timing at the hoisted step's configuration (bf16, m = 6), per shape
    # and summed over one step; each weight's planes rotate past the L2.
    bf, moduli = torch.bfloat16, default_moduli(M_MAIN)
    cfg = api.precision(f"ozaki2-m{M_MAIN}")
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
              "ops_ms": 0.0, "yardstick_ms": 0.0, "float_rhs_ms": 0.0,
              "encode_ms": 0.0, "planes_ms": 0.0, "mainloop_ms": 0.0,
              "weight_encode_ms": 0.0}
    for lbl, m, k, n, tr, count in hoisted_shapes(mcfg):
        copies = max(1, math.ceil(2 * L2_BYTES / (M_MAIN * k * n)))
        bs = [make_weight(gen, k, n, tr, bf, dev) for _ in range(copies)]
        preps = [prepared.prepare_rhs(b, cfg) for b in bs]
        stacks = [pr.stacked() for pr in preps]
        a = conditioned(gen, (m, k), bf, dev)
        mu = scheme2._pow2_int_scale(a, -1, preps[0].budget_bits)
        nus = [scheme2._pow2_int_scale(b, -2, preps[0].budget_bits)
               for b in bs]
        ap = ozaki2.encode_planes(a, mu, moduli)
        out = torch.empty((m, n), dtype=bf, device=dev)
        it = iter(range(10 ** 9))

        def rot(fn):
            def run():
                i = next(it) % copies
                fn(bs[i], nus[i], preps[i], stacks[i])
            return run

        ms = time_ms(rot(lambda b, nu, pr, st: ozaki2.
                         fused_matmul_scheme2_prepared(
                             a, pr.residues, mu, pr.scale, moduli, bf, n)), 10)
        enc = time_ms(lambda: ozaki2.encode_planes(a, mu, moduli), 10)
        planes = time_ms(rot(lambda b, nu, pr, st: ozaki2.plane_matmul(
            ap, pr.residues, mu, pr.scale[:, :n], moduli, bf)), 10)
        main = time_ms(rot(lambda b, nu, pr, st: ozaki2.launch_planes(
            ap[:, None], pr.residues[:, None], mu, pr.scale[:, :n], moduli,
            out, epilogue=False)), 10)
        plain = time_ms(rot(
            lambda b, nu, pr, st: ozaki2.fused_matmul_scheme2_prepared_plain(
                a, st, mu, pr.scale, moduli, bf, n)), 2)
        float_rhs = time_ms(rot(lambda b, nu, pr, st: ozaki2.
                                fused_matmul_scheme2(a, b, mu, nu, moduli,
                                                     bf)), 5)
        yard = time_ms(int_mm_yardstick(gen, dev, 1, m, k, n, M_MAIN), 3)
        bms, by = prepared_bound(m, k, n, M_MAIN, 2, 2)
        _add(totals, count, ms, plain, yard, bms, by)
        for key, t in (("float_rhs_ms", float_rhs), ("encode_ms", enc),
                       ("planes_ms", planes), ("mainloop_ms", main)):
            totals[key] += count * t
        # The weight's encode (planes and twin): once a step for a layer
        # weight (at its forward entry), once a microbatch for the head.
        wenc = 0.0
        if lbl.startswith("fwd"):
            wenc = time_ms(rot(lambda b, nu, pr, st: prepared.prepare_rhs(
                b, cfg, with_twin=True)), 5)
            reps = HOIST_MICRO if tr else count // (HOIST_MICRO * 2)
            totals["weight_encode_ms"] += reps * wenc
        log(f"[prepared-kernel] {lbl} M={m}{' (B transposed)' if tr else ''}"
            f" x{count}/step: route {ms:.4f} ms (lhs encode {enc:.4f}, plane "
            f"GEMM {planes:.4f}: mainloop {main:.4f}, CRT {planes - main:.4f}"
            f"), plain {plain:.4f} ms, float-rhs form {float_rhs:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), yardstick torch._int_mm x{M_MAIN} "
            f"{yard:.4f} ms" + (f"; weight + twin encode {wenc:.4f} ms"
                                if wenc else ""))
        del bs, preps, stacks
    totals["crt_ms"] = totals["planes_ms"] - totals["mainloop_ms"]
    log(f"[prepared-kernel] per hoisted step: route {totals['ms']:.3f} ms "
        f"(lhs encodes {totals['encode_ms']:.3f}, plane GEMMs "
        f"{totals['planes_ms']:.3f}: mainloop {totals['mainloop_ms']:.3f}, "
        f"CRT {totals['crt_ms']:.3f}), weight encodes "
        f"{totals['weight_encode_ms']:.3f} ms, plain {totals['plain_ms']:.3f}"
        f" ms, float-rhs form {totals['float_rhs_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.3f} ms")
    return max_err, totals


def hoisted_train_phase(dev, arch, card: str):
    """Full-width ``arch`` under HOIST_SPEC with HOIST_MICRO microbatches:
    one warm-up and TRAIN_STEPS timed steps with the launch counts and
    prepare_rhs calls read around them, then TRAIN_STEPS traced."""
    from torch.profiler import ProfilerActivity, profile
    arch = micro_arch(arch)
    mcfg = arch.model
    tag = f"[hoist {mcfg.name}]"
    step = S.make_train_step(arch, policy=GemmPolicy(
        default=api.precision(HOIST_SPEC)))
    run = {"state": S.init_state(arch, 0, dev)}
    batches = train_batches(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with counting_preps() as calls:
        reset_counts()
        losses, warm = run_steps(step, run, batches, 1)
        timed, walls = run_steps(step, run, batches, TRAIN_STEPS)
        k1, k2, k3 = snapshot_counts()
        n_preps = calls["n"]
    losses += timed
    peak = torch.cuda.max_memory_allocated(dev)
    tok_s = TRAIN_STEPS * TOKENS / sum(walls)
    n_run = 1 + TRAIN_STEPS
    plain = k1.plain_cuda_calls + k2.plain_cuda_calls + k3.plain_cuda_calls
    launches = {"prepared": k3.launches_prepared,
                "encode": k3.launches_encode, "planes": k3.launches_planes,
                "2d": k3.launches_2d, "batched": k3.launches_batched,
                "residues": k3.launches_residues,
                "emugemm1": k1.launches_2d + k1.launches_batched
                + k1.launches_mixed + k1.launches_encode
                + k1.launches_planes,
                "decompose": k2.launches_pair + k2.launches_rhs,
                "plain_on_cuda": plain}
    log(f"{tag} 1 + {TRAIN_STEPS} steps of {HOIST_MICRO} x "
        f"{TOKENS // HOIST_MICRO} tokens under {HOIST_SPEC}: losses {losses}, "
        f"warm-up wall s {warm[0]:.3f}, timed step wall s "
        f"{[round(w, 3) for w in walls]}, {tok_s:.1f} tokens/s over the "
        f"timed steps, peak memory {peak / 2 ** 30:.2f} GiB on {card}; "
        f"launches {json.dumps(launches)}; prepare_rhs calls {n_preps}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    expect = hoisted_launches(mcfg)
    got = (k3.launches_prepared, k3.launches_encode, k3.launches_planes,
           k3.launches_2d, k3.launches_batched, n_preps)
    want = tuple(n_run * expect[k] for k in ("prepared", "encode", "planes",
                                             "2d", "batched", "preps"))
    if got != want or launches["emugemm1"] or launches["decompose"]:
        raise AssertionError(f"launches or preps {got} differ from the "
                             f"per-step accounting {want} ({expect})")
    if plain:
        raise AssertionError("the hoisted step ran a plain version on CUDA")
    w = expect["preps"] - HOIST_MICRO
    log(f"{tag} preps built once per step: {n_preps // n_run} prepare_rhs "
        f"calls a step, one for each of the {w} layer weights and one for "
        f"the tied head in each of the {HOIST_MICRO} microbatches (preparing "
        f"in every microbatch's forward and recompute would make "
        f"{2 * HOIST_MICRO * w + HOIST_MICRO})")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_losses, prof_walls = run_steps(step, run, batches, TRAIN_STEPS)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    profiled = device_summary(prof, prof_wall_ms, top_n=6)
    profiled["step_wall_s"] = prof_walls
    log(f"{tag} {TRAIN_STEPS} profiled steps " + json.dumps(profiled))
    if not all(math.isfinite(x) for x in prof_losses):
        raise AssertionError(f"non-finite training loss {prof_losses}")
    summary = {"spec": HOIST_SPEC, "microbatches": HOIST_MICRO,
               "losses": losses, "warmup_wall_s": warm[0],
               "step_wall_s": walls, "tokens_per_s": tok_s,
               "peak_memory_bytes": peak, "launches_per_step": expect,
               "prepare_rhs_calls": n_preps, "profile": profiled}
    return run["state"]["params"], k3, summary


def hoisted_parity_phase(dev, arch, params, policy, label, uncached=None,
                         torch_backend=False):
    """One step's loss and float32 gradients at full width, bit for bit:
    hoisted preps (each weight prepared once, the tied head once per
    microbatch) == the per-call cache on each half (the float32 mean of
    two microbatches=1 evaluations), == ``uncached`` when given, and the
    'cuda' == the 'torch' backend when asked."""
    _, batch = next(train_batches(arch))
    halves = S.split_batch(S.batch_to(batch, dev), HOIST_MICRO)

    def grads(pol, hoist):
        preps = prepared.build_step_preps(params, pol) if hoist else None
        return S.accumulate_grads(S.make_loss_fn(arch, pol), params, halves,
                                  preps)

    with counting_preps() as calls:
        hoisted = grads(policy, True)
    want = hoisted_launches(arch.model)["preps"]
    if calls["n"] != want:
        raise AssertionError(f"({label}) the hoisted step prepared "
                             f"{calls['n']} times, not {want}")
    grads_equal(f"({label}) hoisted == mean of the halves' per-call cache",
                hoisted, grads(policy, False))
    if uncached is not None:
        grads_equal(f"({label}) hoisted == uncached", hoisted,
                    grads(uncached, False))
    if torch_backend:
        grads_equal(f"({label}) hoisted, cuda == torch backend", hoisted,
                    grads(on_backend(policy, "torch"), True))


# ---------------------------------------------------------------------------
# Phase 15: the scientific GEMMs, DGEMM- and ZGEMM-grade.
# ---------------------------------------------------------------------------

def eq19(gen, shape, dtype, dev):
    """Paper Eq. 19 matrices drawn in the working type (a complex one has
    two such parts), so float64 carries all 53 mantissa bits, which
    ``conditioned`` (float32, then cast) would not."""
    part = (torch.float64 if dtype in (torch.float64, torch.complex128)
            else torch.float32)

    def draw():
        return (torch.rand(shape, generator=gen, device=dev, dtype=part)
                - 0.5) * torch.exp(2 * torch.randn(shape, generator=gen,
                                                   device=dev, dtype=part))
    return torch.complex(draw(), draw()) if dtype.is_complex else draw()


def timed(fn):
    """(ms, result) of one synchronised call, CUDA events."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def threem_bound(m, k, n, p, part_bytes):
    """Least time of a complex GEMM by 3M: both complex operands and the
    scales read once, the complex output written once, against 3p int8
    GEMMs at the int8 peak."""
    moved = part_bytes * (2 * (m * k + k * n) + m + n + 2 * m * n)
    ops_ = 3 * p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def threem_residue_bound(m, k, n, p):
    moved = p * (3 * (m * k + k * n) + 2 * m * n)
    ops_ = 3 * p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def in_place(x) -> bool:
    """Does the residue plane GEMM read residues (p, [3,] R, K) in place
    (else the route lays them out first)?"""
    return ozaki2.tma_strides(x.shape, x.stride(), x.data_ptr()) is not None


def relayout_bound(x):
    """Least time of laying out residues (p, [3,] R, K): read once, the
    K-padded planes written once."""
    *_, k = x.shape
    moved = x.numel() // k * (k + ozaki2.plane_k(k))
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def relayout_library(x):
    """One PyTorch call that gives the relayout's planes of residues x:
    ``F.pad`` past K (a new contiguous tensor), or where K is already a
    whole number of K tiles (``F.pad`` by 0 keeps the strides) a
    contiguous copy."""
    pad = ozaki2.plane_k(x.shape[-1]) - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x.contiguous()


def check_relayout(what, x, max_err):
    """The relayout kernel against its plain version on residues x, bit
    for bit, the zero residues past K included."""
    return check_equal(f"relayout {what} {tuple(x.shape)} {x.stride()}",
                       ozaki2.relayout_planes(x),
                       ozaki2.relayout_planes_plain(x), max_err, "relayout")


def residue_split(a, b, moduli, iters):
    """The residue route's kernels timed apart on its operands (K5: (p, M,
    K) @ (p, K, N); K7: phase stacks): the relayouts of the operands a
    tensor map cannot read in place, the residue plane GEMM, and its
    mainloop alone (the epilogue off), ms; the relayouts' count and
    bound."""
    gemm = ozaki3m.residue_planes_3m if a.dim() == 4 else ozaki2.residue_planes
    b_t = b.transpose(-1, -2)
    relaid = [x for x in (a, b_t) if not in_place(x)]

    def prep():
        return ozaki2._k_major(a), ozaki2._k_major(b_t)
    relayout_ms = time_ms(prep, iters) if relaid else 0.0
    ka, kb = prep()
    gemm_ms = time_ms(lambda: gemm(ka, kb, moduli), iters)
    *lead, m, k = a.shape
    # The mainloop alone: the kernel launched with its epilogue off.
    if a.dim() == 3:
        ka, kb = ka[:, None], kb[:, None]
    out_re = torch.empty((a.shape[0], m, b.shape[-1]), dtype=torch.int8,
                         device=a.device)
    out_im = torch.empty_like(out_re) if a.dim() == 4 else None
    main_ms = time_ms(lambda: ozaki2.launch_residues(
        ka, kb, tuple(moduli), out_re, out_im, epilogue=False), iters)
    ops_ = math.prod(lead) * 2 * m * b.shape[-1] * k
    return {"relayout_ms": relayout_ms, "residue_gemm_ms": gemm_ms,
            "mainloop_ms": main_ms, "epilogue_ms": gemm_ms - main_ms,
            "mainloop_tops": ops_ / main_ms / 1e9, "relayouts": len(relaid),
            "relayout_bound_ms": sum(relayout_bound(x)[0] for x in relaid)}


def residue_layouts(gen, dev, lead, m, k, n):
    """(label, a, b): full-range int8 residues lead + (M, K) @ lead + (K,
    N) in four layouts: contiguous; B as the transposed view of B^T's
    residues; an A whose modulus (and phase) strides are not the
    contiguous ones; an A whose base is one byte off."""
    def res(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    a, b = res(*lead, m, k), res(*lead, k, n)
    nl = len(lead)
    a_perm = res(m, *lead, k).permute(*range(1, nl + 1), 0, nl + 1)
    a_off = res(math.prod(lead) * m * k + 1)[1:].view(*lead, m, k)
    return (("contiguous", a, b),
            ("B^T view", a, res(*lead, n, k).transpose(-1, -2)),
            ("strided A", a_perm, b), ("offset A", a_off, b))


def residue_checks(dev, max_err):
    """K5 and K7 on the residue route against their plain versions, bit
    for bit, on full-range residues: every (M, N, K) of RES_MN x RES_MN x
    RES_K with each RES_MODULI set, in the four layouts of
    ``residue_layouts``, and the wrapping sum RES_WRAP; and in each case
    the relayout kernel alone on A and on B^T. Returns the number of
    cases and of the relayouts the routes launched."""
    gen = torch.Generator(device=dev).manual_seed(22)
    forms = (("K5", ozaki2.fused_residue_matmul,
              ozaki2.fused_residue_matmul_plain, "residues"),
             ("K7", ozaki3m.fused_3m_residue_matmul,
              ozaki3m.fused_3m_residue_matmul_plain, "3m_residues"))
    cases, relaid = 0, 0
    for moduli in RES_MODULI:
        p = len(moduli)
        for m, n, k in ((m, n, k) for m in RES_MN for n in RES_MN
                        for k in RES_K):
            for form, run, plain, key in forms:
                lead = (p, 3) if form == "K7" else (p,)
                for lbl, a, b in residue_layouts(gen, dev, lead, m, k, n):
                    before = ozaki2.COUNTS.launches_relayout
                    out, ref = run(a, b, moduli), plain(a, b, moduli)
                    relaid += ozaki2.COUNTS.launches_relayout - before
                    if form == "K7":
                        out, ref = torch.stack(out), torch.stack(ref)
                    check_equal(f"{form} {lbl} {(m, k, n)} moduli {moduli}",
                                out, ref, max_err, key)
                    for x in (a, b.transpose(-1, -2)):
                        check_relayout(f"{form} {lbl}", x, max_err)
                    cases += 1
    m, k, n, moduli = RES_WRAP
    a = torch.full((1, m, k), -128, dtype=torch.int8, device=dev)
    b = torch.full((1, k, n), -128, dtype=torch.int8, device=dev)
    ref = ozaki2.fused_residue_matmul_plain(a, b, moduli)
    mod = moduli[0]
    if (ref == (k * 2 ** 14 + mod // 2) % mod - mod // 2).any():
        raise AssertionError("the wrap case's sums do not wrap")
    check_equal(f"K5 wrapping sums {(m, k, n)} moduli {moduli}",
                ozaki2.fused_residue_matmul(a, b, moduli), ref, max_err,
                "residues")
    return cases + 1, relaid


def extended_reference(a_rows, b, pool):
    """a_rows @ b in numpy longdouble on the host, in column chunks on a
    thread pool; returns a function that waits for the product."""
    cplx = a_rows.is_complex() or b.is_complex()
    ar, br = a_rows.real.cpu().numpy(), b.real.cpu().numpy()
    ai, bi = ((a_rows.imag.cpu().numpy(), b.imag.cpu().numpy()) if cplx
              else (None, None))
    cols = np.array_split(np.arange(br.shape[1]), 32)

    def mm(x, y):
        return x.astype(np.longdouble) @ y.astype(np.longdouble)

    def part(c):
        if not cplx:
            return mm(ar, br[:, c])
        return (mm(ar, br[:, c]) - mm(ai, bi[:, c])
                + 1j * (mm(ar, bi[:, c]) + mm(ai, br[:, c])))

    futures = [pool.submit(part, c) for c in cols]
    return lambda: np.concatenate([f.result() for f in futures], axis=1)


def effective_bits(c_rows, ref) -> float:
    """-log2(max |c - ref| / max |ref|) over the sampled rows, in
    longdouble."""
    c = c_rows.cpu().numpy()
    c = c.astype(np.clongdouble if np.iscomplexobj(c) else np.longdouble)
    return float(-np.log2(float(np.abs(c - ref).max() / np.abs(ref).max())))


def scientific_kernel_checks(dev, gen, max_err):
    """The plane route (K7g, float64 K5g), K7 and float64 EmuGEMM-II
    against their plain versions, bit for bit: the encode kernels alone
    (float64, complex64 and complex128 operands, a transposed view, a
    real operand of a complex product); complex64 and complex128 at m in
    {4, 8, 12, 16} (ragged, a transposed view, complex @ real, real @
    complex, rows of tiny magnitude, 1024^3); K7 on random residues;
    float64 at m in {8, 12, 16} (the 2-D plane route and the batched
    form, float64 and float32 outputs, float32 operands to a float64
    output, and the residue route) and at K = SCI_LONG_K, m = 16. One row
    a case, with its maximum absolute difference, which must be 0; then
    K5 and K7 on the residue route (``residue_checks``), one line."""
    rows = []
    # The plane route's own cases draw from a generator of their own, so
    # that the timed inputs are those of earlier runs.
    gen17 = torch.Generator(device=dev).manual_seed(17)

    def case(what, out, ref, key):
        err = check_equal(what, out, ref, max_err, key)
        rows.append(what)
        log(f"[scientific] case {what}: max |kernel - plain| {err}")
    for p in SCI_M_CHECK:
        moduli = default_moduli(p)
        for dtype in (torch.float64, torch.complex64, torch.complex128):
            x, y = (eq19(gen17, (200, 136), dtype, dev),
                    eq19(gen17, (136, 72), dtype, dev))
            if dtype == torch.float64:
                mu, nu = scheme2.scales(x, y, moduli)
                enc, plain, key = (ozaki2.encode_planes,
                                   ozaki2.encode_planes_plain, "encode")
                ops_ = ((x, mu), (y.T, nu.T))
            else:
                mu, nu = complex3m.scales(x, y, moduli)
                enc, plain, key = (ozaki3m.encode_planes_3m,
                                   ozaki3m.encode_planes_3m_plain,
                                   "encode_3m")
                ops_ = ((x, mu), (y.T, nu.T), (x.real.contiguous(), mu))
            for v, sc in ops_:
                case(f"encode {tuple(v.shape)} {v.dtype} strides "
                     f"{v.stride()} m={p}", enc(v, sc, moduli),
                     plain(v, sc, moduli), key)
    for dtype in (torch.complex64, torch.complex128):
        part = torch.float64 if dtype == torch.complex128 else torch.float32
        tiny = 2.0 ** -1000 if part == torch.float64 else 2.0 ** -120
        for p in SCI_M_CHECK:
            moduli = default_moduli(p)
            a = eq19(gen, (200, 136), dtype, dev)
            a[:3] *= tiny                  # 1 / (mu * nu) subnormal or 0
            b = eq19(gen, (136, 72), dtype, dev)
            bt = eq19(gen, (72, 136), dtype, dev).T
            big = (eq19(gen, (SCI_BIG, SCI_BIG), dtype, dev),
                   eq19(gen, (SCI_BIG, SCI_BIG), dtype, dev))
            for lbl, x, y in (("ragged", a, b), ("B transposed", a, bt),
                              ("complex @ real", a, b.real.contiguous()),
                              ("real @ complex", a.real.contiguous(), b),
                              (f"{SCI_BIG}^3", *big)):
                mu, nu = complex3m.scales(x, y, moduli)
                case(f"emugemm3m {lbl} {tuple(x.shape)} @ {tuple(y.shape)} "
                     f"{x.dtype} @ {y.dtype} m={p}",
                     ozaki3m.fused_matmul_3m(x, y, mu, nu, moduli, part),
                     ozaki3m.fused_matmul_3m_plain(x, y, mu, nu, moduli,
                                                   part), "3m_2d")
            del a, b, bt, big
    for p in SCI_M_CHECK:
        moduli = default_moduli(p)
        for m, k, n in ((200, 136, 72), (SCI_BIG,) * 3):
            a3 = torch.randint(-128, 128, (p, 3, m, k), generator=gen,
                               device=dev, dtype=torch.int8)
            b3 = torch.randint(-128, 128, (p, 3, k, n), generator=gen,
                               device=dev, dtype=torch.int8)
            out = ozaki3m.fused_3m_residue_matmul(a3, b3, moduli)
            ref = ozaki3m.fused_3m_residue_matmul_plain(a3, b3, moduli)
            case(f"emugemm3m residues {(p, 3, m, k, n)} m={p}",
                 torch.stack(out), torch.stack(ref), "3m_residues")
    n_res, relaid = residue_checks(dev, max_err)
    log(f"[scientific] residue route: {n_res} K5 / K7 cases (M, N in "
        f"{RES_MN}, K in {RES_K}, moduli {RES_MODULI}, 4 layouts; the "
        f"wrapping sum {RES_WRAP[:3]}) bit-identical to the plain versions, "
        f"{relaid} relayouts; the relayout alone on each case's A and B^T "
        f"bit-identical to its plain version")
    f64 = torch.float64
    for p in F64_M_CHECK:
        moduli = default_moduli(p)
        for lbl, lead, m, k, n, tb in (
                ("ragged", (), 200, 136, 72, False),
                ("B transposed", (), 200, 136, 72, True),
                (f"{SCI_BIG}^3", (), SCI_BIG, SCI_BIG, SCI_BIG, False),
                ("batched", (8,), 128, 128, 128, False),
                ("batched, B transposed", (8,), 128, 128, 128, True)):
            a = eq19(gen, lead + (m, k), f64, dev)
            b = (eq19(gen, lead + (n, k), f64, dev).transpose(-1, -2) if tb
                 else eq19(gen, lead + (k, n), f64, dev))
            for x, y, out_t in ((a, b, f64), (a, b, torch.float32),
                                (a.float(), b.float(), f64)):
                mu, nu = scheme2.scales(x, y, moduli)
                case(f"emugemm2 {lbl} {tuple(x.shape)} @ {tuple(y.shape)} "
                     f"{x.dtype} -> {out_t} m={p}",
                     ozaki2.fused_matmul_scheme2(x, y, mu, nu, moduli, out_t),
                     ozaki2.fused_matmul_scheme2_plain(x, y, mu, nu, moduli,
                                                       out_t),
                     "f64_batched" if lead else "f64_2d")
        a, b = eq19(gen, (200, 136), f64, dev), eq19(gen, (136, 72), f64, dev)
        mu, nu = scheme2.scales(a, b, moduli)
        case(f"emugemm2 residue route (200, 136) @ (136, 72) float64 m={p}",
             ops.fused_scheme2_matmul(a, b, f"ozaki2-m{p}", out_dtype=f64),
             ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu, moduli, f64),
             "f64_residues")
    # Past the plane GEMM's in-kernel reduction: its K tiles between
    # reductions (1023 at m = 256) cover 130944 < SCI_LONG_K.
    moduli = default_moduli(16)
    a = eq19(gen17, (64, SCI_LONG_K), f64, dev)
    b = eq19(gen17, (SCI_LONG_K, 64), f64, dev)
    mu = scheme2._pow2_int_scale(a, -1, 52)
    nu = scheme2._pow2_int_scale(b, -2, 52)
    case(f"emugemm2 plane route (64, {SCI_LONG_K}) @ ({SCI_LONG_K}, 64) "
         "float64 m=16", ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, f64),
         ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu, moduli, f64),
         "f64_2d")
    log(f"[scientific] {len(rows)} complex64/complex128/float64 kernel "
        "cases bit-identical to the plain versions")


def scientific_main_path(dev, gen, za, zb, da, db):
    """The front doors a user calls, with every count zeroed just before
    and read just after: ZGEMM and DGEMM through ``api.einsum`` (the
    plane route: two encodes and one plane GEMM each, the DGEMM one 2-D
    front-door call) and the residue routes (K7, K5 with a float64 CRT:
    each a relayout of B^T and one residue plane GEMM),
    a float64 and a complex128 batched einsum (K6 and batched K7g: the
    batched plane route, two encodes and one plane GEMM each, the float64
    one a batched front-door call) and a complex64 GEMM under ozaki1-p4 (four
    EmuGEMM-I launches). Then the float64 batch is timed, with its
    encode / mainloop / CRT split, beside its bound, its plain version
    and cuBLAS's batched DGEMM."""
    spec = f"ozaki2-m{SCI_M_FRONT}"
    moduli = default_moduli(SCI_M_FRONT)
    ba = eq19(gen, SCI_BATCHED, torch.float64, dev)
    bb = eq19(gen, SCI_BATCHED, torch.float64, dev)
    # The complex batch draws from a generator of its own, so that the
    # inputs drawn after it are those of earlier runs.
    gen18 = torch.Generator(device=dev).manual_seed(18)
    zba = eq19(gen18, SCI_BATCHED, torch.complex128, dev)
    zbb = eq19(gen18, SCI_BATCHED, torch.complex128, dev)
    n4m = SCI_4M_N
    ca, cb = (za[:n4m, :n4m].to(torch.complex64),
              zb[:n4m, :n4m].to(torch.complex64))
    torch.cuda.synchronize()
    reset_counts()
    out = {
        "zgemm": api.einsum("mk,kn->mn", za, zb, precision=spec),
        "zgemm_residues": ops.fused_3m_matmul(za, zb, spec),
        "dgemm": api.einsum("mk,kn->mn", da, db, precision=spec),
        "dgemm_residues": ops.fused_scheme2_matmul(da, db, spec,
                                                   out_dtype=torch.float64),
        "batched": api.einsum("bmk,bkn->bmn", ba, bb, precision=spec),
        "zbatched": api.einsum("bmk,bkn->bmn", zba, zbb, precision=spec),
        "4m": api.einsum("mk,kn->mn", ca, cb, precision="ozaki1-p4"),
    }
    torch.cuda.synchronize()
    c1, _, c2 = snapshot_counts()
    c3 = ozaki3m.LaunchCounts(**vars(ozaki3m.COUNTS))
    counts = {"emugemm3m_encode": c3.launches_encode,
              "emugemm3m_planes": c3.launches_planes,
              "emugemm3m_residues": c3.launches_residues,
              "emugemm2_encode": c2.launches_encode,
              "emugemm2_planes": c2.launches_planes,
              "emugemm2_2d": c2.launches_2d,
              "emugemm2_residues": c2.launches_residues,
              "emugemm2_relayout": c2.launches_relayout,
              "emugemm2_batched": c2.launches_batched,
              "emugemm1_2d": c1.launches_2d,
              "emugemm1_encode": c1.launches_encode,
              "emugemm1_planes": c1.launches_planes}
    plain = c1.plain_cuda_calls + c2.plain_cuda_calls + c3.plain_cuda_calls
    log(f"[scientific] main path launches {json.dumps(counts)}; plain "
        f"versions on CUDA {plain}")
    # The residue routes: B's residues arrive N-contiguous (one relayout
    # each, K5's and K7's), A's K-contiguous at K = 4096 (read in place).
    if counts != {"emugemm3m_encode": 4, "emugemm3m_planes": 2,
                  "emugemm3m_residues": 1, "emugemm2_encode": 4,
                  "emugemm2_planes": 2, "emugemm2_2d": 1,
                  "emugemm2_residues": 1, "emugemm2_relayout": 2,
                  "emugemm2_batched": 1,
                  "emugemm1_2d": 4, "emugemm1_encode": 8,
                  "emugemm1_planes": 4} or plain:
        raise AssertionError("the scientific front doors did not launch "
                             "each kernel as expected")
    for kind in ("zgemm", "dgemm"):
        if not torch.equal(out[kind], out[kind + "_residues"]):
            raise AssertionError(f"{kind}: the fused and residue routes "
                                 "differ")
    if not torch.equal(out["4m"], dispatch.emulated_matmul(
            ca, cb, cfg="ozaki1-p4", backend="torch")):
        raise AssertionError("complex64 ozaki1-p4: four EmuGEMM-I launches "
                             "!= matmul_complex_4m on the torch backend")
    mu, nu = scheme2.scales(ba, bb, moduli)
    if not torch.equal(out["batched"], ozaki2.fused_matmul_scheme2_plain(
            ba, bb, mu, nu, moduli, torch.float64)):
        raise AssertionError("float64 batched einsum != its plain version")
    for e in range(SCI_BATCHED[0]):
        if not torch.equal(out["batched"][e], scheme2.matmul(
                ba[e], bb[e], api.precision(spec))):
            raise AssertionError(f"float64 batched einsum, element {e} != "
                                 "scheme2.matmul")
    if not torch.equal(out["zbatched"][-1], api.einsum(
            "mk,kn->mn", zba[-1], zbb[-1], precision=spec)):
        raise AssertionError("complex128 batched einsum != the 2-D einsum "
                             "of its element")
    del zba, zbb
    b_ms = time_ms(lambda: ozaki2.fused_matmul_scheme2(
        ba, bb, mu, nu, moduli, torch.float64), 10)
    b_plain = time_ms(lambda: ozaki2.fused_matmul_scheme2_plain(
        ba, bb, mu, nu, moduli, torch.float64), 1)
    b_bms, b_by = scheme2_bound(*SCI_BATCHED, SCI_BATCHED[-1], SCI_M_FRONT,
                                8, 8)
    b_lib = time_ms(lambda: torch.matmul(ba, bb), 10)
    enc_ms, main_ms, gemm_ms, _ = plane_split("dgemm", ba, bb, mu, nu, moduli,
                                              10)
    bt, m, k = SCI_BATCHED
    # The same split on the wide tile, which the route leaves for the
    # narrow one on a grid this small.
    tile_n = ozaki2.plane_tile_n(bt, m, k, dev)
    _, wide_main, wide_gemm, _ = plane_split("dgemm", ba, bb, mu, nu, moduli,
                                             10, ozaki2.PLANE_TILE[1])
    batched = {"ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bms,
               "bound_by": b_by, "library_ms": b_lib, "encode_ms": enc_ms,
               "mainloop_ms": main_ms, "planes_ms": gemm_ms,
               "crt_ms": gemm_ms - main_ms,
               "mainloop_tops": bt * SCI_M_FRONT * 2 * m * k * k / main_ms
               / 1e9,
               "encode_bound_ms": encode_bound(m, k, k, SCI_M_FRONT, 8, 1,
                                               bt)[0],
               "tile_n": tile_n,
               "wide_tile": {"tile_n": ozaki2.PLANE_TILE[1],
                             "mainloop_ms": wide_main, "planes_ms": wide_gemm,
                             "crt_ms": wide_gemm - wide_main,
                             "route_ms": enc_ms + wide_gemm}}
    log(f"[scientific] front doors: ZGEMM and DGEMM fused == residue route, "
        f"4M == matmul_complex_4m, the float64 batch == its plain version "
        f"and scheme2.matmul per element, the complex128 batch == the 2-D "
        f"einsum, bit for bit; float64 batched {SCI_BATCHED} "
        f"m={SCI_M_FRONT}: route {b_ms:.4f} ms (encode {enc_ms:.4f}, "
        f"mainloop {main_ms:.4f} at {batched['mainloop_tops']:.1f} int8 "
        f"TOPS, CRT {gemm_ms - main_ms:.4f}; tile 128 x {tile_n}; on the "
        f"128 x {ozaki2.PLANE_TILE[1]} tile: mainloop {wide_main:.4f}, CRT "
        f"{wide_gemm - wide_main:.4f}, route {enc_ms + wide_gemm:.4f}), "
        f"plain {b_plain:.3f} ms, bound {b_bms:.4f} ms ({b_by}), cuBLAS "
        f"{b_lib:.4f} ms")
    return counts, out, batched


def encode_bound(m, k, n, p, part_bytes, phases, batch=1):
    """Least time of the two encodes of a ([batch,] M, K) @ ([batch,] K,
    N): the operands' parts and scales read once, the int8 planes
    (p * phases of them, K padded to the plane GEMM's tile) written
    once."""
    parts = 2 if phases == 3 else 1
    moved = (part_bytes * (parts * (m * k + k * n) + m + n)
             + p * phases * ozaki2.plane_k(k) * (m + n))
    return 1e3 * batch * moved / HBM_BYTES_PER_S, "bytes"


def planes_bound(m, k, n, p, out_bytes, phases):
    """Least time of the plane GEMM: the planes and scales read once and
    the output written once, against p * phases int8 GEMMs at the int8
    peak."""
    kp = ozaki2.plane_k(k)
    moved = p * phases * kp * (m + n) + 8 * (m + n) + out_bytes * m * n
    ops_ = p * phases * 2 * m * n * kp
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def plane_split(kind, a, b, mu, nu, moduli, iters, tile_n=None,
                out_dtype=torch.float64):
    """The plane route's kernels timed apart on a route's operands, 2-D or
    batched: (the two encodes, the plane GEMM's mainloop alone, the plane
    GEMM with its CRT epilogue), ms; and the planes. ``kind`` "dgemm" is
    a real product (any operand types) into ``out_dtype``, "zgemm" a 3M
    one; ``tile_n`` sets the plane GEMM's tile width (default: the one
    the route chooses)."""
    bt, nut = b.transpose(-1, -2), nu.transpose(-1, -2)
    shape = (*a.shape[:-1], b.shape[-1])
    if kind == "dgemm":
        def enc():
            return (ozaki2.encode_planes(a, mu, moduli)[:, None],
                    ozaki2.encode_planes(bt, nut, moduli)[:, None])
        out = torch.empty(shape, dtype=out_dtype, device=a.device)
    else:
        def enc():
            return (ozaki3m.encode_planes_3m(a, mu, moduli),
                    ozaki3m.encode_planes_3m(bt, nut, moduli))
        out = torch.empty(shape, dtype=torch.complex128, device=a.device)
    enc_ms = time_ms(enc, iters)
    ap, bp = enc()
    main_ms = time_ms(lambda: ozaki2.launch_planes(
        ap, bp, mu, nu, moduli, out, epilogue=False, tile_n=tile_n), iters)
    gemm_ms = time_ms(lambda: ozaki2.launch_planes(
        ap, bp, mu, nu, moduli, out, tile_n=tile_n), iters)
    return enc_ms, main_ms, gemm_ms, (ap, bp)


def scientific_phase(dev):
    """DGEMM- and ZGEMM-grade Scheme II: the kernels against their plain
    versions, the front doors, then M = N = K = 4096 at m in {8, 12, 16}
    and 8192 at m = 16, float64 and complex128 on the plane route,
    beside their bounds, the plain versions (4096 only; at 8192 the
    route's first 256 rows are held against the plain version of those
    rows, which is exact because mu is per row and nu depends on b
    alone), the torch._int_mm yardstick and cuBLAS DGEMM / ZGEMM, with
    the encode, the mainloop and the CRT epilogue timed apart and the
    effective bits of the route and of cuBLAS against a longdouble
    product of 64 sampled rows computed on the host. At 4096^3, m = 16,
    each plane kernel is timed beside its plain version."""
    gen = torch.Generator(device=dev).manual_seed(14)
    max_err = dict.fromkeys(("encode", "encode_3m", "3m_2d", "3m_residues",
                             "residues", "relayout", "f64_2d", "f64_batched",
                             "f64_residues"), 0.0)
    t0 = time.perf_counter()
    scientific_kernel_checks(dev, gen, max_err)
    inputs = {(n, kind): (eq19(gen, (n, n), dtype, dev),
                          eq19(gen, (n, n), dtype, dev))
              for n, _ in SCI_SIZES
              for kind, dtype in (("dgemm", torch.float64),
                                  ("zgemm", torch.complex128))}
    n0, p_last = SCI_SIZES[0][0], SCI_SIZES[0][1][-1]
    counts, front, batched = scientific_main_path(
        dev, gen, *inputs[n0, "zgemm"], *inputs[n0, "dgemm"])
    pool = ThreadPoolExecutor(os.cpu_count() or 4)
    table, timings = [], {}
    try:
        # The host references run while the card works.
        samples, exact = {}, {}
        for (n, kind), (a, b) in inputs.items():
            samples[n, kind] = torch.randperm(n, generator=gen,
                                              device=dev)[:EVAL_ROWS]
            exact[n, kind] = extended_reference(a[samples[n, kind]], b, pool)
        for n, ps in SCI_SIZES:
            for kind in ("dgemm", "zgemm"):
                a, b = inputs[n, kind]
                lib_ms = time_ms(lambda: torch.matmul(a, b), 3)
                lib_out = torch.matmul(a, b)
                for p in ps:
                    moduli = default_moduli(p)
                    if kind == "dgemm":
                        mu, nu = scheme2.scales(a, b, moduli)
                        kern, plain = (ozaki2.fused_matmul_scheme2,
                                       ozaki2.fused_matmul_scheme2_plain)
                        bms, by = scheme2_bound(1, n, n, n, p, 8, 8)
                        n_mm = p
                    else:
                        mu, nu = complex3m.scales(a, b, moduli)
                        kern, plain = (ozaki3m.fused_matmul_3m,
                                       ozaki3m.fused_matmul_3m_plain)
                        bms, by = threem_bound(n, n, n, p, 8)
                        n_mm = 3 * p
                    f64 = torch.float64
                    out = kern(a, b, mu, nu, moduli, f64)      # warm-up
                    if n == n0:
                        ms = time_ms(lambda: kern(a, b, mu, nu, moduli, f64),
                                     3)
                        plain_ms, ref = timed(lambda: plain(a, b, mu, nu,
                                                            moduli, f64))
                        rows = slice(None)
                        if p == SCI_M_FRONT and not torch.equal(out,
                                                                front[kind]):
                            raise AssertionError(f"{kind}: einsum != the "
                                                 "direct kernel call")
                    else:
                        ms = time_ms(lambda: kern(a, b, mu, nu, moduli, f64),
                                     1)
                        plain_ms, rows = None, slice(0, SCI_ROWS)
                        ref = plain(a[rows], b, mu[rows], nu, moduli, f64)
                    check_equal(f"{kind} {n}^3 m={p} rows {rows}", out[rows],
                                ref, max_err,
                                "f64_2d" if kind == "dgemm" else "3m_2d")
                    del ref
                    phases = 1 if kind == "dgemm" else 3
                    enc_ms, main_ms, gemm_ms, planes = plane_split(
                        kind, a, b, mu, nu, moduli, 3 if n == n0 else 1)
                    split = {
                        "encode_ms": enc_ms, "mainloop_ms": main_ms,
                        "planes_ms": gemm_ms, "crt_ms": gemm_ms - main_ms,
                        "mainloop_tops": phases * p * 2 * n ** 3 / main_ms
                        / 1e9,
                        "encode_bound_ms": encode_bound(n, n, n, p, 8,
                                                        phases)[0],
                        **dict(zip(("planes_bound_ms", "planes_bound_by"),
                                   planes_bound(n, n, n, p,
                                                8 if phases == 1 else 16,
                                                phases)))}
                    if n == n0 and p == p_last:
                        # The plane kernels beside their plain versions.
                        if kind == "dgemm":
                            enc_p, mm_p = (ozaki2.encode_planes_plain,
                                           ozaki2.plane_matmul_plain)
                        else:
                            enc_p, mm_p = (ozaki3m.encode_planes_3m_plain,
                                           ozaki3m.plane_matmul_3m_plain)
                        split["encode_plain_ms"] = timed(lambda: (
                            enc_p(a, mu, moduli), enc_p(b.T, nu.T, moduli)))[0]
                        ap, bp = (x.squeeze(1) if kind == "dgemm" else x
                                  for x in planes)
                        split["planes_plain_ms"] = timed(lambda: mm_p(
                            ap, bp, mu, nu, moduli, f64))[0]
                        del ap, bp
                    del planes
                    yard = time_ms(int_mm_yardstick(gen, dev, 1, n, n, n,
                                                    n_mm), 1)
                    ref_rows = exact[n, kind]()
                    bits = effective_bits(out[samples[n, kind]], ref_rows)
                    lib_bits = effective_bits(lib_out[samples[n, kind]],
                                              ref_rows)
                    row = {"kind": kind, "n": n, "m": p, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bms,
                           "bound_by": by, "int_mm_yardstick_ms": yard,
                           "library_ms": lib_ms, "bits": bits,
                           "library_bits": lib_bits, **split}
                    table.append(row)
                    timings[kind, n, p] = row
                    plain_txt = ("not run" if plain_ms is None
                                 else f"{plain_ms:.3f} ms")
                    log(f"[scientific] {kind} {n}^3 m={p}: route {ms:.3f} "
                        f"ms (encode {enc_ms:.3f}, mainloop {main_ms:.3f} at "
                        f"{split['mainloop_tops']:.1f} int8 TOPS, CRT "
                        f"{gemm_ms - main_ms:.3f}), bound {bms:.4f} ms "
                        f"({by}), plain {plain_txt}, yardstick "
                        f"torch._int_mm x{n_mm} {yard:.3f} ms, cuBLAS "
                        f"{lib_ms:.3f} ms; effective bits {bits:.2f} (cuBLAS "
                        f"{lib_bits:.2f})")
                    del out
                del lib_out
            for kind in ("dgemm", "zgemm"):
                if n != n0:
                    del inputs[n, kind]
            torch.cuda.empty_cache()
        # The residue forms at the DGEMM / ZGEMM shape and moduli, with the
        # route's split (relayout, residue GEMM: mainloop, epilogue), and
        # the ops routes that drive them.
        p = SCI_SIZES[0][1][-1]
        moduli = default_moduli(p)
        res = {}
        for form, phases, run_k, run_p, bound in (
                ("3m_residues", 3, ozaki3m.fused_3m_residue_matmul,
                 ozaki3m.fused_3m_residue_matmul_plain, threem_residue_bound),
                ("residues", None, ozaki2.fused_residue_matmul,
                 ozaki2.fused_residue_matmul_plain, residue_bound)):
            lead = (p, phases) if phases else (p,)
            a_r = torch.randint(-128, 128, lead + (n0, n0), generator=gen,
                                device=dev, dtype=torch.int8)
            b_r = torch.randint(-128, 128, lead + (n0, n0), generator=gen,
                                device=dev, dtype=torch.int8)
            ms = time_ms(lambda: run_k(a_r, b_r, moduli), 3)
            plain_ms = time_ms(lambda: run_p(a_r, b_r, moduli), 1)
            bms, by = bound(n0, n0, n0, p)
            split = residue_split(a_r, b_r, moduli, 3)
            b_t = b_r.transpose(-1, -2)
            if not torch.equal(relayout_library(b_t),
                               ozaki2.relayout_planes_plain(b_t)):
                raise AssertionError("the relayout's library call differs "
                                     "from its plain version")
            res[form] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                         "bound_by": by, **split,
                         "relayout_max_abs_err": check_relayout(
                             f"{form} B^T", b_t, max_err),
                         "relayout_plain_ms": time_ms(
                             lambda: ozaki2.relayout_planes_plain(b_t), 1),
                         "relayout_library_ms": time_ms(
                             lambda: relayout_library(b_t), 3)}
            log(f"[scientific] {form} p={p} {n0}^3 (int8 in and out): "
                f"route {ms:.3f} ms (relayouts {split['relayouts']}: "
                f"{split['relayout_ms']:.3f}, bound "
                f"{split['relayout_bound_ms']:.3f}; residue GEMM "
                f"{split['residue_gemm_ms']:.3f}: mainloop "
                f"{split['mainloop_ms']:.3f} at "
                f"{split['mainloop_tops']:.1f} int8 TOPS, epilogue "
                f"{split['epilogue_ms']:.3f}), plain {plain_ms:.3f} ms, "
                f"bound {bms:.4f} ms ({by}); relayout of B^T alone "
                f"{res[form]['relayout_plain_ms']:.3f} ms plain, "
                f"{res[form]['relayout_library_ms']:.3f} ms library")
            del a_r, b_r, b_t
        spec = f"ozaki2-m{p}"
        za, zb = inputs[n0, "zgemm"]
        da, db = inputs[n0, "dgemm"]
        res["ops_routes_ms"] = {
            "fused_3m_matmul": time_ms(lambda: ops.fused_3m_matmul(
                za, zb, spec), 3),
            "fused_scheme2_matmul": time_ms(lambda: ops.fused_scheme2_matmul(
                da, db, spec, out_dtype=torch.float64), 3)}
        log(f"[scientific] ops routes {n0}^3 m={p}: "
            f"{json.dumps(res['ops_routes_ms'])}")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    log("[scientific] table " + json.dumps(table))
    log(f"[scientific] phase took {time.perf_counter() - t0:.1f} s")
    # Phase 25 runs Scheme I on the same 4096^3 operands and holds it to
    # the same longdouble rows.
    shared = {kind: (*inputs[n0, kind], samples[n0, kind],
                     exact[n0, kind]()) for kind in ("dgemm", "zgemm")}
    return max_err, counts, timings, res, batched, shared


def emu_train_parity_phase(dev, arch, params):
    """One full-width step of olmo-1b-emu under its gemm_sites: loss and
    gradients bit-identical on the 'cuda' and 'torch' backends."""
    def run(backend):
        _, batch = next(train_batches(arch))
        loss_fn = S.make_loss_fn(arch, on_backend(arch.gemm_policy(),
                                                  backend))
        return S.value_and_grad(loss_fn, params, S.batch_to(batch, dev))

    grads_equal(f"(e) {arch.model.name}, cuda == torch backend",
                run("cuda"), run("torch"))


def trainer_phase():
    """Fail at step 2, resume, and end in the uninterrupted run's state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        argv = ["--arch", "olmo-1b", "--smoke", "--steps", "4", "--batch",
                "2", "--seq", "32", "--gemm", TRAIN_SPEC, "--device", "cuda",
                "--ckpt-every", "2"]
        ref, ft = os.path.join(tmp, "ref"), os.path.join(tmp, "ft")
        train_cli.main(argv + ["--ckpt-dir", ref])
        try:
            train_cli.main(argv + ["--ckpt-dir", ft, "--fail-at", "2"])
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("the injected failure did not fire")
        log_ft = train_cli.main(argv + ["--ckpt-dir", ft])
        if [m["step"] for m in log_ft] != [2, 3]:
            raise AssertionError(f"resume ran steps {log_ft}")
        a, b = (tree_flatten(CheckpointManager(d).restore(3))
                for d in (ref, ft))
        bad = [k for k in a if not (a[k].dtype == b[k].dtype
                                    and torch.equal(a[k], b[k]))]
        if sorted(a) != sorted(b) or bad:
            raise AssertionError(f"resumed state differs: {bad[:5]}")
        log(f"[trainer] failed at step 2, resumed, final state == "
            f"uninterrupted run's ({len(a)} leaves bit-identical)")
        preempted_run(os.path.join(tmp, "pre"), a)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def preempted_run(ckpt_dir, want, device="cuda"):
    """The trainer phase's run preempted: a step hook sends SIGTERM to the
    process inside step 1; the step finishes, its checkpoint is written
    and ``run`` returns; a new Trainer resumes from it and ends in the
    uninterrupted run's state (``want``, step 3), bit for bit."""
    arch = configs.get_smoke_config("olmo-1b")
    step = S.make_train_step(arch, policy=GemmPolicy(
        default=api.precision(TRAIN_SPEC)))
    shape = ShapeSpec("cli", 32, 2, "train")

    def trainer(hook=None, **kw):
        calls = iter(range(10 ** 9))

        def step_fn(state, batch):
            out = step(state, batch)
            if hook is not None:
                hook(next(calls))
            return out

        return Trainer(step_fn=step_fn,
                       init_state_fn=lambda: S.init_state(arch, 0, device),
                       batch_iterator=make_batch_iterator(arch, shape, 0),
                       ckpt_dir=ckpt_dir, device=device, ckpt_every=2, **kw)

    def hook(i):
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    tr = trainer(hook, handle_sigterm=True)
    try:
        log_pre = tr.run(4)
    finally:
        tr.close()
    if signal.getsignal(signal.SIGTERM) != before:
        raise AssertionError("the Trainer left its SIGTERM handler behind")
    if ([m["step"] for m in log_pre] != [0, 1]
            or CheckpointManager(ckpt_dir).latest_step() != 1):
        raise AssertionError(f"preempted run: steps {log_pre}, checkpoint "
                             f"{CheckpointManager(ckpt_dir).latest_step()}")
    tr = trainer()
    try:
        if tr.start_step != 2:
            raise AssertionError(f"resumed at step {tr.start_step}")
        tr.run(2)
    finally:
        tr.close()
    got = tree_flatten(CheckpointManager(ckpt_dir).restore(3))
    bad = [k for k in want if not (want[k].dtype == got[k].dtype
                                   and torch.equal(want[k], got[k]))]
    if sorted(want) != sorted(got) or bad:
        raise AssertionError(f"preempted and resumed state differs: "
                             f"{bad[:5]}")
    log("[trainer] SIGTERM inside step 1: the step finished, its "
        "checkpoint was written and run returned; resumed, the final "
        f"state == the uninterrupted run's ({len(got)} leaves)")


# ---------------------------------------------------------------------------
# Phase 19: the library kernels (K8, K11, K9, K10).
# ---------------------------------------------------------------------------

def s1_relayout_bound(m, k, n, p):
    """K8's two relayouts: A-hat and B-hat (p Kp bytes a row, Kp = K padded
    to decompose.TILE) read once, their planes (p Kp' a row, Kp' =
    plane_k(Kp)) written once."""
    kp = decompose.round_up(k)
    moved = p * (m + n) * (kp + ozaki1.plane_k(kp))
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def lhs_bound(m, k, p, in_bytes):
    """K11: A and mu read once, the p planes of (M, Kp) written once."""
    moved = in_bytes * m * k + 4 * m + p * m * decompose.round_up(k)
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def int8_bound(m, k, n):
    moved = m * k + k * n + 4 * m * n
    t_b, t_o = moved / HBM_BYTES_PER_S, 2 * m * n * k / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def attn_bound(b, h, kvh, sq, sk, d, causal, window, kernel):
    """q, k, v and o moved once, against 4 D flops for every (q, k) pair
    a head sees (half the pairs, plus the diagonal, when causal with
    S_q = S_k) at the peak of the kernel's arithmetic: the bf16 tensor
    cores ('wgmma'), three times the flops at the TF32 peak
    ('wgmma-3xtf32'), or float32 outside the tensor cores ('ffma')."""
    size = 2 if kernel == "wgmma" else 4
    moved = size * d * (2 * b * h * sq + 2 * b * kvh * sk)
    pairs = int(flash_attn.visible(sq, sk, causal, window).sum())
    flops = 4 * b * h * d * pairs
    t_b = moved / HBM_BYTES_PER_S
    t_o = {"wgmma": flops / BF16_FLOPS_PER_S,
           "wgmma-3xtf32": 3 * flops / TF32_FLOPS_PER_S,
           "ffma": flops / FP32_FLOPS_PER_S}[kernel]
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def split_bound(b, h, kvh, sq, sk, d):
    """The 3xTF32 pre-pass: float32 q, k, v read once, both parts of q, k
    and of v^T (keys padded to 32) written once."""
    skp = -(-sk // 32) * 32
    moved = 4 * d * (3 * b * h * sq + 4 * b * kvh * sk + 2 * b * kvh * skp)
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def library_counts():
    return {"emugemm1": ozaki1.LaunchCounts(**vars(ozaki1.COUNTS)),
            "decompose": decompose.LaunchCounts(**vars(decompose.COUNTS)),
            "int8": matmul_int8.LaunchCounts(**vars(matmul_int8.COUNTS)),
            "flash": flash_attn.LaunchCounts(**vars(flash_attn.COUNTS))}


def scheme1_cfg(p, decomp):
    return dataclasses.replace(api.precision(f"ozaki1-p{p}"), decomp=decomp)


def naive_scheme1(a, b, p, beta):
    """Paper Fig. 4's naive emulation: split both operands, p(p+1)/2 int8
    GEMMs (K9), each written to device memory, summed into p int32
    accumulators, then a separate shift-reduce."""
    a_sl, mu = scheme1.split(a, p, beta, axis=1)
    b_sl, nu = scheme1.split(b, p, beta, axis=0)
    accs = []
    for s in range(p):
        acc = ops.int8_matmul(a_sl[0], b_sl[s])
        for i in range(1, s + 1):
            acc = acc + ops.int8_matmul(a_sl[i], b_sl[s - i])
        accs.append(acc)
    return scheme1.shift_reduce(torch.stack(accs), beta, mu, nu,
                                torch.float32)


def fused_scheme1(a, b, p, beta):
    """The same GEMM in one EmuGEMM-I launch (K1), scales included."""
    mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
    return ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, beta, torch.float32)


def attn_inputs(gen, dev, case):
    _, b, h, kvh, sq, sk, d, _, _, dt = case
    dtype = getattr(torch, dt)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, h, sq, d), (b, kvh, sk, d),
                               (b, kvh, sk, d)))


def check_close(what, out, ref, tol, max_err, key):
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    max_err[key] = max(max_err[key], err)
    if bool((diff > tol + tol * ref.float().abs()).any()) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"{what}: kernel differs from the plain version "
                             f"beyond {tol}, max |diff| {err}")
    return err


def library_phase(dev, mcfg):
    """K11 and K8 (the 'xla' route of ops.fused_scheme1_matmul and the
    lhs + rhs decompositions feeding the interleaved form), K9 (the int8
    baseline and the naive structure it composes) and K10 (fused
    attention at the head layouts of olmo-1b, granite-3-8b and
    recurrentgemma-2b): checked against their plain versions, driven
    through the library's entry points with the counts read around them,
    and timed beside their bounds and library calls."""
    gen = torch.Generator(device=dev).manual_seed(19)
    max_err = {"interleaved": 0.0, "relayout": 0.0, "lhs": 0.0, "int8": 0.0,
               "rhs": 0.0, "pair": 0.0, "flash": 0.0, "flash_f32": 0.0,
               "flash_f16": 0.0, "split": 0.0}
    shapes = dense_shapes(mcfg)

    # (a) K11 and K8, bit for bit: against the plain versions, K11 + K2r
    # -> K8 against K1 on the same operands, the 'xla' route against the
    # 'kernel' route.
    checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for p in LIB_P:
            for m, k, n in shapes + [LIB_RAGGED]:
                a = conditioned(gen, (m, k), dtype, dev)
                b = conditioned(gen, (k, n), dtype, dev)
                beta = scheme1_cfg(p, "xla").resolved_beta(k)
                mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
                what = f"{(m, k, n)} {dtype} p={p}"
                a_hat = decompose.decompose_interleave(a, mu, p, beta)
                check_equal(f"K11 {what}", a_hat,
                            decompose.decompose_lhs_plain(a, mu, p, beta),
                            max_err, "lhs")
                b_hat = decompose.decompose_interleave_rhs(b, nu, p, beta)
                check_equal(f"K2r {what}", b_hat,
                            decompose.decompose_rhs_plain(b, nu, p, beta),
                            max_err, "rhs")
                tau = scheme1.pow2_scale(b, 1).T
                beta_t = scheme1_cfg(p, "xla").resolved_beta(n)
                for x, y in zip(decompose.decompose_interleave_pair(
                        b, nu, tau, p, beta, beta_t),
                        decompose.decompose_pair_plain(b, nu, tau, p, beta,
                                                       beta_t)):
                    check_equal(f"K2 {what}", x, y, max_err, "pair")
                for x, operand in ((a_hat, "a"), (b_hat, "b")):
                    check_equal(f"K8's relayout of {operand}-hat {what}",
                                ozaki1.relayout_interleaved(x, p, operand),
                                ozaki1.relayout_interleaved_plain(
                                    x, p, operand), max_err, "relayout")
                out = ozaki1.fused_matmul_interleaved(a_hat, b_hat, mu, nu,
                                                      p, beta, dtype)
                check_equal(f"K8 {what}", out,
                            ozaki1.fused_matmul_interleaved_plain(
                                a_hat, b_hat, mu, nu, p, beta, dtype),
                            max_err, "interleaved")
                if not torch.equal(out, ozaki1.fused_matmul_scheme1(
                        a, b, mu, nu, p, beta, dtype)):
                    raise AssertionError(f"K11 + K2r -> K8 != K1 at {what}")
                routes = [ops.fused_scheme1_matmul(
                    a, b, scheme1_cfg(p, d), out_dtype=dtype)
                    for d in ("xla", "kernel")]
                if not torch.equal(*routes):
                    raise AssertionError(f"ops.fused_scheme1_matmul: 'xla' "
                                         f"!= 'kernel' at {what}")
                checks += 1
                del a, b, a_hat, b_hat, out, routes
    log(f"[library] K11, K2r, K2 and K8: {checks} shape/type/p cases "
        "bit-identical to their plain versions (K8's relayouts alone too); "
        "K11 + K2r -> K8 == K1 and the 'xla' route == the 'kernel' route in "
        "every case")

    # (b) K9, bit for bit, with its relayouts counted: INT8_CHECK (A read
    # in place unless its row stride is misaligned, B relaid), B as the
    # transposed view of an aligned (N, K) buffer (read in place, no
    # relayout), A's base misaligned (relaid), and an int32 sum that wraps.
    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    n9 = INT8_CHECK[0][0]
    cases = [(f"{(m, k, n)}", i8(m, k), i8(k, n), None)
             for m, k, n in INT8_CHECK]
    cases += [("B a transposed view", i8(n9, n9), i8(n9, n9).T, 0),
              ("A misaligned", i8(n9, n9 + 1)[:, 1:], i8(n9, n9), 2),
              (f"wrapping, K = {SCI_LONG_K}",
               torch.full((128, SCI_LONG_K), -128, dtype=torch.int8,
                          device=dev),
               torch.full((SCI_LONG_K, 128), -128, dtype=torch.int8,
                          device=dev), 1)]
    relaid = {}
    for what, a8, b8, expect in cases:
        before = matmul_int8.COUNTS.launches_relayout
        out = matmul_int8.int8_matmul(a8, b8)
        relaid[what] = matmul_int8.COUNTS.launches_relayout - before
        if expect is not None and relaid[what] != expect:
            raise AssertionError(f"K9 {what}: {relaid[what]} relayouts, "
                                 f"expected {expect}")
        check_equal(f"K9 {what}", out, matmul_int8.int8_matmul_plain(a8, b8),
                    max_err, "int8")
        if what.startswith("wrapping") and int(out[0, 0]) != (
                SCI_LONG_K * 128 * 128 - 2 ** 32):
            raise AssertionError(f"K9 {what}: {int(out[0, 0])} did not wrap")
        del a8, b8, out
    log(f"[library] K9 bit-identical to its plain version in {len(cases)} "
        f"cases, relayouts a call: {json.dumps(relaid)}")

    # The main path: the library's entry points, counts zeroed just before
    # and read just after. Nothing here compares with a plain version.
    bf, p = torch.bfloat16, P_MAIN
    xs = [(conditioned(gen, (m, k), bf, dev), conditioned(gen, (k, n), bf, dev))
          for m, k, n in shapes]
    na = conditioned(gen, (NAIVE_N, NAIVE_N), torch.float32, dev)
    nb = conditioned(gen, (NAIVE_N, NAIVE_N), torch.float32, dev)
    naive_beta = scheme1_cfg(p, "xla").resolved_beta(NAIVE_N)
    qkvs = [attn_inputs(gen, dev, c) for c in ATTN_CASES]
    torch.cuda.synchronize()
    reset_counts()
    routed = [ops.fused_scheme1_matmul(a, b, scheme1_cfg(p, "xla"),
                                       out_dtype=bf) for a, b in xs]
    composed, paired = [], []
    for a, b in xs:
        beta = scheme1_cfg(p, "xla").resolved_beta(a.shape[1])
        beta_t = scheme1_cfg(p, "xla").resolved_beta(b.shape[1])
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        tau = scheme1.pow2_scale(b, 1).T
        a_hat = decompose.decompose_interleave(a, mu, p, beta)
        composed.append(ozaki1.fused_matmul_interleaved(
            a_hat, decompose.decompose_interleave_rhs(b, nu, p, beta), mu, nu,
            p, beta, bf))
        # The pair decomposition's forward layout feeds K8 the same way.
        fwd, _ = decompose.decompose_interleave_pair(b, nu, tau, p, beta,
                                                     beta_t)
        paired.append(ozaki1.fused_matmul_interleaved(a_hat, fwd, mu, nu, p,
                                                      beta, bf))
    naive = naive_scheme1(na, nb, p, naive_beta)
    attn = [flash_attn.flash_attention(q, k, v, causal=c[7], window=c[8])
            for c, (q, k, v) in zip(ATTN_CASES, qkvs)]
    torch.cuda.synchronize()
    counts = library_counts()
    e1, dc = counts["emugemm1"], counts["decompose"]
    n_mm = p * (p + 1) // 2
    kernels = [flash_attn.instance(getattr(torch, c[9]), c[6]).kernel
               for c in ATTN_CASES]
    log(f"[library] main path: K8 {e1.launches_interleaved} (relayouts "
        f"{e1.launches_relayout}, plane GEMMs {e1.launches_planes}), K11 "
        f"{dc.launches_lhs}, K2r {dc.launches_rhs}, K2 {dc.launches_pair}, K9 "
        f"{counts['int8'].launches} (relayouts "
        f"{counts['int8'].launches_relayout}), K10 {counts['flash'].launches} "
        f"({', '.join(kernels)}; the 3xTF32 pre-pass "
        f"{counts['flash'].launches_split}), K1 {e1.launches_2d}, plain "
        f"versions on CUDA {sum(c.plain_cuda_calls for c in counts.values())}")
    fl = counts["flash"]
    # The naive structure's K9 calls read A's slices in place and relay
    # each B slice (N-contiguous) into B^T's plane.
    expected = (3 * len(shapes), 6 * len(shapes), 3 * len(shapes),
                len(shapes), len(shapes), len(shapes), n_mm, n_mm,
                len(ATTN_CASES), kernels.count("wgmma-3xtf32"),
                kernels.count("ffma"), kernels.count("wgmma-3xtf32"), 0, 0)
    got = (e1.launches_interleaved, e1.launches_relayout, e1.launches_planes,
           dc.launches_lhs, dc.launches_rhs, dc.launches_pair,
           counts["int8"].launches, counts["int8"].launches_relayout,
           fl.launches, fl.launches_3xtf32, fl.launches_ffma,
           fl.launches_split, e1.launches_2d, e1.launches_encode)
    if got != expected:
        raise AssertionError(f"library main path launches {got}, expected "
                             f"{expected}")
    if any(c.plain_cuda_calls for c in counts.values()):
        raise AssertionError("the library path ran a plain version on CUDA")
    for (a, b), r, c, pc in zip(xs, routed, composed, paired):
        if not (torch.equal(r, c) and torch.equal(r, pc)
                and torch.equal(r, ops.fused_scheme1_matmul(
                    a, b, scheme1_cfg(p, "kernel"), out_dtype=bf))):
            raise AssertionError(f"the 'xla' route, the decompositions + K8 "
                                 f"and K1 differ at {tuple(a.shape)} @ "
                                 f"{tuple(b.shape)}")
    if not torch.equal(naive, fused_scheme1(na, nb, p, naive_beta)):
        raise AssertionError("the naive K9 composition != K1")
    for c, (q, k, v), out in zip(ATTN_CASES, qkvs, attn):
        check_close(f"K10 {c}", out, flash_attn.flash_attention_plain(
            q, k, v, c[7], c[8]), ATTN_TOL[c[9]], max_err,
            ATTN_ERR_KEY[c[9]])
    for c, (q, k, v), kernel in zip(ATTN_CASES, qkvs, kernels):
        if kernel == "wgmma-3xtf32":
            parts = flash_attn.split_3xtf32(q, k, v)
            plain = flash_attn.split_3xtf32_plain(q, k, v)
            for x, y in zip(parts, plain):
                check_equal(f"K10 3xTF32 pre-pass {c}", x, y, max_err,
                            "split")
            del parts, plain
    log(f"[library] on the main path the 'xla' route == K11 + K2r -> K8 == "
        f"K11 + K2 -> K8 == K1, the naive K9 composition at {NAIVE_N}^3 == K1, and K10 within "
        f"its bars in {len(ATTN_CASES)} cases (max |diff| bf16 "
        f"{max_err['flash']:.3g}, float16 {max_err['flash_f16']:.3g}, "
        f"float32 {max_err['flash_f32']:.3g}); the "
        "3xTF32 pre-pass bit-identical to its plain version")
    del routed, composed, paired, naive, attn

    # Times. K8 and K11 summed over one launch at each dense shape; K8's
    # relayouts (beside one .contiguous() of the permuted interleaved
    # views, which is the relayout where Kp is a whole number of K
    # tiles), plane GEMM and mainloop apart.
    t8, t11, trel, t2, t2r = ({"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                               "bytes_ms": 0.0, "ops_ms": 0.0,
                               "yardstick_ms": 0.0} for _ in range(5))
    split8 = dict.fromkeys(("relayout_ms", "planes_ms", "mainloop_ms",
                            "library_ms", "planes_bound_ms"), 0.0)
    for (m, k, n), (a, b) in zip(shapes, xs):
        beta = scheme1_cfg(p, "xla").resolved_beta(k)
        beta_t = scheme1_cfg(p, "xla").resolved_beta(n)
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        tau = scheme1.pow2_scale(b, 1).T
        a_hat = decompose.decompose_interleave(a, mu, p, beta)
        b_hat = decompose.decompose_interleave_rhs(b, nu, p, beta)
        for tot, run_k, run_p, (bms, by) in (
                (t2r, lambda: decompose.decompose_interleave_rhs(
                    b, nu, p, beta),
                 lambda: decompose.decompose_rhs_plain(b, nu, p, beta),
                 rhs_bound(k, n, p, 2)),
                (t2, lambda: decompose.decompose_interleave_pair(
                    b, nu, tau, p, beta, beta_t),
                 lambda: decompose.decompose_pair_plain(
                     b, nu, tau, p, beta, beta_t),
                 pair_bound(k, n, p, 2)),
                (t8, lambda: ozaki1.fused_matmul_interleaved(
                    a_hat, b_hat, mu, nu, p, beta, bf),
                 lambda: ozaki1.fused_matmul_interleaved_plain(
                     a_hat, b_hat, mu, nu, p, beta, bf),
                 bound_ms(1, m, k, n, p, p, 2)),     # p bytes an element in
                (trel, lambda: (ozaki1.relayout_interleaved(a_hat, p, "a"),
                                ozaki1.relayout_interleaved(b_hat, p, "b")),
                 lambda: (ozaki1.relayout_interleaved_plain(a_hat, p, "a"),
                          ozaki1.relayout_interleaved_plain(b_hat, p, "b")),
                 s1_relayout_bound(m, k, n, p)),
                (t11, lambda: decompose.decompose_interleave(a, mu, p, beta),
                 lambda: decompose.decompose_lhs_plain(a, mu, p, beta),
                 lhs_bound(m, k, p, 2))):
            _add(tot, 1, time_ms(run_k, 10), time_ms(run_p, 3), 0.0, bms, by)
            if any(tot is x for x in (t2r, t2, t11)):
                # Their device time too: at the smaller shapes CUDA events
                # over back-to-back calls time the wrapper's host work.
                tot["device_ms"] = tot.get("device_ms", 0.0) + queued_ms(
                    run_k)
        pa = ozaki1.relayout_interleaved(a_hat, p, "a")
        pb = ozaki1.relayout_interleaved(b_hat, p, "b")
        out = torch.empty((m, n), dtype=bf, device=dev)
        kp = a_hat.shape[1] // p
        views = (a_hat.view(m, kp // decompose.TILE, p, decompose.TILE
                            ).permute(2, 0, 1, 3),
                 b_hat.view(kp // decompose.TILE, p, decompose.TILE, n
                            ).permute(1, 3, 0, 2))
        split8["relayout_ms"] = trel["ms"]
        split8["planes_ms"] += time_ms(lambda: ozaki1.launch_planes(
            pa, pb, mu, nu, p, beta, out), 10)
        split8["mainloop_ms"] += time_ms(lambda: ozaki1.launch_planes(
            pa, pb, mu, nu, p, beta, out, epilogue=False), 10)
        if kp % ozaki1.PLANE_K == 0 and split8["library_ms"] is not None:
            split8["library_ms"] += time_ms(
                lambda: [v.contiguous() for v in views], 10)
        else:       # no single call pads K
            split8["library_ms"] = None
        split8["planes_bound_ms"] += s1_planes_bound(m, k, n, p, 2)[0]
        log(f"[library] M={m} K={k} N={n} bf16 p={p}: K8, its relayouts and "
            f"K11 running totals {t8['ms']:.4f} / {trel['ms']:.4f} / "
            f"{t11['ms']:.4f} ms")
        del pa, pb, out, views
    split8["mainloop_tops"] = (p * (p + 1) * sum(
        m * k * n for m, k, n in shapes) / split8["mainloop_ms"] / 1e9)
    log(f"[library] K8 per {len(shapes)} dense shapes: route "
        f"{t8['ms']:.4f} ms (relayouts {trel['ms']:.4f}, bound "
        f"{trel['bound_ms']:.4f}, plain {trel['plain_ms']:.4f}, .contiguous() "
        f"{split8['library_ms']}; plane GEMM {split8['planes_ms']:.4f}, "
        f"mainloop {split8['mainloop_ms']:.4f} at "
        f"{split8['mainloop_tops']:.1f} TOPS, bound "
        f"{split8['planes_bound_ms']:.4f}), plain {t8['plain_ms']:.4f} ms, "
        f"bound {t8['bound_ms']:.4f} ms; " + "; ".join(
            f"{name}: device {t['device_ms']:.4f} ms (CUDA events "
            f"{t['ms']:.4f}), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms (bytes)"
            for name, t in (("K11", t11), ("K2r", t2r), ("K2", t2))))
    del xs

    # K9 beside torch._int_mm (the library call; yardstick_phase names
    # its device kernel) and its bound: the route, B's relayout, the plane
    # GEMM and its mainloop apart (A is read in place), at each of its
    # output tiles, and the route and the relayout by device time (the
    # wrapper's host work sets a lone relayout's CUDA-event time).
    t9 = []
    for n_ in INT8_TIMED:
        a8, b8 = i8(n_, n_), i8(n_, n_)
        out = torch.empty((n_, n_), dtype=torch.int32, device=dev)
        a, lda, _ = matmul_int8.operand_plane(a8)
        bt, ldb, _ = matmul_int8.operand_plane(b8.T)
        row = {"n": n_,
               "ms": time_ms(lambda: matmul_int8.int8_matmul(a8, b8), 10),
               "plain_ms": time_ms(
                   lambda: matmul_int8.int8_matmul_plain(a8, b8), 3),
               "library_ms": time_ms(lambda: torch._int_mm(a8, b8), 10),
               "device_ms": queued_ms(
                   lambda: matmul_int8.int8_matmul(a8, b8)),
               "relayout_ms": queued_ms(
                   lambda: matmul_int8.operand_plane(b8.T)),
               "gemm_ms": time_ms(lambda: matmul_int8.launch(
                   a, lda, bt, ldb, n_, out), 10),
               "mainloop_ms": time_ms(lambda: matmul_int8.launch(
                   a, lda, bt, ldb, n_, out, epilogue=False), 10),
               "gemm_by_tile_ms": {f"{tm} x {tn}": time_ms(
                   lambda: matmul_int8.launch(a, lda, bt, ldb, n_, out,
                                              tile_mn=(tm, tn)), 10)
                   for tm, tn in ((128, 256), (64, 128))}}
        row["epilogue_ms"] = row["gemm_ms"] - row["mainloop_ms"]
        row["mainloop_tops"] = 2 * n_ ** 3 / row["mainloop_ms"] / 1e9
        row["relayout_bound_ms"] = 1e3 * (n_ * n_ + n_ * ozaki1.plane_k(
            n_)) / HBM_BYTES_PER_S
        row["bound_ms"], row["bound_by"] = int8_bound(n_, n_, n_)
        t9.append(row)
        log(f"[library] K9 {n_}^3: " + json.dumps(row))
        del a8, b8, a, bt, out
    naive_ms = time_ms(lambda: naive_scheme1(na, nb, p, naive_beta), 3)
    fused_ms = time_ms(lambda: fused_scheme1(na, nb, p, naive_beta), 3)
    log(f"[library] Fig. 4 at {NAIVE_N}^3, float32, p={p}: naive ({n_mm} K9 "
        f"launches, split and shift-reduce in torch) {naive_ms:.3f} ms, "
        f"fused (K1, one launch) {fused_ms:.3f} ms, naive/fused "
        f"{naive_ms / fused_ms:.3f}")
    del na, nb

    # K10 beside its bound and scaled_dot_product_attention (the library
    # call; a window as an explicit boolean mask).
    # The float32 rows also beside the FFMA bound, with the pre-pass timed
    # alone and the device kernels one call runs (torch.profiler).
    t10 = []
    for c, (q, k, v), kernel in zip(ATTN_CASES, qkvs, kernels):
        label, b_, h, kvh, sq, sk, d, causal, window, dt = c

        def run():
            return flash_attn.flash_attention(q, k, v, causal=causal,
                                              window=window)
        ms = time_ms(run, 10)
        plain = time_ms(lambda: flash_attn.flash_attention_plain(
            q, k, v, causal, window), 3)
        if window is None:
            lib = time_ms(lambda: torch.nn.functional.
                          scaled_dot_product_attention(
                              q, k, v, is_causal=causal,
                              enable_gqa=h != kvh), 10)
        else:                       # the window as an explicit mask
            rel = (torch.arange(sq, device=q.device)[:, None]
                   - torch.arange(sk, device=q.device)[None, :])
            mask = (rel >= 0) & (rel < window)
            lib = time_ms(lambda: torch.nn.functional.
                          scaled_dot_product_attention(
                              q, k, v, attn_mask=mask,
                              enable_gqa=h != kvh), 10)
            del mask
        bms, by = attn_bound(b_, h, kvh, sq, sk, d, causal, window, kernel)
        row = {"case": label, "shape": [b_, h, kvh, sq, sk, d],
               "causal": causal, "window": window, "dtype": dt,
               "instance": dataclasses.asdict(
                   flash_attn.instance(getattr(torch, dt), d)),
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": bms, "bound_by": by}
        if dt == "float32":
            row["bound_ffma_ms"] = attn_bound(b_, h, kvh, sq, sk, d, causal,
                                              window, "ffma")[0]
            row["device_kernels_ms"] = yardstick_kernels(run, 3)
        if kernel == "wgmma-3xtf32":
            row["split_ms"] = time_ms(
                lambda: flash_attn.split_3xtf32(q, k, v), 10)
            row["split_plain_ms"] = time_ms(
                lambda: flash_attn.split_3xtf32_plain(q, k, v), 3)
            row["split_bound_ms"] = split_bound(b_, h, kvh, sq, sk, d)[0]
        t10.append(row)
        log(f"[library] K10 {label} {dt} B={b_} H={h}/{kvh} S={sq}/{sk} "
            f"D={d} ({kernel}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{bms:.4f} ms ({by})" + "".join(
                f", {key} {row[key]}" for key in (
                    "bound_ffma_ms", "split_ms", "split_plain_ms",
                    "split_bound_ms", "device_kernels_ms") if key in row))
    del qkvs

    f32 = next(r for r in t10 if r["instance"]["kernel"] == "wgmma-3xtf32")
    ffma = next(r for r in t10 if r["instance"]["kernel"] == "ffma")

    def totals(t):
        """ms: device time (torch.profiler) where taken, events_ms: CUDA
        events over back-to-back calls."""
        return {"ms": t.get("device_ms", t["ms"]), "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                else "operations",
                **({"events_ms": t["ms"]} if "device_ms" in t else {})}

    common = {"route": "cuda"}
    lib_per = (f"one launch at each of olmo-1b's dense shapes at {TOKENS} "
               f"tokens, bf16, p = {p} (launches: phase 19's main path)")
    return dc, {"pair": {**totals(t2), "max_abs_err": max_err["pair"]},
                "rhs": {**totals(t2r), "max_abs_err": max_err["rhs"]}}, [
        {"name": "emugemm1_interleaved", **common, "source": SOURCE_S1_PLANES,
         "replaces": "src/repro/kernels/ozaki1.py:118",
         "launches": e1.launches_interleaved,
         "max_abs_err": max_err["interleaved"], **totals(t8),
         "library_ms": None, **{k_: v for k_, v in split8.items()
                                if k_ != "library_ms"},
         "per": lib_per + "; the route: a relayout of A-hat and of B-hat + 1 "
                "plane GEMM a call, relayout_ms their sum"},
        {"name": "emugemm1_relayout", **common, "source": SOURCE_S1_PLANES,
         "replaces": "src/repro/kernels/ozaki1.py:118",
         "launches": e1.launches_relayout, "max_abs_err": max_err["relayout"],
         **totals(trel), "library_ms": split8["library_ms"],
         "per": "the relayouts of A-hat and B-hat into planes at each of "
                f"olmo-1b's dense shapes at {TOKENS} tokens, bf16, p = {p}, "
                "summed; library: .contiguous() of the permuted interleaved "
                "views"},
        {"name": "decompose_lhs", **common, "source": DECOMPOSE_SOURCE,
         "replaces": "src/repro/kernels/decompose.py:42",
         "launches": dc.launches_lhs, "max_abs_err": max_err["lhs"],
         **totals(t11), "library_ms": None, "per": lib_per},
        {"name": "int8_matmul", **common, "source": SOURCE_S1_PLANES,
         "replaces": "src/repro/kernels/matmul_int8.py:38",
         "launches": counts["int8"].launches,
         "launches_relayout": counts["int8"].launches_relayout,
         "max_abs_err": max_err["int8"],
         **{key: t9[0][key] for key in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "relayout_ms", "gemm_ms", "mainloop_ms",
             "epilogue_ms", "mainloop_tops")},
         "per": f"one {INT8_TIMED[0]}^3 GEMM: a relayout of B + the plane "
                "GEMM's int32 instance (A read in place); library: "
                f"torch._int_mm (launches: the naive Fig. 4 structure at "
                f"{NAIVE_N}^3)",
         "relayouts_by_check": relaid, "cases": t9,
         "naive_fig4_ms": naive_ms, "fused_k1_ms": fused_ms},
        {"name": "flash_attention", **common, "source": SOURCE_FLASH,
         "replaces": "src/repro/kernels/flash_attn.py:75",
         "launches": fl.launches - fl.launches_3xtf32 - fl.launches_ffma,
         "max_abs_err": max_err["flash"],
         "max_abs_err_float16": max_err["flash_f16"],
         **{key: t10[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
         "per": f"one call at {ATTN_CASES[0][0]} {ATTN_CASES[0][9]} "
                f"{list(t10[0]['shape'])} on the bf16 wgmma kernel; "
                "library: scaled_dot_product_attention (launches: one per "
                "bf16 or float16 case; cases: every case, float16 and the "
                "head dims 80 and 192 among them, each beside SDPA and its "
                "bound)",
         "cases": t10},
        {"name": "flash_attention_3xtf32", **common, "source": SOURCE_FLASH,
         "replaces": "src/repro/kernels/flash_attn.py:75",
         "launches": fl.launches_3xtf32, "max_abs_err": max_err["flash_f32"],
         **{key: f32[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "bound_ffma_ms", "split_ms")},
         "per": f"one call at {f32['case']} float32 {list(f32['shape'])}: "
                "the pre-pass and the 3xTF32 wgmma kernel; bound: 3 TF32 "
                "products at the TF32 peak; library: "
                "scaled_dot_product_attention (launches: one per float32 "
                "case at D <= 128)"},
        {"name": "flash_split_3xtf32", **common, "source": SOURCE_FLASH,
         "replaces": "src/repro/kernels/flash_attn.py:75",
         "launches": fl.launches_split, "max_abs_err": max_err["split"],
         "ms": f32["split_ms"], "plain_ms": f32["split_plain_ms"],
         "bound_ms": f32["split_bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "per": f"the 3xTF32 pre-pass of one call at {f32['case']} float32 "
                "(launches: one per 3xTF32 call)"},
        {"name": "flash_attention_ffma", **common, "source": SOURCE_FLASH,
         "replaces": "src/repro/kernels/flash_attn.py:75",
         "launches": fl.launches_ffma, "max_abs_err": max_err["flash_f32"],
         **{key: ffma[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
         "per": f"one call at {ffma['case']} float32 {list(ffma['shape'])} "
                "(D = 256: the 3xTF32 kernel's q parts would not fit); "
                "library: scaled_dot_product_attention with the window as an "
                "explicit boolean mask"},
    ]


# ---------------------------------------------------------------------------
# Phases 20-24: granite-3-8b served with its untied head prepared once, the
# lockstep (prefill / decode) path, deepseek-coder-33b at its widths, and
# olmo-1b under more specs. Phases 20-23 run right after the build: every
# wall they take comes before the process's first torch.profiler session.
# ---------------------------------------------------------------------------

def s1_counts():
    return ozaki1.LaunchCounts(**vars(ozaki1.COUNTS))


def site_launches(mcfg, policy, prepared_head: bool, steps: int = 1):
    """(EmuGEMM-I, EmuGEMM-II) launches of ``steps`` forward passes under
    ``policy``. A layer: q, k, v, o ('attn') and the (shared experts')
    gate, up and down ('ffn') as 2-D products, attn_qk and attn_av
    batched; with a MoE, the router ('moe_gate') a 2-D float32 product
    and the three expert stacks ('moe_expert') batched; the head one 2-D
    call, or one mixed call when prepared. A 2-D EmuGEMM-I call is 2
    encodes + 1 plane GEMM, a mixed call 1 + 1, an EmuGEMM-II call
    2 + 1."""
    L = mcfg.n_layers
    s1 = {"2d": 0, "mixed": 0, "batched": 0}
    s2 = {"2d": 0, "batched": 0}
    sites = [("attn", "2d", 4 * L), ("ffn", "2d", 3 * L),
             ("attn_qk", "batched", L), ("attn_av", "batched", L),
             ("logits", "mixed" if prepared_head else "2d", 1)]
    if mcfg.moe is not None:
        sites += [("moe_gate", "2d", L), ("moe_expert", "batched", 3 * L)]
    for site, form, n in sites:
        scheme = policy.for_site(site).scheme
        if scheme == "ozaki1":
            s1[form] += n
        elif scheme == "ozaki2":
            s2[form] += n
    s1["encodes"] = 2 * s1["2d"] + s1["mixed"]
    s1["plane_gemms"] = s1["2d"] + s1["mixed"]
    s2["encodes"] = 2 * (s2["2d"] + s2["batched"])
    s2["plane_gemms"] = s2["2d"] + s2["batched"]
    return ({k: steps * v for k, v in s1.items()},
            {k: steps * v for k, v in s2.items()})


def step_launches(mcfg, prepared_head: bool, steps: int = 1) -> dict:
    """EmuGEMM-I launches of ``steps`` forward passes under one Scheme-I
    spec (``site_launches`` with every site on EmuGEMM-I)."""
    return site_launches(mcfg, GemmPolicy(default=api.precision(SPEC)),
                         prepared_head, steps)[0]


def launches_of(c) -> dict:
    return {"2d": c.launches_2d, "mixed": c.launches_mixed,
            "batched": c.launches_batched, "encodes": c.launches_encode,
            "plane_gemms": c.launches_planes}


def check_launches(what, c, want):
    got = launches_of(c)
    if got != want or c.plain_cuda_calls:
        raise AssertionError(f"{what}: EmuGEMM-I launches {got}, plain "
                             f"versions on CUDA {c.plain_cuda_calls}; "
                             f"expected {want} and none")


def head_prepared(params) -> bool:
    return isinstance(params.get("head"), prepared.PreparedOperand)


def keep_rows(eng, rows: dict):
    """Have ``eng`` put each request's pool rows (its gathered per-lane
    view, every cache leaf) into ``rows[rid]`` as it releases them."""
    release = eng.kv.release

    def keep(rid):
        rows[rid] = {k: v[:, 0] for k, v in eng.kv.gather(
            eng.pools, eng.kv.tables_for([rid]))["layers"]["b0"].items()}
        release(rid)
    eng.kv.release = keep


def serve_trace(dev, arch, params, policy, check=False, rows=None):
    """Serve phase 3's trace (a '+cached' policy prepares nothing that
    ``params`` holds prepared already); returns (engine, trace, tokens,
    metrics, counts), the EmuGEMM-I launches checked when ``check``; each
    request's pool rows go into ``rows`` when given (``keep_rows``)."""
    eng = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=policy,
                           params=params, max_lanes=LANES, chunk=CHUNK,
                           page_size=PAGE, device=dev)
    if rows is not None:
        keep_rows(eng, rows)
    trace = build_trace(np.random.default_rng(0), arch.model.vocab, REQUESTS,
                        PROMPT, GEN, 0.0)
    torch.cuda.synchronize()
    eng.reset_clock()
    reset_counts()
    t0 = time.perf_counter()
    results = eng.run(trace)
    dt = time.perf_counter() - t0
    counts = s1_counts()
    toks = [results[r.rid].tokens for r in trace]
    if not all(len(t) == GEN and all(0 <= x < arch.model.vocab for x in t)
               for t in toks):
        raise AssertionError(f"malformed tokens {toks}")
    steps = eng.utilization()["steps"]
    metrics = {"steps": steps, "seconds": dt, "tok_per_s": REQUESTS * GEN / dt,
               "ttft_p50_s": float(np.median([results[r.rid].ttft
                                              for r in trace]))}
    if check:
        check_launches(f"{arch.model.name} serve", counts,
                       step_launches(arch.model, head_prepared(eng.params),
                                     steps))
    return eng, trace, toks, metrics, counts


def alone_equals_cohort(dev, arch, eng, trace, toks, tag):
    alone = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=eng.policy,
                             params=eng.params, prepare=False,
                             max_lanes=LANES, chunk=CHUNK, page_size=PAGE,
                             device=dev)
    r0 = Request(prompt=trace[0].prompt, max_new_tokens=GEN)
    if alone.run([r0])[r0.rid].tokens != toks[0]:
        raise AssertionError(f"{tag}: request 0 alone differs from the "
                             "cohort")


def mixed_step_inputs(dev, mcfg, view_tokens):
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, mcfg.vocab, (LANES, CHUNK), generator=gen,
                           device=dev, dtype=torch.int32)
    start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
    n_new = torch.tensor([16, 16, 5, 1], device=dev, dtype=torch.int32)
    cache = M.init_cache(mcfg, LANES, view_tokens, dev)
    for name, leaf in cache["layers"]["b0"].items():
        if leaf.dtype == torch.int8:             # an int8 cache's values
            leaf.random_(-127, 128, generator=gen)
        elif name.endswith("_scale"):            # and their scales
            leaf.uniform_(0.001, 0.05, generator=gen)
        else:
            leaf.normal_(generator=gen)
    return tokens, start, n_new, cache


def mixed_step_logits(mcfg, params, policy, inputs):
    tokens, start, n_new, cache = inputs
    views = {"layers": {"b0": {k: v.clone() for k, v in
                               cache["layers"]["b0"].items()}}}
    with torch.inference_mode():
        logits, _ = M.forward_step(params, mcfg, tokens, start, n_new, views,
                                   policy)
    torch.cuda.synchronize()
    return logits


def step_walls(dev, mcfg, params, policy, view_tokens, prepared_head,
               check=None):
    """Wall ms of a mixed and a decode step (mean of 3 after a warm-up),
    each step's launches checked: by ``check(what)`` when given, else the
    EmuGEMM-I launches of a dense model."""
    if check is None:
        def check(what):
            check_launches(what, s1_counts(),
                           step_launches(mcfg, prepared_head))
    out = {}
    for kind, c, n_new in (("mixed", CHUNK, [16, 16, 5, 1]),
                           ("decode", 1, [1, 1, 1, 1])):
        tokens = torch.ones((LANES, c), device=dev, dtype=torch.int32)
        start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
        nn = torch.tensor(n_new, device=dev, dtype=torch.int32)
        cache = M.init_cache(mcfg, LANES, view_tokens, dev)

        def step():
            with torch.inference_mode():
                M.forward_step(params, mcfg, tokens, start, nn, cache, policy)
            torch.cuda.synchronize()

        reset_counts()
        step()
        check(f"{mcfg.name} {kind} step")
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        out[f"{kind}_step_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    return out


def head_f32_policy(spec):
    """``spec`` everywhere, the logits site's output in float32: the
    unprepared head GEMM then rounds once to bf16, as the prepared one
    (float32 out, then cast, as the reference's ``prepared_dot``) does."""
    return GemmPolicy(default=api.precision(spec), overrides=(
        ("logits", api.precision(spec, out_dtype="float32")),))


def granite_serve_phase(dev, arch, params, view_tokens):
    """granite-3-8b at full width under GRANITE_SPEC: the untied head
    prepared once, then served (one K3 call a step); prepared == the
    unprepared head with a float32 logits output, tokens and logits bit
    for bit; request 0 alone == in its cohort; one mixed step on the
    'cuda' and 'torch' backends bit for bit; step walls."""
    mcfg = arch.model
    tag = f"[serve {mcfg.name}]"
    torch.cuda.reset_peak_memory_stats()
    policy = GemmPolicy(default=api.precision(GRANITE_SPEC))
    reset_counts()
    t0 = time.perf_counter()
    eng = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=policy,
                           params=params, max_lanes=LANES, chunk=CHUNK,
                           page_size=PAGE, device=dev)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    head = eng.params["head"]
    prep_encodes = ozaki1.COUNTS.launches_encode
    if not (eng.prepared and isinstance(head, prepared.PreparedOperand)
            and head.layout == "planes" and prep_encodes == 1):
        raise AssertionError(f"{tag}: the head was not prepared once into "
                             f"planes ({type(head).__name__}, "
                             f"{prep_encodes} encodes)")
    eng, trace, toks, serve, counts = serve_trace(
        dev, arch, eng.params, policy, check=True)
    serve["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    serve["head_prepare_ms"] = prep_ms
    serve["launches"] = launches_of(counts)
    serve["launches_per_step"] = step_launches(mcfg, True)
    log(f"{tag} {GRANITE_SPEC}: head prepared once ({prep_encodes} encode, "
        f"{prep_ms:.1f} ms), {serve['steps']} steps, {REQUESTS} requests x "
        f"{GEN} tokens in {serve['seconds']:.3f} s "
        f"({serve['tok_per_s']:.1f} tok/s), ttft p50 "
        f"{serve['ttft_p50_s']:.3f} s, peak {serve['peak_gib']:.2f} GiB; "
        f"launches {serve['launches']} (per step "
        f"{serve['launches_per_step']})")
    alone_equals_cohort(dev, arch, eng, trace, toks, tag)
    _, _, plain_toks, plain, _ = serve_trace(
        dev, arch, params, head_f32_policy(SPEC), check=True)
    if plain_toks != toks:
        raise AssertionError(f"{tag}: prepared tokens differ from the "
                             "unprepared head's")
    inputs = mixed_step_inputs(dev, mcfg, view_tokens)
    got = mixed_step_logits(mcfg, eng.params, policy, inputs)
    want = mixed_step_logits(mcfg, params, head_f32_policy(SPEC), inputs)
    bf16_head = mixed_step_logits(mcfg, params,
                                  GemmPolicy(default=api.precision(SPEC)),
                                  inputs)
    if not torch.equal(got, want):
        raise AssertionError(f"{tag}: prepared logits differ from the "
                             "unprepared head's")
    # Reported, not asserted: the bf16 epilogue rounds every shift-reduce
    # op of the unprepared head (ROADMAP.md § 3 R6).
    _, _, bf16_toks, _, _ = serve_trace(
        dev, arch, params, GemmPolicy(default=api.precision(SPEC)),
        check=True)
    serve["bf16_head_logits"] = {
        "max_abs_diff": (got.float() - bf16_head.float()).abs().max().item(),
        "argmax_equal_lanes": int((got[:, :mcfg.vocab].argmax(-1)
                                   == bf16_head[:, :mcfg.vocab].argmax(-1))
                                  .sum().item()),
        "equal_tokens_of_trace": sum(x == y for a, b in zip(toks, bf16_toks)
                                     for x, y in zip(a, b))}
    log(f"{tag} request 0 alone == in cohort; prepared == unprepared "
        f"(logits site float32 out) tokens and a mixed step's logits bit "
        f"for bit ({plain['tok_per_s']:.1f} tok/s unprepared); against "
        f"{SPEC}'s bf16 head epilogue: {serve['bf16_head_logits']}")
    torch_params = prepared.prepare_params(params, on_backend(policy,
                                                              "torch"))
    a = mixed_step_logits(mcfg, eng.params, on_backend(policy, "cuda"),
                          inputs)
    b = mixed_step_logits(mcfg, torch_params, on_backend(policy, "torch"),
                          inputs)
    if torch_params["head"].layout != "interleaved" or not torch.equal(a, b):
        raise AssertionError(f"{tag}: cuda and torch backend logits differ")
    if not torch.isfinite(a).all() or a.shape != (LANES,
                                                  pad_vocab(mcfg.vocab)):
        raise AssertionError(f"{tag}: bad logits {a.shape}")
    del torch_params
    log(f"{tag} one mixed step: cuda == torch backend logits bit for bit "
        "(each backend's head prep)")
    serve.update(step_walls(dev, mcfg, eng.params, policy, view_tokens,
                            True))
    log(f"{tag} summary " + json.dumps(serve))
    return eng.params, serve


def lockstep_phase(dev, arch, params, spec, prepare, tag):
    """LockstepEngine on the 'cuda' and 'torch' backends: REQUESTS prompts
    of PROMPT tokens, GEN new; tokens and prefill logits bit for bit, the
    launches of the prefill and of a decode step checked, their walls."""
    mcfg = arch.model
    prompts = np.random.default_rng(2).integers(
        0, mcfg.vocab, (REQUESTS, PROMPT)).astype(np.int32)
    pt = torch.as_tensor(prompts, device=dev)
    policy = GemmPolicy(default=api.precision(spec))
    out, res = {}, {}
    for backend in ("cuda", "torch"):
        eng = LockstepEngine(arch, None, PROMPT + GEN,
                             on_backend(policy, backend), params=params,
                             prepare=prepare, device=dev)
        if backend == "cuda":
            eng.prefill(pt)                       # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            logits, cache = eng.prefill(pt)
            torch.cuda.synchronize()
            res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            check_launches(f"{tag} prefill", s1_counts(),
                           step_launches(mcfg, prepare))
            tok = torch.argmax(logits[:, -1:, :mcfg.vocab], -1)
            reset_counts()
            t0 = time.perf_counter()
            eng.decode(tok, PROMPT, cache)
            torch.cuda.synchronize()
            res["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
            check_launches(f"{tag} decode step", s1_counts(),
                           step_launches(mcfg, prepare))
            del cache
            t0 = time.perf_counter()
            toks = eng.generate(prompts, GEN)
            res["generate_s"] = time.perf_counter() - t0
            res["tok_per_s"] = REQUESTS * GEN / res["generate_s"]
        else:
            logits, _ = eng.prefill(pt)
            toks = eng.generate(prompts, GEN)
        torch.cuda.synchronize()
        out[backend] = (logits, toks)
        del eng
    (la, ta), (lb, tb) = out["cuda"], out["torch"]
    if not torch.equal(la, lb) or not np.array_equal(ta, tb):
        raise AssertionError(f"{tag}: lockstep cuda and torch backends "
                             "differ")
    if (ta.shape != (REQUESTS, GEN) or not torch.isfinite(la).all()
            or ((ta < 0) | (ta >= mcfg.vocab)).any()):
        raise AssertionError(f"{tag}: malformed lockstep output")
    res["launches_per_step"] = step_launches(mcfg, prepare)
    log(f"{tag} lockstep {spec}{' (head prepared)' if prepare else ''}: "
        f"{REQUESTS} x {PROMPT} prompts, {GEN} new: cuda == torch tokens "
        f"and prefill logits bit for bit; prefill {res['prefill_ms']:.1f} "
        f"ms, decode step {res['decode_step_ms']:.1f} ms, generate "
        f"{res['generate_s']:.3f} s ({res['tok_per_s']:.1f} tok/s); "
        f"launches a prefill and a decode step {res['launches_per_step']}")
    return res


def olmo_spec_serves_phase(dev, arch, params):
    """olmo-1b's trace under each of SPEC_SERVES: tok/s; each emulated
    spec's launches checked and request 0 alone == its cohort; native
    launches no EmuGEMM-I kernel."""
    out = {}
    for spec in SPEC_SERVES:
        emulated = spec != "native"
        eng, trace, toks, m, c = serve_trace(
            dev, arch, params, GemmPolicy(default=api.precision(spec)),
            check=emulated)
        if not emulated and any(launches_of(c).values()):
            raise AssertionError(f"native serve launched {launches_of(c)}")
        if emulated:
            alone_equals_cohort(dev, arch, eng, trace, toks,
                                f"olmo-1b {spec}")
        out[spec] = m
        log(f"[serve olmo-1b] {spec}: {m['steps']} steps, "
            f"{m['tok_per_s']:.1f} tok/s, ttft p50 {m['ttft_p50_s']:.3f} s"
            + ("; request 0 alone == in cohort" if emulated else ""))
    return out


def new_path_phases(dev, view_tokens):
    """Phases 20-23 (walls only); returns granite's raw and prepared
    params, and the report."""
    report = {}
    granite = configs.get_config(GRANITE)
    t0 = time.perf_counter()
    params = M.init_params(granite.model, 0, dev)
    torch.cuda.synchronize()
    log(f"[{GRANITE}] {M.param_count(params) / 1e9:.3f} B parameters "
        f"(bf16, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB) drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    prepped, report["granite_serve"] = granite_serve_phase(
        dev, granite, params, view_tokens)
    report["granite_lockstep"] = lockstep_phase(
        dev, granite, params, SPEC, True, f"[{GRANITE}]")
    olmo = configs.get_config("olmo-1b")
    oparams = M.init_params(olmo.model, 0, dev)
    report["olmo_lockstep"] = lockstep_phase(dev, olmo, oparams, SPEC, False,
                                             "[olmo-1b]")
    report["olmo_specs"] = olmo_spec_serves_phase(dev, olmo, oparams)
    del oparams
    ds = configs.get_config(DEEPSEEK)
    ds = dataclasses.replace(ds, model=dataclasses.replace(
        ds.model, n_layers=DEEPSEEK_LAYERS))
    dparams = M.init_params(ds.model, 0, dev)
    log(f"[{DEEPSEEK}] published widths (d {ds.model.d_model}, "
        f"{ds.model.n_heads} heads over {ds.model.n_kv_heads} KV heads, d_ff "
        f"{ds.model.d_ff}, vocab {ds.model.vocab}), depth cut from 62 to "
        f"{DEEPSEEK_LAYERS} layers: {M.param_count(dparams) / 1e9:.3f} B "
        "parameters")
    report["deepseek_lockstep"] = lockstep_phase(
        dev, ds, dparams, SPEC, True, f"[{DEEPSEEK} {DEEPSEEK_LAYERS}L]")
    del dparams
    log("[new paths] summary " + json.dumps(report))
    return params, prepped, report


def granite_kernel_phase(dev, arch, params, prepped, view_tokens):
    """After the walls: one granite mixed and one decode step under
    torch.profiler (device-busy, idle share, top kernels), and the times
    of K3 against the prepared head, K4 at g = 4 and K1 at granite's dense
    shapes beside their bounds and plain versions."""
    from torch.profiler import ProfilerActivity, profile
    mcfg = arch.model
    policy = GemmPolicy(default=api.precision(GRANITE_SPEC))
    out = {}
    for kind, c, n_new in (("mixed", CHUNK, [16, 16, 5, 1]),
                           ("decode", 1, [1, 1, 1, 1])):
        tokens = torch.ones((LANES, c), device=dev, dtype=torch.int32)
        start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
        nn = torch.tensor(n_new, device=dev, dtype=torch.int32)
        cache = M.init_cache(mcfg, LANES, view_tokens, dev)
        with torch.inference_mode():
            M.forward_step(prepped, mcfg, tokens, start, nn, cache, policy)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.inference_mode():
                M.forward_step(prepped, mcfg, tokens, start, nn, cache,
                               policy)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        out[f"{kind}_profile"] = device_summary(prof, prof_wall)
        log(f"[{GRANITE}] profiled {kind} step: "
            + json.dumps(out[f"{kind}_profile"]))
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    # K3: the logits GEMM of a step, 4 lanes against the prepared head.
    head = prepped["head"]
    d, vp = mcfg.d_model, pad_vocab(mcfg.vocab)
    a = conditioned(gen, (LANES, d), bf, dev)
    torch_head = prepared.prepare_rhs(params["head"], api.precision(
        SPEC, backend="torch"))
    k3 = {"ms": time_ms(lambda: prepared.matmul_prepared(
              a, head, torch.float32), 20),
          "plain_ms": time_ms(lambda: prepared.matmul_prepared(
              a, torch_head, torch.float32), 3)}
    if not torch.equal(prepared.matmul_prepared(a, head, torch.float32),
                       prepared.matmul_prepared(a, torch_head,
                                                torch.float32)):
        raise AssertionError("K3 on the prepared head != its plain version")
    k3["bound_ms"], k3["bound_by"] = mixed_bound(LANES, d, vp, P_MAIN, 2, 4)
    del torch_head
    out["k3_head"] = k3
    # K4 at g = 4: attn_qk and attn_av of a mixed and a decode step.
    hd, bkv = mcfg.resolved_head_dim, LANES * mcfg.n_kv_heads
    g = mcfg.n_heads // mcfg.n_kv_heads
    k4 = {}
    for kind, c in (("mixed", CHUNK), ("decode", 1)):
        t = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        for m, k, n in ((c * g, hd, view_tokens), (c * g, view_tokens, hd)):
            x = conditioned(gen, (bkv, m, k), bf, dev)
            y = conditioned(gen, (bkv, k, n), bf, dev)
            mu, nu = scheme1.pow2_scale(x, -1), scheme1.pow2_scale(y, -2)
            ref = ozaki1.fused_matmul_plain(x, y, mu, nu, P_MAIN, 7, bf)
            got = ozaki1.fused_matmul_scheme1(x, y, mu, nu, P_MAIN, 7, bf)
            if not torch.equal(got, ref):
                raise AssertionError(f"K4 at g = {g} != plain {(m, k, n)}")
            t["ms"] += mcfg.n_layers * device_ms(
                lambda: ozaki1.launch_batched(x, y, mu, nu, P_MAIN, 7, bf))
            t["plain_ms"] += mcfg.n_layers * time_ms(
                lambda: ozaki1.fused_matmul_plain(x, y, mu, nu, P_MAIN, 7,
                                                  bf), 3)
            t["bound_ms"] += mcfg.n_layers * bound_ms(bkv, m, k, n, P_MAIN,
                                                      2, 2)[0]
        k4[kind] = t
    out["k4_g4"] = k4
    # K1 at granite's dense shapes, a mixed step's M, weights cold.
    m = LANES * CHUNK
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "encode_ms": 0.0,
          "planes_ms": 0.0, "mainloop_ms": 0.0}
    for k, n, count in ((d, d, 2), (d, mcfg.n_kv_heads * hd, 2),
                        (d, mcfg.d_ff, 2), (mcfg.d_ff, d, 1)):
        copies = max(1, math.ceil(2 * L2_BYTES / (2 * k * n)))
        t = route_times(gen, dev, m, k, n, False, P_MAIN, bf, copies)
        t["encode_ms"] = t["encode_a_ms"] + t["encode_b_ms"]
        for key in k1:
            if key != "bound_ms":
                k1[key] += count * mcfg.n_layers * t[key]
        k1["bound_ms"] += count * mcfg.n_layers * bound_ms(
            1, m, k, n, P_MAIN, 2, 2)[0]
    out["k1_mixed_step"] = k1
    log(f"[{GRANITE}] kernels: " + json.dumps({k: v for k, v in out.items()
                                              if "profile" not in k}))
    return out


# ---------------------------------------------------------------------------
# Phase 26: qwen2-moe-a2.7b-emu (models/moe.py) at its published widths and
# depth: the router on K5g, the expert stacks on K4. Its walls are taken
# right after the build (moe_phase), before any profiler session; its
# profiled steps and kernel times come after phase 24 (moe_kernel_phase).
# ---------------------------------------------------------------------------

MOE, MOE_EMU = "qwen2-moe-a2.7b", "qwen2-moe-a2.7b-emu"
MOE_SPEC = "ozaki1-p4+cached"     # the lockstep run's; the -emu default
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 2
# The expert stacks' rows (G * C, one token a group): a mixed serve step
# (4 lanes x chunk 16), a decode step, a lockstep prefill of 8 x 48.
MOE_TOKENS = (("mixed", LANES * CHUNK), ("decode", LANES),
              ("prefill", REQUESTS * PROMPT))


def moe_launches_of():
    c2 = ozaki2.COUNTS
    return (launches_of(ozaki1.COUNTS),
            {"2d": c2.launches_2d, "batched": c2.launches_batched,
             "encodes": c2.launches_encode, "plane_gemms": c2.launches_planes})


def check_moe_launches(what, want):
    got = moe_launches_of()
    plain = ozaki1.COUNTS.plain_cuda_calls + ozaki2.COUNTS.plain_cuda_calls
    if got != want or plain:
        raise AssertionError(f"{what}: launches (EmuGEMM-I, EmuGEMM-II) "
                             f"{got}, plain versions on CUDA {plain}; "
                             f"expected {want} and none")


def moe_serve_phase(dev, params, view_tokens):
    """qwen2-moe-a2.7b-emu under its gemm_sites: the untied head prepared
    once (one encode), then phase 3's trace served, its launches checked
    against ``site_launches``; request 0 alone == in its cohort; step
    walls; one mixed step on the 'cuda' and 'torch' backends (each with
    its own head prep), bit for bit."""
    arch = configs.get_config(MOE_EMU)
    mcfg = arch.model
    tag = f"[serve {MOE_EMU}]"
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng = ContinuousEngine(arch, max_seq=PROMPT + GEN, params=params,
                           max_lanes=LANES, chunk=CHUNK, page_size=PAGE,
                           device=dev)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    policy, head = eng.policy, eng.params["head"]
    if not (eng.prepared and isinstance(head, prepared.PreparedOperand)
            and head.layout == "planes"
            and ozaki1.COUNTS.launches_encode == 1):
        raise AssertionError(f"{tag}: the head was not prepared once into "
                             f"planes ({type(head).__name__}, "
                             f"{ozaki1.COUNTS.launches_encode} encodes)")
    eng, trace, toks, serve, _ = serve_trace(dev, arch, eng.params, policy)
    check_moe_launches(f"{tag} serve", site_launches(
        mcfg, policy, True, serve["steps"]))
    serve["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    serve["head_prepare_ms"] = prep_ms
    serve["launches"] = moe_launches_of()
    serve["launches_per_step"] = site_launches(mcfg, policy, True)
    log(f"{tag} its gemm_sites: head prepared once (1 encode, "
        f"{prep_ms:.1f} ms), {serve['steps']} steps, {REQUESTS} requests x "
        f"{GEN} tokens in {serve['seconds']:.3f} s "
        f"({serve['tok_per_s']:.1f} tok/s), ttft p50 "
        f"{serve['ttft_p50_s']:.3f} s, peak {serve['peak_gib']:.2f} GiB; "
        f"launches (EmuGEMM-I, EmuGEMM-II) {serve['launches']}, per step "
        f"{serve['launches_per_step']}")
    alone_equals_cohort(dev, arch, eng, trace, toks, tag)
    serve.update(step_walls(
        dev, mcfg, eng.params, policy, view_tokens, True,
        check=lambda what: check_moe_launches(
            what, site_launches(mcfg, policy, True))))
    inputs = mixed_step_inputs(dev, mcfg, view_tokens)
    torch_params = prepared.prepare_params(params,
                                           on_backend(policy, "torch"))
    a = mixed_step_logits(mcfg, eng.params, on_backend(policy, "cuda"),
                          inputs)
    b = mixed_step_logits(mcfg, torch_params, on_backend(policy, "torch"),
                          inputs)
    if torch_params["head"].layout != "interleaved" or not torch.equal(a, b):
        raise AssertionError(f"{tag}: cuda and torch backend logits differ")
    if not torch.isfinite(a).all() or a.shape != (LANES,
                                                  pad_vocab(mcfg.vocab)):
        raise AssertionError(f"{tag}: bad logits {a.shape}")
    log(f"{tag} request 0 alone == in cohort; one mixed step: cuda == torch "
        f"backend logits bit for bit; mixed step {serve['mixed_step_ms']:.1f}"
        f" ms, decode step {serve['decode_step_ms']:.1f} ms")
    return serve


def moe_lockstep_phase(dev, params):
    """LockstepEngine on qwen2-moe-a2.7b under MOE_SPEC, the head prepared:
    REQUESTS prompts of PROMPT tokens (one token a group), GEN new; the
    launches of the prefill and of a decode step checked, their walls;
    the prefill's logits on the 'cuda' and 'torch' backends bit for
    bit."""
    arch = configs.get_config(MOE)
    mcfg = arch.model
    tag = f"[{MOE}]"
    prompts = np.random.default_rng(2).integers(
        0, mcfg.vocab, (REQUESTS, PROMPT)).astype(np.int32)
    pt = torch.as_tensor(prompts, device=dev)
    policy = GemmPolicy(default=api.precision(MOE_SPEC))
    want = site_launches(mcfg, policy, True)
    res = {}
    eng = LockstepEngine(arch, None, PROMPT + GEN, on_backend(policy, "cuda"),
                         params=params, prepare=True, device=dev)
    eng.prefill(pt)                               # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(pt)
    torch.cuda.synchronize()
    res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    check_moe_launches(f"{tag} prefill", want)
    tok = torch.argmax(logits[:, -1:, :mcfg.vocab], -1)
    reset_counts()
    t0 = time.perf_counter()
    eng.decode(tok, PROMPT, cache)
    torch.cuda.synchronize()
    res["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
    check_moe_launches(f"{tag} decode step", want)
    del cache
    t0 = time.perf_counter()
    toks = eng.generate(prompts, GEN)
    res["generate_s"] = time.perf_counter() - t0
    res["tok_per_s"] = REQUESTS * GEN / res["generate_s"]
    del eng
    ref = LockstepEngine(arch, None, PROMPT + GEN,
                         on_backend(policy, "torch"), params=params,
                         prepare=True, device=dev)
    ref_logits, _ = ref.prefill(pt)
    torch.cuda.synchronize()
    del ref
    if not torch.equal(logits, ref_logits):
        raise AssertionError(f"{tag}: lockstep prefill logits differ between "
                             "the cuda and torch backends")
    if (toks.shape != (REQUESTS, GEN) or not torch.isfinite(logits).all()
            or ((toks < 0) | (toks >= mcfg.vocab)).any()):
        raise AssertionError(f"{tag}: malformed lockstep output")
    res["launches_per_step"] = want
    log(f"{tag} lockstep {MOE_SPEC} (head prepared): {REQUESTS} x {PROMPT} "
        f"prompts, {GEN} new: prefill {res['prefill_ms']:.1f} ms, decode "
        f"step {res['decode_step_ms']:.1f} ms, generate "
        f"{res['generate_s']:.3f} s ({res['tok_per_s']:.1f} tok/s); prefill "
        f"logits cuda == torch bit for bit; launches a prefill and a decode "
        f"step {want}")
    return res


def moe_train_phase(dev):
    """2 of the 24 layers of qwen2-moe-a2.7b-emu at full width under its
    gemm_sites, AdamW, the config's 2 microbatches (its dense weights
    prepared once a step): a warm-up and MOE_TRAIN_STEPS timed steps of 8
    x 128 tokens (512 a microbatch: 512 groups of one token), one of 2 x
    2048 (2048 a microbatch: 512 groups of 4 tokens at capacity 1, so
    slots are dropped); then, under deterministic algorithms (an op
    without a deterministic CUDA implementation raises), the loss and
    every gradient leaf on the 'cuda' and 'torch' backends bit for bit at
    both sizes."""
    base = configs.get_config(MOE_EMU)
    arch = dataclasses.replace(base, model=dataclasses.replace(
        base.model, n_layers=MOE_TRAIN_LAYERS))
    tag = f"[train {MOE_EMU} {MOE_TRAIN_LAYERS}L]"
    policy = dispatch.resolve_policy(arch.gemm_policy())
    step = S.make_train_step(arch)
    run = {"state": S.init_state(arch, 0, dev)}
    batches = train_batches(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, warm = run_steps(step, run, batches, 1)
    timed, walls = run_steps(step, run, batches, MOE_TRAIN_STEPS)
    losses += timed
    launches = moe_launches_of()
    plain = ozaki1.COUNTS.plain_cuda_calls + ozaki2.COUNTS.plain_cuda_calls
    peak = torch.cuda.max_memory_allocated(dev)
    if plain or not (launches[0]["batched"] and launches[1]["2d"]):
        raise AssertionError(f"{tag}: launches {launches}, plain versions on "
                             f"CUDA {plain}")
    torch.cuda.reset_peak_memory_stats(dev)
    long_losses, long_walls = run_steps(
        step, run, train_batches(arch, LONG_BATCH, LONG_SEQ), 1)
    long_peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses + long_losses):
        raise AssertionError(f"{tag}: non-finite loss {losses + long_losses}")
    res = {"losses": losses, "warmup_wall_s": warm[0], "step_wall_s": walls,
           "tokens_per_s": MOE_TRAIN_STEPS * TOKENS / sum(walls),
           "peak_gib": peak / 2 ** 30,
           "launches_in_warmup_and_timed_steps": launches,
           "long_seq": {"tokens": LONG_BATCH * LONG_SEQ,
                        "losses": long_losses, "step_wall_s": long_walls,
                        "peak_gib": long_peak / 2 ** 30}}
    log(f"{tag} {arch.train.microbatches} microbatches, AdamW: "
        f"{json.dumps(res)}")
    params = run["state"]["params"]
    del run, step
    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    try:
        for b, s in ((TRAIN_BATCH, TRAIN_SEQ), (LONG_BATCH, LONG_SEQ)):
            _, batch = next(train_batches(arch, b, s))
            halves = S.split_batch(S.batch_to(batch, dev),
                                   arch.train.microbatches)

            def grads(backend):
                pol = on_backend(policy, backend)
                return S.accumulate_grads(
                    S.make_loss_fn(arch, pol), params, halves,
                    prepared.build_step_preps(params, pol))

            grads_equal(f"({MOE_EMU} {MOE_TRAIN_LAYERS}L, {b} x {s} tokens "
                        f"in {arch.train.microbatches} microbatches) cuda == "
                        "torch backend", grads("cuda"), grads("torch"))
    finally:
        torch.use_deterministic_algorithms(False)
    return res


def moe_phase(dev, view_tokens):
    """Phase 26's walls (right after the build): full-width, full-depth
    qwen2-moe-a2.7b-emu drawn on the card, served, the lockstep path on
    its weights, then 2 of its layers trained."""
    arch = configs.get_config(MOE_EMU)
    mcfg = arch.model
    t0 = time.perf_counter()
    params = M.init_params(mcfg, 0, dev)
    torch.cuda.synchronize()
    log(f"[{MOE_EMU}] published widths and depth ({mcfg.n_layers} layers, "
        f"d {mcfg.d_model}, {mcfg.n_heads} heads of "
        f"{mcfg.resolved_head_dim}, {mcfg.moe.n_experts} routed experts "
        f"padded to {moe.padded_experts(mcfg.moe)}, top-{mcfg.moe.top_k}, "
        f"expert d_ff {mcfg.moe.d_ff_expert}, {mcfg.moe.n_shared} shared of "
        f"{mcfg.moe.d_ff_shared}, vocab {mcfg.vocab} padded to "
        f"{pad_vocab(mcfg.vocab)}): {M.param_count(params) / 1e9:.3f} B "
        f"parameters ({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    report = {"serve": moe_serve_phase(dev, params, view_tokens),
              "lockstep": moe_lockstep_phase(dev, params)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    report["train"] = moe_train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{MOE_EMU}] summary " + json.dumps(report))
    return report


def moe_kernel_phase(dev, view_tokens):
    """Phase 26 after the profiler sessions: a mixed and a decode step of
    qwen2-moe-a2.7b-emu profiled (device-busy, idle share, top kernels);
    K4 at the expert stacks (MOE_TOKENS rows; dense rows and the
    dispatched stacks' zero rows) and K5g at the router's shapes against
    their plain versions bit for bit; each of them, and K1, K3 and K6 at
    a mixed step's shapes, timed beside its bound and torch.bmm /
    torch.matmul of the same shapes in bf16 and float32."""
    from torch.profiler import ProfilerActivity, profile
    arch = configs.get_config(MOE_EMU)
    mcfg = arch.model
    L = mcfg.n_layers
    policy = dispatch.resolve_policy(arch.gemm_policy())
    params = prepared.prepare_params(M.init_params(mcfg, 0, dev), policy)
    out = {}
    for kind, c, n_new in (("mixed", CHUNK, [16, 16, 5, 1]),
                           ("decode", 1, [1, 1, 1, 1])):
        tokens = torch.ones((LANES, c), device=dev, dtype=torch.int32)
        start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
        nn = torch.tensor(n_new, device=dev, dtype=torch.int32)
        cache = M.init_cache(mcfg, LANES, view_tokens, dev)
        with torch.inference_mode():
            M.forward_step(params, mcfg, tokens, start, nn, cache, policy)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.inference_mode():
                M.forward_step(params, mcfg, tokens, start, nn, cache,
                               policy)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        out[f"{kind}_profile"] = {**device_summary(prof, prof_wall, 6),
                                  **host_summary(prof)}
        log(f"[{MOE_EMU}] profiled {kind} step: "
            + json.dumps(out[f"{kind}_profile"]))
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(26)
    bf, f32 = torch.bfloat16, torch.float32
    e, d = moe.padded_experts(mcfg.moe), mcfg.d_model
    f, vp = mcfg.moe.d_ff_expert, pad_vocab(mcfg.vocab)
    max_err = {"k4": 0.0, "k5g": 0.0, "k3": 0.0, "k6": 0.0}
    # K4: gate and up (E, T, d) @ (E, d, f), down (E, T, f) @ (E, f, d).
    k4 = {}
    weights = {(k, n): conditioned(gen, (e, k, n), bf, dev)
               for k, n in ((d, f), (f, d))}
    for kind, rows in MOE_TOKENS:
        per = {}
        for name, (k, n), count in (("gate_up", (d, f), 2),
                                    ("down", (f, d), 1)):
            y = weights[(k, n)]
            nu = scheme1.pow2_scale(y, -2)
            x = conditioned(gen, (e, rows, k), bf, dev)
            # The dispatched stacks: a slot holds a token only where one
            # was routed to the expert; the others are zero rows.
            routed = x * (torch.rand((e, rows, 1), generator=gen,
                                     device=dev) < 0.1)
            for a in (x, routed):
                mu = scheme1.pow2_scale(a, -1)
                before = ozaki1.COUNTS.launches_batched
                got = ozaki1.fused_matmul_scheme1(a, y, mu, nu, P_MAIN, 7, bf)
                if ozaki1.COUNTS.launches_batched != before + 1:
                    raise AssertionError("K4 at the expert stacks: not one "
                                         "launch")
                check_equal(f"K4 {kind} {name} {(e, rows, k, n)}", got,
                            ozaki1.fused_matmul_plain(a, y, mu, nu, P_MAIN,
                                                      7, bf), max_err, "k4")
            mu = scheme1.pow2_scale(x, -1)
            xf, yf = x.float(), y.float()
            bms, by = bound_ms(e, rows, k, n, P_MAIN, 2, 2)
            per[name] = {
                "shape": [e, rows, k, n], "launches_per_step": count * L,
                "ms": queued_ms(lambda: ozaki1.launch_batched(
                    x, y, mu, nu, P_MAIN, 7, bf)),
                "plain_ms": time_ms(lambda: ozaki1.fused_matmul_plain(
                    x, y, mu, nu, P_MAIN, 7, bf), 3),
                "bound_ms": bms, "bound_by": by,
                "library_bf16_ms": time_ms(lambda: torch.bmm(x, y), 10),
                "library_f32_ms": time_ms(lambda: torch.bmm(xf, yf), 10)}
            del xf, yf
        step = {key: sum(per[nm][key] * per[nm]["launches_per_step"]
                         for nm in per)
                for key in ("ms", "plain_ms", "bound_ms", "library_bf16_ms",
                            "library_f32_ms")}
        k4[kind] = {"per_launch": per, "per_step": step}
    del weights
    out["k4"] = k4
    # K5g: the router, (T, d) @ (d, E) in float32 at m = 6.
    moduli = default_moduli(M_MAIN)
    router = conditioned(gen, (d, e), f32, dev)
    k5g = {}
    for kind, rows in MOE_TOKENS:
        a = conditioned(gen, (rows, d), f32, dev)
        mu, nu = scheme2.scales(a, router, moduli)
        c = ozaki2.COUNTS
        before = (c.launches_2d, c.launches_encode, c.launches_planes)
        got = ozaki2.fused_matmul_scheme2(a, router, mu, nu, moduli, f32)
        if (c.launches_2d, c.launches_encode, c.launches_planes) != (
                before[0] + 1, before[1] + 2, before[2] + 1):
            raise AssertionError("K5g at the router: not 2 encodes + 1 plane "
                                 "GEMM")
        check_equal(f"K5g router {(rows, d, e)}", got,
                    ozaki2.fused_matmul_scheme2_plain(a, router, mu, nu,
                                                      moduli, f32),
                    max_err, "k5g")
        bms, by = scheme2_bound(1, rows, d, e, M_MAIN, 4, 4)
        ab, rb = a.to(bf), router.to(bf)
        k5g[kind] = {
            "shape": [rows, d, e], "launches_per_step": L,
            "ms": queued_ms(lambda: ozaki2.fused_matmul_scheme2(
                a, router, mu, nu, moduli, f32)),
            "events_ms": time_ms(lambda: ozaki2.fused_matmul_scheme2(
                a, router, mu, nu, moduli, f32), 20),
            "plain_ms": time_ms(lambda: ozaki2.fused_matmul_scheme2_plain(
                a, router, mu, nu, moduli, f32), 3),
            "bound_ms": bms, "bound_by": by,
            "library_f32_ms": time_ms(lambda: torch.matmul(a, router), 20),
            "library_bf16_ms": time_ms(lambda: torch.matmul(ab, rb), 20)}
    out["k5g"] = k5g
    # K1: the 2-D calls of a mixed step (q, k, v, o; the shared experts'
    # gate, up and down), weights rotated past the L2.
    m = LANES * CHUNK
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "encode_ms": 0.0,
          "planes_ms": 0.0, "mainloop_ms": 0.0, "library_bf16_ms": 0.0,
          "library_f32_ms": 0.0, "launches_per_step": 7 * L}
    fs = mcfg.moe.d_ff_shared
    for k, n, count in ((d, d, 4), (d, fs, 2), (fs, d, 1)):
        copies = max(1, math.ceil(2 * L2_BYTES / (2 * k * n)))
        t = route_times(gen, dev, m, k, n, False, P_MAIN, bf, copies)
        t["encode_ms"] = t["encode_a_ms"] + t["encode_b_ms"]
        a, b = conditioned(gen, (m, k), bf, dev), conditioned(gen, (k, n),
                                                               bf, dev)
        af, bf32 = a.float(), b.float()
        t["library_bf16_ms"] = time_ms(lambda: torch.matmul(a, b), 20)
        t["library_f32_ms"] = time_ms(lambda: torch.matmul(af, bf32), 20)
        for key in k1:
            if key in t:
                k1[key] += count * L * t[key]
        k1["bound_ms"] += count * L * bound_ms(1, m, k, n, P_MAIN, 2, 2)[0]
    out["k1_mixed_step"] = k1
    # K3: the logits of a step, 4 lanes against the prepared head.
    a = conditioned(gen, (LANES, d), bf, dev)
    w = conditioned(gen, (d, vp), bf, dev)
    head = prepared.prepare_rhs(w, api.precision(SPEC))
    torch_head = prepared.prepare_rhs(w, api.precision(SPEC,
                                                       backend="torch"))
    check_equal("K3 on the head", prepared.matmul_prepared(a, head, f32),
                prepared.matmul_prepared(a, torch_head, f32), max_err, "k3")
    af, wf = a.float(), w.float()
    bms, by = mixed_bound(LANES, d, vp, P_MAIN, 2, 4)
    out["k3_head"] = {
        "shape": [LANES, d, vp], "launches_per_step": 1,
        "ms": queued_ms(lambda: prepared.matmul_prepared(a, head, f32)),
        "plain_ms": time_ms(lambda: prepared.matmul_prepared(
            a, torch_head, f32), 3),
        "bound_ms": bms, "bound_by": by,
        "library_bf16_ms": time_ms(lambda: torch.matmul(a, w), 20),
        "library_f32_ms": time_ms(lambda: torch.matmul(af, wf), 20)}
    del w, wf, head, torch_head
    # K6: attn_qk of a mixed and a decode step (16 KV heads of 128 a lane,
    # one query head each) at m = 6.
    bkv, hd = LANES * mcfg.n_kv_heads, mcfg.resolved_head_dim
    k6 = {}
    for kind, c in (("mixed", CHUNK), ("decode", 1)):
        q = conditioned(gen, (bkv, c, hd), bf, dev)
        kt = conditioned(gen, (bkv, view_tokens, hd), bf, dev).transpose(
            -1, -2)
        mu, nu = scheme2.scales(q, kt, moduli)
        check_equal(f"K6 attn_qk {kind}", ozaki2.fused_matmul_scheme2(
            q, kt, mu, nu, moduli, bf), ozaki2.fused_matmul_scheme2_plain(
            q, kt, mu, nu, moduli, bf), max_err, "k6")
        qf, ktf = q.float(), kt.float()
        bms, by = scheme2_bound(bkv, c, hd, view_tokens, M_MAIN, 2, 2)
        k6[kind] = {
            "shape": [bkv, c, hd, view_tokens], "launches_per_step": L,
            "ms": queued_ms(lambda: ozaki2.fused_matmul_scheme2(
                q, kt, mu, nu, moduli, bf)),
            "plain_ms": time_ms(lambda: ozaki2.fused_matmul_scheme2_plain(
                q, kt, mu, nu, moduli, bf), 3),
            "bound_ms": bms, "bound_by": by,
            "library_bf16_ms": time_ms(lambda: torch.bmm(q, kt), 20),
            "library_f32_ms": time_ms(lambda: torch.bmm(qf, ktf), 20)}
    out["k6_attn_qk"] = k6
    out["max_abs_err"] = max_err
    log(f"[{MOE_EMU}] kernels: " + json.dumps(
        {k: v for k, v in out.items() if "profile" not in k}))
    return out


# ---------------------------------------------------------------------------
# Phase 27: qwen1.5-32b at full width with its int8 KV cache, and Scheme II
# with float16 operands (the float16 instances of K5g, K6 and K5g's
# prepared form).
# ---------------------------------------------------------------------------

QWEN, QWEN_SPEC = "qwen1.5-32b", "ozaki1-p4+cached"
QWEN_CHECK_LAYERS = 2           # cuda == torch (the plain versions) depth
QWEN_ATTN = ("qwen1.5-32b MHA causal", 1, 40, 40, 2048, 2048, 128, True,
             None, "bfloat16")
F16_4096 = (4096, 4096, 4096)
F16_BATCHED = ((LANES * 16, CHUNK, 128, 64), (8, 512, 512, 512))
F16_TAG = "[float16 Scheme II]"


def none_launched(what):
    """No EmuGEMM-I or -II launch (a native run)."""
    got = {**launches_of(ozaki1.COUNTS),
           **{"s2_" + k: v for k, v in vars(ozaki2.COUNTS).items()}}
    if any(got.values()):
        raise AssertionError(f"{what}: launched {got}")


def same_rows(what, a: dict, b: dict):
    """Every cache leaf equal bit for bit."""
    for name, leaf in a.items():
        if not torch.equal(leaf, b[name]):
            raise AssertionError(f"{what}: cache leaf {name} differs")


def qwen_serve_phase(dev, arch, params, view_tokens):
    """qwen1.5-32b under QWEN_SPEC (the head prepared once) and native:
    phase 3's trace with every launch checked, tok/s, TTFT p50, peak
    memory, step walls; the int8 pools' rows of request 0 alone == in its
    cohort, bit for bit."""
    mcfg = arch.model
    tag = f"[serve {QWEN}]"
    torch.cuda.reset_peak_memory_stats()
    policy = GemmPolicy(default=api.precision(QWEN_SPEC))
    reset_counts()
    t0 = time.perf_counter()
    eng = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=policy,
                           params=params, max_lanes=LANES, chunk=CHUNK,
                           page_size=PAGE, device=dev)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    head = eng.params["head"]
    if not (eng.prepared and isinstance(head, prepared.PreparedOperand)
            and head.layout == "planes"
            and ozaki1.COUNTS.launches_encode == 1):
        raise AssertionError(f"{tag}: the head was not prepared once into "
                             "planes")
    pools = eng.pools["layers"]["b0"]
    if pools["k"].dtype != torch.int8 or pools["k_scale"].shape[-1] != 1:
        raise AssertionError(f"{tag}: the pools are not the int8 cache's")
    prepped = eng.params
    del eng
    rows = {}
    eng, trace, toks, serve, counts = serve_trace(
        dev, arch, prepped, policy, check=True, rows=rows)
    serve["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    serve["head_prepare_ms"] = prep_ms
    serve["launches"] = launches_of(counts)
    serve["launches_per_step"] = step_launches(mcfg, True)
    log(f"{tag} {QWEN_SPEC}: head prepared once (1 encode, {prep_ms:.1f} "
        f"ms), {serve['steps']} steps, {REQUESTS} requests x {GEN} tokens "
        f"in {serve['seconds']:.3f} s ({serve['tok_per_s']:.2f} tok/s), "
        f"ttft p50 {serve['ttft_p50_s']:.3f} s, peak "
        f"{serve['peak_gib']:.2f} GiB; launches {serve['launches']} (per "
        f"step {serve['launches_per_step']})")
    r0 = trace[0]
    alone_rows = {}
    alone = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=policy,
                             params=prepped, prepare=False, max_lanes=LANES,
                             chunk=CHUNK, page_size=PAGE, device=dev)
    keep_rows(alone, alone_rows)
    req = Request(prompt=r0.prompt, max_new_tokens=GEN)
    if alone.run([req])[req.rid].tokens != toks[0]:
        raise AssertionError(f"{tag}: request 0 alone differs from the "
                             "cohort")
    # The rows it wrote: its prompt and every token but the last.
    used = len(r0.prompt) + GEN - 1
    same_rows(f"{tag} request 0's int8 pool rows alone vs in its cohort",
              {k: v[:, :used] for k, v in alone_rows[req.rid].items()},
              {k: v[:, :used] for k, v in rows[r0.rid].items()})
    del alone, alone_rows
    serve.update(step_walls(dev, mcfg, prepped, policy, view_tokens, True))
    log(f"{tag} request 0 alone == in cohort: tokens and int8 pool rows "
        f"bit for bit; mixed step {serve['mixed_step_ms']:.1f} ms, decode "
        f"step {serve['decode_step_ms']:.1f} ms")
    native = GemmPolicy(default=api.precision("native"))
    _, _, ntoks, nserve, _ = serve_trace(dev, arch, params, native)
    none_launched(f"{tag} native serve")
    nserve.update(step_walls(dev, mcfg, params, native, view_tokens, False,
                             check=none_launched))
    serve["native"] = nserve
    log(f"{tag} native: {nserve['steps']} steps, "
        f"{nserve['tok_per_s']:.2f} tok/s, ttft p50 "
        f"{nserve['ttft_p50_s']:.3f} s; mixed step "
        f"{nserve['mixed_step_ms']:.1f} ms, decode step "
        f"{nserve['decode_step_ms']:.1f} ms")
    return prepped, trace, rows[r0.rid], serve


def qwen_lockstep_phase(dev, arch, prepped, trace, pool_rows):
    """LockstepEngine on the head-prepared weights: the trace's 8 prompts
    of 48 tokens, 16 new; prefill and decode walls, launches checked.
    Layer 0's int8 cache rows of request 0's prompt equal its pool rows
    from the continuous engine bit for bit; the deeper layers' differ by
    design: the lockstep prefill attends with the fresh k and v, a
    continuous step with its chunk as the int8 cache holds it (the
    reference's asymmetry)."""
    mcfg = arch.model
    tag = f"[{QWEN}]"
    prompts = np.array([r.prompt for r in trace], np.int32)
    pt = torch.as_tensor(prompts, device=dev)
    policy = GemmPolicy(default=api.precision(SPEC))
    eng = LockstepEngine(arch, None, PROMPT + GEN, policy, params=prepped,
                         prepare=False, device=dev)
    res = {}
    eng.prefill(pt)                                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(pt)
    torch.cuda.synchronize()
    res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    check_launches(f"{tag} prefill", s1_counts(), step_launches(mcfg, True))
    kv = cache["layers"]["b0"]
    layer0 = {k: v[0, 0, :PROMPT] for k, v in kv.items()}
    same_rows(f"{tag} layer 0's lockstep cache rows vs the continuous "
              "engine's pool rows", layer0,
              {k: v[0, :PROMPT] for k, v in pool_rows.items()})
    res["equal_rows_deeper_layers"] = int(sum(
        bool(torch.equal(kv["k"][i, 0, j], pool_rows["k"][i, j]))
        for i in range(1, mcfg.n_layers) for j in range(PROMPT)))
    tok = torch.argmax(logits[:, -1:, :mcfg.vocab], -1)
    reset_counts()
    t0 = time.perf_counter()
    eng.decode(tok, PROMPT, cache)
    torch.cuda.synchronize()
    res["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
    check_launches(f"{tag} decode step", s1_counts(),
                   step_launches(mcfg, True))
    del cache, kv
    t0 = time.perf_counter()
    toks = eng.generate(prompts, GEN)
    res["generate_s"] = time.perf_counter() - t0
    res["tok_per_s"] = REQUESTS * GEN / res["generate_s"]
    if (toks.shape != (REQUESTS, GEN) or not torch.isfinite(logits).all()
            or ((toks < 0) | (toks >= mcfg.vocab)).any()):
        raise AssertionError(f"{tag}: malformed lockstep output")
    res["launches_per_step"] = step_launches(mcfg, True)
    log(f"{tag} lockstep {SPEC} (head prepared): {REQUESTS} x {PROMPT} "
        f"prompts, {GEN} new: prefill {res['prefill_ms']:.1f} ms, decode "
        f"step {res['decode_step_ms']:.1f} ms, generate "
        f"{res['generate_s']:.3f} s ({res['tok_per_s']:.2f} tok/s); layer "
        f"0's cache rows == the continuous engine's pool rows bit for bit "
        f"({res['equal_rows_deeper_layers']} of "
        f"{(mcfg.n_layers - 1) * PROMPT} deeper rows equal)")
    return res


def qwen_step(mcfg, params, policy, inputs):
    """One mixed step: (logits, the updated cache views)."""
    tokens, start, n_new, cache = inputs
    views = {"layers": {"b0": {k: v.clone() for k, v in
                               cache["layers"]["b0"].items()}}}
    with torch.inference_mode():
        logits, views = M.forward_step(params, mcfg, tokens, start, n_new,
                                       views, policy)
    torch.cuda.synchronize()
    return logits, views["layers"]["b0"]


def qwen_parity_phase(dev, arch, view_tokens):
    """QWEN_CHECK_LAYERS layers at full width: one mixed step on the 'cuda'
    and 'torch' backends (each with its own head prep) gives equal logits
    and int8 caches, bit for bit; quantize_kv on the card == on the CPU."""
    tag = f"[{QWEN} {QWEN_CHECK_LAYERS}L]"
    mcfg = dataclasses.replace(arch.model, n_layers=QWEN_CHECK_LAYERS)
    params = M.init_params(mcfg, 0, dev)
    policy = GemmPolicy(default=api.precision(QWEN_SPEC))
    inputs = mixed_step_inputs(dev, mcfg, view_tokens)
    out = {}
    for backend in ("cuda", "torch"):
        pol = on_backend(policy, backend)
        out[backend] = qwen_step(mcfg, prepared.prepare_params(params, pol),
                                 pol, inputs)
    (la, ca), (lb, cb) = out["cuda"], out["torch"]
    if not torch.equal(la, lb):
        raise AssertionError(f"{tag}: cuda and torch backend logits differ")
    same_rows(f"{tag} cuda vs torch backend caches", ca, cb)
    if not torch.isfinite(la).all() or la.shape != (LANES,
                                                    pad_vocab(mcfg.vocab)):
        raise AssertionError(f"{tag}: bad logits {la.shape}")
    gen = torch.Generator(device=dev).manual_seed(27)
    x = (torch.randn((LANES, view_tokens, mcfg.n_kv_heads,
                      mcfg.resolved_head_dim), generator=gen, device=dev)
         * 3).to(torch.bfloat16)
    x[0, 0] = 0
    from repro_torch.models import attention
    q, s = attention.quantize_kv(x)
    qc, sc = attention.quantize_kv(x.cpu())
    if not (torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)):
        raise AssertionError(f"{tag}: quantize_kv on the card differs from "
                             "the CPU's")
    del params, out
    log(f"{tag} one mixed step: cuda == torch backend logits and int8 "
        "caches bit for bit (each backend's head prep); quantize_kv on the "
        "card == on the CPU, bit for bit")


def qwen_kernel_times(dev, mcfg, view_tokens):
    """K1 (a mixed step's 2-D calls), K3 (the head), K4 (attn_qk and
    attn_av on the dequantized cache, one query head a KV head) and K10
    (a 2048-token causal prefill of qwen's heads) at qwen1.5-32b's
    shapes, held against their plain versions (K10 within its bar) and
    timed beside their bounds and the library calls."""
    gen = torch.Generator(device=dev).manual_seed(28)
    bf, f32 = torch.bfloat16, torch.float32
    d, f, L = mcfg.d_model, mcfg.d_ff, mcfg.n_layers
    vp = pad_vocab(mcfg.vocab)
    max_err = {"k1": 0.0, "k3": 0.0, "k4": 0.0, "k10": 0.0}
    out = {}
    m = LANES * CHUNK
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "encode_ms": 0.0,
          "planes_ms": 0.0, "mainloop_ms": 0.0, "library_bf16_ms": 0.0,
          "launches_per_step": 7 * L}
    for k, n, count in ((d, d, 4), (d, f, 2), (f, d, 1)):
        t = route_times(gen, dev, m, k, n, False, P_MAIN, bf, 1)
        t["encode_ms"] = t["encode_a_ms"] + t["encode_b_ms"]
        a, b = conditioned(gen, (m, k), bf, dev), conditioned(gen, (k, n),
                                                               bf, dev)
        mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
        check_equal(f"K1 {(m, k, n)}", ozaki1.fused_matmul_scheme1(
            a, b, mu, nu, P_MAIN, 7, bf), ozaki1.fused_matmul_plain(
            a, b, mu, nu, P_MAIN, 7, bf), max_err, "k1")
        t["library_bf16_ms"] = time_ms(lambda: torch.matmul(a, b), 20)
        for key in k1:
            if key in t:
                k1[key] += count * L * t[key]
        k1["bound_ms"] += count * L * bound_ms(1, m, k, n, P_MAIN, 2, 2)[0]
        del a, b
    out["k1_mixed_step"] = k1
    a = conditioned(gen, (LANES, d), bf, dev)
    w = conditioned(gen, (d, vp), bf, dev)
    head = prepared.prepare_rhs(w, api.precision(SPEC))
    torch_head = prepared.prepare_rhs(w, api.precision(SPEC,
                                                       backend="torch"))
    check_equal("K3 on the head", prepared.matmul_prepared(a, head, f32),
                prepared.matmul_prepared(a, torch_head, f32), max_err, "k3")
    bms, by = mixed_bound(LANES, d, vp, P_MAIN, 2, 4)
    out["k3_head"] = {
        "shape": [LANES, d, vp], "launches_per_step": 1,
        "ms": queued_ms(lambda: prepared.matmul_prepared(a, head, f32)),
        "plain_ms": time_ms(lambda: prepared.matmul_prepared(
            a, torch_head, f32), 3),
        "bound_ms": bms, "bound_by": by,
        "library_bf16_ms": time_ms(lambda: torch.matmul(a, w), 20)}
    del w, head, torch_head
    gc.collect()
    torch.cuda.empty_cache()
    bkv, hd = LANES * mcfg.n_kv_heads, mcfg.resolved_head_dim
    k4 = {}
    for kind, c in (("mixed", CHUNK), ("decode", 1)):
        per = {}
        for site, (k, n) in (("attn_qk", (hd, view_tokens)),
                             ("attn_av", (view_tokens, hd))):
            x = conditioned(gen, (bkv, c, k), bf, dev)
            y = conditioned(gen, (bkv, k, n), bf, dev)
            mu, nu = scheme1.pow2_scale(x, -1), scheme1.pow2_scale(y, -2)
            before = ozaki1.COUNTS.launches_batched
            got = ozaki1.fused_matmul_scheme1(x, y, mu, nu, P_MAIN, 7, f32)
            if ozaki1.COUNTS.launches_batched != before + 1:
                raise AssertionError("K4 at qwen's attention: not one launch")
            check_equal(f"K4 {kind} {site}", got, ozaki1.fused_matmul_plain(
                x, y, mu, nu, P_MAIN, 7, f32), max_err, "k4")
            bms, by = bound_ms(bkv, c, k, n, P_MAIN, 2, 4)
            per[site] = {
                "shape": [bkv, c, k, n], "launches_per_step": L,
                "ms": queued_ms(lambda: ozaki1.launch_batched(
                    x, y, mu, nu, P_MAIN, 7, f32)),
                "plain_ms": time_ms(lambda: ozaki1.fused_matmul_plain(
                    x, y, mu, nu, P_MAIN, 7, f32), 3),
                "bound_ms": bms, "bound_by": by,
                "library_bf16_ms": time_ms(lambda: torch.bmm(x, y), 20)}
        k4[kind] = {"per_launch": per, "per_step": {
            key: L * sum(per[s][key] for s in per)
            for key in ("ms", "plain_ms", "bound_ms", "library_bf16_ms")}}
    out["k4"] = k4
    label, b, h, kvh, sq, sk, dd, causal, window, _ = QWEN_ATTN
    q, kk, v = attn_inputs(gen, dev, QWEN_ATTN)
    got = flash_attn.flash_attention(q, kk, v, causal=causal)
    check_close(f"K10 {label}", got, flash_attn.flash_attention_plain(
        q, kk, v, causal=causal), ATTN_TOL["bfloat16"], max_err, "k10")
    bms, by = attn_bound(b, h, kvh, sq, sk, dd, causal, window, "wgmma")
    out["k10_prefill"] = {
        "shape": [b, h, kvh, sq, sk, dd], "causal": causal,
        "ms": queued_ms(lambda: flash_attn.flash_attention(q, kk, v,
                                                           causal=causal)),
        "plain_ms": time_ms(lambda: flash_attn.flash_attention_plain(
            q, kk, v, causal=causal), 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kk, v, is_causal=causal), 20)}
    out["max_abs_err"] = max_err
    log(f"[{QWEN}] kernels at its shapes: " + json.dumps(out))
    return out


def f16_scheme2_phase(dev, mcfg):
    """K5g and K6 with float16 operands at olmo-1b's dense shapes (1024
    tokens) and 4096^3 under ozaki2-m6, float16 and float32 outputs, and
    the prepared form with a float16 lhs, each bit for bit against its
    plain version; the main path (the front doors: 2-D, batched and a
    prepared weight) with its launches counted; each timed behind the
    spin kernel beside its bound, its plain version and cuBLAS's HGEMM."""
    gen = torch.Generator(device=dev).manual_seed(16)
    moduli = default_moduli(M_MAIN)
    f16, f32 = torch.float16, torch.float32
    max_err = {"2d": 0.0, "batched": 0.0, "prepared": 0.0}
    out = {"2d": [], "batched": [], "prepared": []}
    cfg = api.precision(f"ozaki2-m{M_MAIN}")

    def both_outputs(what, a, b, mu, nu, key):
        for out_t in (f32, f16):
            s1w_equal(f"{what} -> {out_t}", ozaki2.fused_matmul_scheme2(
                a, b, mu, nu, moduli, out_t), ozaki2.fused_matmul_scheme2_plain(
                a, b, mu, nu, moduli, out_t), max_err, key, tag=F16_TAG)

    for (m, k, n) in dense_shapes(mcfg) + [F16_4096]:
        a, b = conditioned(gen, (m, k), f16, dev), conditioned(gen, (k, n),
                                                               f16, dev)
        mu, nu = scheme2.scales(a, b, moduli)
        both_outputs(f"K5g {(m, k, n)}", a, b, mu, nu, "2d")
        prep = prepared.prepare_rhs(b, cfg)
        got = prepared.matmul_prepared(a, prep, f32)
        s1w_equal(f"K5g b_res {(m, k, n)}", got,
                  ozaki2.fused_matmul_scheme2_prepared_plain(
                      a, prep.stacked(), mu, prep.scale, moduli, f32, n),
                  max_err, "prepared", tag=F16_TAG)
        s1w_equal(f"K5g b_res {(m, k, n)} == unprepared", got,
                  ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, f32),
                  max_err, "prepared", tag=F16_TAG)
        t = {"shape": [m, k, n],
             "ms": queued_ms(lambda: ozaki2.fused_matmul_scheme2(
                 a, b, mu, nu, moduli, f32)),
             "f16_out_ms": queued_ms(lambda: ozaki2.fused_matmul_scheme2(
                 a, b, mu, nu, moduli, f16)),
             "plain_ms": time_ms(lambda: ozaki2.fused_matmul_scheme2_plain(
                 a, b, mu, nu, moduli, f32), 3),
             "library_ms": time_ms(lambda: torch.matmul(a, b), 20)}
        t["bound_ms"], t["bound_by"] = scheme2_bound(1, m, k, n, M_MAIN, 2, 4)
        out["2d"].append(t)
        pt = {"shape": [m, k, n],
              "ms": queued_ms(lambda: prepared.matmul_prepared(a, prep, f32)),
              "plain_ms": time_ms(
                  lambda: ozaki2.fused_matmul_scheme2_prepared_plain(
                      a, prep.stacked(), mu, prep.scale, moduli, f32, n), 3),
              "library_ms": t["library_ms"]}
        pt["bound_ms"], pt["bound_by"] = prepared_bound(m, k, n, M_MAIN, 2, 4)
        out["prepared"].append(pt)
        del a, b, prep
    for (bt, m, k, n) in F16_BATCHED:
        a = conditioned(gen, (bt, m, k), f16, dev)
        b = conditioned(gen, (bt, k, n), f16, dev)
        mu, nu = scheme2.scales(a, b, moduli)
        both_outputs(f"K6 {(bt, m, k, n)}", a, b, mu, nu, "batched")
        t = {"shape": [bt, m, k, n],
             "ms": queued_ms(lambda: ozaki2.fused_matmul_scheme2(
                 a, b, mu, nu, moduli, f32)),
             "plain_ms": time_ms(lambda: ozaki2.fused_matmul_scheme2_plain(
                 a, b, mu, nu, moduli, f32), 3),
             "library_ms": time_ms(lambda: torch.bmm(a, b), 20)}
        t["bound_ms"], t["bound_by"] = scheme2_bound(bt, m, k, n, M_MAIN, 2,
                                                     4)
        out["batched"].append(t)
    # The main path: the front doors, the counts set to 0 just before and
    # read just after.
    (m, k, n), (bt, bm, bk, bn) = dense_shapes(mcfg)[0], F16_BATCHED[0]
    a, w = conditioned(gen, (m, k), f16, dev), conditioned(gen, (k, n), f16,
                                                           dev)
    a3 = conditioned(gen, (bt, bm, bk), f16, dev)
    b3 = conditioned(gen, (bt, bk, bn), f16, dev)
    prep = prepared.prepare_rhs(w, cfg)
    torch.cuda.synchronize()
    ozaki2.COUNTS.reset()
    api.einsum("mk,kn->mn", a, w, precision=cfg, out_dtype=f32)
    api.einsum("bmk,bkn->bmn", a3, b3, precision=cfg, out_dtype=f32)
    prepared.matmul_prepared(a, prep, f32)
    torch.cuda.synchronize()
    c = ozaki2.COUNTS
    got = (c.launches_2d, c.launches_batched, c.launches_prepared,
           c.launches_encode, c.launches_planes, c.plain_cuda_calls)
    if got != (1, 1, 1, 5, 3, 0):
        raise AssertionError(f"[float16 Scheme II] main path launches {got}")
    out["launches"] = {"2d": c.launches_2d, "batched": c.launches_batched,
                       "prepared": c.launches_prepared,
                       "encodes": c.launches_encode,
                       "plane_gemms": c.launches_planes}
    out["max_abs_err"] = max_err
    log("[float16 Scheme II] K5g, K6 and the prepared form (float16 lhs) "
        "bit for bit (NaN where NaN) at olmo-1b's dense shapes, 4096^3 and "
        "the batches, float32 and float16 outputs; main path launches "
        + json.dumps(out["launches"]) + "; " + json.dumps(
            {k: v for k, v in out.items() if k in ("2d", "batched",
                                                   "prepared")}))
    return out


def qwen_phase(dev, view_tokens):
    """Phase 27 (after phases 29, 30 and 28, with nothing else resident):
    qwen1.5-32b at its published widths and depth drawn on the card,
    served and run in lockstep with its int8 KV cache; then 2 of its
    layers on both backends, its kernels at its shapes, and Scheme II
    with float16 operands."""
    arch = configs.get_config(QWEN)
    mcfg = arch.model
    t0 = time.perf_counter()
    params = M.init_params(mcfg, 0, dev)
    torch.cuda.synchronize()
    report = {"init_s": time.perf_counter() - t0,
              "params_b": M.param_count(params) / 1e9,
              "weights_gib": torch.cuda.memory_allocated() / 2 ** 30}
    log(f"[{QWEN}] published widths and depth ({mcfg.n_layers} layers, d "
        f"{mcfg.d_model}, {mcfg.n_heads} heads over {mcfg.n_kv_heads} KV "
        f"heads of {mcfg.resolved_head_dim}, qkv bias, d_ff {mcfg.d_ff}, "
        f"vocab {mcfg.vocab} padded to {pad_vocab(mcfg.vocab)}, bf16, "
        f"{mcfg.kv_cache_dtype} KV cache): {report['params_b']:.3f} B "
        f"parameters ({report['weights_gib']:.2f} GiB) drawn on the card in "
        f"{report['init_s']:.1f} s")
    prepped, trace, pool_rows, report["serve"] = qwen_serve_phase(
        dev, arch, params, view_tokens)
    report["lockstep"] = qwen_lockstep_phase(dev, arch, prepped, trace,
                                             pool_rows)
    del params, prepped, pool_rows
    gc.collect()
    torch.cuda.empty_cache()
    qwen_parity_phase(dev, arch, view_tokens)
    gc.collect()
    torch.cuda.empty_cache()
    report["kernels"] = qwen_kernel_times(dev, mcfg, view_tokens)
    gc.collect()
    torch.cuda.empty_cache()
    report["f16"] = f16_scheme2_phase(dev, configs.get_config("olmo-1b")
                                      .model)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{QWEN}] summary " + json.dumps(
        {k: v for k, v in report.items() if k not in ("kernels", "f16")}))
    return report


# ---------------------------------------------------------------------------
# Phase 28: the rest of the zoo at full width and depth: recurrentgemma-2b
# (RG-LRU blocks and local attention over a ring-buffer KV cache) and
# mamba2-780m (Mamba-2 SSD blocks) served by the lockstep engine,
# internvl2-1b (the vision stub) through the prefill / decode steps and
# the lockstep engine, and hubert-xlarge (the audio stub, a bidirectional
# encoder) through its prefill step, a plain forward.
# ---------------------------------------------------------------------------

ZOO_SPEC = "ozaki1-p4+cached"
ZOO_LANES, ZOO_GEN = 4, 32
ZOO_PROMPTS = {"recurrentgemma-2b": 2304, "mamba2-780m": 2048,
               "internvl2-1b": 2048}
ZOO_TEXT_PROMPT = 512           # internvl2-1b's lockstep text run
HUBERT_FRAMES = (2, 2048)
# Reduced-depth checks at full width: the layers kept, the tokens, and
# what is shrunk so that the CPU run sees the same code path (a ring that
# rotates and wraps; several SSD chunks and a ragged one).
ZOO_CHECK = {"recurrentgemma-2b": (4, {"attn_window": 16}),
             "mamba2-780m": (2, {"ssd_chunk": 16}),
             "internvl2-1b": (2, {}), "hubert-xlarge": (2, {})}
ZOO_CHECK_B, ZOO_CHECK_S, ZOO_CHECK_DECODES = 2, 40, 3
ZOO_CPU_TOL = 1e-4              # the CPU parity tests' bar on logits


@contextlib.contextmanager
def recorded_calls():
    """Count the EmuGEMM-I front-door calls made inside the block by
    signature: ('2d' | 'batched', batch, m, k, n, operand dtype, output
    dtype, B read through its transpose) and ('mixed', 1, m, k, n, ...)
    for a prepared weight. The calls go on to the wrappers unchanged."""
    calls = {}
    s1, mixed = ozaki1.fused_matmul_scheme1, ozaki1.fused_matmul_mixed

    def rec_s1(a, b, mu, nu, p, beta, out_dtype):
        lead = (a.shape[0],) if a.dim() == 3 else (1,)
        tr = b.shape[-1] > 1 and b.stride(-2) == 1 and b.shape[-2] > 1
        key = ("batched" if a.dim() == 3 else "2d", *lead, a.shape[-2],
               a.shape[-1], b.shape[-1], a.dtype, out_dtype, tr)
        calls[key] = calls.get(key, 0) + 1
        return s1(a, b, mu, nu, p, beta, out_dtype)

    def rec_mixed(a, b_planes, mu, nu, p, beta, out_dtype):
        key = ("mixed", 1, a.shape[0], a.shape[1], b_planes.shape[1],
               a.dtype, out_dtype, False)
        calls[key] = calls.get(key, 0) + 1
        return mixed(a, b_planes, mu, nu, p, beta, out_dtype)

    ozaki1.fused_matmul_scheme1 = rec_s1
    ozaki1.fused_matmul_mixed = rec_mixed
    try:
        yield calls
    finally:
        ozaki1.fused_matmul_scheme1 = s1
        ozaki1.fused_matmul_mixed = mixed


def plain_scheme1(a, b, mu, nu, out_dt):
    """``ozaki1.fused_matmul_plain`` at p = P_MAIN; a batch whose float64
    slice products would pass 2^28 entries of B a group of batch elements
    at a time (each element's product is its own, so the bits are the
    same)."""
    step = a.shape[0] if a.dim() < 3 else max(1, 2 ** 28 // b[0].numel())
    if a.dim() < 3 or step >= a.shape[0]:
        return ozaki1.fused_matmul_plain(a, b, mu, nu, P_MAIN, 7, out_dt)
    return torch.cat([ozaki1.fused_matmul_plain(
        a[i:i + step], b[i:i + step], mu[i:i + step], nu[i:i + step],
        P_MAIN, 7, out_dt) for i in range(0, a.shape[0], step)])


def zoo_kernel_times(dev, tag, steps: dict, max_err: dict,
                     plain_iters: int = 3) -> dict:
    """Each EmuGEMM-I signature that ``steps`` ({step name: recorded
    calls}) made, on Eq. 19 operands of its shape, type and layout: the
    kernel against its plain version bit for bit, one front-door call
    the expected launches; timed (device, behind a spin kernel) beside
    its bound, its plain version (``plain_iters`` calls after two
    warm-ups, or with 0 the checking call alone, by CUDA events) and
    torch.matmul / torch.bmm on the same operands; then summed over each
    step's calls."""
    gen = torch.Generator(device=dev).manual_seed(28)

    def plain_ms(fn):
        if plain_iters:
            return None, time_ms(fn, plain_iters)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    per_sig = {}
    for sig in sorted({s for calls in steps.values() for s in calls},
                      key=str):
        form, batch, m, k, n, dt, out_dt, tr = sig
        lead = (batch,) if form == "batched" else ()
        a = conditioned(gen, lead + (m, k), dt, dev)
        if form == "mixed":
            w = conditioned(gen, (k, n), dt, dev)
            prep = prepared.prepare_rhs(w, api.precision(SPEC))
            plain_prep = prepared.prepare_rhs(
                w, api.precision(SPEC, backend="torch"))
            c = ozaki1.COUNTS
            before = (c.launches_mixed, c.launches_encode, c.launches_planes)
            got = prepared.matmul_prepared(a, prep, out_dt)
            if (c.launches_mixed, c.launches_encode, c.launches_planes) != (
                    before[0] + 1, before[1] + 1, before[2] + 1):
                raise AssertionError(f"{tag} K3 {sig}: not 1 encode + 1 "
                                     "plane GEMM")
            ref, p_ms = plain_ms(lambda: prepared.matmul_prepared(
                a, plain_prep, out_dt))
            check_equal(f"{tag} K3 {sig[:5]}", got, ref if ref is not None
                        else prepared.matmul_prepared(a, plain_prep, out_dt),
                        max_err, "k3")
            del ref
            bms, by = mixed_bound(m, k, n, P_MAIN, a.element_size(),
                                  torch.empty((), dtype=out_dt).element_size())
            per_sig[sig] = {
                "ms": queued_ms(lambda: prepared.matmul_prepared(a, prep,
                                                                 out_dt)),
                "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": time_ms(lambda: torch.matmul(a, w), 10)}
            del w, prep, plain_prep
            continue
        shape_b = lead + ((n, k) if tr else (k, n))
        b = conditioned(gen, shape_b, dt, dev)
        b = b.transpose(-1, -2) if tr else b
        mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
        c = ozaki1.COUNTS
        key = "launches_batched" if form == "batched" else "launches_2d"
        before = getattr(c, key)
        got = ozaki1.fused_matmul_scheme1(a, b, mu, nu, P_MAIN, 7, out_dt)
        if getattr(c, key) != before + 1:
            raise AssertionError(f"{tag} {sig}: not one front-door call")
        kid = "k4" if form == "batched" else "k1"
        ref, p_ms = plain_ms(lambda: plain_scheme1(a, b, mu, nu, out_dt))
        check_equal(f"{tag} {kid.upper()} {sig[:5]} {dt}", got,
                    ref if ref is not None
                    else plain_scheme1(a, b, mu, nu, out_dt), max_err, kid)
        del ref
        bms, by = bound_ms(batch, m, k, n, P_MAIN, a.element_size(),
                           torch.empty((), dtype=out_dt).element_size())
        lib = torch.bmm if form == "batched" else torch.matmul
        per_sig[sig] = {
            "ms": queued_ms(lambda: ozaki1.fused_matmul_scheme1(
                a, b, mu, nu, P_MAIN, 7, out_dt)),
            "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: lib(a, b), 10)}
        del a, b, got
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for step, calls in steps.items():
        rows = {}
        for form, kid in (("2d", "k1"), ("mixed", "k3"), ("batched", "k4")):
            sigs = {s: n for s, n in calls.items() if s[0] == form}
            if not sigs:
                continue
            rows[kid] = {
                "launches_per_step": sum(sigs.values()),
                **{key: sum(n * per_sig[s][key] for s, n in sigs.items())
                   for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
                "shapes": [[*s[1:5], str(s[5])[6:], str(s[6])[6:],
                            "B^T" if s[7] else "B", n, per_sig[s]["ms"]]
                           for s, n in sigs.items()]}
        out[step] = rows
    return out


def zoo_lockstep(dev, arch, params, prompt_len, spec, tag):
    """LockstepEngine on ZOO_LANES seeded prompts of ``prompt_len``
    tokens, ZOO_GEN new: the prefill (after a warm-up) and one decode
    step timed with their launches read around them and their EmuGEMM-I
    calls recorded; then generate timed (tok/s; TTFT, the prefill's wall:
    every lane's first token comes from its logits); peak memory."""
    mcfg = arch.model
    cached = spec == ZOO_SPEC
    policy = GemmPolicy(default=api.precision(spec))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng = LockstepEngine(arch, None, prompt_len + ZOO_GEN, policy,
                         params=params, prepare=cached, device=dev)
    torch.cuda.synchronize()
    res = {"prepare_ms": (time.perf_counter() - t0) * 1e3,
           "prepared_leaves": sum(isinstance(v, prepared.PreparedOperand)
                                  for v in tree_flatten(eng.params).values()),
           "prepare_encodes": ozaki1.COUNTS.launches_encode}
    prompts = np.random.default_rng(0).integers(
        0, mcfg.vocab, (ZOO_LANES, prompt_len)).astype(np.int32)
    pt = torch.as_tensor(prompts, device=dev)
    eng.prefill(pt)                                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    with recorded_calls() as pre_calls:
        t0 = time.perf_counter()
        logits, cache = eng.prefill(pt)
        torch.cuda.synchronize()
        res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    res["prefill_launches"] = launches_of(s1_counts())
    if not cached:
        none_launched(f"{tag} native prefill")
    tok = torch.argmax(logits[:, -1:, :mcfg.vocab], -1)
    reset_counts()
    with recorded_calls() as dec_calls:
        t0 = time.perf_counter()
        eng.decode(tok, prompt_len, cache)
        torch.cuda.synchronize()
        res["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
    res["decode_launches"] = launches_of(s1_counts())
    if cached:
        for what, calls in (("prefill", pre_calls), ("decode", dec_calls)):
            got = res[f"{what}_launches"]
            want = {f: sum(n for s, n in calls.items() if s[0] == f)
                    for f in ("2d", "mixed", "batched")}
            if ({f: got[f] for f in want} != want or not want["2d"]
                    or s1_counts().plain_cuda_calls):
                raise AssertionError(f"{tag} {what}: launches {got}, "
                                     f"recorded calls {want}")
    else:
        none_launched(f"{tag} native decode")
    del cache
    t0 = time.perf_counter()
    toks = eng.generate(prompts, ZOO_GEN)
    res["generate_s"] = time.perf_counter() - t0
    res["tok_per_s"] = ZOO_LANES * ZOO_GEN / res["generate_s"]
    res["ttft_s"] = res["prefill_ms"] / 1e3
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if (toks.shape != (ZOO_LANES, ZOO_GEN) or not torch.isfinite(logits).all()
            or ((toks < 0) | (toks >= mcfg.vocab)).any()):
        raise AssertionError(f"{tag}: malformed lockstep output")
    log(f"{tag} lockstep {spec}: {ZOO_LANES} x {prompt_len} prompts, "
        f"{ZOO_GEN} new: prefill {res['prefill_ms']:.1f} ms (launches "
        f"{res['prefill_launches']}), decode step "
        f"{res['decode_step_ms']:.1f} ms (launches {res['decode_launches']}),"
        f" generate {res['generate_s']:.3f} s ({res['tok_per_s']:.2f} "
        f"tok/s), peak {res['peak_gib']:.2f} GiB; {res['prepared_leaves']} "
        f"leaves prepared in {res['prepare_ms']:.1f} ms")
    del eng
    return res, {"prefill": pre_calls, "decode": dec_calls}


def zoo_check_inputs(mcfg, seed=29):
    """Seeded numpy inputs of the reduced-depth checks: ids (the vision
    stub's with image embeddings) or the audio stub's frames."""
    rng = np.random.default_rng(seed)
    b, s = ZOO_CHECK_B, ZOO_CHECK_S
    if mcfg.frontend == "audio_stub":
        return {"tokens": rng.standard_normal(
            (b, s, mcfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, mcfg.vocab, (b, s)).astype(np.int32)}
    if mcfg.frontend == "vision_stub":
        out["image_embeds"] = rng.standard_normal(
            (b, mcfg.n_image_tokens, mcfg.frontend_dim)).astype(np.float32)
    return out


def zoo_run(mcfg, params, policy, inputs, dev):
    """The reduced model's logits: an encoder's forward, or a prefill and
    ZOO_CHECK_DECODES greedy decodes (each step's logits, in float32)."""
    dtype = getattr(torch, mcfg.dtype)
    x = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    x = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in x.items()}          # stub features in the model type
    with torch.inference_mode():
        if not mcfg.causal:
            return [M.forward_train(params, mcfg, x, policy,
                                    remat=False)[0].float().cpu()]
        s = x["tokens"].shape[1]
        logits, cache = M.forward_prefill(params, mcfg, x,
                                          s + ZOO_CHECK_DECODES, policy)
        outs = [logits.float().cpu()]
        for i in range(ZOO_CHECK_DECODES):
            tok = torch.argmax(outs[-1][:, -1:, :mcfg.vocab], -1).to(
                torch.int32)
            logits, cache = M.forward_decode(params, mcfg, tok.to(dev),
                                             s + i, cache, policy)
            outs.append(logits.float().cpu())
    return outs


def zoo_check_phase(dev, arch_id):
    """The architecture at full width and reduced depth (ZOO_CHECK): in
    float32 native on the card against the CPU port on the same weights,
    within ZOO_CPU_TOL x max|logits|; in bf16 under ZOO_SPEC (the
    2-D weights prepared) on the 'cuda' backend against the 'torch'
    backend (the plain versions, on the card), bit for bit."""
    n_layers, shrink = ZOO_CHECK[arch_id]
    mcfg = configs.get_config(arch_id).model
    rep = {"n_layers": n_layers}
    if "attn_window" in shrink:
        rep["attn_window"] = shrink["attn_window"]
        mcfg = dataclasses.replace(mcfg, attn_window=shrink["attn_window"])
    if "ssd_chunk" in shrink:
        rep["ssd_chunk"] = shrink["ssd_chunk"]
        mcfg = dataclasses.replace(mcfg, ssd=dataclasses.replace(
            mcfg.ssd, chunk=shrink["ssd_chunk"]))
    tag = f"[{arch_id} {n_layers}L]"
    inputs = zoo_check_inputs(mcfg)
    f32 = dataclasses.replace(mcfg, n_layers=n_layers, dtype="float32")
    params = M.init_params(f32, 0, dev)
    native = GemmPolicy(default=api.precision("native"))
    card = zoo_run(f32, params, native, inputs, dev)
    cpu_params = tree_map(lambda x: x.cpu(), params)
    del params
    host = zoo_run(f32, cpu_params, native, inputs, torch.device("cpu"))
    del cpu_params
    err = 0.0
    for a, b in zip(card, host):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{tag}: non-finite logits on the card")
        err = max(err, ((a - b).abs().max() / b.abs().max()).item())
    if err > ZOO_CPU_TOL:
        raise AssertionError(f"{tag}: card vs CPU logits {err:.3g} of "
                             f"max|logits| > {ZOO_CPU_TOL}")
    rep["card_vs_cpu_rel_err"] = err
    bf = dataclasses.replace(mcfg, n_layers=n_layers)
    params = M.init_params(bf, 0, dev)
    policy = GemmPolicy(default=api.precision(ZOO_SPEC))
    outs = {}
    for backend in ("cuda", "torch"):
        pol = on_backend(policy, backend)
        outs[backend] = zoo_run(bf, prepared.prepare_params(params, pol),
                                pol, inputs, dev)
    for a, b in zip(outs["cuda"], outs["torch"]):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: cuda and torch backend logits "
                                 "differ")
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} full width, {n_layers} layers"
        + (f" ({shrink})" if shrink else "") + f": float32 card vs CPU "
        f"logits within {err:.3g} of max|logits| (bar {ZOO_CPU_TOL}); "
        f"{ZOO_SPEC} bf16: cuda == torch backend logits bit for bit "
        f"({1 + ZOO_CHECK_DECODES * mcfg.causal} steps)")
    return rep


def zoo_arch(dev, arch_id, max_err):
    """One architecture of phase 28 at full width and depth: its run(s),
    its kernels at their shapes, its reduced-depth checks."""
    arch = configs.get_config(arch_id)
    mcfg = arch.model
    tag = f"[{arch_id}]"
    t0 = time.perf_counter()
    params = M.init_params(mcfg, 0, dev)
    torch.cuda.synchronize()
    rep = {"init_s": time.perf_counter() - t0,
           "params_b": M.param_count(params) / 1e9,
           "weights_gib": torch.cuda.memory_allocated() / 2 ** 30}
    log(f"{tag} published widths and depth ({mcfg.n_layers} layers, "
        f"pattern {mcfg.block_pattern}, d {mcfg.d_model}, vocab "
        f"{mcfg.vocab}, bf16): {rep['params_b']:.3f} B parameters "
        f"({rep['weights_gib']:.2f} GiB) drawn on the card in "
        f"{rep['init_s']:.1f} s")
    if arch_id in ("recurrentgemma-2b", "mamba2-780m"):
        rep["lockstep"], calls = zoo_lockstep(
            dev, arch, params, ZOO_PROMPTS[arch_id], ZOO_SPEC, tag)
        rep["lockstep_native"], _ = zoo_lockstep(
            dev, arch, params, ZOO_PROMPTS[arch_id], "native", tag)
    elif arch_id == "internvl2-1b":
        rep["steps"], calls = zoo_vlm_steps(dev, arch, params, tag)
        rep["lockstep_text"], _ = zoo_lockstep(
            dev, arch, params, ZOO_TEXT_PROMPT, ZOO_SPEC, tag)
    else:
        rep["encoder"], calls = zoo_encoder(dev, arch, params, tag)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    zoo_check_launches(tag, mcfg, rep)
    rep["kernels"] = zoo_kernel_times(dev, tag, calls, max_err)
    rep["check"] = zoo_check_phase(dev, arch_id)
    log(f"{tag} kernels a step at its shapes: " + json.dumps(rep["kernels"]))
    return rep


def zoo_check_launches(tag, mcfg, rep):
    """The forms each path must launch under ZOO_SPEC: K4 at every
    attention layer (attn_qk, attn_av) and at mamba2's decode state read
    ('ssd_state'), K3 for every prepared weight (the untied heads and
    recurrentgemma-2b's 2-D tail), K1 for the rest."""
    kinds = mcfg.pattern_for_layers()
    n_attn, n_ssd = kinds.count("attn"), kinds.count("ssd")
    tail = M._groups(mcfg)[2]
    mixed = (0 if mcfg.tie_embeddings else 1) + 6 * len(tail)
    runs = []
    if "lockstep" in rep:
        runs += [("prefill", rep["lockstep"]["prefill_launches"]),
                 ("decode", rep["lockstep"]["decode_launches"])]
    if "steps" in rep:
        runs += [("prefill", rep["steps"]["prefill_launches"]),
                 ("decode", rep["steps"]["decode_launches"])]
    if "encoder" in rep:
        runs += [("forward", rep["encoder"][ZOO_SPEC]["launches"])]
    for what, got in runs:
        want_b = n_attn and got["batched"] >= 2 * n_attn or (
            not n_attn and got["batched"] == (n_ssd if what == "decode"
                                              else 0))
        if got["mixed"] != mixed or not want_b or not got["2d"]:
            raise AssertionError(f"{tag} {what}: launches {got}; expected "
                                 f"{mixed} mixed, K4 at {n_attn} attention "
                                 f"/ {n_ssd} ssd layers")


def zoo_vlm_steps(dev, arch, params, tag):
    """internvl2-1b: make_prefill_step on a pipeline batch of ZOO_LANES x
    its prompt with n_image_tokens projected image tokens, then ZOO_GEN
    make_decode_step steps, under ZOO_SPEC with the head prepared once."""
    mcfg = arch.model
    s = ZOO_PROMPTS[arch.model.name]
    policy = GemmPolicy(default=api.precision(ZOO_SPEC))
    prepped = prepared.prepare_params(params, policy)
    shape = ShapeSpec("zoo", s + ZOO_GEN, ZOO_LANES, "prefill")
    _, batch = next(make_batch_iterator(
        arch, ShapeSpec("zoo", s, ZOO_LANES, "prefill"), 0))
    if batch["image_embeds"].shape[1] != mcfg.n_image_tokens:
        raise AssertionError(f"{tag}: the batch has no image tokens")
    inputs = S.batch_to({k: v for k, v in batch.items() if k != "labels"},
                        dev)
    prefill = S.make_prefill_step(arch, shape, None, policy)
    decode = S.make_decode_step(arch, shape, None, policy)
    torch.cuda.reset_peak_memory_stats()
    prefill(prepped, inputs)                          # warm-up
    torch.cuda.synchronize()
    reset_counts()
    with recorded_calls() as pre_calls:
        t0 = time.perf_counter()
        logits, cache = prefill(prepped, inputs)
        torch.cuda.synchronize()
        res = {"prefill_ms": (time.perf_counter() - t0) * 1e3}
    res["prefill_launches"] = launches_of(s1_counts())
    toks = []
    walls = []
    dec_calls = None
    for i in range(ZOO_GEN):
        tok = torch.argmax(logits[:, -1:, :mcfg.vocab], -1).to(torch.int32)
        toks.append(tok)
        reset_counts()
        with recorded_calls() as calls:
            t0 = time.perf_counter()
            logits, cache = decode(prepped, cache, tok, s + i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if dec_calls is None:
            dec_calls = calls
            res["decode_launches"] = launches_of(s1_counts())
    toks = torch.cat(toks, 1)
    if (not torch.isfinite(logits).all() or toks.shape != (ZOO_LANES, ZOO_GEN)
            or ((toks < 0) | (toks >= mcfg.vocab)).any()):
        raise AssertionError(f"{tag}: malformed steps' output")
    res.update({"decode_step_ms": float(np.mean(walls[1:])),
                "tok_per_s": ZOO_LANES * ZOO_GEN / (
                    res["prefill_ms"] + sum(walls)) * 1e3,
                "ttft_s": res["prefill_ms"] / 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    if res["prefill_launches"]["mixed"] != 1 or not res["prefill_launches"][
            "batched"]:
        raise AssertionError(f"{tag}: prefill launches "
                             f"{res['prefill_launches']}")
    log(f"{tag} steps {ZOO_SPEC}: prefill of {ZOO_LANES} x {s} tokens "
        f"({mcfg.n_image_tokens} image tokens) {res['prefill_ms']:.1f} ms "
        f"(launches {res['prefill_launches']}), {ZOO_GEN} decode steps "
        f"{res['decode_step_ms']:.1f} ms each (launches "
        f"{res['decode_launches']}), {res['tok_per_s']:.2f} tok/s, peak "
        f"{res['peak_gib']:.2f} GiB")
    del prepped, cache
    return res, {"prefill": pre_calls, "decode": dec_calls}


def zoo_encoder(dev, arch, params, tag):
    """hubert-xlarge: the encoder's make_prefill_step (a plain forward)
    on HUBERT_FRAMES frames of frontend_dim from the pipeline, in the
    model's type (the reference's input_specs), under ZOO_SPEC with the
    head prepared once, and native."""
    mcfg = arch.model
    b, s = HUBERT_FRAMES
    _, batch = next(make_batch_iterator(arch, ShapeSpec("zoo", s, b,
                                                        "prefill"), 0))
    frames = torch.as_tensor(batch["tokens"], device=dev).to(
        getattr(torch, mcfg.dtype))
    res = {}
    calls = None
    for spec in (ZOO_SPEC, "native"):
        policy = GemmPolicy(default=api.precision(spec))
        prepped = prepared.prepare_params(params, policy)
        step = S.make_prefill_step(arch, ShapeSpec("zoo", s, b, "prefill"),
                                   None, policy)
        torch.cuda.reset_peak_memory_stats()
        step(prepped, {"tokens": frames})             # warm-up
        torch.cuda.synchronize()
        reset_counts()
        with recorded_calls() as rec:
            t0 = time.perf_counter()
            logits = step(prepped, {"tokens": frames})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        if logits.shape != (b, s, pad_vocab(mcfg.vocab)) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"{tag}: bad logits {tuple(logits.shape)}")
        r = {"forward_ms": wall, "frames_per_s": b * s / wall * 1e3,
             "launches": launches_of(s1_counts()),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if spec == ZOO_SPEC:
            calls = {"forward": rec}
            if r["launches"]["mixed"] != 1 or not r["launches"]["batched"]:
                raise AssertionError(f"{tag}: launches {r['launches']}")
        else:
            none_launched(f"{tag} native")
        res[spec] = r
        log(f"{tag} encoder prefill step {spec}: {b} x {s} frames of "
            f"{mcfg.frontend_dim} in {wall:.1f} ms ({r['frames_per_s']:.0f} "
            f"frames/s), launches {r['launches']}, peak "
            f"{r['peak_gib']:.2f} GiB")
        del prepped, logits
    return res, calls


def zoo_phase(dev):
    """Phase 28 (after phase 30, before any profiler session; each
    architecture frees its weights before the next)."""
    max_err = {"k1": 0.0, "k3": 0.0, "k4": 0.0}
    report = {}
    for arch_id in ("recurrentgemma-2b", "mamba2-780m", "internvl2-1b",
                    "hubert-xlarge"):
        t0 = time.perf_counter()
        report[arch_id] = zoo_arch(dev, arch_id, max_err)
        report[arch_id]["phase_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    report["max_abs_err"] = max_err
    log("[zoo] summary " + json.dumps(
        {a: {k: v for k, v in r.items() if k != "kernels"}
         for a, r in report.items() if a != "max_abs_err"}))
    return report


# ---------------------------------------------------------------------------
# Phase 29: deepseek-v3-671b (MLA over a latent KV cache, sigmoid-routed
# top-8 MoE over 256 experts with a shared expert, multi-token prediction,
# Adafactor) at its published widths, DSV3_LAYERS of its 61 layers deep.
# ---------------------------------------------------------------------------

DSV3, DSV3_SPEC = "deepseek-v3-671b", "ozaki1-p4+cached"
# 2 x 11.50 B in the layers and 1.86 B in the embedding and head: 46.3
# GiB of bf16 weights, and the head's planes 3.46 GiB; a third layer
# (about 71 GiB before any temporary) leaves no room.
DSV3_LAYERS = 2
# The reduced config of the checks and of training: 1 layer and 16 of
# the 256 experts (top-8 kept), every other width published.
DSV3_CHECK_LAYERS, DSV3_CHECK_EXPERTS = 1, 16
DSV3_TRAIN_BATCH, DSV3_TRAIN_SEQ, DSV3_TRAIN_STEPS = 16, 128, 2
DSV3_ADAFACTOR_LR = 1e-3
# One leaf of each rank for Adafactor on the card against the CPU: 1-D
# (a norm scale, the router bias), 2-D (a projection, a stacked norm),
# 3-D (the MTP block's expert stack) and 4-D (the layer's).
DSV3_ADAFACTOR_LEAVES = ("mtp/ln/scale", "mtp/block/moe/router_bias",
                         "mtp/proj", "layers/b0/ln1/scale",
                         "mtp/block/moe/wo", "layers/b0/moe/wi_gate")


def dsv3_arch(n_layers, n_experts=None, mtp=False):
    """deepseek-v3-671b's config, ``n_layers`` deep, with ``n_experts``
    routed experts (top-8 kept) and the MTP block only with ``mtp``."""
    base = configs.get_config(DSV3)
    mcfg = dataclasses.replace(base.model, n_layers=n_layers, mtp=mtp)
    if n_experts:
        mcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(
            mcfg.moe, n_experts=n_experts))
    return dataclasses.replace(base, model=mcfg)


def dsv3_launches(mcfg, prepared_head: bool, latent: int = 0) -> dict:
    """EmuGEMM-I launches of one forward pass under one Scheme-I spec. A
    layer: wq_a, wq_b, wkv_a, wo ('attn'), the router ('moe_gate', float32)
    and the shared expert's gate, up and down ('ffn') as 2-D calls, and
    ``latent`` 'mla_latent' decompressions (2 a KV chunk of a prefill or
    a training forward; none in the absorbed step and decode); the three
    expert stacks ('moe_expert') batched; the head one mixed call when
    prepared. A 2-D call is 2 encodes + 1 plane GEMM, a mixed one 1 + 1;
    MLA's score and output products are plain einsums, as the
    reference's."""
    L = mcfg.n_layers
    s1 = {"2d": (8 + latent) * L + (0 if prepared_head else 1),
          "mixed": int(prepared_head), "batched": 3 * L}
    s1["encodes"] = 2 * s1["2d"] + s1["mixed"]
    s1["plane_gemms"] = s1["2d"] + s1["mixed"]
    return s1


def dsv3_decode_inputs(dev, mcfg, view_tokens):
    """A pure decode step's inputs: one token a lane at the lanes' mixed
    step positions, on a zero cache."""
    return (torch.ones((LANES, 1), device=dev, dtype=torch.int32),
            torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32),
            torch.ones(LANES, device=dev, dtype=torch.int32),
            M.init_cache(mcfg, LANES, view_tokens, dev))


def dsv3_serve(dev, arch, params, view_tokens):
    """The served model (DSV3_LAYERS deep, no MTP block) under DSV3_SPEC:
    the head prepared once, phase 3's trace served with every launch
    checked; request 0 alone == in its cohort; step walls; the EmuGEMM-I
    calls of a mixed and a decode step recorded; then native."""
    mcfg = arch.model
    tag = f"[serve {DSV3} {mcfg.n_layers}L]"
    policy = GemmPolicy(default=api.precision(DSV3_SPEC))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=policy,
                           params=params, max_lanes=LANES, chunk=CHUNK,
                           page_size=PAGE, device=dev)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    head = eng.params["head"]
    if not (eng.prepared and isinstance(head, prepared.PreparedOperand)
            and head.layout == "planes"
            and ozaki1.COUNTS.launches_encode == 1):
        raise AssertionError(f"{tag}: the head was not prepared once into "
                             f"planes ({type(head).__name__}, "
                             f"{ozaki1.COUNTS.launches_encode} encodes)")
    pools = eng.pools["layers"]["b0"]
    if {k: v.shape[-1] for k, v in pools.items()} != {
            "c_kv": mcfg.mla.kv_lora_rank, "k_pe": mcfg.mla.qk_rope_dim}:
        raise AssertionError(f"{tag}: pools {list(pools)}")
    prepped = eng.params
    eng, trace, toks, serve, counts = serve_trace(dev, arch, prepped, policy)
    per_step = dsv3_launches(mcfg, True)
    check_launches(f"{tag} serve", counts,
                   {k: serve["steps"] * v for k, v in per_step.items()})
    serve.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 head_prepare_ms=prep_ms, launches=launches_of(counts),
                 launches_per_step=per_step)
    log(f"{tag} {DSV3_SPEC}: head prepared once (1 encode, {prep_ms:.1f} "
        f"ms), {serve['steps']} steps, {REQUESTS} requests x {GEN} tokens in "
        f"{serve['seconds']:.3f} s ({serve['tok_per_s']:.2f} tok/s), ttft "
        f"p50 {serve['ttft_p50_s']:.3f} s, peak {serve['peak_gib']:.2f} GiB; "
        f"launches {serve['launches']} (per step {per_step})")
    alone_equals_cohort(dev, arch, eng, trace, toks, tag)
    del eng
    serve.update(step_walls(
        dev, mcfg, prepped, policy, view_tokens, True,
        check=lambda what: check_launches(what, s1_counts(), per_step)))
    calls = {}
    for kind, inputs in (("mixed", mixed_step_inputs(dev, mcfg, view_tokens)),
                         ("decode", dsv3_decode_inputs(dev, mcfg,
                                                       view_tokens))):
        with recorded_calls() as calls[kind]:
            logits = mixed_step_logits(mcfg, prepped, policy, inputs)
        if not torch.isfinite(logits).all() or logits.shape != (
                LANES, pad_vocab(mcfg.vocab)):
            raise AssertionError(f"{tag} {kind} step: bad logits")
    native = GemmPolicy(default=api.precision("native"))
    reset_counts()
    _, _, _, nat, _ = serve_trace(dev, arch, params, native)
    none_launched(f"{tag} native serve")
    nat.update(step_walls(dev, mcfg, params, native, view_tokens, False,
                          check=none_launched))
    serve["native"] = nat
    log(f"{tag} request 0 alone == in cohort; mixed / decode step "
        f"{serve['mixed_step_ms']:.1f} / {serve['decode_step_ms']:.1f} ms; "
        f"native: {nat['tok_per_s']:.2f} tok/s, ttft p50 "
        f"{nat['ttft_p50_s']:.3f} s, mixed / decode step "
        f"{nat['mixed_step_ms']:.1f} / {nat['decode_step_ms']:.1f} ms")
    return prepped, serve, calls


def dsv3_lockstep(dev, arch, prepped):
    """LockstepEngine on the served weights (the head prepared): REQUESTS
    prompts of PROMPT tokens, GEN new; the prefill (its KV chunk
    decompressed through 'mla_latent' on K1) and a decode step timed with
    their launches checked and the prefill's calls recorded."""
    mcfg = arch.model
    tag = f"[{DSV3} {mcfg.n_layers}L]"
    policy = GemmPolicy(default=api.precision(DSV3_SPEC))
    prompts = np.random.default_rng(2).integers(
        0, mcfg.vocab, (REQUESTS, PROMPT)).astype(np.int32)
    pt = torch.as_tensor(prompts, device=dev)
    eng = LockstepEngine(arch, None, PROMPT + GEN, policy, params=prepped,
                         device=dev)
    eng.prefill(pt)                               # warm-up
    torch.cuda.synchronize()
    reset_counts()
    res = {}
    with recorded_calls() as pre_calls:
        t0 = time.perf_counter()
        logits, cache = eng.prefill(pt)
        torch.cuda.synchronize()
        res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    n_chunks = PROMPT // min(mcfg.kv_chunk, PROMPT)
    latent = n_chunks * (n_chunks + 1)    # 2 a (query, KV) chunk pair
    res["prefill_launches"] = launches_of(s1_counts())
    check_launches(f"{tag} lockstep prefill", s1_counts(),
                   dsv3_launches(mcfg, True, latent))
    tok = torch.argmax(logits[:, -1:, :mcfg.vocab], -1)
    reset_counts()
    t0 = time.perf_counter()
    eng.decode(tok, PROMPT, cache)
    torch.cuda.synchronize()
    res["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
    res["decode_launches"] = launches_of(s1_counts())
    check_launches(f"{tag} lockstep decode", s1_counts(),
                   dsv3_launches(mcfg, True))
    del cache
    t0 = time.perf_counter()
    toks = eng.generate(prompts, GEN)
    res["generate_s"] = time.perf_counter() - t0
    res["tok_per_s"] = REQUESTS * GEN / res["generate_s"]
    if (toks.shape != (REQUESTS, GEN) or not torch.isfinite(logits).all()
            or ((toks < 0) | (toks >= mcfg.vocab)).any()):
        raise AssertionError(f"{tag}: malformed lockstep output")
    log(f"{tag} lockstep {DSV3_SPEC} (head prepared): {REQUESTS} x {PROMPT} "
        f"prompts, {GEN} new: prefill {res['prefill_ms']:.1f} ms (launches "
        f"{res['prefill_launches']}, {latent} mla_latent a layer), decode "
        f"step {res['decode_step_ms']:.1f} ms (launches "
        f"{res['decode_launches']}), generate {res['generate_s']:.3f} s "
        f"({res['tok_per_s']:.2f} tok/s)")
    return res, pre_calls


def dsv3_step(mcfg, params, policy, inputs):
    """A mixed step's logits and the latent views it wrote (float32 on the
    host), on a copy of the inputs' cache."""
    tokens, start, n_new, cache = inputs
    views = tree_map(torch.clone, cache)
    with torch.inference_mode():
        logits, views = M.forward_step(params, mcfg, tokens, start, n_new,
                                       views, policy)
    return [logits.float().cpu()] + [
        v.float().cpu() for v in views["layers"]["b0"].values()]


def dsv3_prefill(mcfg, params, policy, prompts):
    """A lockstep prefill's last logits and latent cache (float32 on the
    host)."""
    with torch.inference_mode():
        logits, cache = M.forward_prefill(params, mcfg, {"tokens": prompts},
                                          prompts.shape[1], policy)
    return [logits.float().cpu()] + [
        v.float().cpu() for v in cache["layers"]["b0"].values()]


def dsv3_check_phase(dev, view_tokens):
    """The reduced config (DSV3_CHECK_LAYERS layer, DSV3_CHECK_EXPERTS
    experts, every other width published): a mixed step and a lockstep
    prefill in float32 native on the card against the CPU port on the
    same weights, logits within ZOO_CPU_TOL x max|logits|; in bf16 under
    DSV3_SPEC (the head prepared) on the 'cuda' and 'torch' backends,
    logits and latent caches bit for bit."""
    mcfg = dsv3_arch(DSV3_CHECK_LAYERS, DSV3_CHECK_EXPERTS).model
    tag = f"[{DSV3} {DSV3_CHECK_LAYERS}L {DSV3_CHECK_EXPERTS}E]"
    prompts = torch.as_tensor(np.random.default_rng(29).integers(
        0, mcfg.vocab, (REQUESTS, PROMPT)).astype(np.int32), device=dev)
    f32 = dataclasses.replace(mcfg, dtype="float32")
    params = M.init_params(f32, 0, dev)
    native = GemmPolicy(default=api.precision("native"))
    step_in = mixed_step_inputs(dev, f32, view_tokens)
    card = (dsv3_step(f32, params, native, step_in)[:1]
            + dsv3_prefill(f32, params, native, prompts[:2])[:1])
    cpu = torch.device("cpu")
    cpu_params = tree_map(lambda x: x.cpu(), params)
    del params
    host = (dsv3_step(f32, cpu_params, native,
                      [tree_map(lambda x: x.cpu(), x) for x in step_in])[:1]
            + dsv3_prefill(f32, cpu_params, native, prompts[:2].to(cpu))[:1])
    del cpu_params
    err = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(card, host))
    if err > ZOO_CPU_TOL or not all(torch.isfinite(a).all() for a in card):
        raise AssertionError(f"{tag}: card vs CPU logits {err:.3g} of "
                             f"max|logits| > {ZOO_CPU_TOL}")
    params = M.init_params(mcfg, 0, dev)
    policy = GemmPolicy(default=api.precision(DSV3_SPEC))
    step_in = mixed_step_inputs(dev, mcfg, view_tokens)
    outs = {}
    for backend in ("cuda", "torch"):
        pol = on_backend(policy, backend)
        prepped = prepared.prepare_params(params, pol)
        outs[backend] = (dsv3_step(mcfg, prepped, pol, step_in)
                         + dsv3_prefill(mcfg, prepped, pol, prompts))
        del prepped
    for a, b in zip(outs["cuda"], outs["torch"]):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: cuda and torch backends differ")
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} full width: float32 native card vs CPU logits (a mixed "
        f"step, a prefill of 2 x {PROMPT}) within {err:.3g} of max|logits| "
        f"(bar {ZOO_CPU_TOL}); {DSV3_SPEC} bf16: a mixed step and a "
        f"{REQUESTS} x {PROMPT} lockstep prefill, logits and latent caches "
        f"cuda == torch bit for bit")
    return {"card_vs_cpu_rel_err": err}


def dsv3_train_phase(dev):
    """DSV3_CHECK_LAYERS layer and the MTP block at the reduced config's
    widths under DSV3_SPEC, Adafactor and the config's 16 microbatches
    (its dense weights prepared once a step): a warm-up and
    DSV3_TRAIN_STEPS timed steps of DSV3_TRAIN_BATCH x DSV3_TRAIN_SEQ
    tokens; under strict deterministic algorithms the loss (its MTP term
    included) and every gradient leaf of one microbatch with the step's
    preps on 'cuda' and 'torch' bit for bit (each backend's gradients
    kept on the host: the plain versions' float64 products of the head
    need the room); Adafactor on the card against the CPU on
    DSV3_ADAFACTOR_LEAVES of those gradients."""
    from repro_torch import optim
    arch = dsv3_arch(DSV3_CHECK_LAYERS, DSV3_CHECK_EXPERTS, mtp=True)
    tag = f"[train {DSV3} {DSV3_CHECK_LAYERS}L {DSV3_CHECK_EXPERTS}E + MTP]"
    policy = GemmPolicy(default=api.precision(DSV3_SPEC))
    step = S.make_train_step(arch, policy=policy)
    run = {"state": S.init_state(arch, 0, dev)}
    n_params = M.param_count(run["state"]["params"])
    batches = train_batches(arch, DSV3_TRAIN_BATCH, DSV3_TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, warm = run_steps(step, run, batches, 1)
    timed, walls = run_steps(step, run, batches, DSV3_TRAIN_STEPS)
    launches = launches_of(s1_counts())
    if (s1_counts().plain_cuda_calls or not all(launches.values())
            or not all(math.isfinite(x) for x in losses + timed)):
        raise AssertionError(f"{tag}: launches {launches}, losses "
                             f"{losses + timed}")
    tokens = DSV3_TRAIN_BATCH * DSV3_TRAIN_SEQ
    res = {"params_b": n_params / 1e9, "losses": losses + timed,
           "warmup_wall_s": warm[0], "step_wall_s": walls,
           "tokens_per_s": DSV3_TRAIN_STEPS * tokens / sum(walls),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "launches_in_warmup_and_timed_steps": launches,
           "opt_step": int(run["state"]["opt"]["step"])}
    log(f"{tag} {arch.train.microbatches} microbatches, "
        f"{arch.train.optimizer}: {json.dumps(res)}")
    params = run["state"]["params"]
    del run, step
    gc.collect()
    torch.cuda.empty_cache()
    _, batch = next(train_batches(arch, DSV3_TRAIN_BATCH, DSV3_TRAIN_SEQ))
    mb = S.split_batch(S.batch_to(batch, dev), arch.train.microbatches)[0]
    torch.use_deterministic_algorithms(True)
    try:
        def grads(backend):
            pol = on_backend(policy, backend)
            loss, g = S.value_and_grad(S.make_loss_fn(arch, pol), params, mb,
                                       prepared.build_step_preps(params, pol))
            return loss.cpu(), tree_map(lambda x: x.cpu(), g)

        got = grads("cuda")
        grads_equal(f"({DSV3} {DSV3_CHECK_LAYERS}L {DSV3_CHECK_EXPERTS}E + "
                    f"MTP, a microbatch of {DSV3_TRAIN_SEQ} tokens with the "
                    "step's preps) cuda == torch backend", got,
                    grads("torch"))
    finally:
        torch.use_deterministic_algorithms(False)
    flat_g = tree_flatten(got[1])
    if not flat_g["mtp/proj"].abs().sum() > 0:
        raise AssertionError(f"{tag}: no gradient reaches the MTP block")
    flat_p = tree_flatten(params)
    sub_p = {k: flat_p[k].float() for k in DSV3_ADAFACTOR_LEAVES}
    sub_g = {k: flat_g[k] for k in DSV3_ADAFACTOR_LEAVES}
    del got, flat_g, params, flat_p
    gc.collect()
    torch.cuda.empty_cache()
    outs = []
    for device in (dev, torch.device("cpu")):
        p = {k: v.to(device) for k, v in sub_p.items()}
        g = {k: v.to(device) for k, v in sub_g.items()}
        state = dict(optim.adafactor_init(p), step=torch.tensor(
            10, dtype=torch.int32, device=device))
        new, state = optim.adafactor_update(g, state, p, DSV3_ADAFACTOR_LR)
        outs.append(tree_map(lambda x: x.cpu(), {"params": new, **state}))
    card, host = (tree_flatten(o) for o in outs)
    err = 0.0
    for key, want in host.items():
        if want.dtype == torch.int32:
            if not torch.equal(card[key], want):
                raise AssertionError(f"{tag}: Adafactor {key} differs")
            continue
        err = max(err, ((card[key] - want).abs().max()
                        / want.abs().max().clamp(min=1e-30)).item())
    if err > 1e-6:
        raise AssertionError(f"{tag}: Adafactor on the card vs the CPU "
                             f"{err:.3g} > 1e-6 of max|leaf|")
    res["adafactor_card_vs_cpu_rel_err"] = err
    log(f"{tag} Adafactor on the card vs the CPU on "
        f"{len(DSV3_ADAFACTOR_LEAVES)} leaves (ranks 1-4): parameters and "
        f"vr / vc within {err:.3g} of max|leaf|")
    return res


def dsv3_phase(dev, view_tokens):
    """Phase 29 (first, before any profiler session): the served
    model drawn on the card, served, run in lockstep and freed; its
    kernels at its shapes; the reduced config's checks and training."""
    t_phase = time.perf_counter()
    arch = dsv3_arch(DSV3_LAYERS)
    mcfg = arch.model
    t0 = time.perf_counter()
    params = M.init_params(mcfg, 0, dev)
    torch.cuda.synchronize()
    report = {"init_s": time.perf_counter() - t0,
              "params_b": M.param_count(params) / 1e9,
              "weights_gib": torch.cuda.memory_allocated() / 2 ** 30}
    log(f"[{DSV3}] published widths, {mcfg.n_layers} of 61 layers, no MTP "
        f"block (d {mcfg.d_model}, {mcfg.n_heads} MLA heads, q_lora "
        f"{mcfg.mla.q_lora_rank}, kv_lora {mcfg.mla.kv_lora_rank}, "
        f"{mcfg.moe.n_experts} routed experts of {mcfg.moe.d_ff_expert} "
        f"top-{mcfg.moe.top_k} by sigmoid, 1 shared, vocab {mcfg.vocab} "
        f"padded to {pad_vocab(mcfg.vocab)}, bf16): {report['params_b']:.3f} "
        f"B parameters ({report['weights_gib']:.2f} GiB) drawn on the card "
        f"in {report['init_s']:.1f} s")
    prepped, report["serve"], calls = dsv3_serve(dev, arch, params,
                                                 view_tokens)
    report["lockstep"], calls["prefill"] = dsv3_lockstep(dev, arch, prepped)
    del params, prepped
    gc.collect()
    torch.cuda.empty_cache()
    max_err = {"k1": 0.0, "k3": 0.0, "k4": 0.0}
    t0 = time.perf_counter()
    report["kernels"] = zoo_kernel_times(dev, f"[{DSV3}]", calls, max_err,
                                         plain_iters=0)
    report["kernels_s"] = time.perf_counter() - t0
    report["max_abs_err"] = max_err
    log(f"[{DSV3}] kernels a step at its shapes: "
        + json.dumps(report["kernels"]))
    report["check"] = dsv3_check_phase(dev, view_tokens)
    report["train"] = dsv3_train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[{DSV3}] summary " + json.dumps(
        {k: v for k, v in report.items() if k != "kernels"}))
    return report


# ---------------------------------------------------------------------------
# Phase 25: Scheme I in float64, at p = 9..16 and with float16 (the
# float64 / complex128 / float16 instances of the encode, the plane GEMM,
# the batched kernel and the decompositions).
# ---------------------------------------------------------------------------

S1W_F64_P = (8, 12, 16)
S1W_CASES = (("f32", torch.float32, 12), ("bf16", torch.bfloat16, 10),
             ("f16", torch.float16, 4))
S1W_BATCHED = (8, 512, 512)
S1W_BATCHED_P = (8, 16)
S1W_LIB_P = 12                    # the library path and the prepared weight


def s1w_route_bound(m, k, n, p, in_bytes, products=1):
    """The issue's route bound: p(p+1)/2 int8 GEMMs a real product at the
    int8 peak, plus the encodes' bytes (each operand read once, its p
    planes written once) at the HBM rate, in series."""
    ops_ = products * p * (p + 1) // 2 * 2 * m * n * k
    enc = products * (in_bytes * (m * k + k * n)
                      + p * ozaki1.plane_k(k) * (m + n))
    return 1e3 * (ops_ / INT8_OPS_PER_S + enc / HBM_BYTES_PER_S)


def s1w_equal(what, out, ref, max_err, key, tag="[scheme1 wide]"):
    """Bit for bit, NaN where NaN (a float16 shift-reduce makes inf - inf,
    a float16 Scheme-II output inf / inf); records 0 in max_err[key] or
    raises."""
    o = torch.view_as_real(out) if out.is_complex() else out
    r = torch.view_as_real(ref) if ref.is_complex() else ref
    nan = r.isnan()
    if (o.dtype != r.dtype or not torch.equal(o.isnan(), nan)
            or not torch.equal(o.masked_fill(nan, 0), r.masked_fill(nan, 0))):
        diff = (o.double() - r.double()).abs().nan_to_num(float("inf"))
        raise AssertionError(f"{tag} {what}: the kernel differs from "
                             f"its plain version (max |diff| "
                             f"{diff.max().item():.3e})")
    max_err.setdefault(key, 0.0)


def s1w_split(a, b, mu, nu, p, beta, out_dtype, iters=3):
    """EmuGEMM-I's 2-D route timed apart: the two encodes, the plane GEMM,
    its mainloop alone, ms."""
    bt, nut = b.T, nu.T

    def enc():
        return (ozaki1.encode_planes(a, mu, p, beta),
                ozaki1.encode_planes(bt, nut, p, beta))
    enc_ms = time_ms(enc, iters)
    pa, pb = enc()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                      device=a.device)
    planes_ms = time_ms(lambda: ozaki1.launch_planes(
        pa, pb, mu, nu, p, beta, out), iters)
    main_ms = time_ms(lambda: ozaki1.launch_planes(
        pa, pb, mu, nu, p, beta, out, epilogue=False), iters)
    return {"encode_ms": enc_ms, "planes_ms": planes_ms,
            "mainloop_ms": main_ms,
            "mainloop_tops": p * (p + 1) // 2 * 2 * a.shape[0] * b.shape[1]
            * a.shape[1] / main_ms / 1e9}


def s1w_counts_of(c) -> dict:
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if getattr(c, f.name)}


def s1w_main_path(what, fn, want, dec_want=None):
    """One segment of phase 25's main path: every count set to 0 just
    before, read just after, and held to ``want`` (EmuGEMM-I) and
    ``dec_want`` (the decompositions); no plain version on CUDA."""
    ozaki1.COUNTS.reset()
    decompose.COUNTS.reset()
    out = fn()
    torch.cuda.synchronize()
    got, dec = s1w_counts_of(ozaki1.COUNTS), s1w_counts_of(decompose.COUNTS)
    if got != want or dec != (dec_want or {}):
        raise AssertionError(f"[scheme1 wide] {what}: launches {got} "
                             f"{dec}, expected {want} {dec_want or {}}")
    log(f"[scheme1 wide] main path {what}: launches {got} {dec}")
    return out, got, dec


def scheme1_wide_phase(dev, mcfg, shared, sci_t):
    """Phase 25: each new Scheme-I instance against its plain version bit
    for bit on the card, timed beside its bound and cuBLAS, then driven
    through the front doors with its launches counted. ``shared`` holds
    phase 15's 4096^3 DGEMM and ZGEMM operands, its sampled rows and
    their longdouble products, and ``sci_t`` its timings (cuBLAS and
    Scheme II at m = 16 on the same operands, with their bits). Returns
    the rows of the kernels line."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(25)
    f64, c128 = torch.float64, torch.complex128
    max_err: dict = {}
    rows = []
    common = {"route": "cuda"}
    a, b, samples, ref_rows = shared["dgemm"]
    n = a.shape[0]
    s2 = sci_t["dgemm", n, 16]
    lib_ms, bits_cublas = s2["library_ms"], s2["library_bits"]
    s2_ms, bits_s2 = s2["ms"], s2["bits"]
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    beta = api.precision("ozaki1-p8").resolved_beta(n)
    by_p = {}
    for p in S1W_F64_P:
        out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, beta, f64)
        plain_ms, ref = timed(lambda: ozaki1.fused_matmul_plain(
            a, b, mu, nu, p, beta, f64))
        s1w_equal(f"DGEMM {n}^3 p={p}", out, ref, max_err, "f64")
        del ref
        ms = time_ms(lambda: ozaki1.fused_matmul_scheme1(
            a, b, mu, nu, p, beta, f64), 3)
        bms, by = bound_ms(1, n, n, n, p, 8, 8)
        split = s1w_split(a, b, mu, nu, p, beta, f64)
        enc_bms, _ = s1_encode_bound(n, n, p, 8)
        by_p[p] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "route_bound_ms": s1w_route_bound(
                       n, n, n, p, 8), **split,
                   "encode_bound_ms": 2 * enc_bms,
                   "bits": effective_bits(out[samples], ref_rows)}
        if p == S1W_F64_P[-1]:
            enc_plain_ms = timed(lambda: (
                ozaki1.encode_planes_plain(a, mu, p, beta),
                ozaki1.encode_planes_plain(b.T, nu.T, p, beta)))[0]
            by_p[p]["encode_plain_ms"] = enc_plain_ms
        log(f"[scheme1 wide] DGEMM {n}^3 ozaki1-p{p}: route {ms:.3f} ms "
            f"(encodes {split['encode_ms']:.3f}, plane GEMM "
            f"{split['planes_ms']:.3f}, mainloop {split['mainloop_ms']:.3f}"
            f" at {split['mainloop_tops']:.1f} int8 TOPS), bound "
            f"{bms:.3f} ms ({by}), route bound "
            f"{by_p[p]['route_bound_ms']:.3f} ms, plain {plain_ms:.1f} ms, "
            f"cuBLAS DGEMM {lib_ms:.3f} ms; effective bits "
            f"{by_p[p]['bits']:.2f} (cuBLAS {bits_cublas:.2f}, "
            f"ozaki2-m16 {bits_s2:.2f} in {s2_ms:.3f} ms, phase 15)")
        del out
    top = by_p[S1W_F64_P[-1]]
    dgemm_extra = {"library_ms": lib_ms, "library_bits": bits_cublas,
                   "scheme2_m16_ms": s2_ms, "scheme2_m16_bits": bits_s2}
    # float32 at p = 12, bf16 at p = 10, float16 under ozaki1-p4 at the
    # same shape (float16 operands widen to float32; its output rounds
    # every op in float16, so |C_s| >= 65520 is inf, as in the
    # reference).
    narrow = {}
    for tag, dt, p in S1W_CASES:
        x, y = a.to(dt), b.to(dt)
        xw, yw = (x.float(), y.float()) if dt == torch.float16 else (x, y)
        xmu, ynu = scheme1.pow2_scale(xw, -1), scheme1.pow2_scale(yw, -2)
        out = ozaki1.fused_matmul_scheme1(xw, yw, xmu, ynu, p, beta, dt)
        plain_ms, ref = timed(lambda: ozaki1.fused_matmul_plain(
            xw, yw, xmu, ynu, p, beta, dt))
        s1w_equal(f"{tag} {n}^3 p={p}", out, ref, max_err, tag)
        finite = float(out.isfinite().float().mean())
        del ref, out
        ms = time_ms(lambda: ozaki1.fused_matmul_scheme1(
            xw, yw, xmu, ynu, p, beta, dt), 3)
        in_b, out_b = x.element_size(), x.element_size()
        bms, by = bound_ms(1, n, n, n, p, in_b, out_b)
        split = s1w_split(xw, yw, xmu, ynu, p, beta, dt)
        lib = time_ms(lambda: x @ y, 5)
        narrow[tag] = {"p": p, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bms, "bound_by": by,
                       "route_bound_ms": s1w_route_bound(
                           n, n, n, p, xw.element_size()),
                       "library_ms": lib, "finite_share": finite, **split}
        log(f"[scheme1 wide] {tag} {n}^3 ozaki1-p{p}: route {ms:.3f} ms "
            f"(encodes {split['encode_ms']:.3f}, plane GEMM "
            f"{split['planes_ms']:.3f}), bound {bms:.3f} ms ({by}), "
            f"plain {plain_ms:.1f} ms, torch.matmul {lib:.3f} ms; finite "
            f"outputs {finite:.4f}")
        del x, y, xw, yw
    # ZGEMM: complex128 under ozaki1-p8, 4M of float64 parts.
    del a, b, mu, nu
    za, zb, zsamples, zref_rows = shared["zgemm"]
    zs2 = sci_t["zgemm", n, 16]
    zout = api.einsum("mk,kn->mn", za, zb, precision="ozaki1-p8")
    zplain_ms, zref = timed(lambda: api.einsum(
        "mk,kn->mn", za, zb, precision="ozaki1-p8", backend="torch"))
    s1w_equal(f"ZGEMM {n}^3 ozaki1-p8", zout, zref, max_err, "c128")
    del zref
    zms = time_ms(lambda: api.einsum("mk,kn->mn", za, zb,
                                     precision="ozaki1-p8"), 3)
    zbits = {"bits": effective_bits(zout[zsamples], zref_rows),
             "library_bits": zs2["library_bits"],
             "scheme2_m16_bits": zs2["bits"]}
    zt_b = 16 * 3 * n * n / HBM_BYTES_PER_S
    zt_o = 4 * 36 * 2 * n ** 3 / INT8_OPS_PER_S
    zb_ms = 1e3 * max(zt_b, zt_o)
    zrow = {"ms": zms, "plain_ms": zplain_ms, "bound_ms": zb_ms,
            "bound_by": "bytes" if zt_b >= zt_o else "operations",
            "library_ms": zs2["library_ms"],
            "route_bound_ms": s1w_route_bound(n, n, n, 8, 8, products=4),
            "scheme2_m16_ms": zs2["ms"], **zbits}
    log(f"[scheme1 wide] ZGEMM {n}^3 ozaki1-p8 (4M): {zms:.3f} ms, bound "
        f"{zb_ms:.3f} ms, route bound {zrow['route_bound_ms']:.3f} ms, "
        f"plain {zplain_ms:.1f} ms, cuBLAS ZGEMM {zrow['library_ms']:.3f} "
        f"ms; effective bits {zbits['bits']:.2f} (cuBLAS "
        f"{zbits['library_bits']:.2f}, ozaki2-m16 3M "
        f"{zbits['scheme2_m16_bits']:.2f} in {zs2['ms']:.3f} ms, phase "
        "15)")
    del za, zb, zout
    torch.cuda.empty_cache()

    # K4: a float64 batch of 8 x 512^3 at p = 8 (32-row tiles, two
    # buffers) and p = 16 (16-row tiles, one buffer).
    bt, m, k = S1W_BATCHED
    ba, bb = eq19(gen, (bt, m, k), f64, dev), eq19(gen, (bt, k, m), f64, dev)
    bmu, bnu = scheme1.pow2_scale(ba, -1), scheme1.pow2_scale(bb, -2)
    bbeta = api.precision("ozaki1-p8").resolved_beta(k)
    batched = {}
    blib = time_ms(lambda: torch.bmm(ba, bb), 5)
    for p in S1W_BATCHED_P:
        out = ozaki1.fused_matmul_scheme1(ba, bb, bmu, bnu, p, bbeta, f64)
        plain_ms, ref = timed(lambda: ozaki1.fused_matmul_plain(
            ba, bb, bmu, bnu, p, bbeta, f64))
        s1w_equal(f"batched {S1W_BATCHED} p={p}", out, ref, max_err,
                  "batched")
        ms = time_ms(lambda: ozaki1.fused_matmul_scheme1(
            ba, bb, bmu, bnu, p, bbeta, f64), 5)
        bms, by = bound_ms(bt, m, k, m, p, 8, 8)
        batched[p] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                      "bound_by": by, "tile_n": ozaki1.batched_tile_n(m, p)}
        log(f"[scheme1 wide] batched float64 {S1W_BATCHED} ozaki1-p{p}: "
            f"{ms:.3f} ms (tile {batched[p]['tile_n']} rows of C), bound "
            f"{bms:.3f} ms ({by}), plain {plain_ms:.1f} ms, cuBLAS batched "
            f"DGEMM {blib:.3f} ms")
        del out, ref

    # The library path K11 -> K2 -> K8 and a prepared float64 weight (K3,
    # twin included) at olmo-1b's dense shapes, p = 12.
    p = S1W_LIB_P
    lib = {key: dict.fromkeys(("ms", "plain_ms", "bound_ms"), 0.0)
           for key in ("lhs", "pair", "rhs", "k8", "mixed")}
    for (m, k, nn) in dense_shapes(mcfg):
        x, w = eq19(gen, (m, k), f64, dev), eq19(gen, (k, nn), f64, dev)
        xmu, wnu = scheme1.pow2_scale(x, 1), scheme1.pow2_scale(w, 0)
        wtau = scheme1.pow2_scale(w, 1).T
        beta_f = api.precision(f"ozaki1-p{p}").resolved_beta(k)
        beta_b = api.precision(f"ozaki1-p{p}").resolved_beta(nn)
        a_hat = decompose.decompose_interleave(x, xmu, p, beta_f)
        s1w_equal(f"K11 {(m, k)}", a_hat, decompose.decompose_lhs_plain(
            x, xmu, p, beta_f), max_err, "lhs")
        fwd, twin = decompose.decompose_interleave_pair(w, wnu, wtau, p,
                                                        beta_f, beta_b)
        rf, rt = decompose.decompose_pair_plain(w, wnu, wtau, p, beta_f,
                                                beta_b)
        s1w_equal(f"K2 {(k, nn)}", fwd, rf, max_err, "pair")
        s1w_equal(f"K2 twin {(k, nn)}", twin, rt, max_err, "pair")
        s1w_equal(f"K2r {(k, nn)}", decompose.decompose_interleave_rhs(
            w, wnu, p, beta_f), rf, max_err, "rhs")
        out = ozaki1.fused_matmul_interleaved(a_hat, fwd, xmu, wnu, p,
                                              beta_f, f64)
        s1w_equal(f"K8 {(m, k, nn)}", out, ozaki1.fused_matmul_interleaved_plain(
            a_hat, fwd, xmu, wnu, p, beta_f, f64), max_err, "k8")
        s1w_equal(f"K8 == K1 {(m, k, nn)}", out, ozaki1.fused_matmul_scheme1(
            x, w, xmu, wnu, p, beta_f, f64), max_err, "k8")
        prep = prepared.prepare_rhs(w, api.precision(f"ozaki1-p{p}"),
                                    with_twin=True)
        out3 = prepared.matmul_prepared(x, prep, f64)
        s1w_equal(f"K3 {(m, k, nn)}", out3, out, max_err, "mixed")
        g = eq19(gen, (m, nn), f64, dev)
        s1w_equal(f"K3 twin {(m, nn, k)}", prepared.matmul_prepared(
            g, prep.twin, f64), api.einsum("mk,kn->mn", g, w.T,
                                           precision=f"ozaki1-p{p}"),
            max_err, "mixed")
        for key, run, plain, (bms, _) in (
                ("lhs", lambda: decompose.decompose_interleave(
                    x, xmu, p, beta_f),
                 lambda: decompose.decompose_lhs_plain(x, xmu, p, beta_f),
                 lhs_bound(m, k, p, 8)),
                ("pair", lambda: decompose.decompose_interleave_pair(
                    w, wnu, wtau, p, beta_f, beta_b),
                 lambda: decompose.decompose_pair_plain(
                     w, wnu, wtau, p, beta_f, beta_b), pair_bound(k, nn, p, 8)),
                ("rhs", lambda: decompose.decompose_interleave_rhs(
                    w, wnu, p, beta_f),
                 lambda: decompose.decompose_rhs_plain(w, wnu, p, beta_f),
                 rhs_bound(k, nn, p, 8)),
                ("k8", lambda: ozaki1.fused_matmul_interleaved(
                    a_hat, fwd, xmu, wnu, p, beta_f, f64),
                 lambda: ozaki1.fused_matmul_interleaved_plain(
                     a_hat, fwd, xmu, wnu, p, beta_f, f64),
                 bound_ms(1, m, k, nn, p, p, 8)),
                ("mixed", lambda: prepared.matmul_prepared(x, prep, f64),
                 lambda: ozaki1.fused_matmul_plain(x, w, xmu, wnu, p, beta_f,
                                                   f64),
                 mixed_bound(m, k, nn, p, 8, 8))):
            lib[key]["ms"] += time_ms(run, 3)
            lib[key]["plain_ms"] += timed(plain)[0]
            lib[key]["bound_ms"] += bms
        del x, w, a_hat, fwd, twin, rf, rt, out, out3, prep, g
    for key, t in lib.items():
        t["bound_by"] = ("bytes" if key in ("lhs", "pair", "rhs") else
                         bound_ms(1, *dense_shapes(mcfg)[0], p, p, 8)[1])
        log(f"[scheme1 wide] {key} float64 p={p} at olmo-1b's dense shapes "
            f"(summed): {t['ms']:.3f} ms, bound {t['bound_ms']:.3f} ms, "
            f"plain {t['plain_ms']:.1f} ms")
    torch.cuda.empty_cache()

    # The main path: the front doors, segment by segment, counts read
    # around each.
    def operands(shape_a, shape_b, dt):
        x, y = eq19(gen, shape_a, f64, dev), eq19(gen, shape_b, f64, dev)
        return x.to(dt), y.to(dt)

    two_d = {"launches_2d": 1, "launches_encode": 2, "launches_planes": 1}
    launches = {}
    x, y = operands((n, n), (n, n), f64)
    for p in S1W_F64_P:
        _, launches[f"f64_p{p}"], _ = s1w_main_path(
            f"einsum float64 ozaki1-p{p}", lambda: api.einsum(
                "mk,kn->mn", x, y, precision=f"ozaki1-p{p}"), two_d)
    for tag, dt, p in S1W_CASES:
        xd, yd = x.to(dt), y.to(dt)
        _, launches[tag], _ = s1w_main_path(
            f"einsum {tag} ozaki1-p{p}", lambda: api.einsum(
                "mk,kn->mn", xd, yd, precision=f"ozaki1-p{p}"), two_d)
    del x, y, xd, yd
    z, zz = operands((1024, 1024), (1024, 1024), c128)
    _, launches["c128"], _ = s1w_main_path(
        "einsum complex128 ozaki1-p8 (4M)", lambda: api.einsum(
            "mk,kn->mn", z, zz, precision="ozaki1-p8"),
        {k: 4 * v for k, v in two_d.items()})
    del z, zz
    for p in S1W_BATCHED_P:
        _, launches[f"batched_p{p}"], _ = s1w_main_path(
            f"einsum float64 batch {S1W_BATCHED} ozaki1-p{p}",
            lambda: api.einsum("bmk,bkn->bmn", ba, bb,
                               precision=f"ozaki1-p{p}"),
            {"launches_batched": 1})
    del ba, bb
    p = S1W_LIB_P
    m, k, nn = dense_shapes(mcfg)[0]
    x, w = operands((m, k), (k, nn), f64)
    g = eq19(gen, (m, nn), f64, dev)
    cfg = api.precision(f"ozaki1-p{p}+cached")

    def library_route():
        xmu, wnu = scheme1.pow2_scale(x, 1), scheme1.pow2_scale(w, 0)
        beta_f, beta_b = cfg.resolved_beta(k), cfg.resolved_beta(nn)
        fwd, _ = decompose.decompose_interleave_pair(
            w, wnu, scheme1.pow2_scale(w, 1).T, p, beta_f, beta_b)
        return ozaki1.fused_matmul_interleaved(
            decompose.decompose_interleave(x, xmu, p, beta_f), fwd, xmu, wnu,
            p, beta_f, f64)

    k8_launches = {"launches_interleaved": 1, "launches_relayout": 2,
                   "launches_planes": 1}
    _, launches["library"], launches["library_dec"] = s1w_main_path(
        f"K11 -> K2 -> K8 float64 p={p}", library_route, k8_launches,
        {"launches_lhs": 1, "launches_pair": 1})

    def library_rhs_route():
        xmu, wnu = scheme1.pow2_scale(x, 1), scheme1.pow2_scale(w, 0)
        beta_f = cfg.resolved_beta(k)
        return ozaki1.fused_matmul_interleaved(
            decompose.decompose_interleave(x, xmu, p, beta_f),
            decompose.decompose_interleave_rhs(w, wnu, p, beta_f), xmu, wnu,
            p, beta_f, f64)

    _, _, launches["library_rhs_dec"] = s1w_main_path(
        f"K11 -> K2r -> K8 float64 p={p}", library_rhs_route, k8_launches,
        {"launches_lhs": 1, "launches_rhs": 1})

    def prepared_route():
        from repro_torch.core import emulated
        prep = prepared.prepare_rhs(w, cfg, with_twin=True)
        xr = x.clone().requires_grad_()
        out = emulated.emulated_dot_prepared(xr, w, prep, cfg)
        out.backward(g)
        return out

    _, launches["prepared"], _ = s1w_main_path(
        f"prepare_rhs + emulated_dot_prepared float64 p={p} (forward and "
        "dA from the twin)", prepared_route,
        {"launches_mixed": 2, "launches_encode": 4, "launches_planes": 2})
    del x, w, g

    log(f"[scheme1 wide] max_abs_err {json.dumps(max_err)}")
    log(f"[scheme1 wide] phase took {time.perf_counter() - t0:.1f} s")
    lib_per = (f"olmo-1b's dense shapes at {TOKENS} tokens, float64, p = "
               f"{S1W_LIB_P}, summed")
    rows += [
        {"name": "emugemm1_2d_f64", **common, "source": SOURCE_S1_PLANES,
         "replaces": "src/repro/kernels/ozaki1.py:143",
         "also_replaces": "src/repro/kernels/backends/gpu.py:202",
         "launches": launches[f"f64_p{S1W_F64_P[-1]}"]["launches_2d"],
         "max_abs_err": max_err["f64"],
         **{key: top[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "route_bound_ms",
                                      "encode_ms", "planes_ms", "mainloop_ms",
                                      "mainloop_tops", "bits")},
         **dgemm_extra, "by_p": by_p,
         "per": f"one float64 GEMM {n}^3 (paper Eq. 19 inputs) at p = "
                f"{S1W_F64_P[-1]}; by_p: p = {S1W_F64_P}; the route: 2 "
                "encodes + 1 plane GEMM (its float64 tile, (128, 64)); "
                "library: cuBLAS DGEMM; bits against a longdouble product "
                f"of {EVAL_ROWS} rows, beside Scheme II's at m = 16"},
        {"name": "emugemm1_encode_f64", **common, "source": SOURCE_S1_PLANES,
         "replaces": "src/repro/kernels/ozaki1.py:143",
         "launches": launches[f"f64_p{S1W_F64_P[-1]}"]["launches_encode"],
         "max_abs_err": max_err["f64"], "ms": top["encode_ms"],
         "plain_ms": top["encode_plain_ms"],
         "bound_ms": top["encode_bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "per": f"the two encodes of the float64 GEMM {n}^3 at p = "
                f"{S1W_F64_P[-1]} ((8 + p) bytes an element)"}]
    for tag, _, p in S1W_CASES:
        t = narrow[tag]
        rows.append({
            "name": f"emugemm1_2d_{tag}_p{p}", **common,
            "source": SOURCE_S1_PLANES,
            "replaces": "src/repro/kernels/backends/gpu.py:202",
            "launches": launches[tag]["launches_2d"],
            "max_abs_err": max_err[tag],
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "route_bound_ms", "encode_ms",
                                       "planes_ms", "mainloop_ms",
                                       "finite_share")},
            "per": f"one {tag} GEMM {n}^3 (Eq. 19 inputs rounded to {tag}) "
                   f"under ozaki1-p{p}" + (", widened to float32 on entry, "
                                          "output float16" if tag == "f16"
                                          else "") + "; library: "
                   "torch.matmul in the operand type"})
    rows.append({
        "name": "emugemm1_4m_c128", **common, "source": SOURCE_S1_PLANES,
        "replaces": "src/repro/kernels/backends/gpu.py:202",
        "launches": launches["c128"]["launches_2d"],
        "max_abs_err": max_err["c128"], **zrow,
        "per": f"one complex128 GEMM {n}^3 under ozaki1-p8: 4M, four "
               "float64 products on the 2-D route; library: cuBLAS ZGEMM; "
               f"bits against a longdouble product of {EVAL_ROWS} rows "
               "(launches: a 1024^3 product on the main path)"})
    top_b = batched[S1W_BATCHED_P[-1]]
    rows.append({
        "name": "emugemm1_batched_f64", **common,
        "source": SOURCE_S1_BATCHED,
        "replaces": "src/repro/kernels/backends/gpu.py:240",
        "launches": sum(launches[f"batched_p{p}"]["launches_batched"]
                        for p in S1W_BATCHED_P),
        "max_abs_err": max_err["batched"],
        **{key: top_b[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")},
        "library_ms": blib, "by_p": batched,
        "per": f"one float64 batched GEMM {S1W_BATCHED} at p = "
               f"{S1W_BATCHED_P[-1]} (16-row tiles, one shared buffer); "
               f"by_p: p = {S1W_BATCHED_P}; library: cuBLAS batched DGEMM "
               "(torch.bmm)"})
    for key, name, source, replaces, n_launch in (
            ("lhs", "decompose_lhs_f64", DECOMPOSE_SOURCE,
             "src/repro/kernels/decompose.py:42",
             launches["library_dec"]["launches_lhs"]),
            ("pair", "decompose_pair_f64", DECOMPOSE_SOURCE,
             "src/repro/kernels/decompose.py:106",
             launches["library_dec"]["launches_pair"]),
            ("rhs", "decompose_rhs_f64", DECOMPOSE_SOURCE,
             "src/repro/kernels/decompose.py:71",
             launches["library_rhs_dec"]["launches_rhs"]),
            ("k8", "emugemm1_interleaved_f64", SOURCE_S1_PLANES,
             "src/repro/kernels/ozaki1.py:118",
             launches["library"]["launches_interleaved"]),
            ("mixed", "emugemm1_mixed_f64", SOURCE_S1_PLANES,
             "src/repro/kernels/ozaki1.py:170",
             launches["prepared"]["launches_mixed"])):
        rows.append({"name": name, **common, "source": source,
                     "replaces": replaces, "launches": n_launch,
                     "max_abs_err": max_err[key], "library_ms": None,
                     **lib[key],
                     "per": lib_per + {
                         "lhs": "", "pair": " (forward and twin)",
                         "rhs": " (the forward layout alone)",
                         "k8": " (2 relayouts + 1 plane GEMM, float64 "
                               "scales)",
                         "mixed": " (an lhs encode + 1 plane GEMM against "
                                  "the prepared planes)"}[key]})
    return rows


BUILD_NAMES = ("emugemm1_batched", "emugemm1_planes", "decompose",
               "emugemm2_planes", "flash_attn")


def start_builds():
    """nvcc for each kernel source, all started together: (the pool,
    {name: future}, the start time)."""
    ex = ThreadPoolExecutor(len(BUILD_NAMES))
    return ex, {n: ex.submit(build.build, n) for n in BUILD_NAMES}, \
        time.perf_counter()


def wait_builds(builds, names):
    """Wait for the named sources' libraries (raising a failed nvcc)."""
    ex, futures, t0 = builds
    for n in names:
        futures[n].result()
    log(f"[build] {', '.join(n + '.cu' for n in names)} built "
        f"{time.perf_counter() - t0:.1f} s after the builds started")


def build_phase():
    """nvcc for each kernel source, all started together, waited for."""
    builds = start_builds()
    wait_builds(builds, BUILD_NAMES)
    builds[0].shutdown()


# ---------------------------------------------------------------------------
# Phase 30: the guard and the telemetry on the card. olmo-1b served at full
# width under GUARD_SPEC with telemetry on, beside the unguarded serve of
# the same process; the ladder at olmo-1b's dense shapes; the Trainer under
# GUARD_TRAIN_SPEC beside the unguarded run. Right after phase 29: its
# walls come before any profiler session.
# ---------------------------------------------------------------------------

GUARD_SPEC = "ozaki1-p4+guard"
GUARD_TRAIN_SPEC = "ozaki1-p4+guard:strict"
GUARD_REQUESTS = REQUESTS // 2     # of phase 3's trace: one wave of 4
GUARD_TRAIN = (2, 2, 128)          # steps, batch, seq
GUARD_ROWS = LANES * CHUNK         # rows of the ladder's operands
GUARD_DTYPE = torch.bfloat16       # the ladder's NaN/Inf and K3 operands


def kernel_launches(*counts):
    """The nonzero kernel launch counts of ``counts`` (a plain version's
    calls on the card are not launches)."""
    return {f: v for c in counts for f, v in vars(c).items()
            if v and f != "plain_cuda_calls"}


def guard_serve(dev, arch, params, spec):
    """Phase 3's trace (its first GUARD_REQUESTS requests) under ``spec``,
    one engine step at a time: tokens, step walls, launches, guard
    counters, host syncs, the telemetry's emulated calls, peak memory,
    and the EmuGEMM-I calls by signature (``recorded_calls``)."""
    from repro_torch import guard, telemetry
    from repro_torch.guard import ladder
    trace = build_trace(np.random.default_rng(0), arch.model.vocab, REQUESTS,
                        PROMPT, GEN, 0.0)[:GUARD_REQUESTS]
    eng = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=GemmPolicy(
        default=api.precision(spec)), params=params, max_lanes=LANES,
        chunk=CHUNK, page_size=PAGE, device=dev)
    for r in trace:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    guard.stats_clear()
    ladder.SYNCS.reset()
    calls0 = telemetry.REGISTRY.total("repro_emulated_calls_total")
    walls = []
    t0 = time.perf_counter()
    with recorded_calls() as calls:
        while eng.sched.has_work():
            t = time.perf_counter()
            if eng.step_once() is None:
                raise AssertionError("an idle step on an all-at-once trace")
            walls.append(time.perf_counter() - t)
    dt = time.perf_counter() - t0
    counts = s1_counts()
    stats = guard.stats()
    results = eng._results
    return {"tokens": [results[r.rid].tokens for r in trace],
            "steps": len(walls), "seconds": dt,
            "tok_per_s": len(trace) * GEN / dt,
            "step_ms": {"mean": 1e3 * float(np.mean(walls)),
                        "p50": 1e3 * float(np.median(walls)),
                        "max": 1e3 * float(np.max(walls))},
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "launches": {"2d": counts.launches_2d,
                         "batched": counts.launches_batched,
                         "mixed": counts.launches_mixed,
                         "plain": counts.plain_cuda_calls},
            "guard": dataclasses.asdict(stats),
            "syncs": ladder.SYNCS.n,
            "telemetry_calls": telemetry.REGISTRY.total(
                "repro_emulated_calls_total") - calls0,
            "calls": calls}


def guard_serve_phase(dev, arch, params):
    """(a) The guarded serve == the unguarded one, bit for bit, with the
    same EmuGEMM-I calls (each signature then held against its plain
    version), every guarded call verified without a trip, the
    telemetry's calls == K1's and K4's launch counts, one JSONL record a
    step."""
    from repro_torch import telemetry
    mcfg = arch.model
    plain = guard_serve(dev, arch, params, SPEC)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_guard_") as tmp:
        sink = os.path.join(tmp, "serve.jsonl")
        with telemetry.recording(sink):
            guarded = guard_serve(dev, arch, params, GUARD_SPEC)
        guarded["records"] = sum(1 for _ in open(sink, encoding="utf-8"))
    g, n = guarded["guard"], guarded["steps"]
    # A step's guarded calls: q, k, v, o, gate, up, down a layer and the
    # tied head (2-D, K1: the eager ladder, 3 host syncs a call), and
    # attn_qk / attn_av, one K4 launch a layer each whose (lane, head)
    # elements are verified and counted one by one (1 sync a call).
    dense = 7 * mcfg.n_layers + 1
    batched = 2 * mcfg.n_layers
    per_elem = batched * LANES * mcfg.n_heads
    per_step = dense + per_elem
    launched = guarded["launches"]["2d"] + guarded["launches"]["batched"]
    log(f"[guard] serve olmo-1b: {GUARD_SPEC} {n} steps, "
        f"{guarded['tok_per_s']:.2f} tok/s, step {guarded['step_ms']} ms, "
        f"{guarded['syncs'] / n:.1f} syncs a step, peak "
        f"{guarded['peak_gib']:.2f} GiB, guard {g}, launches "
        f"{guarded['launches']}, telemetry calls "
        f"{guarded['telemetry_calls']:.0f}, {guarded['records']} records; "
        f"unguarded {plain['steps']} steps, {plain['tok_per_s']:.2f} tok/s, "
        f"step {plain['step_ms']} ms, peak {plain['peak_gib']:.2f} GiB, "
        f"launches {plain['launches']}")
    if guarded["tokens"] != plain["tokens"] or n != plain["steps"]:
        raise AssertionError("the guarded serve's tokens differ from the "
                             "unguarded serve's")
    if not all(len(t) == GEN and all(0 <= x < mcfg.vocab for x in t)
               for t in guarded["tokens"]):
        raise AssertionError("malformed tokens under the guard")
    def shapes(calls):
        # By form, shape and types: the guard's sanitized copies may lay
        # an operand out otherwise than the view the unguarded call read.
        out = {}
        for sig, k in calls.items():
            out[sig[:7]] = out.get(sig[:7], 0) + k
        return out
    if shapes(guarded["calls"]) != shapes(plain["calls"]) or \
            guarded["launches"] != plain["launches"]:
        raise AssertionError("the guarded serve's EmuGEMM-I calls differ "
                             "from the unguarded serve's")
    if g["trips"] or g["escalations"] or g["masked"] or not (
            g["calls"] == g["verified"] == n * per_step
            and guarded["launches"]["2d"] == n * dense
            and guarded["launches"]["batched"] == n * batched):
        raise AssertionError(f"guard counters {g}, launches "
                             f"{guarded['launches']}, expected {n} x "
                             f"{per_step} verified calls on {n} x {dense} "
                             f"K1 and {n} x {batched} K4 launches")
    if guarded["launches"]["plain"] or guarded["launches"]["mixed"]:
        raise AssertionError("a plain version ran on the card, or K3")
    if guarded["telemetry_calls"] != launched:
        raise AssertionError("the telemetry's emulated calls != K1's and "
                             "K4's launch counts")
    if guarded["records"] != n:
        raise AssertionError(f"{guarded['records']} JSONL records for {n} "
                             "steps")
    if guarded["syncs"] != n * (3 * dense + batched):
        raise AssertionError(f"{guarded['syncs']} host syncs: expected 3 a "
                             "dense call and 1 a batched call")
    # Every EmuGEMM-I signature of the guarded serve, on Eq. 19 operands
    # of its shape, type and layout: the kernel against its plain version
    # bit for bit, timed beside its bound.
    max_err = {"k1": 0.0, "k3": 0.0, "k4": 0.0}
    t0 = time.perf_counter()
    kernels = zoo_kernel_times(dev, "[guard]", {"serve": guarded["calls"]},
                               max_err, plain_iters=0)["serve"]
    for rows in kernels.values():
        rows["launches_in_serve"] = rows.pop("launches_per_step")
    log(f"[guard] the guarded serve == the unguarded serve bit for bit, "
        f"with the same EmuGEMM-I calls; {g['calls']} calls == verified == "
        f"{n} x {per_step} on {n} x {dense} K1 and {n} x {batched} K4 "
        f"launches, no trip; telemetry calls == K1 + K4 launches; one "
        f"record a step; its {len(guarded['calls'])} call signatures bit "
        f"for bit against the plain version ({max_err}, "
        f"{time.perf_counter() - t0:.1f} s): " + json.dumps(kernels))
    drop = ("tokens", "calls")
    return {"guarded": {k: v for k, v in guarded.items() if k not in drop},
            "unguarded": {k: v for k, v in plain.items() if k not in drop},
            "calls_per_step": per_step, "kernels": kernels,
            "max_abs_err": max_err}


def guard_ladder_phase(dev, mcfg):
    """(b) The ladder on the card at olmo-1b's dense shapes: NaN/Inf lanes
    through the real K1, a guarded call against a prepared weight (K3),
    injected faults under '+xla' tripping and recovering in one rung bit
    for bit, an exhausted strict ladder raising, and '+guard' falling back
    to the native dot with one warning."""
    import warnings
    from repro_torch import guard
    gen = torch.Generator(device=dev).manual_seed(30)
    bf = GUARD_DTYPE
    report = {"nan_inf": []}
    for _, k, n in dense_shapes(mcfg):
        a = eq19(gen, (GUARD_ROWS, k), torch.float32, dev).to(bf)
        b = eq19(gen, (k, n), torch.float32, dev).to(bf)
        a[3, 5], a[17, 0], b[2, 7] = math.nan, math.inf, -math.inf
        native = torch.matmul(a.float(), b.float())
        reset_counts()
        guard.stats_clear()
        out = dispatch.emulated_matmul(a, b, cfg=GUARD_SPEC)
        launched = s1_counts().launches_2d
        ref = dispatch.emulated_matmul(
            guard.sentinel.sanitize(a), guard.sentinel.sanitize(b), cfg=SPEC)
        torch.cuda.synchronize()
        nan = torch.isnan(out)
        clean = ~nan
        s = guard.stats()
        if not (torch.equal(nan, ~torch.isfinite(native))
                and int(nan.sum()) == 2 * n + GUARD_ROWS - 2
                and torch.equal(out[clean], ref[clean]) and launched == 1
                and (s.calls, s.verified, s.trips, s.masked) == (1, 1, 0, 1)):
            raise AssertionError(f"NaN/Inf masking through K1 at "
                                 f"({GUARD_ROWS}, {k}) @ ({k}, {n}): {s}")
        report["nan_inf"].append([GUARD_ROWS, k, n])
    log(f"[guard] NaN/Inf rows and columns through K1 at olmo-1b's dense "
        f"shapes: NaN exactly where torch.matmul is non-finite, every other "
        f"entry K1's bits on the sanitized operands ({report['nan_inf']})")

    # A guarded call against a prepared weight: one K3 launch, verified
    # against reconstruct().
    _, k, n = dense_shapes(mcfg)[0]
    a = eq19(gen, (GUARD_ROWS, k), torch.float32, dev).to(bf)
    w = eq19(gen, (k, n), torch.float32, dev).to(bf)
    prep = prepared.prepare_rhs(w, api.precision(SPEC))
    reset_counts()
    guard.stats_clear()
    out = dispatch.emulated_matmul(a, prep, cfg=GUARD_SPEC)
    mixed = s1_counts().launches_mixed
    s = guard.stats()
    if not (torch.equal(out, dispatch.emulated_matmul(a, prep, cfg=SPEC))
            and mixed == 1 and (s.calls, s.verified, s.trips) == (1, 1, 0)):
        raise AssertionError(f"the guarded prepared call: {s}, K3 {mixed}")
    report["prepared"] = {"launches_mixed": mixed, "guard":
                          dataclasses.asdict(s)}
    log(f"[guard] a guarded call against a prepared weight: one K3 launch, "
        f"verified against reconstruct(), the unguarded bits ({s})")

    # Injected faults on the reference route ('+xla': the plain version on
    # the card, where the hooks are), integer operands: every config is
    # exact, so recovery is bit-identity with the clean result. At
    # olmo-1b's (64, 2048) @ (2048, 2048) a Scheme-II fault (a wrong
    # residue makes the CRT return garbage) trips. A Scheme-I fault moves
    # A's entries by at most their own size, and the verifier's bound
    # (the reference's: the residual normalised by sums over all of B,
    # against 16 (K + N) eps) does not see it at K + N = 4096: with
    # entries in [-8, 8] and beta = 7 the top slice plane holds all of A,
    # so zeroing it makes C = 0, and the bound passes an all-zero product
    # there (read below). Those cases are pinned to their verdict, no
    # trip and the faulty product returned; the Scheme-I recovery runs at
    # guard.smoke's (64, 96) @ (96, 48), where the faults trip. None of
    # these cases launches a kernel.
    verdicts = []
    real_verify = guard.verify.verify_gemm

    def spy(*args, **kw):
        res = real_verify(*args, **kw)
        verdicts.append((float(res.err), res.tol))
        return res
    rng = np.random.default_rng(30)
    report["inject"] = {}
    s1_trips = 0 if k + n >= 4096 else 1    # olmo-1b's: K + N = 4096
    guard.verify.verify_gemm = spy
    try:
        for shape, scheme, plane, kind, trips in (
                ((GUARD_ROWS, k, n), "ozaki1-p4", 0, "zero_modulus",
                 s1_trips),
                ((GUARD_ROWS, k, n), "ozaki2-m6", 1, "zero_modulus", 1),
                ((GUARD_ROWS, k, n), "ozaki2-m6", 1, "bitflip_slice", 1),
                ((GUARD_ROWS, k, n), "ozaki1-p4", 0, "bitflip_slice",
                 s1_trips),
                ((64, 96, 48), "ozaki1-p4", 0, "bitflip_slice", 1),
                ((64, 96, 48), "ozaki1-p4", 0, "zero_modulus", 1)):
            m_, k_, n_ = shape
            t_case = time.perf_counter()
            ai = torch.as_tensor(rng.integers(-8, 9, (m_, k_)),
                                 dtype=torch.float32, device=dev)
            bi = torch.as_tensor(rng.integers(-8, 9, (k_, n_)),
                                 dtype=torch.float32, device=dev)
            spec = scheme + "+xla+guard"
            clean = dispatch.emulated_matmul(ai, bi, cfg=scheme,
                                             backend="torch")
            guard.stats_clear()
            verdicts.clear()
            reset_counts()
            with guard.inject(kind, count=1, plane=plane) as fault:
                out = dispatch.emulated_matmul(ai, bi, cfg=spec)
            s = guard.stats()
            if not (fault.fired == 1 and (s.trips, s.escalations,
                                          s.recoveries, s.native_fallbacks)
                    == (trips, trips, trips, 0)
                    and torch.equal(out, clean) == bool(trips)
                    and not kernel_launches(ozaki1.COUNTS, ozaki2.COUNTS)):
                raise AssertionError(f"inject {kind} under {spec} at "
                                     f"{shape}: {s}, fired {fault.fired}, "
                                     f"(err, tol) {verdicts}")
            key = f"{scheme} {kind} {m_}x{k_}x{n_}"
            report["inject"][key] = {"guard": dataclasses.asdict(s),
                                     "err_tol": list(verdicts)}
            log(f"[guard] inject {kind} under {spec} at ({m_}, {k_}) @ "
                f"({k_}, {n_}): {'tripped, recovered in one rung' if trips
                                 else 'below the bound: no trip, the '
                                 'faulty product returned'}; (err, "
                f"tol) of each verification {verdicts} "
                f"({time.perf_counter() - t_case:.1f} s)")
    finally:
        guard.verify.verify_gemm = real_verify
    # The verifier's verdict on an all-zero product at each dense shape,
    # on the integer operands above and on Eq. 19 operands.
    report["zero_product"] = {}
    for _, k_, n_ in dense_shapes(mcfg):
        for what, x, y in (
                ("integers", *(torch.as_tensor(rng.integers(-8, 9, sh)).to(
                    device=dev, dtype=torch.float32)
                    for sh in ((GUARD_ROWS, k_), (k_, n_)))),
                ("eq19", eq19(gen, (GUARD_ROWS, k_), torch.float32, dev),
                 eq19(gen, (k_, n_), torch.float32, dev))):
            v = guard.verify.verify_gemm(
                x, y, torch.zeros(GUARD_ROWS, n_, device=dev), SPEC)
            report["zero_product"][f"{what} {GUARD_ROWS}x{k_}x{n_}"] = {
                "passes": bool(v.ok), "err": float(v.err), "tol": v.tol}
    log("[guard] the verifier's verdict on an all-zero product: "
        + json.dumps(report["zero_product"]))
    ai = torch.as_tensor(rng.integers(-8, 9, (GUARD_ROWS, k)),
                         dtype=torch.float32, device=dev)
    bi = torch.as_tensor(rng.integers(-8, 9, (k, n)), dtype=torch.float32,
                         device=dev)

    # An exhausted ladder: strict raises, 'on' falls back to native with
    # one warning.
    guard.stats_clear()
    try:
        with guard.inject("zero_modulus", count=99, plane=1):
            dispatch.emulated_matmul(ai, bi, cfg="ozaki2-m6+xla+guard:strict")
    except guard.EmulationAccuracyError:
        pass
    else:
        raise AssertionError("an exhausted strict ladder did not raise")
    strict = guard.stats()
    dispatch.fallback_warnings_clear()
    guard.stats_clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with guard.inject("zero_modulus", count=99, plane=1):
            outs = [dispatch.emulated_matmul(ai, bi, cfg="ozaki2-m6+xla+guard")
                    for _ in range(2)]
    native = [x for x in rec if "native" in str(x.message)]
    s = guard.stats()
    if not (strict.trips == 1 and strict.recoveries == 0
            and len(native) == 1 and s.native_fallbacks == 2
            and all(torch.equal(o, torch.matmul(ai, bi)) for o in outs)):
        raise AssertionError(f"exhausted ladders: strict {strict}, 'on' {s}, "
                             f"{len(native)} warnings")
    report["strict"] = dataclasses.asdict(strict)
    report["native_fallback"] = dataclasses.asdict(s)
    log(f"[guard] an exhausted ladder: +guard:strict raised "
        f"EmulationAccuracyError ({strict}); +guard fell back to the native "
        f"dot twice with one warning ({s})")
    return report


def guard_train_phase(dev, arch):
    """(c) The Trainer on full-width olmo-1b under GUARD_TRAIN_SPEC beside
    the unguarded run: the same losses bit for bit, no trip, one JSONL
    record a step."""
    from repro_torch import telemetry
    steps, batch, seq = GUARD_TRAIN
    shape = ShapeSpec("chip", seq, batch, "train")
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_guard_") as tmp:
            for spec in (SPEC, GUARD_TRAIN_SPEC):
                sink = os.path.join(tmp, f"{spec}.jsonl")
                tr = Trainer(
                    step_fn=S.make_train_step(arch, policy=GemmPolicy(
                        default=api.precision(spec))),
                    init_state_fn=lambda: S.init_state(arch, 0, dev),
                    batch_iterator=make_batch_iterator(arch, shape, seed=0),
                    ckpt_dir=os.path.join(tmp, spec), device=dev,
                    ckpt_every=10 ** 6, metrics_jsonl=sink,
                    tokens_per_step=batch * seq)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    log_ = tr.run(steps)
                finally:
                    tr.close()
                with open(sink, encoding="utf-8") as fh:
                    records = [json.loads(x) for x in fh]
                runs[spec] = {
                    "losses": [r["loss"] for r in log_],
                    "seconds": time.perf_counter() - t0,
                    "step_s": [r["seconds"] for r in log_],
                    "trips": [r["guard_trips"] for r in log_],
                    "guard_calls": [r["guard"].get("calls", 0)
                                    for r in records],
                    "records": len(records), "trip_steps":
                    tr.guard_monitor.trip_steps}
                del tr
    finally:
        torch.use_deterministic_algorithms(False)
        telemetry.disable()
    g, p = runs[GUARD_TRAIN_SPEC], runs[SPEC]
    log(f"[guard] train olmo-1b {steps} steps of {batch} x {seq} tokens: "
        f"{GUARD_TRAIN_SPEC} losses {g['losses']} ({g['step_s']} s a step, "
        f"guard calls {g['guard_calls']} a step, trips {g['trips']}); "
        f"{SPEC} losses {p['losses']} ({p['step_s']} s a step)")
    if g["losses"] != p["losses"] or any(g["trips"]) or g["trip_steps"] \
            or not all(np.isfinite(g["losses"])):
        raise AssertionError("the guarded Trainer's losses differ from the "
                             "unguarded run's, or a step tripped")
    if g["records"] != steps or p["records"] != steps or \
            not all(c > 0 for c in g["guard_calls"]):
        raise AssertionError("not one JSONL record a step, or a step "
                             "without guarded calls")
    log("[guard] the guarded Trainer's losses == the unguarded run's bit "
        "for bit; GuardMonitor: no trip; one record a step")
    return runs


def guard_phase(dev):
    """Phase 30: (a), (b) and (c) above."""
    t_phase = time.perf_counter()
    arch = configs.get_config("olmo-1b")
    params = M.init_params(arch.model, 0, dev)
    report = {"serve": guard_serve_phase(dev, arch, params)}
    del params
    walls = {"serve": time.perf_counter() - t_phase}
    report["ladder"] = guard_ladder_phase(dev, arch.model)
    walls["ladder"] = time.perf_counter() - t_phase - sum(walls.values())
    report["train"] = guard_train_phase(dev, arch)
    walls["train"] = time.perf_counter() - t_phase - sum(walls.values())
    torch.cuda.empty_cache()
    report["walls_s"] = walls
    report["seconds"] = time.perf_counter() - t_phase
    log("[guard] summary " + json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# Phase 31: K10's ragged and wide head dims, utils.perf_probe on olmo-1b's
# train_4k and decode_32k cells, and the four examples/*_torch.py. After
# every wall of phases 20-30: perf_probe's profiles are the process's
# first torch.profiler sessions.
# ---------------------------------------------------------------------------

K10_NEW = (("bfloat16", 72), ("float16", 72), ("float32", 72),
           ("float32", 100), ("bfloat16", 320), ("float32", 320),
           ("bfloat16", 512), ("float32", 512))
K10_NEW_SHAPE = (1, 16, 16, 2048, 2048)       # B, H, KVH, S_q, S_k
PROBE_CELLS = (("train_4k", "ozaki1-p4+cached", 1),
               ("decode_32k", "ozaki1-p4", 4))
PROBE_SHARE_MAX = 1.05
PROBE_COVERAGE_TOL = 0.05
EXAMPLES = (("quickstart_torch", []), ("scientific_dgemm_torch", []),
            ("serve_lm_torch", ["--arch", "olmo-1b"]),
            ("train_emulated_lm_torch", ["--small", "--steps", "20"]))


def k10_new_phase(dev):
    """K10 at the new head dims: the main path (every case once, the
    counts read around it), each case against the plain version within
    ATTN_TOL, then timed beside SDPA and the bound of its type (16-bit:
    the bf16 tensor-core peak; float32: the peak of the kernel's
    arithmetic)."""
    gen = torch.Generator(device=dev).manual_seed(31)
    b, h, kvh, sq, sk = K10_NEW_SHAPE
    inputs = {}
    for dt, d in K10_NEW:
        inputs[dt, d] = attn_inputs(gen, dev, ("", b, h, kvh, sq, sk, d,
                                               True, None, dt))
    cases = [(dt, d, causal) for dt, d in K10_NEW for causal in (True, False)]
    torch.cuda.synchronize()
    flash_attn.COUNTS.reset()
    outs = [flash_attn.flash_attention(*inputs[dt, d], causal=causal)
            for dt, d, causal in cases]
    torch.cuda.synchronize()
    c = flash_attn.LaunchCounts(**vars(flash_attn.COUNTS))
    kernels = [flash_attn.instance(getattr(torch, dt), d).kernel
               for dt, d, _ in cases]
    want = (len(cases), kernels.count("ffma"), kernels.count("wgmma-3xtf32"),
            kernels.count("wgmma-3xtf32"), 0)
    got = (c.launches, c.launches_ffma, c.launches_3xtf32, c.launches_split,
           c.plain_cuda_calls)
    if got != want:
        raise AssertionError(f"[k10 new] launches {got}, expected {want}")
    max_err = dict.fromkeys(ATTN_ERR_KEY.values(), 0.0)
    rows = []
    for (dt, d, causal), out, kernel in zip(cases, outs, kernels):
        q, k, v = inputs[dt, d]
        err = check_close(f"K10 D={d} {dt} causal={causal}", out,
                          flash_attn.flash_attention_plain(q, k, v, causal),
                          ATTN_TOL[dt], max_err, ATTN_ERR_KEY[dt])
        inst = flash_attn.instance(q.dtype, d)

        def run():
            return flash_attn.flash_attention(q, k, v, causal=causal)
        bms, by = attn_bound(b, h, kvh, sq, sk, d, causal, None,
                             kernel if dt == "float32" else "wgmma")
        row = {"dtype": dt, "d": d, "causal": causal,
               "shape": [b, h, kvh, sq, sk, d],
               "instance": dataclasses.asdict(inst), "max_abs_err": err,
               "ms": time_ms(run, 10),
               "plain_ms": time_ms(lambda: flash_attn.flash_attention_plain(
                   q, k, v, causal), 2),
               "library_ms": time_ms(lambda: torch.nn.functional.
                                     scaled_dot_product_attention(
                                         q, k, v, is_causal=causal), 10),
               "bound_ms": bms, "bound_by": by}
        if inst.width != d:
            row["pad_ms"] = time_ms(lambda: [
                torch.nn.functional.pad(x, (0, inst.width - d))
                for x in (q, k, v)], 10)
        if inst.slices > 1:
            # Q K^T computed once a slice: the flops past the bound's.
            pairs = int(flash_attn.visible(sq, sk, causal, None).sum())
            row["recomputed_qk_flops"] = (inst.slices - 1) * 2 * b * h \
                * pairs * inst.width
        rows.append(row)
        log(f"[k10 new] D={d} {dt} causal={causal} ({kernel}, width "
            f"{inst.width}, {inst.slices} slice(s)): kernel {row['ms']:.4f} "
            f"ms, plain {row['plain_ms']:.4f} ms, sdpa "
            f"{row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}), max "
            f"|diff| {err:.3g}" + (f", pads {row['pad_ms']:.4f} ms"
                                   if "pad_ms" in row else ""))
    del inputs, outs
    return c, max_err, rows


def probe_phase(dev):
    """utils.perf_probe on olmo-1b's two cells: per tag and site the
    share of the bound (at most PROBE_SHARE_MAX) and the tagged ranges'
    cover of the step's emulation-kernel time (within
    PROBE_COVERAGE_TOL)."""
    from repro_torch.utils import perf_probe
    out = {}
    for shape, spec, batch in PROBE_CELLS:
        t0 = time.perf_counter()
        res = perf_probe.probe("olmo-1b", shape, spec, batch=batch,
                               device=dev)
        s = perf_probe.summary(res)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        s["phase_s"] = time.perf_counter() - t0
        log(f"[probe] olmo-1b {shape} batch {batch} under {spec}, "
            f"{s['layers']} layers: step {s['wall_s']:.4f} s, model flops "
            f"{s['model_flops']:.4e}, mfu {s['mfu']}; emulation "
            f"kernels {s['emulation_kernel_ms']:.3f} ms, in tagged ranges "
            f"{s['tagged_emulation_kernel_ms']:.3f} ms (coverage "
            f"{s['coverage']})")
        for r in s["rows"]:
            log(f"[probe] {shape} {r['tag']} {r['site']}: {r['calls']} "
                f"calls, modeled {r['modeled_gb']:.4f} GB, device "
                f"{r['device_ms']:.4f} ms (emulation kernels "
                f"{r['emu_kernel_ms']:.4f}), bound {r['bound_ms']:.4f} ms, "
                f"share {r['share']}, paired {r['paired']}")
        if not s["rows"] or s["coverage"] is None:
            raise AssertionError(f"[probe] {shape}: no emulation rows or "
                                 "no emulation-kernel time in the trace")
        high = [(r["tag"], r["site"], r["share"]) for r in s["rows"]
                if r["share"] is None or r["share"] > PROBE_SHARE_MAX]
        if high:
            raise AssertionError(f"[probe] {shape}: shares of the bound "
                                 f"above {PROBE_SHARE_MAX} (or no device "
                                 f"time): {high}")
        if abs(1.0 - s["coverage"]) > PROBE_COVERAGE_TOL:
            raise AssertionError(
                f"[probe] {shape}: the tagged ranges hold "
                f"{s['tagged_emulation_kernel_ms']:.3f} ms of the step's "
                f"{s['emulation_kernel_ms']:.3f} ms of emulation kernels")
        out[shape] = s
    return out


def examples_phase(dev):
    """The four examples at their default sizes on the card, the kernel
    modules' launch counts read around each (no plain version on the
    card)."""
    import importlib.util
    mods = (ozaki1, ozaki2, ozaki3m, decompose, matmul_int8, flash_attn)
    out = {}
    for name, argv in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for m in mods:
            m.COUNTS.reset()
        t0 = time.perf_counter()
        mod.main(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {f"{m.__name__.rsplit('.', 1)[1]}.{f}": v for m in mods
                    for f, v in kernel_launches(m.COUNTS).items()}
        if any(m.COUNTS.plain_cuda_calls for m in mods):
            raise AssertionError(f"[examples] {name} ran a plain version on "
                                 "the card")
        out[name] = {"argv": argv, "wall_s": wall, "launches": launches}
        log(f"[examples] {name} {' '.join(argv)}: {wall:.2f} s, launches "
            f"{launches}")
        gc.collect()
        torch.cuda.empty_cache()
    if not all(v["launches"] for k, v in out.items()
               if k != "serve_lm_torch"):
        raise AssertionError(f"[examples] an emulated example launched no "
                             f"kernel: {out}")
    return out


def phase31(dev):
    t0 = time.perf_counter()
    k10 = k10_new_phase(dev)
    probe = probe_phase(dev)
    examples = examples_phase(dev)
    log(f"[phase 31] {time.perf_counter() - t0:.1f} s")
    return k10, probe, examples


# ---------------------------------------------------------------------------
# Phase 32: the port's meshes on torch.distributed, one process a rank.
# The ranks are spawned processes (torch.multiprocessing, a FileStore in
# a temporary directory) that load the libraries this process built. On
# one card they share cuda:0 over gloo (NCCL refuses two ranks on one
# GPU); with a card a rank they run over NCCL. Their walls are
# correctness timings of ranks that share one card, not multi-card
# numbers.
# ---------------------------------------------------------------------------

# (a)'s serves: (arch, layers (None: full depth), spec). granite-3-8b's
# untied head is the dense weight a serve prepares (olmo-1b's head is tied
# and layer stacks stay unprepared, R4), so under '+cached' each rank
# prepares its head tile and runs K3 against it.
MP_SERVES = (("olmo-1b", None, "ozaki1-p4"),
             ("granite-3-8b", 4, "ozaki1-p4+cached"))
MP_LABELS = tuple(f"{a} {s}" for a, _, s in MP_SERVES)
MP_DENSE = ((2048, 2048), (2048, 8192), (8192, 2048))   # olmo-1b's (K, N)
MP_ROW = (2048, 2049)              # K divides, N does not: a row partition
MP_HEAD = (2048, 50304)            # the tied head's (K, padded vocab)
MP_ROWS = LANES * CHUNK            # rows of a mixed serve step
MP_PSUM = 1 << 16
# steps, batch, seq, layers: the warmup's first learning rate is 0, so
# the third loss follows a nonzero update.
MP_TRAIN = (3, 2, 128, 4)
# The losses of the first two steps (taken where the parameters have not
# moved) against the one-rank full-batch steps'.
MP_LOSS_RTOL = 1e-5


def mp_backend(world: int) -> str:
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def mp_entry(rank, world, store_path, queue, program, args):
    """One rank: join the group, run ``program``, put its result (or the
    traceback) on the queue."""
    import torch.distributed as dist
    try:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        dist.init_process_group(mp_backend(world),
                                store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        result = program(rank, world, dev, *args)
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, "ok", result))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def mp_world(program, world: int, *args) -> list:
    """``program(rank, world, dev, *args)`` on ``world`` spawned ranks;
    every rank's result, or the first failure raised here. Every process
    is joined (or killed) before it returns."""
    import queue as queue_mod
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmpdir:
        procs = tmp.start_processes(
            mp_entry, args=(world, os.path.join(tmpdir, "store"), queue,
                            program, args),
            nprocs=world, join=False, start_method="spawn")
        results, failure = {}, None
        try:
            while len(results) < world and failure is None:
                try:
                    rank, status, value = queue.get(timeout=5)
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs.processes
                            if p.exitcode not in (None, 0)]
                    if dead:
                        failure = f"a rank exited with {dead}"
                    continue
                if status != "ok":
                    failure = f"rank {rank}:\n{value}"
                results[rank] = value
        finally:
            if failure is not None:
                for p in procs.processes:
                    p.kill()
            for p in procs.processes:
                p.join(60)
                if p.is_alive():
                    p.kill()
        if failure is not None:
            raise AssertionError(f"[phase 32] {failure}")
    return [results[r] for r in range(world)]


def mp_counts() -> dict:
    c = ozaki1.COUNTS
    return {"2d": c.launches_2d, "encode": c.launches_encode,
            "planes": c.launches_planes, "batched": c.launches_batched,
            "mixed": c.launches_mixed, "plain_cuda": c.plain_cuda_calls}


def mp_arch(arch_id: str, layers):
    arch = configs.get_config(arch_id)
    if layers is None:
        return arch
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=layers))


def mp_serve_once(arch, spec, dev, mesh=None):
    """(tokens, seconds, engine) of phase 3's trace served on ``mesh``
    (None: one rank) from seed-0 weights."""
    eng = ContinuousEngine(arch, mesh, max_seq=PROMPT + GEN,
                           policy=GemmPolicy(default=api.precision(spec)),
                           seed=0, max_lanes=LANES, chunk=CHUNK,
                           page_size=PAGE, device=dev)
    trace = build_trace(np.random.default_rng(0), arch.model.vocab,
                        REQUESTS, PROMPT, GEN, 0.0)
    torch.cuda.synchronize()
    eng.reset_clock()
    reset_counts()
    t0 = time.perf_counter()
    results = eng.run(trace)
    torch.cuda.synchronize()
    return ([results[r.rid].tokens for r in trace],
            time.perf_counter() - t0, eng)


def mp_serve(rank, dev, want):
    """(a): each of MP_SERVES tensor-parallel on
    make_host_mesh(model_parallel=2), phase 3's trace, its tokens against
    the one-rank serve's: olmo-1b at full width and depth, and
    granite-3-8b's head tile prepared on each rank (K3)."""
    from repro_torch import telemetry
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import pad_vocab
    from repro_torch.telemetry import record as rec
    mesh = make_host_mesh(model_parallel=2)
    out = {}
    for label, (arch_id, layers, spec) in zip(MP_LABELS, MP_SERVES):
        arch = mp_arch(arch_id, layers)
        telemetry.enable()
        telemetry.REGISTRY.clear()
        toks, dt, eng = mp_serve_once(arch, spec, dev, mesh)
        counts = mp_counts()
        parts = {lab["kind"]: v for lab, v in telemetry.REGISTRY.series(
            rec.SHARD_PARTITION)}
        coll = {lab["kind"]: v for lab, v in telemetry.REGISTRY.series(
            rec.MODELED_COLLECTIVE_BYTES)}
        telemetry.disable()
        if toks != want[label]:
            raise AssertionError(f"{label}: rank {rank}'s tokens differ "
                                 "from the one-rank serve's")
        if counts["2d"] == 0 or counts["batched"] == 0:
            raise AssertionError(f"{label}: the serve launched no K1 / K4")
        # K1: 2 encodes + 1 plane GEMM a call; K3: 1 encode (the lhs) + 1.
        if (counts["encode"], counts["planes"]) != (
                2 * counts["2d"] + counts["mixed"],
                counts["2d"] + counts["mixed"]):
            raise AssertionError(f"{label}: the encodes and plane GEMMs "
                                 f"{counts} are not K1's and K3's")
        if counts["plain_cuda"]:
            raise AssertionError(f"{label}: a plain version ran on the card")
        if set(parts) != {"column"}:
            raise AssertionError(f"{label}: partitions {parts}: every "
                                 "dense N divides 2")
        head = eng.params.get("head")
        if spec.endswith("+cached"):
            vp = pad_vocab(arch.model.vocab)
            if not (eng.prepared and isinstance(head, prepared.PreparedOperand)
                    and head.n * 2 == vp and head.mesh_shape
                    == (("data", 1), ("model", 2))):
                raise AssertionError(f"{label}: the head is not this rank's "
                                     "prepared tile")
            if counts["mixed"] == 0:
                raise AssertionError(f"{label}: no K3 against the prepared "
                                     "head tile")
        w = eng.params["layers"]["b0"]["mixer"]["wq"]
        out[label] = {"seconds": dt, "tok_per_s": REQUESTS * GEN / dt,
                      "steps": eng.utilization()["steps"],
                      "launches": counts, "partitions": parts,
                      "collective_bytes": coll, "prepared": eng.prepared,
                      "head": (f"prepared tile n={head.n}"
                               if eng.prepared else "tied"),
                      "wq_tile": list(w.shape),
                      "tensors_on": str(w.device)}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mp_matmul(rank, world, dev, shapes):
    """(b): sharded_matmul at olmo-1b's dense shapes on each mesh: column
    partitions bit for bit the one-rank product; the row partition bit
    for bit the sum of the pinned partials (2 ranks) or within 1e-6 of
    the largest magnitude (4), every partial the same bits on every rank;
    the localized prepared head (K3) bit for bit; one rank's K1 tile
    against the plain versions."""
    from repro_torch.launch.mesh import axis_index, make_live_mesh
    from repro_torch.parallel import comm, shard_gemm
    cfg = api.precision(SPEC)
    gen = torch.Generator(device=dev).manual_seed(32)
    a = conditioned(gen, (MP_ROWS, 8192), torch.bfloat16, dev)
    ws = {kn: conditioned(gen, kn, torch.bfloat16, dev) for kn in MP_DENSE}
    a32 = conditioned(gen, (MP_ROWS, MP_ROW[0]), torch.float32, dev)
    w_row = conditioned(gen, MP_ROW, torch.float32, dev)
    head = conditioned(gen, MP_HEAD, torch.bfloat16, dev)
    out = {"cases": {}}
    for shape in shapes:
        mesh = make_live_mesh(shape, ("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"
        tp = shape[1]
        for (k, n), w in ws.items():
            x = a[:, :k].contiguous()
            ref = dispatch.emulated_matmul(x, w, cfg=cfg)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = shard_gemm.sharded_matmul(x, w, cfg, mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if not torch.equal(got, ref):
                raise AssertionError(f"{tag} ({k}, {n}): the partitioned "
                                     "product differs from the one-rank one")
            out["cases"][f"{tag} {k}x{n}"] = {"ms": ms,
                                              "launches": mp_counts()}
        if tp > 1:
            k = MP_ROW[0]
            pinned = shard_gemm._pin_row_cfg(cfg, k)
            step = k // tp
            parts = [dispatch.emulated_matmul(
                a32[:, i * step:(i + 1) * step],
                w_row[i * step:(i + 1) * step], cfg=pinned)
                for i in range(tp)]
            got = shard_gemm.sharded_matmul(a32, w_row, cfg, mesh)
            mine = parts[axis_index(mesh, "model")]
            every = comm.gather_raw(mine[None], 0, mesh, "model")
            if not all(torch.equal(every[i], parts[i]) for i in range(tp)):
                raise AssertionError(f"{tag}: a row partial differs")
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            scale = float(total.abs().max())
            err = float((got - total).abs().max())
            if (tp == 2 and not torch.equal(got, total)) or err > 1e-6 * scale:
                raise AssertionError(f"{tag}: the row sum is off by {err}")
            out["cases"][f"{tag} row {k}x{MP_ROW[1]}"] = {
                "max_abs_err": err, "rel": err / scale}
            prep = prepared.prepare_rhs(head, cfg)
            x = a[:, :MP_HEAD[0]].contiguous()
            ref = prepared.matmul_prepared(x, prep)
            reset_counts()
            got = shard_gemm.sharded_dense(x, prep, cfg, mesh)
            if got is None or not torch.equal(got, ref):
                raise AssertionError(f"{tag}: the localized head differs")
            out["cases"][f"{tag} head {MP_HEAD[0]}x{MP_HEAD[1]}"] = {
                "launches": mp_counts()}
    # This rank's K1 tile (a column tile of q's weight, one of the world's)
    # on the card, once, against the plain versions on the host.
    k, n = MP_DENSE[0]
    cols = n // world
    w_tile = ws[(k, n)][:, rank * cols:(rank + 1) * cols]
    x = a[:, :k].contiguous()
    reset_counts()
    card = dispatch.emulated_matmul(x, w_tile, cfg=cfg)
    launched = mp_counts()
    plain = dispatch.emulated_matmul(x.cpu(), w_tile.cpu(), cfg=cfg,
                                     backend="cuda")
    if (launched["encode"], launched["planes"]) != (2, 1) \
            or not torch.equal(card.cpu(), plain):
        raise AssertionError("this rank's K1 tile differs from the plain "
                             "versions")
    out["k1_tile"] = {"shape": [MP_ROWS, k, cols], "launches": launched}
    return out


def mp_psum(rank, world, dev):
    """(c): compressed_psum over every rank: the same bits on each, equal
    to the one-process integer sum of every rank's residues."""
    from repro_torch.launch.mesh import make_live_mesh
    from repro_torch.parallel import comm, compress
    mesh = make_live_mesh((1, world), ("data", "model"))
    xs = [conditioned(torch.Generator(device=dev).manual_seed(320 + r),
                      (MP_PSUM,), torch.float32, dev) for r in range(world)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compress.compressed_psum(xs[rank], (mesh, "model"), world)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    every = comm.gather_raw(got[None], 0, mesh, "model")
    moduli = default_moduli(6)
    amax = torch.max(torch.stack([x.abs().max() for x in xs]))
    scale = compress._scale(amax, compress._budget(moduli, world))
    res = [compress.residues_of(x, scale, moduli) for x in xs]
    sums = [sum(r[j] for r in res) for j in range(len(moduli))]
    plain = compress.reconstruct(sums, scale, moduli)
    if not all(torch.equal(e, plain) for e in every):
        raise AssertionError(f"compressed_psum over {world} ranks differs "
                             "from the integer sum")
    err = float((plain.double() - sum(x.double() for x in xs)).abs().max())
    return {"ms": ms, "max_abs_err_vs_float64_sum": err}


def mp_train(rank, dev):
    """(d): data-parallel olmo-1b train steps on mesh (2, 1), each rank
    its half of the batch. Against the one-rank steps over the same two
    halves as microbatches (the same sums in the same order): every loss,
    parameter and AdamW moment the same bits, on both ranks. Against the
    one-rank full-batch steps (whose dB products contract the whole batch
    at once): the first two losses within MP_LOSS_RTOL; the third loss,
    the moments and the parameters' differences are reported."""
    from repro_torch.launch.mesh import make_live_mesh
    from repro_torch.parallel import comm
    steps, batch, seq, layers = MP_TRAIN
    arch = mp_arch("olmo-1b", layers)
    policy = GemmPolicy(default=api.precision(TRAIN_SPEC))
    shape = ShapeSpec("mp", seq, batch, "train")
    mesh = make_live_mesh((2, 1), ("data", "model"))
    step = S.make_train_step(arch, mesh, shape, policy)
    state = S.init_state(arch, 0, dev, mesh)
    it = make_batch_iterator(arch, shape, 0, rank, 2)
    losses, walls = [], []
    reset_counts()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, next(it)[1])
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    counts = mp_counts()
    for key, leaf in tree_flatten(state["params"]).items():
        both = comm.gather_raw(leaf[None], 0, mesh, "data")
        if not torch.equal(both[0], both[1]):
            raise AssertionError(f"the ranks' {key} differ after {steps} "
                                 "steps")

    def one_rank(micro: int):
        """(losses, state) of the one-rank steps on the whole batch, both
        halves host by host, in ``micro`` microbatches."""
        a = dataclasses.replace(arch, train=dataclasses.replace(
            arch.train, microbatches=micro))
        fn = S.make_train_step(a, None, shape, policy)
        halves = [make_batch_iterator(arch, shape, 0, r, 2)
                  for r in range(2)]
        st, out = S.init_state(arch, 0, dev), []
        for _ in range(steps):
            parts = [next(h)[1] for h in halves]
            st, m = fn(st, {k: np.concatenate([p[k] for p in parts])
                            for k in parts[0]})
            out.append(float(m["loss"]))
        return out, st

    def gaps(ref):
        """The largest difference of each moment from ``ref``'s over its
        largest, and the count of parameters that differ."""
        out = {}
        for name in ("m", "v"):
            got, exp = (tree_flatten(st["opt"][name]) for st in (state, ref))
            out[name] = max(float((got[k] - exp[k]).abs().max()
                                  / exp[k].abs().max()) for k in exp)
        got, exp = tree_flatten(state["params"]), tree_flatten(ref["params"])
        out["params_differ"] = sum(int((got[k] != exp[k]).sum()) for k in exp)
        return out

    micro_losses, ref = one_rank(2)
    micro = gaps(ref)
    del ref
    want, ref = one_rank(1)
    full = gaps(ref)
    start = tree_flatten(S.init_state(arch, 0, dev)["params"])
    full["params_moved"] = sum(int((v != start[k]).sum()) for k, v in
                               tree_flatten(ref["params"]).items())
    del ref, state, start
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    report = {"losses": losses, "one_rank_micro_losses": micro_losses,
              "one_rank_losses": want, "rel": rel, "vs_micro": micro,
              "vs_full_batch": full, "walls_s": walls, "launches": counts}
    if losses != micro_losses or micro != {"m": 0.0, "v": 0.0,
                                           "params_differ": 0}:
        raise AssertionError("the data-parallel steps differ from the "
                             f"one-rank microbatched steps: {report}")
    if max(rel[:2]) > MP_LOSS_RTOL:
        raise AssertionError(f"data-parallel losses off the one-rank full-"
                             f"batch steps': {report}")
    return report


def mp_rank(rank, world, dev, want):
    import torch.distributed as dist
    out = {"backend": dist.get_backend(), "device": str(dev)}
    if world == 2:
        out["serve"] = mp_serve(rank, dev, want)
        out["matmul"] = mp_matmul(rank, world, dev, ((1, 2), (2, 1)))
        out["psum"] = mp_psum(rank, world, dev)
        out["train"] = mp_train(rank, dev)
    else:
        out["matmul"] = mp_matmul(rank, world, dev, ((2, 2), (1, 4)))
        out["psum"] = mp_psum(rank, world, dev)
    return out


def phase32(dev):
    """(a)-(d) over worlds of 2 and 4 ranks, after every build."""
    t0 = time.perf_counter()
    want, one_rank_s = {}, {}
    for label, (arch_id, layers, spec) in zip(MP_LABELS, MP_SERVES):
        want[label], one_rank_s[label], eng = mp_serve_once(
            mp_arch(arch_id, layers), spec, dev)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase 32] one-rank serve of phase 3's trace, {label}: "
            f"{one_rank_s[label]:.2f} s")
    report = {"one_rank_serve_s": one_rank_s, "worlds": {}}
    for w in (2, 4):
        t1 = time.perf_counter()
        ranks = mp_world(mp_rank, w, want)
        log(f"[phase 32] world {w}: {time.perf_counter() - t1:.1f} s")
        for r, out in enumerate(ranks):
            log(f"[phase 32] world {w} rank {r}: backend {out['backend']}, "
                f"tensors on {out['device']}")
            if "serve" in out:
                for label, s in out["serve"].items():
                    log(f"[phase 32] rank {r} {label}: {s['steps']} steps "
                        f"in {s['seconds']:.2f} s ({s['tok_per_s']:.1f} "
                        f"tok/s; one rank {one_rank_s[label]:.2f} s), "
                        f"tokens == one-rank; launches {s['launches']}, "
                        f"partitions {s['partitions']}, modeled collective "
                        f"bytes {s['collective_bytes']}, wq tile "
                        f"{s['wq_tile']} on {s['tensors_on']}, head "
                        f"{s['head']}")
                t = out["train"]
                log(f"[phase 32] rank {r} train (2, 1): losses {t['losses']}"
                    f" == the one-rank microbatched steps' (params and "
                    f"AdamW moments the same bits); one-rank full batch "
                    f"{t['one_rank_losses']} (rel {t['rel']}), moments and "
                    f"params vs it {t['vs_full_batch']}; walls "
                    f"{[round(x, 2) for x in t['walls_s']]} s, launches "
                    f"{t['launches']}; params equal on both ranks")
            log(f"[phase 32] rank {r} sharded_matmul: "
                + json.dumps(out["matmul"]))
            log(f"[phase 32] rank {r} compressed_psum over {w}: "
                + json.dumps(out["psum"]))
        report["worlds"][w] = ranks
    report["seconds"] = time.perf_counter() - t0
    log(f"[phase 32] {report['seconds']:.1f} s")
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(card)
    builds = start_builds()
    view_tokens = PAGE * math.ceil((PROMPT + GEN - 1 + CHUNK) / PAGE)
    # Phases 29, 30, 28, 27, 26 and 20-23 first: their walls come before
    # any profiler session. Phases 29, 30 and 28 need EmuGEMM-I alone, so
    # they run while emugemm2_planes.cu, the longest nvcc, compiles (on
    # the same cores as their host-bound steps); each
    # frees what it drew, so phase 27's 64 layers of qwen1.5-32b and
    # phase 29's 24.9 B parameters each have the card to themselves.
    wait_builds(builds, ("emugemm1_batched", "emugemm1_planes", "decompose",
                         "flash_attn"))
    dsv3 = dsv3_phase(dev, view_tokens)
    guard_report = guard_phase(dev)
    zoo = zoo_phase(dev)
    wait_builds(builds, ("emugemm2_planes",))
    builds[0].shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 32: its ranks load the libraries built above.
    mp = phase32(dev)
    log(f"[qwen1.5-32b] the card before the phase: "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved(dev) / 2 ** 30:.2f} GiB reserved")
    qwen = qwen_phase(dev, view_tokens)
    moe_walls = moe_phase(dev, view_tokens)
    gparams, gprepped, new_paths = new_path_phases(dev, view_tokens)
    # Phase 31: its perf_probe profiles are the process's first profiler
    # sessions, after every wall of phases 20-30.
    (k10_counts, k10_err, k10_rows), probe, examples = phase31(dev)
    yardsticks = yardstick_phase(dev)
    gk = granite_kernel_phase(dev, configs.get_config(GRANITE), gparams,
                              gprepped, view_tokens)
    del gparams, gprepped
    mk = moe_kernel_phase(dev, view_tokens)

    arch = configs.get_config("olmo-1b")
    spec_policy = GemmPolicy(default=api.precision(SPEC))
    max_err, totals = kernel_phase(dev, arch.model, view_tokens)
    eng, (counts, _), serve = serve_phase(dev, arch, spec_policy)
    serve.update(parity_phase(dev, arch, eng.params, view_tokens,
                              spec_policy, SPEC))
    log("[serve] summary " + json.dumps(serve))
    profile_phase(dev, arch, eng.params, view_tokens,
                  ((SPEC, spec_policy),
                   ("native", GemmPolicy(default=api.precision("native")))))
    del eng

    t_err, t_totals = train_kernel_phase(dev, arch.model)
    params, (k1, k2, _), train = train_phase(
        dev, arch, card, GemmPolicy(default=api.precision(TRAIN_SPEC)))
    log("[train] summary " + json.dumps(
        {k: v for k, v in train.items() if k != "profile"}))
    torch.use_deterministic_algorithms(True, warn_only=True)
    train_parity_phase(dev, arch, params)
    del params
    trainer_phase()
    torch.use_deterministic_algorithms(False)

    # olmo-1b-emu: Scheme II on attn_qk, under the config's gemm_sites.
    emu = configs.get_config(EMU)
    s2_err, s2_totals = scheme2_kernel_phase(dev, emu.model, view_tokens)
    lib_counts, lib_totals = scheme2_library_phase(dev, emu.model)
    eng, (e1, e2), emu_serve = serve_phase(dev, emu, None)
    emu_serve.update(parity_phase(dev, emu, eng.params, view_tokens,
                                  eng.policy, EMU))
    log(f"[serve {EMU}] summary " + json.dumps(emu_serve))
    profile_phase(dev, emu, eng.params, view_tokens, ((EMU, eng.policy),))
    del eng
    params, (ek1, ek2, ek3), emu_train = train_phase(dev, emu, card,
                                                      long_seq=False)
    log(f"[train {EMU}] summary " + json.dumps(
        {k: v for k, v in emu_train.items() if k != "profile"}))
    torch.use_deterministic_algorithms(True, warn_only=True)
    emu_train_parity_phase(dev, emu, params)
    hoisted_parity_phase(dev, micro_arch(emu), params,
                         dispatch.resolve_policy(emu.gemm_policy()), "f")
    del params
    torch.use_deterministic_algorithms(False)

    # DGEMM- and ZGEMM-grade Scheme II.
    sci_err, sci_counts, sci_t, sci_res, sci_batched, sci_shared = \
        scientific_phase(dev)
    # Scheme I in float64, at p = 9..16, with float16 and 4M, on the same
    # DGEMM / ZGEMM operands.
    wide_rows = scheme1_wide_phase(dev, arch.model, sci_shared, sci_t)
    del sci_shared

    # olmo-1b trained under ozaki2-m6+cached with gradient accumulation:
    # EmuGEMM-II's prepared form and the once-per-step hoist.
    p_err, p_totals = prepared_kernel_phase(dev, arch.model)
    params, hk, hoist = hoisted_train_phase(dev, arch, card)
    log("[hoist] summary " + json.dumps(
        {k: v for k, v in hoist.items() if k != "profile"}))
    torch.use_deterministic_algorithms(True, warn_only=True)
    hoisted_parity_phase(
        dev, micro_arch(arch), params,
        GemmPolicy(default=api.precision(HOIST_SPEC)), "g",
        uncached=GemmPolicy(default=api.precision(f"ozaki2-m{M_MAIN}")),
        torch_backend=True)
    del params
    torch.use_deterministic_algorithms(False)

    # The library kernels.
    lib_dc, lib_dec, library_rows = library_phase(dev, arch.model)

    def bound_by(t):
        return "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"

    common = {"route": "cuda", "library_ms": None}
    kernels = []
    t2, td, tt = totals["mixed", "2d"], totals["decode", "2d"], t_totals["2d"]
    train_per = (f"one {TRAIN_SPEC} train step of full-width olmo-1b "
                 f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens; launches: the "
                 f"warm-up and {TRAIN_STEPS} timed steps)")

    def split(t):
        return {"encode_ms": t["encode_ms"], "planes_ms": t["planes_ms"],
                "mainloop_ms": t["mainloop_ms"],
                "epilogue_ms": t["planes_ms"] - t["mainloop_ms"],
                "mainloop_tops": t["ops"] / t["mainloop_ms"] / 1e9}

    kernels.append({
        "name": "emugemm1_2d", **common, "source": SOURCE_S1_PLANES,
        "replaces": "src/repro/kernels/ozaki1.py:143",
        "also_replaces": "src/repro/kernels/backends/gpu.py:202",
        "launches": counts.launches_2d, "max_abs_err": max_err["2d"],
        "ms": t2["ms"], "plain_ms": t2["plain_ms"],
        "bound_ms": t2["bound_ms"], "bound_by": bound_by(t2), **split(t2),
        "int_mm_yardstick_ms": t2["yardstick_ms"],
        "per": "one mixed serve step of olmo-1b (4 lanes x chunk 16); the "
               "route: 2 encodes + 1 plane GEMM a call",
        "per_decode_step": {k: td[k] for k in ("ms", "plain_ms",
                                               "bound_ms")},
        "launches_in_train_run": k1.launches_2d,
        "granite_serve": {
            **gk["k1_mixed_step"],
            "launches": new_paths["granite_serve"]["launches"]["2d"],
            "launches_per_step": new_paths["granite_serve"][
                "launches_per_step"]["2d"],
            "per": f"the 2-D calls of one mixed serve step of {GRANITE} "
                   f"(4 lanes x chunk 16, 7 a layer), timed at their shapes "
                   f"with weights cold; launches: its {GRANITE_SPEC} serve"},
        "per_train_step": {"ms": tt["ms"], "plain_ms": tt["plain_ms"],
                           "bound_ms": tt["bound_ms"], **split(tt),
                           "per": train_per + ": dB = A^T dC"}})
    t, tdb = totals["mixed", "batched"], totals["decode", "batched"]
    kernels.append({
        "name": "emugemm1_batched", **common, "source": SOURCE_S1_BATCHED,
        "replaces": "src/repro/kernels/backends/gpu.py:240",
        "launches": counts.launches_batched, "max_abs_err": max_err["batched"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": bound_by(t), "int_mm_yardstick_ms": t["yardstick_ms"],
        "other_tile_ms": t["other_tile_ms"], "events_ms": t["events_ms"],
        "per": "one mixed serve step of olmo-1b (4 lanes x chunk 16): attn_qk "
               "and attn_av, one launch a call; ms: the kernel's device time "
               "(torch.profiler), events_ms: back-to-back calls by CUDA "
               "events (the host's wrapper at these shapes); other_tile_ms: "
               "the same launches at the other tile height (device)",
        "per_decode_step": {k: tdb[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "other_tile_ms", "events_ms")},
        "launches_in_train_run": k1.launches_batched,
        "granite_serve_g4": {
            **gk["k4_g4"],
            "launches": new_paths["granite_serve"]["launches"]["batched"],
            "per": f"attn_qk and attn_av of one mixed (and decode) serve step "
                   f"of {GRANITE}, 4 query heads a KV head; ms: device time "
                   f"(torch.profiler); launches: its {GRANITE_SPEC} serve"}})
    tm = t_totals["mixed"]
    kernels.append({
        "name": "emugemm1_mixed", **common, "source": SOURCE_S1_PLANES,
        "replaces": "src/repro/kernels/ozaki1.py:170",
        "launches": k1.launches_mixed, "max_abs_err": t_err["mixed"],
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": bound_by(tm), **split(tm),
        "int_mm_yardstick_ms": tm["yardstick_ms"],
        "weights_encode_ms": t_totals["weights"]["ms"],
        "per": train_per + "; the route: an lhs encode + 1 plane GEMM a call "
               "against the weight's planes (the weights' encodes apart)",
        "granite_head": {
            **gk["k3_head"],
            "launches": new_paths["granite_serve"]["launches"]["mixed"],
            "head_prepare_ms": new_paths["granite_serve"]["head_prepare_ms"],
            "per": f"the logits GEMM of one serve step of {GRANITE}: 4 lanes "
                   f"against the head's planes (4096 x 49664, prepared once "
                   f"a session, one encode); plain: the interleaved prep's "
                   f"mixed form; launches: its {GRANITE_SPEC} serve, one a "
                   "step"}})
    kernels.append({
        "name": "emugemm1_encode", **common, "source": SOURCE_S1_PLANES,
        "replaces": "src/repro/kernels/ozaki1.py:143",
        "launches": counts.launches_encode,
        "max_abs_err": max(max_err["encode"], t_err["encode"]),
        "ms": t2["encode_ms"], "plain_ms": t2["encode_plain_ms"],
        "bound_ms": t2["encode_bound_ms"], "bound_by": "bytes",
        "per": "the encodes of one mixed serve step of olmo-1b (2 a 2-D call)",
        "launches_in_train_run": k1.launches_encode,
        "per_train_step_ms": tt["encode_ms"] + tm["encode_ms"]
        + t_totals["weights"]["ms"]})
    kernels.append({
        "name": "emugemm1_planes", **common, "source": SOURCE_S1_PLANES,
        "replaces": "src/repro/kernels/ozaki1.py:143",
        "launches": counts.launches_planes, "max_abs_err": max_err["2d"],
        "ms": t2["planes_ms"], "plain_ms": t2["planes_plain_ms"],
        "bound_ms": t2["planes_bound_ms"],
        "bound_by": ("operations" if 2 * t2["planes_ops_bound_ms"]
                     >= t2["planes_bound_ms"] else "bytes"),
        "mainloop_ms": t2["mainloop_ms"],
        "per": "the plane GEMMs of one mixed serve step of olmo-1b",
        "launches_in_train_run": k1.launches_planes,
        "per_train_step_ms": tt["planes_ms"] + tm["planes_ms"]})
    for key, name, source, replaces, launches in (
            ("pair", "decompose_pair", DECOMPOSE_SOURCE,
             "src/repro/kernels/decompose.py:106", lib_dc.launches_pair),
            ("rhs", "decompose_rhs", DECOMPOSE_SOURCE,
             "src/repro/kernels/decompose.py:71", lib_dc.launches_rhs)):
        t = t_totals[key]
        kernels.append({
            "name": name, **common, "source": source, "replaces": replaces,
            "launches": launches, **lib_dec[key],
            "max_abs_err": max(t_err[key], lib_dec[key]["max_abs_err"]),
            "per": f"one launch at each of olmo-1b's dense shapes at "
                   f"{TOKENS} tokens, bf16, p = {P_MAIN}, summed (launches: "
                   "phase 19's main path, the decompositions feeding K8)",
            "per_train_step_weights": {
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "per": f"one {TRAIN_SPEC} train step's weights decomposed "
                       "into the 'interleaved' layout"
                       + (f" at bwd_p={P_BWD}" if key == "rhs" else "")}})
    lib_per = (f"one launch at each of olmo-1b's dense shapes at {TOKENS} "
               f"tokens under ozaki2-m{M_MAIN}, bf16 (launches: the library "
               "route's run)")
    earlier = ("earlier times: PERF.md's kernel table (emugemm2.cu's fused "
               "form, which this route replaced)")
    hoist_per = (f"one {HOIST_SPEC} train step of full-width olmo-1b "
                 f"({HOIST_MICRO} microbatches of {TOKENS // HOIST_MICRO} "
                 f"tokens; launches: the warm-up and {TRAIN_STEPS} timed "
                 "steps)")
    t, tdb = lib_totals["2d"], s2_totals["db"]
    kernels.append({
        "name": "emugemm2_2d", **common, "source": SOURCE_PLANES,
        "replaces": "src/repro/kernels/backends/gpu.py:359",
        "launches": lib_counts.launches_2d, "max_abs_err": s2_err["2d"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": bound_by(t), **split(t),
        "int_mm_yardstick_ms": t["yardstick_ms"],
        "per": lib_per + "; the plane route: 2 encodes + 1 plane GEMM a call; "
               + earlier,
        "per_hoisted_step_db": {
            "ms": tdb["ms"], "plain_ms": tdb["plain_ms"],
            "bound_ms": tdb["bound_ms"], "bound_by": bound_by(tdb),
            **split(tdb), "encode_bound_ms": tdb["encode_bound_ms"],
            "plane_gemms_by_tile_width": tdb["tiles"],
            "per": hoist_per + ": dB = X^T dC of every weight, X^T read "
                   "through its strides"}})
    t = lib_totals["residues"]

    def residue_split_of(t):
        return {k: t[k] for k in ("relayout_ms", "residue_gemm_ms",
                                  "mainloop_ms", "epilogue_ms",
                                  "relayout_bound_ms", "relayouts")}

    kernels.append({
        "name": "emugemm2_residues", **common, "source": SOURCE_PLANES,
        "replaces": "src/repro/kernels/ozaki2.py:52",
        "launches": lib_counts.launches_residues,
        "launches_relayout": lib_counts.launches_relayout,
        "max_abs_err": max(s2_err["residues"], sci_err["residues"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": bound_by(t), **residue_split_of(t),
        "mainloop_tops": t["ops"] / t["mainloop_ms"] / 1e9,
        "int_mm_yardstick_ms": t["yardstick_ms"],
        "per": lib_per + "; the residue route: a relayout of B^T (A read "
               "in place) + 1 residue plane GEMM a call"})
    t = s2_totals["mixed"]

    def k6(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": bound_by(t),
                "yardstick_ms": t["yardstick_ms"], **split(t)}

    kernels.append({
        "name": "emugemm2_batched", **common, "source": SOURCE_PLANES,
        "replaces": "src/repro/kernels/backends/gpu.py:409",
        "launches": e2.launches_batched, "max_abs_err": s2_err["batched"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": bound_by(t), **split(t),
        "int_mm_yardstick_ms": t["yardstick_ms"],
        "per": f"one mixed serve step of {EMU} (attn_qk, ozaki2-m{M_MAIN}); "
               "the plane route with the batch coordinate: 2 encodes + 1 "
               "plane GEMM a call; " + earlier,
        "launches_in_train_run": ek3.launches_batched,
        "per_decode_step": k6(s2_totals["decode"]),
        "per_train_step": k6(s2_totals["train"]),
        "per_long_step": {**k6(s2_totals["long"]),
                          "per": f"attn_qk of one {LONG_BATCH} x {LONG_SEQ} "
                                 f"token train step of {EMU}"}})
    kernels.append({
        "name": "emugemm2_prepared", **common, "source": SOURCE_PLANES,
        "replaces": "src/repro/kernels/backends/gpu.py:359",
        "launches": hk.launches_prepared, "max_abs_err": p_err["prepared"],
        "ms": p_totals["ms"], "plain_ms": p_totals["plain_ms"],
        "bound_ms": p_totals["bound_ms"], "bound_by": bound_by(p_totals),
        **{k: p_totals[k] for k in ("encode_ms", "planes_ms", "mainloop_ms",
                                    "crt_ms", "weight_encode_ms",
                                    "float_rhs_ms")},
        "launches_encode": hk.launches_encode,
        "launches_planes": hk.launches_planes,
        "int_mm_yardstick_ms": p_totals["yardstick_ms"],
        "per": hoist_per + "; the plane route: an lhs encode (real float32 "
               "/ bf16 instances) and a plane GEMM a call, the weights' "
               "encodes apart"})
    for row in kernels:
        if row["name"] in ("emugemm2_2d", "emugemm2_batched"):
            row["launches_in_hoisted_train"] = (
                hk.launches_2d if row["name"] == "emugemm2_2d"
                else hk.launches_batched)
            row["launches_in_hoisted_train_encode_planes"] = (
                hk.launches_encode, hk.launches_planes)
    # The float64 entry of EmuGEMM-II's residue row, the plane route of
    # DGEMM, ZGEMM and the float64 batch, and K7.
    n0, p_sci = SCI_SIZES[0][0], SCI_SIZES[0][1][-1]
    dgemm, zgemm = sci_t["dgemm", n0, p_sci], sci_t["zgemm", n0, p_sci]
    sci_per = (f"one {{}} {n0}^3 at m = {p_sci} (launches: the scientific "
               f"front doors at m = {SCI_M_FRONT})")
    ops_ms = sci_res["ops_routes_ms"]
    f64_rows = {
        "emugemm2_residues": {**sci_res["residues"], "library_ms": None,
                              "ops_route_ms": ops_ms["fused_scheme2_matmul"],
                              "max_abs_err": sci_err["f64_residues"],
                              "launches": sci_counts["emugemm2_residues"],
                              "per": sci_per.format(
                                  "residue GEMM of the DGEMM route")}}
    for row in kernels:
        if row["name"] in f64_rows:
            row["float64"] = f64_rows[row["name"]]
    for t, prefix, replaces, what, enc_err in (
            (dgemm, "emugemm2", "src/repro/kernels/backends/gpu.py:359",
             "DGEMM-grade float64 GEMM", "encode"),
            (zgemm, "emugemm3m", "src/repro/kernels/backends/gpu.py:522",
             "ZGEMM-grade complex128 GEMM", "encode_3m")):
        kernels.append({
            "name": f"{prefix}_encode", **common, "source": SOURCE_PLANES,
            "replaces": replaces,
            "launches": sci_counts[f"{prefix}_encode"],
            "max_abs_err": sci_err[enc_err], "ms": t["encode_ms"],
            "plain_ms": t["encode_plain_ms"],
            "bound_ms": t["encode_bound_ms"], "bound_by": "bytes",
            "per": sci_per.format(f"pair of operand encodes of a {what}")})
        kernels.append({
            "name": f"{prefix}_planes", **common, "source": SOURCE_PLANES,
            "replaces": replaces,
            "launches": sci_counts[f"{prefix}_planes"],
            "max_abs_err": sci_err["f64_2d" if prefix == "emugemm2"
                                   else "3m_2d"],
            "ms": t["planes_ms"], "plain_ms": t["planes_plain_ms"],
            "bound_ms": t["planes_bound_ms"],
            "bound_by": t["planes_bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in ("mainloop_ms", "crt_ms", "mainloop_tops",
                                 "bits", "library_bits",
                                 "int_mm_yardstick_ms")},
            "route_ms": t["ms"], "route_plain_ms": t["plain_ms"],
            "route_bound_ms": t["bound_ms"],
            "per": sci_per.format(what) + "; library: cuBLAS on the "
                   "float operands; route: the encodes and the plane GEMM"})
    kernels.append({
        "name": "emugemm2_planes_batched", **common, "source": SOURCE_PLANES,
        "replaces": "src/repro/kernels/backends/gpu.py:409",
        "launches": sci_counts["emugemm2_planes"],
        "max_abs_err": sci_err["f64_batched"], **sci_batched,
        "per": f"one float64 batched GEMM {SCI_BATCHED} at m = "
               f"{SCI_M_FRONT}: the route, its 2 encodes and the plane GEMM "
               "with the batch coordinate; library: cuBLAS batched DGEMM "
               "(launches: the plane GEMM's on the scientific front doors, "
               "the DGEMM's and the float64 batch's)"})
    kernels.append({
        "name": "emugemm3m_residues", **common, "source": SOURCE_PLANES,
        "replaces": "src/repro/kernels/ozaki3m.py:72",
        "launches": sci_counts["emugemm3m_residues"],
        "max_abs_err": sci_err["3m_residues"], **sci_res["3m_residues"],
        "int_mm_yardstick_ms": zgemm["int_mm_yardstick_ms"],
        "ops_route_ms": ops_ms["fused_3m_matmul"],
        "per": sci_per.format("3p-product residue GEMM of the ZGEMM route")
        + "; the residue route: a relayout of B^T's phases (A read in "
          "place) + 1 residue plane GEMM"})
    # The relayout alone: B^T of K5's and of K7's 4096^2 operands, m = 16.
    r5, r7 = sci_res["residues"], sci_res["3m_residues"]
    kernels.append({
        "name": "emugemm2_relayout", **common, "source": SOURCE_PLANES,
        "replaces": "src/repro/kernels/ozaki2.py:52",
        "also_replaces": "src/repro/kernels/ozaki3m.py:72",
        "launches": sci_counts["emugemm2_relayout"],
        "max_abs_err": sci_err["relayout"],
        "ms": r5["relayout_ms"], "plain_ms": r5["relayout_plain_ms"],
        "bound_ms": r5["relayout_bound_ms"], "bound_by": "bytes",
        "library_ms": r5["relayout_library_ms"],
        "k7": {"ms": r7["relayout_ms"], "plain_ms": r7["relayout_plain_ms"],
               "bound_ms": r7["relayout_bound_ms"],
               "library_ms": r7["relayout_library_ms"],
               "max_abs_err": r7["relayout_max_abs_err"]},
        "per": f"B^T of K5's (p, {n0}, {n0}) residues at m = {p_sci}; k7: "
               "B^T of K7's phase stacks (launches: the scientific front "
               "doors' residue routes; max_abs_err: the kernel against its "
               "plain version, padding included, on every residue check "
               "case's A and B^T and on these operands); library: "
               "F.pad(x, (0, Kp - K)) of the strided view, or x.contiguous() "
               "where Kp = K"})
    for row in library_rows:
        if row["name"] == "int8_matmul":
            row["library_kernels_ms"] = yardsticks["int_mm"]
        if row["name"] in ("flash_attention_3xtf32", "flash_split_3xtf32"):
            row["device_kernels_ms"] = {
                k: v for k, v in yardsticks["k10_f32"].items()
                if ("split" in k) == (row["name"] == "flash_split_3xtf32")}
    kernels += library_rows + wide_rows
    # Phase 26: qwen2-moe-a2.7b-emu's shapes beside each kernel's row.
    s1_run, s2_run = moe_walls["serve"]["launches"]
    moe_serve = (f"launches: the {MOE_EMU} serve of phase 3's trace "
                 f"({moe_walls['serve']['steps']} steps)")
    moe_rows = {
        "emugemm1_batched": {"qwen2_moe_experts": {
            **mk["k4"], "max_abs_err": mk["max_abs_err"]["k4"],
            "launches": s1_run["batched"],
            "per": f"the expert stacks (E, T, d) @ (E, d, f) (gate, up) and "
                   f"(E, T, f) @ (E, f, d) (down), bf16, p = {P_MAIN}, at T "
                   f"rows of a mixed step, a decode step and a lockstep "
                   f"prefill; ms: CUDA events behind a spin kernel; "
                   f"{moe_serve}: 3 expert launches and attn_av a layer"}},
        "emugemm2_2d": {"qwen2_moe_router": {
            **mk["k5g"], "max_abs_err": mk["max_abs_err"]["k5g"],
            "launches": s2_run["2d"],
            "per": f"the router (T, d) @ (d, E), float32, m = {M_MAIN}; ms: "
                   f"the call's device time (2 encodes + 1 plane GEMM) "
                   f"behind a spin kernel, events_ms: back to back; "
                   f"{moe_serve}"}},
        "emugemm1_2d": {"qwen2_moe_serve": {
            **mk["k1_mixed_step"], "launches": s1_run["2d"],
            "per": f"the 2-D calls of one mixed serve step (q, k, v, o, the "
                   f"shared experts' gate, up, down; 7 a layer), weights "
                   f"cold; {moe_serve}"}},
        "emugemm1_mixed": {"qwen2_moe_head": {
            **mk["k3_head"], "max_abs_err": mk["max_abs_err"]["k3"],
            "launches": s1_run["mixed"],
            "per": f"the logits GEMM of a serve step against the head's "
                   f"planes, prepared once a session; {moe_serve}"}},
        "emugemm2_batched": {"qwen2_moe_attn_qk": {
            **mk["k6_attn_qk"], "max_abs_err": mk["max_abs_err"]["k6"],
            "launches": s2_run["batched"],
            "per": f"attn_qk of a mixed and a decode step, m = {M_MAIN}; "
                   f"{moe_serve}"}}}
    for row in kernels:
        row.update(moe_rows.get(row["name"], {}))
    # Phase 27: qwen1.5-32b's shapes, and Scheme II's float16 instances.
    qk, f16, q_serve = qwen["kernels"], qwen["f16"], qwen["serve"]
    q_per = (f"launches: the {QWEN} {QWEN_SPEC} serve of phase 3's trace "
             f"({q_serve['steps']} steps, 64 layers, int8 KV cache)")
    f16_per = (f"float16 operands under ozaki2-m{M_MAIN}, a float32 output "
               "(f16_out_ms: a float16 one), at olmo-1b's dense shapes "
               f"({TOKENS} tokens) and {F16_4096[0]}^3; ms: behind a spin "
               "kernel; library: cuBLAS's HGEMM (torch.matmul in float16); "
               "launches: the front doors' main path")
    qwen_rows = {
        "emugemm1_2d": {"qwen1_5_32b_serve": {
            **qk["k1_mixed_step"], "max_abs_err": qk["max_abs_err"]["k1"],
            "launches": q_serve["launches"]["2d"],
            "per": f"the 2-D calls of one mixed serve step (q, k, v, o, "
                   f"gate, up, down: 7 a layer, 64 layers), weights cold; "
                   f"{q_per}"}},
        "emugemm1_mixed": {"qwen1_5_32b_head": {
            **qk["k3_head"], "max_abs_err": qk["max_abs_err"]["k3"],
            "launches": q_serve["launches"]["mixed"],
            "per": f"the logits GEMM of a serve step: 4 lanes against the "
                   f"untied head's planes (5120 x 152064), prepared once; "
                   f"{q_per}"}},
        "emugemm1_batched": {"qwen1_5_32b_attn": {
            **qk["k4"], "max_abs_err": qk["max_abs_err"]["k4"],
            "launches": q_serve["launches"]["batched"],
            "per": f"attn_qk and attn_av on the dequantized int8 cache, one "
                   f"query head a KV head (40 a lane), a mixed and a decode "
                   f"step; ms: behind a spin kernel; {q_per}"}},
        "flash_attention": {"qwen1_5_32b_prefill": {
            **qk["k10_prefill"], "max_abs_err": qk["max_abs_err"]["k10"],
            "per": "a 2048-token causal prefill at qwen1.5-32b's 40 heads "
                   "of 128, bf16, within 2e-2 of its plain version (the "
                   "model's prefill runs the plain chunked attention, as "
                   "the reference's does, so it launches none)"}},
        "emugemm2_2d": {"float16": {
            "per_shape": f16["2d"], "max_abs_err": f16["max_abs_err"]["2d"],
            "launches": f16["launches"]["2d"], "per": f16_per}},
        "emugemm2_batched": {"float16": {
            "per_shape": f16["batched"],
            "max_abs_err": f16["max_abs_err"]["batched"],
            "launches": f16["launches"]["batched"],
            "per": f"float16 batches (olmo-1b-emu's attn_qk of a mixed "
                   f"step, and 8 x 512^3) under ozaki2-m{M_MAIN}; library: "
                   "torch.bmm in float16"}},
        "emugemm2_prepared": {"float16_lhs": {
            "per_shape": f16["prepared"],
            "max_abs_err": f16["max_abs_err"]["prepared"],
            "launches": f16["launches"]["prepared"],
            "per": "a float16 lhs against a prepared float16 weight (the "
                   "b_res form): one lhs encode + 1 plane GEMM; " + f16_per}}}
    for row in kernels:
        row.update(qwen_rows.get(row["name"], {}))
    # Phase 28: the zoo's paths, per step, each form's calls summed at
    # their shapes.
    zoo_per = {
        "k1": "the 2-D EmuGEMM-I calls of each step",
        "k3": "the calls against prepared weights (the untied heads, "
              "recurrentgemma-2b's 2-D tail)",
        "k4": "the batched calls (attn_qk, attn_av; mamba2-780m's "
              "ssd_state, N = 1)"}
    for name, kid in (("emugemm1_2d", "k1"), ("emugemm1_mixed", "k3"),
                      ("emugemm1_batched", "k4")):
        per_arch = {a: {step: rows[kid] for step, rows in
                        zoo[a]["kernels"].items() if kid in rows}
                    for a in ZOO_CHECK}
        for row in kernels:
            if row["name"] == name:
                row["zoo"] = {
                    **per_arch, "max_abs_err": zoo["max_abs_err"][kid],
                    "per": f"{zoo_per[kid]} under {ZOO_SPEC}, on Eq. 19 "
                           "operands of each call's shape, type and layout "
                           "(ms behind a spin kernel); library: "
                           "torch.matmul / torch.bmm on the same operands; "
                           "launches_per_step: the phase's own run"}
    # Phase 29: deepseek-v3-671b's paths, per step, each form's calls
    # summed at their shapes.
    ds_serve = dsv3["serve"]
    ds_per = (f"launches: the {DSV3} {DSV3_SPEC} serve of phase 3's trace "
              f"({ds_serve['steps']} steps, {DSV3_LAYERS} of 61 layers at "
              "full width)")
    for name, kid, what in (
            ("emugemm1_2d", "k1", "the 2-D calls of a mixed and a decode "
             "serve step (8 a layer: wq_a, wq_b, wkv_a, wo, the float32 "
             "router, the shared expert's gate, up, down) and of a lockstep "
             "prefill (+2 a layer: mla_latent, K = 512)"),
            ("emugemm1_mixed", "k3", "the logits GEMM against the untied "
             "head's planes (7168 x 129536), prepared once a session"),
            ("emugemm1_batched", "k4", "the expert stacks (256, G*C, 7168) "
             "@ (256, 7168, 2048) (gate, up) and (256, G*C, 2048) @ (256, "
             "2048, 7168) (down), 3 a layer")):
        for row in kernels:
            if row["name"] == name:
                row["deepseek_v3"] = {
                    **{step: rows[kid] for step, rows in
                       dsv3["kernels"].items() if kid in rows},
                    "max_abs_err": dsv3["max_abs_err"][kid],
                    "launches": ds_serve["launches"][
                        {"k1": "2d", "k3": "mixed", "k4": "batched"}[kid]],
                    "per": f"{what}; on Eq. 19 operands of each call's "
                           "shape, type and layout, ms behind a spin "
                           "kernel, plain_ms the checking call by CUDA "
                           "events; library: torch.matmul / torch.bmm in "
                           f"bf16 on the same operands; {ds_per}"}
    # Phase 30: the guard's calls on K1, K4 and K3; K10's repaired cases.
    gs = guard_report["serve"]
    for row in kernels:
        kid = {"emugemm1_2d": ("k1", "2d", "every dense call (q, k, v, o, "
                               "gate, up, down, the tied head), each on "
                               "the eager ladder; plus one NaN/Inf call a "
                               "dense shape in the ladder checks"),
               "emugemm1_batched": ("k4", "batched", "attn_qk / attn_av, "
                                    "one launch a layer each, each (lane, "
                                    "head) element verified")}.get(
            row["name"])
        if kid is not None:
            row["guard_phase"] = {
                **gs["kernels"].get(kid[0], {}),
                "max_abs_err": gs["max_abs_err"][kid[0]],
                "launches": gs["guarded"]["launches"][kid[1]],
                "launches_unguarded": gs["unguarded"]["launches"][kid[1]],
                "steps": gs["guarded"]["steps"],
                "per": f"olmo-1b's serve of phase 3's first {GUARD_REQUESTS} "
                       f"requests under {GUARD_SPEC}: {kid[2]}; the "
                       "unguarded serve makes the same calls; ms, "
                       "plain_ms, bound_ms and library_ms summed over the "
                       "serve's calls, each signature on Eq. 19 operands "
                       "of its shape, type and layout, held bit for bit"}
        elif row["name"] == "emugemm1_mixed":
            row["guard_phase"] = {
                "launches": guard_report["ladder"]["prepared"][
                    "launches_mixed"],
                "per": "one guarded call against a prepared olmo-1b weight, "
                       "verified against reconstruct()"}
        elif row["name"] == "flash_attention":
            row["repaired_cases"] = [
                c for c in row["cases"] if c["dtype"] == "float16"
                or c["shape"][5] not in flash_attn.HEAD_DIMS]
    # Phase 31: K10's ragged and wide heads, by the kernel that ran them.
    k10_new = {"flash_attention": (("wgmma", "wgmma-wide"), k10_counts.launches
                                   - k10_counts.launches_ffma
                                   - k10_counts.launches_3xtf32),
               "flash_attention_3xtf32": (("wgmma-3xtf32",),
                                          k10_counts.launches_3xtf32),
               "flash_attention_ffma": (("ffma",), k10_counts.launches_ffma),
               "flash_split_3xtf32": ((), k10_counts.launches_split)}
    for row in kernels:
        if row["name"] in k10_new:
            kernel, launches = k10_new[row["name"]]
            row["phase31"] = {
                "launches": launches,
                "max_abs_err": {k: v for k, v in k10_err.items() if v},
                "cases": [c for c in k10_rows
                          if c["instance"]["kernel"] in kernel],
                "per": "K10's ragged (D % 8 != 0: zero-padded copies at "
                       "the next multiple of 8, pad_ms inside ms) and wide "
                       "(D > 256: one block a 256-column output slice; "
                       "bf16 / float16 on the wgmma-wide kernel) "
                       f"heads at {list(K10_NEW_SHAPE)}, causal and full, "
                       "one call each on the main path; library: "
                       "scaled_dot_product_attention"}
    # Phase 32: each rank's launches on the tensor-parallel serve (a) and
    # in sharded_matmul's cases (b).
    ranks2 = mp["worlds"][2]
    for row in kernels:
        key = {"emugemm1_2d": "2d", "emugemm1_encode": "encode",
               "emugemm1_planes": "planes", "emugemm1_batched": "batched",
               "emugemm1_mixed": "mixed"}.get(row["name"])
        if key is None:
            continue
        row["phase32"] = {
            "tp_serve_launches_per_rank": {
                label: [r["serve"][label]["launches"][key] for r in ranks2]
                for label in MP_LABELS},
            "sharded_matmul_launches_per_rank": {
                case: [r["matmul"]["cases"][case]["launches"][key]
                       for r in ranks]
                for ranks in mp["worlds"].values()
                for case, c in ranks[0]["matmul"]["cases"].items()
                if "launches" in c},
            "per": "phase 32: olmo-1b (full depth) and granite-3-8b (4 "
                   "layers, its head tile prepared on each rank) served "
                   "tensor-parallel on mesh (1, 2) (launches per rank), "
                   "and sharded_matmul at "
                   "its dense shapes and the localized tied-head shape on "
                   "meshes (1, 2), (2, 1), (2, 2), (1, 4); ranks share one "
                   "card over " + ranks2[0]["backend"]}
    print(json.dumps({"probe": probe, "examples": examples}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
